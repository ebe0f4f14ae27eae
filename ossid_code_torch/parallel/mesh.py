"""Device mesh and the serving helpers built on it (the port of
ossid_code_tpu/parallel/mesh.py).

The JAX package's mesh is one controller over a `jax.sharding.Mesh`; so is
the port's: one process drives a numpy array of `torch.device`s, shaped
(dp,) or (dp, tp), with its axis names. A batch is split along its leading
axis in order over the devices of an axis, each device runs its part
(launches on different cards overlap: CUDA calls return before the work is
done), and the parts are gathered in order onto the first device of the
axis. The model's weights are read at each call, so a finetune is seen by
the next call; a device other than the model's gets a copy of the current
weights at each call.

The data-parallel training of the JAX package's mesh (`make_sharded_train_step`)
is `train/offline.py::OfflineTrainer(n_devices > 1)` on `torch.distributed`,
one process a device (parallel/launch.py).

The default device list is every CUDA device, and it raises when there is
none; the CPU tests pass `devices=[torch.device("cpu")] * 8`, the
counterpart of the JAX tests' eight virtual CPU devices.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from ossid_code_torch.models.zephyr.module import _bucket


class Mesh:
    """`devices`: the torch.devices in order, laid out as `shape`, one axis
    a name of `axis_names`."""

    def __init__(self, devices: list, shape: tuple, axis_names):
        arr = np.empty(len(devices), dtype=object)
        arr[:] = [torch.device(d) for d in devices]
        self.devices = arr.reshape(shape)
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def axis_devices(self, axis_name: str) -> list:
        """The devices along `axis_name`, at index 0 of every other axis."""
        ax = self.axis_names.index(axis_name)
        idx = [0] * self.devices.ndim
        out = []
        for i in range(self.devices.shape[ax]):
            idx[ax] = i
            out.append(self.devices[tuple(idx)])
        return out

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.devices.reshape(-1)]})"


def visible_devices(devices=None) -> list:
    """`devices` as a list, or by default every CUDA device; no CUDA raises
    (there is no fallback to the CPU)."""
    if devices is not None:
        return [torch.device(d) for d in devices]
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass devices=[torch.device('cpu')] * n "
                           "to build a mesh on the CPU")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(n_devices: int | None = None, axis_name: str = "dp", devices=None) -> Mesh:
    devs = visible_devices(devices)
    n = n_devices or len(devs)
    if n > len(devs):
        raise ValueError(f"requested {n} devices, have {len(devs)}")
    return Mesh(devs[:n], (n,), (axis_name,))


def make_mesh_2d(dp: int, tp: int, axis_names=("dp", "tp"), devices=None) -> Mesh:
    """2-D mesh: `dp` frame-parallel rows of `tp` template-parallel devices."""
    devs = visible_devices(devices)
    if dp * tp > len(devs):
        raise ValueError(f"requested {dp}x{tp} devices, have {len(devs)}")
    return Mesh(devs[:dp * tp], (dp, tp), axis_names)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return fn(tree)


def to_tensor(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.astype(np.int32) if a.dtype == np.uint16 else a)


def shard_batch(mesh: Mesh, tree, axis_name: str = "dp"):
    """Every leaf's leading axis split in order over the devices along
    `axis_name`: a list of parts, part i on the axis's i-th device. The
    axis must divide the leading size, as JAX's sharding requires."""
    devs = mesh.axis_devices(axis_name)

    def put(x):
        x = to_tensor(x)
        if x.shape[0] % len(devs):
            raise ValueError(f"leading axis {x.shape[0]} does not divide over {len(devs)} devices")
        return [part.to(d) for part, d in zip(x.chunk(len(devs)), devs)]

    return _map(tree, put)


def replicate(mesh: Mesh, tree):
    """Every leaf copied to each device of the mesh, in the mesh's order."""
    return _map(tree, lambda x: [to_tensor(x).to(d) for d in mesh.devices.reshape(-1)])


def batch_pspec(axis_name: str = "dp") -> tuple:
    """The leading axis split over `axis_name` (JAX's P(axis_name))."""
    return (axis_name,)


def _same_device(a: torch.device, b: torch.device) -> bool:
    """a and b are one device: "cuda" is the current card. (torch's own
    equality, kept for the CPU, tells "cpu" from "cpu:0"; the CPU tests use
    that to run the copy path below.)"""
    norm = lambda d: torch.device("cuda", torch.cuda.current_device()) if d.type == "cuda" and d.index is None else d  # noqa: E731
    return norm(torch.device(a)) == norm(torch.device(b))


def _split(x: torch.Tensor, n: int) -> list:
    """x's leading axis in n ordered parts (the last ones smaller where n
    does not divide it; empty parts included)."""
    return list(torch.tensor_split(x, n))


class _Replicas:
    """A network on other devices than its model's: a copy a device, loaded
    with the model's current weights and statistics at each `net` call."""

    def __init__(self, base_fn, home: torch.device):
        self.base_fn = base_fn
        self.home = home
        self.copies: dict = {}

    def net(self, device: torch.device):
        base = self.base_fn()
        if _same_device(device, self.home):
            return base
        rep = self.copies.get(device)
        if rep is None:
            with torch.inference_mode(False), torch.no_grad():
                rep = copy.deepcopy(base).to(device).eval().requires_grad_(False)
            self.copies[device] = rep
        else:
            with torch.no_grad():
                for dst, src in zip(rep.state_dict().values(), base.state_dict().values()):
                    dst.copy_(src)
        return rep


def dtoid_replicas(dtoid_model) -> _Replicas:
    """The detector's inference network (float32, or its bf16 copy) on any
    device."""
    return _Replicas(dtoid_model._infer_net, dtoid_model.device)


# ---------------------------------------------------------------------------
# Inference-side axes: template-parallel detection, hypothesis-parallel
# scoring, and the 2-D frames x templates serving farm
# ---------------------------------------------------------------------------

def make_template_parallel_forward(dtoid_model, mesh: Mesh, axis_name: str = "dp"):
    """Template-parallel DTOID forward: the T local templates split over the
    devices along `axis_name`, each device computes the image features and
    correlates its templates, and the per-template outputs are gathered in
    template order onto the first device. Returns fn(image (1, H, W, 3) in
    [0,1], local_feats (T, 7, 7, 640), global_feat (1, 3, 3, 64)) -> (cls
    (T, N, 2), reg (T, N, 4), heatmap (T, fh, fw, 1), seg_probs (T, H, W))."""
    devs = mesh.axis_devices(axis_name)
    reps = dtoid_replicas(dtoid_model)

    @torch.inference_mode()
    def fwd(image, local_feats, global_feat):
        image, local_feats, global_feat = (to_tensor(a) for a in (image, local_feats, global_feat))
        parts = []
        for d, lf in zip(devs, _split(local_feats, len(devs))):
            if len(lf):
                out = reps.net(d).forward_all_templates(image.to(d), lf.to(d), global_feat.to(d))
                parts.append([o.to(devs[0]) for o in out])
        return tuple(torch.cat(p, 0) for p in zip(*parts))

    return fwd


def _zephyr_on(zephyr_model, device: torch.device, cache: dict):
    """The scorer on `device`: itself on its own device, else a copy of it
    holding the current weights (and its own per-object state)."""
    if _same_device(device, zephyr_model.device):
        return zephyr_model
    rep = cache.get(device)
    if rep is None:
        rep = copy.copy(zephyr_model)
        with torch.inference_mode(False), torch.no_grad():
            rep.net = copy.deepcopy(zephyr_model.net).to(device).eval()
        rep.device, rep._objects, rep._bf16_net = device, {}, None
        cache[device] = rep
    else:
        with torch.no_grad():
            for dst, src in zip(rep.net.state_dict().values(), zephyr_model.net.state_dict().values()):
                dst.copy_(src)
        rep._bf16_net = None
    return rep


def make_hypothesis_parallel_scorer(zephyr_model, mesh: Mesh, axis_name: str = "dp"):
    """Hypothesis-parallel Zephyr scoring: the M pose hypotheses split over
    the devices along `axis_name`; the frame and the object's cloud go to
    each. Returns fn(img_u8, depth_u16, depth_origin, cam_K, pts, cols, nrms,
    sa1c, sa1g, sa2c, sa2g, ricp_pts, ricp_nrms, poses (M, 4, 4), valid (M,))
    -> (scores, raw_scores, uv, inconst, align_stat, refined), the first five
    with M rows on the first device, as ZephyrModel's score program gives
    them (the JAX function's `params` and `batch_stats` arguments are the
    model's current weights, read at each call).

    The score program refines the first `refine_top` hypotheses of the whole
    batch with device ICP. A shard scored on its own would refine its own
    first rows, so the refinement runs before the split, on the first
    device, and the shards score the refined poses as given. M is padded to
    a multiple of the device count with invalid rows, dropped after the
    gather; each shard is padded to the scorer's power-of-two bucket, as a
    score call pads its hypotheses."""
    devs = mesh.axis_devices(axis_name)
    cache: dict = {}

    @torch.inference_mode()
    def score(img_u8, depth_u16, depth_origin, cam_K, pts, cols, nrms, sa1c, sa1g, sa2c, sa2g,
              ricp_pts, ricp_nrms, poses, valid):
        frame = [to_tensor(a) for a in (img_u8, depth_u16, depth_origin, cam_K, pts, cols, nrms,
                                       sa1c, sa1g, sa2c, sa2g, ricp_pts, ricp_nrms)]
        d0 = devs[0]
        poses, valid = to_tensor(poses).to(d0), to_tensor(valid).to(d0)
        refined = None
        zm0 = _zephyr_on(zephyr_model, d0, cache)
        if zephyr_model.refine_top > 0:
            f0 = [a.to(d0) for a in frame]
            depth = f0[1].to(torch.float32) / 1000.0
            poses, refined = zm0._refine(depth, f0[2], f0[3], f0[11], f0[12], poses, valid)
        m, n = poses.shape[0], len(devs)
        per = -(-m // n)
        mb = _bucket(per)
        outs = []
        for i, d in enumerate(devs):
            p, v = poses[i * per:(i + 1) * per], valid[i * per:(i + 1) * per]
            pad = mb - p.shape[0]
            p = torch.cat([p, torch.eye(4, dtype=p.dtype, device=d0).expand(pad, 4, 4)])
            v = torch.cat([v, torch.zeros(pad, dtype=v.dtype, device=d0)])
            zm = _zephyr_on(zephyr_model, d, cache)
            out = zm._score(*(a.to(d) for a in frame), p.to(d), v.to(d), refine=False)[:5]
            rows = mb - pad
            outs.append([o[:rows].to(d0) for o in out])
        return tuple(torch.cat(o, 0) for o in zip(*outs)) + (refined,)

    return score


def split_2d(mesh: Mesh, axes, images, local_feats):
    """(row devices, frame parts a row, template parts a column)."""
    rows = mesh.devices if mesh.axis_names.index(axes[0]) == 0 else mesh.devices.T
    return rows, _split(images, rows.shape[0]), _split(local_feats, rows.shape[1])


def make_serving_farm_forward(dtoid_model, mesh: Mesh, axes=("dp", "tp")):
    """The serving farm on a 2-D mesh: F frames split over `axes[0]` and the
    T templates over `axes[1]`; each device correlates its templates with
    its frames, and each row gathers its templates' outputs on its first
    device. Returns fn(images (F, H, W, 3) in [0,1], local_feats (T, 7, 7,
    640), global_feat (1, 3, 3, 64)) -> (cls (F, T, N, 2), reg (F, T, N, 4),
    heatmap (F, T, fh, fw, 1), seg_probs (F, T, H, W)) on the mesh's first
    device."""
    reps = dtoid_replicas(dtoid_model)

    @torch.inference_mode()
    def fwd(images, local_feats, global_feat):
        images, local_feats, global_feat = (to_tensor(a) for a in (images, local_feats, global_feat))
        rows, frame_parts, template_parts = split_2d(mesh, axes, images, local_feats)
        out_rows = []
        for r, frames in enumerate(frame_parts):
            if not len(frames):
                continue
            head = rows[r, 0]
            parts = [[o.to(head) for o in reps.net(d).forward_frames(frames.to(d), lf.to(d), global_feat.to(d))]
                     for d, lf in zip(rows[r], template_parts) if len(lf)]
            out_rows.append([torch.cat(p, 1) for p in zip(*parts)])
        return tuple(torch.cat([o.to(rows[0, 0]) for o in p], 0) for p in zip(*out_rows))

    return fwd
