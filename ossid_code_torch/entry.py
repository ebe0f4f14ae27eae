"""Driver entry points of the port (the counterpart of `__graft_entry__.py`).

    entry(device=None) -> (fn, example_args)
        DTOID's all-templates detection forward at the JAX entry's shapes
        (128x160 frame, 7x9 heat map, 4 local templates); `fn` runs under
        `torch.inference_mode`.
    dryrun_multidevice(n, device=None)
        At tiny shapes, the mesh's template-parallel forward, the
        hypothesis-parallel scorer and the 2-D serving farm on a mesh of n
        devices, then one data-parallel DTOID step in n processes of one
        `torch.distributed` group (gloo). On the CPU the mesh is n CPU
        devices; on the card it is the card n times over, as one card shows
        the split and gather code.

Both run on the card unless `device="cpu"`. A script that calls
`dryrun_multidevice` needs an `if __name__ == "__main__":` guard: the step's
processes are spawned, and they import the main module.
"""

from __future__ import annotations

import numpy as np
import torch

from ossid_code_torch.device import resolve_device

ENTRY_HW = (128, 160)
ENTRY_HEATMAP = (7, 9)
ENTRY_TEMPLATES = 4
DRYRUN_HW = (64, 64)
DRYRUN_HEATMAP = (3, 3)
DRYRUN_BLOCKS = (2, 2, 2)   # the JAX dry run's DenseNet depth: every layer kind, fewer repeats


def _entry_config(hw, heatmap, densenet_blocks=None):
    from ossid_code_torch.core.config import default_config

    cfg = default_config()
    cfg.model.img_h, cfg.model.img_w = hw
    cfg.model.heatmap_h, cfg.model.heatmap_w = heatmap
    if densenet_blocks is not None:
        cfg.model.densenet_blocks = tuple(densenet_blocks)
    return cfg


def entry(device=None, densenet_blocks=None):
    """(fn, example_args): fn(image (1, 128, 160, 3) in [0, 1], local_feats
    (4, 7, 7, 640), global_feat (1, 3, 3, 64)) -> (cls (4, N, 2), reg (4, N,
    4), heatmap (4, 7, 9, 1), seg_probs (4, 128, 160)) of a DtoidModel from
    seed 0 (`fn.model`), the example arguments zeros on its device.
    `densenet_blocks` (default DenseNet-121's) cuts the image encoder's
    depth for small runs."""
    from ossid_code_torch.models.dtoid.module import DtoidModel

    dev = resolve_device(device)
    model = DtoidModel(_entry_config(ENTRY_HW, ENTRY_HEATMAP, densenet_blocks), seed=0, device=dev)
    net = model.net

    @torch.inference_mode()
    def fn(image, local_feats, global_feat):
        return net.forward_all_templates(image, local_feats, global_feat)

    fn.model = model
    h, w = ENTRY_HW
    example_args = (torch.zeros((1, h, w, 3), device=dev), torch.zeros((ENTRY_TEMPLATES, 7, 7, 640), device=dev),
                    torch.zeros((1, 3, 3, 64), device=dev))
    return fn, example_args


def _dryrun_batch(b: int, seed: int = 0) -> dict:
    """The JAX dry run's training batch: b samples at 64x64."""
    rng = np.random.default_rng(seed)
    (h, w), ts = DRYRUN_HW, 124
    return {
        "img": rng.uniform(0, 1, (b, h, w, 3)).astype(np.float32),
        "limg": rng.uniform(0, 1, (b, ts, ts, 3)).astype(np.float32),
        "lmask": np.ones((b, ts, ts, 1), np.float32),
        "gimg": rng.uniform(0, 1, (b, ts, ts, 3)).astype(np.float32),
        "gmask": np.ones((b, ts, ts, 1), np.float32),
        "bbox_gt": np.asarray([[[10, 10, 50, 50, 1]]] * b, np.float32),
        "heatmap": rng.uniform(0, 1, (b,) + DRYRUN_HEATMAP + (1,)).astype(np.float32),
        "mask": (rng.uniform(0, 1, (b, h, w, 1)) > 0.8).astype(np.float32),
    }


def _dryrun_model(device, batch_size: int):
    from ossid_code_torch.models.dtoid.module import DtoidModel

    cfg = _entry_config(DRYRUN_HW, DRYRUN_HEATMAP, DRYRUN_BLOCKS)
    cfg.train.batch_size = batch_size
    return cfg, DtoidModel(cfg, seed=0, device=device)


def _dp_rank(rank: int, world: int, device: str) -> float:
    """One rank of the data-parallel step: OfflineTrainer over the group, one
    batch of `world` samples (one a rank); returns the step's loss."""
    from ossid_code_torch.train.offline import OfflineTrainer

    cfg, model = _dryrun_model(device, world)
    return float(OfflineTrainer(model, cfg, n_devices=world).train_epoch([_dryrun_batch(world)])["loss"])


def dryrun_multidevice(n: int, device=None) -> dict:
    """The mesh's serving helpers and one data-parallel DTOID step over n
    devices at tiny shapes (the JAX dry run's four programs, cheapest
    first); prints a line a program and returns what each gave (shapes and
    the step's loss on every rank). Raises where an output is not finite."""
    from ossid_code_torch.models.zephyr.module import ZephyrModel
    from ossid_code_torch.parallel import mesh as pm
    from ossid_code_torch.parallel.launch import spawn

    dev = resolve_device(device)
    devices = [dev] * n
    _, model = _dryrun_model(dev, n)
    rng = np.random.default_rng(0)
    out = {}

    # 1) template-parallel detection forward: T = n templates over the mesh
    tp_fwd = pm.make_template_parallel_forward(model, pm.make_mesh(n, devices=devices))
    h, w = DRYRUN_HW
    gfeat = torch.zeros((1, 3, 3, 64), device=dev)
    cls = tp_fwd(torch.zeros((1, h, w, 3), device=dev), torch.zeros((n, 7, 7, 640), device=dev), gfeat)[0]
    if cls.shape[0] != n or not torch.isfinite(cls).all():
        raise RuntimeError(f"template-parallel detection: cls {tuple(cls.shape)} for {n} templates")
    out["template_parallel_cls"] = list(cls.shape)
    print(f"dryrun_multidevice({n}): template-parallel detection OK {tuple(cls.shape)}", flush=True)

    # 2) hypothesis-parallel scoring: M = 2n hypotheses over the mesh
    zm = ZephyrModel(num_points=64, seed=0, device=dev)
    pts = rng.normal(0, 0.03, (256, 3)).astype(np.float32)
    cols = rng.uniform(0, 1, (256, 3)).astype(np.float32)
    nrms = np.tile(np.asarray([[0, 0, -1.0]], np.float32), (256, 1))
    prep = zm.prepare_object(1, pts, cols, nrms)
    m = 2 * n
    poses = np.tile(np.eye(4, dtype=np.float32), (m, 1, 1))
    poses[:, 2, 3] = 0.5
    k = np.array([[40.0, 0, 16], [0, 40.0, 16], [0, 0, 1]], np.float32)
    frame = (torch.zeros((32, 32, 3), dtype=torch.uint8), torch.full((32, 32), 500, dtype=torch.int32),
             torch.zeros(2, dtype=torch.int32), torch.from_numpy(k))
    hp = pm.make_hypothesis_parallel_scorer(zm, pm.make_mesh(n, devices=devices))
    scores, raw = hp(*(t.to(dev) for t in frame), *prep, torch.from_numpy(poses).to(dev),
                     torch.ones(m, dtype=torch.bool, device=dev))[:2]
    if raw.shape[0] != m or not torch.isfinite(raw).all():
        raise RuntimeError(f"hypothesis-parallel scoring: raw scores {raw}")
    out["hypothesis_parallel_scores"] = list(scores.shape)
    print(f"dryrun_multidevice({n}): hypothesis-parallel scoring OK {tuple(scores.shape)}", flush=True)

    # 3) the 2-D serving farm: F frames x T templates over (dp, tp)
    dp2, tp2 = (2, n // 2) if n >= 4 else (1, n)
    farm = pm.make_serving_farm_forward(model, pm.make_mesh_2d(dp2, tp2, devices=devices[:dp2 * tp2]))
    frames = torch.from_numpy(rng.uniform(0, 1, (2 * dp2, h, w, 3)).astype(np.float32)).to(dev)
    fcls = farm(frames, torch.zeros((tp2, 7, 7, 640), device=dev), gfeat)[0]
    if tuple(fcls.shape[:2]) != (2 * dp2, tp2) or not torch.isfinite(fcls).all():
        raise RuntimeError(f"2-D serving farm: cls {tuple(fcls.shape)} on mesh {dp2}x{tp2}")
    out["farm_cls"], out["farm_mesh"] = list(fcls.shape), [dp2, tp2]
    print(f"dryrun_multidevice({n}): 2-D serving farm OK {tuple(fcls.shape)} on mesh {dp2}x{tp2}", flush=True)

    # 4) the data-parallel step: n processes of one gloo group, one sample each
    losses = spawn(_dp_rank, n, "gloo", args=(str(dev),))
    if not all(np.isfinite(losses)):
        raise RuntimeError(f"data-parallel step: losses by rank {losses}")
    out["dp_losses"] = losses
    print(f"dryrun_multidevice({n}): DP train step OK, loss={losses[0]:.4f}", flush=True)
    return out
