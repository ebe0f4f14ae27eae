"""ZephyrModel: pose-hypothesis scoring, inference (counterpart of
ossid_code_tpu/models/zephyr/module.py).

One score program takes the frame (uint8 image, uint16 depth, K), the
object's prepared model cloud and grouping indices, and a batch of pose
hypotheses padded to a power-of-two bucket; it blurs the image, assembles
per-point features on the device and scores every hypothesis with
PointNet2SSG. Hypotheses whose free-space-violation ratio reaches
`inconst_ratio_th` score -inf (the reference's pre-network pruning).
Per-object state (cloud, colours, normals, grouping indices, the denser ICP
cloud) is prepared once and kept on the device: grouping is rigid-invariant,
so FPS and ball query never run per frame. With `refine_top > 0` the first
`refine_top` hypotheses are refined by device ICP (ops/icp_device.py) against
the depth before they are scored, and the refined rows replace them where
they are valid. With `bf16=True` (the JAX package's OSSID_BF16_SCORER) the
network runs in bf16 on a cached bf16 copy of its weights: geometry, ICP,
feature assembly and the alignment statistic stay float32, and the point
features are cast to bf16 just before the network. `packed_sample` (default
on, the JAX package's OSSID_PACKED_SAMPLE) gathers each bilinear sample's
four taps at once from a packed image; `packed_sample=False` takes the four
taps one by one (the same values: `bilinear_sample`, `bilinear_sample_packed`).

`train_step` trains the scorer as the JAX package does: the network in
training mode (in-graph grouping, flax-rule BatchNorm, dropout from a
generator seeded per step), class-balanced sigmoid BCE plus `rank_weight`
(default `RANK_WEIGHT`, 1.0; 0 leaves it out) times a listwise softmax term
over the hypothesis set, and optax's plain
Adam (lr 1e-3) on every parameter but the calibrated alignment head.
"""

from __future__ import annotations

import copy
import hashlib

import numpy as np
import torch
import torch.nn.functional as F

from .optim import OptaxAdam
from .device import resolve_device
from .network import lecun_init_
from .features import DIM_POINT, assemble_score_features
from .pointnet2 import PointNet2SSG
from .icp_device import batched_icp, sample_valid_points


# device ICP of the refined hypotheses (the JAX package's defaults)
REFINE_MAX_DIST = 0.01
REFINE_ITERS = 16
# weight of the listwise ranking term in the scorer loss: ZephyrModel's
# default (the JAX package's)
RANK_WEIGHT = 1.0


def _bucket(m: int, minimum: int = 64) -> int:
    b = minimum
    while b < m:
        b *= 2
    return b


def _fps_np(pts: np.ndarray, n: int) -> np.ndarray:
    if n >= len(pts):
        return np.arange(len(pts))
    idxs = np.zeros(n, np.int32)
    d = np.full(len(pts), np.inf)
    last = 0
    for i in range(1, n):
        d = np.minimum(d, ((pts - pts[last]) ** 2).sum(1))
        last = int(d.argmax())
        idxs[i] = last
    return idxs


def _ball_np(centers: np.ndarray, pts: np.ndarray, r: float, k: int) -> np.ndarray:
    d2 = ((centers[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
    idx = np.zeros((len(centers), k), np.int32)
    for i in range(len(centers)):
        inside = np.nonzero(d2[i] <= r * r)[0]
        if len(inside) == 0:
            continue
        sel = inside[:k]
        idx[i, : len(sel)] = sel
        idx[i, len(sel):] = sel[0]
    return idx


# cv2 GaussianBlur((5,5), 0) kernel == [1, 4, 6, 4, 1] / 16
_BLUR_K = np.asarray([1.0, 4.0, 6.0, 4.0, 1.0]) / 16.0


def _blur5(img: torch.Tensor) -> torch.Tensor:
    """Separable 5x5 Gaussian blur of an (H, W, C) image, edge-replicated,
    with the taps summed in the JAX package's order."""
    h, w = img.shape[0], img.shape[1]
    x = torch.cat([img[:1], img[:1], img, img[-1:], img[-1:]], 0)
    x = sum(float(_BLUR_K[i]) * x[i:i + h] for i in range(5))
    x = torch.cat([x[:, :1], x[:, :1], x, x[:, -1:], x[:, -1:]], 1)
    return sum(float(_BLUR_K[i]) * x[:, i:i + w] for i in range(5))


def scorer_loss(logits: torch.Tensor, labels: torch.Tensor, valid: torch.Tensor,
                rank_weight: float = RANK_WEIGHT) -> torch.Tensor:
    """Class-balanced sigmoid BCE (optax's `sigmoid_binary_cross_entropy`,
    positives and negatives weighted equally) plus `rank_weight` times the
    listwise term: softmax cross-entropy of the valid logits (invalid ones at
    -1e9) against a uniform target over the positives, shifted by its
    log(npos) floor, counted only when the set holds both classes. Where
    `rank_weight` is not above 0 the listwise term is not computed (BCE
    alone), as in the JAX package."""
    losses = -labels * F.logsigmoid(logits) - (1.0 - labels) * F.logsigmoid(-logits)
    pos = (labels > 0.5) & valid
    neg = (labels <= 0.5) & valid
    zero = torch.zeros_like(losses)
    wpos = torch.where(pos, losses, zero).sum() / pos.sum().clamp(min=1)
    wneg = torch.where(neg, losses, zero).sum() / neg.sum().clamp(min=1)
    if rank_weight <= 0.0:
        return 0.5 * (wpos + wneg)
    masked = torch.where(valid, logits, torch.full_like(logits, -1e9))
    logz = torch.logsumexp(masked, 0)
    npos = pos.sum()
    tgt = pos.to(logits.dtype) / npos.clamp(min=1)
    rank = -(tgt * (masked - logz)).sum() - torch.log(npos.to(logits.dtype).clamp(min=1.0))
    has_both = (npos > 0) & (npos < valid.sum())
    return 0.5 * (wpos + wneg) + rank_weight * torch.where(has_both, rank, torch.zeros_like(rank))


class ZephyrModel:
    def __init__(self, num_points: int = 512, inconst_ratio_th: float = 100.0, seed: int = 0,
                 need_uv: bool = True, refine_top: int = 0, rank_blend: float = 0.0, align_feats: bool = False,
                 bf16: bool = False, packed_sample: bool = True, device: str | torch.device | None = None,
                 rank_weight: float = RANK_WEIGHT):
        self.device = resolve_device(device)
        # weight of the listwise ranking term in train_step (0: class-balanced BCE alone)
        self.rank_weight = float(rank_weight)
        # the scorer network in bf16 (the JAX package's OSSID_BF16_SCORER)
        self.bf16 = bool(bf16)
        # one gather of packed taps a bilinear sample (the JAX package's OSSID_PACKED_SAMPLE)
        self.packed_sample = bool(packed_sample)
        self._bf16_net = None  # bf16 copy of self.net, dropped when the weights load
        self.num_points = num_points
        self.inconst_ratio_th = inconst_ratio_th
        self.need_uv = need_uv
        # device ICP of the first refine_top hypotheses before scoring
        self.refine_top = int(refine_top)
        # blended ranking weight of the geometric alignment statistic in _pick
        # (0 = argmax of the net score); host-side only
        self.rank_blend = float(rank_blend)
        self.align_feats = bool(align_feats)
        self.net = PointNet2SSG(num_class=1, dim_point=DIM_POINT, align_feats=self.align_feats)
        lecun_init_(self.net, torch.Generator().manual_seed(seed))
        if self.net.align_head is not None:
            torch.nn.init.zeros_(self.net.align_head.weight)
        self.net.to(self.device).eval()
        self.optimizer = OptaxAdam([p for name, p in self.net.named_parameters()
                                    if not name.startswith("align_head.")], lr=1e-3)
        self._objects: dict = {}

    # ------------------------------------------------------------- weights
    def state_dict(self) -> dict:
        return self.net.state_dict()

    def load_state_dict(self, sd: dict) -> None:
        self.net.load_state_dict(sd, strict=True)
        self._bf16_net = None

    # ------------------------------------------------------------ training
    def train_step(self, point_x, labels, valid, seed: int = 0) -> float:
        """One Adam step on a frame's hypothesis set: point_x (M, N, D)
        features, labels (M,) in {0, 1}, valid (M,) bool; the dropout masks
        come from a generator seeded with `seed`. Returns the loss."""
        dev = self.device
        point_x = torch.as_tensor(point_x, device=dev)
        labels = torch.as_tensor(labels, dtype=torch.float32, device=dev)
        valid = torch.as_tensor(valid, dtype=torch.bool, device=dev)
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        logits = self.net(point_x, train=True, generator=gen)
        loss = scorer_loss(logits, labels, valid, self.rank_weight)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()
        self._bf16_net = None
        return float(loss.detach())

    def _score_net(self):
        """The network in the scoring dtype: itself, or with `bf16` a bf16 copy
        of its weights and statistics kept on the device until the weights
        load anew (JAX `_score_vars`)."""
        if not self.bf16:
            return self.net
        if self._bf16_net is None:
            with torch.inference_mode(False), torch.no_grad():  # plain tensors, not inference tensors
                self._bf16_net = copy.deepcopy(self.net).to(torch.bfloat16).eval().requires_grad_(False)
        return self._bf16_net

    # --------------------------------------------------------- object prep
    def prepare_object(self, obj_id, points, colors, normals):
        """Resample the model cloud to num_points, precompute the
        rigid-invariant PointNet++ grouping indices, keep all on the device."""
        if obj_id in self._objects:
            return self._objects[obj_id]
        points = np.asarray(points, np.float32)
        colors = np.asarray(colors, np.float32)
        normals = np.asarray(normals, np.float32)
        n = len(points)
        if n >= self.num_points:
            idx = np.linspace(0, n - 1, self.num_points).round().astype(int)
        else:
            idx = np.resize(np.arange(n), self.num_points)
        pts, cols, nrms = points[idx], colors[idx], normals[idx]

        centered = pts - pts.mean(0, keepdims=True)
        sa1_n = min(512, self.num_points)
        sa2_n = min(128, sa1_n)
        sa1c = (np.arange(sa1_n, dtype=np.int32) if sa1_n == self.num_points
                else _fps_np(centered, sa1_n))
        c1 = centered[sa1c]
        sa1g = _ball_np(c1, centered, 0.2, min(64, self.num_points))
        sa2c = _fps_np(c1, sa2_n)
        sa2g = _ball_np(c1[sa2c], c1, 0.4, 64)
        # ICP cloud: denser than the scoring cloud when num_points is small
        ridx = np.linspace(0, n - 1, min(384, n)).round().astype(int)

        prep = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                     for a in (pts, cols, nrms, sa1c.astype(np.int32), sa1g.astype(np.int32),
                               sa2c.astype(np.int32), sa2g.astype(np.int32),
                               points[ridx], normals[ridx]))
        self._objects[obj_id] = prep
        return prep

    # -------------------------------------------------------- score program
    def _refine(self, depth, depth_origin, cam_K, ricp_pts, ricp_nrms, poses, valid):
        """Device ICP of the first `refine_top` hypotheses against the depth
        (metres): (poses with the valid refined rows in place, the refined
        rows)."""
        k = min(self.refine_top, poses.shape[0])
        scene_pts, scene_ok = sample_valid_points(depth, cam_K, origin=depth_origin, k=4096)
        refined = batched_icp(poses[:k], ricp_pts, scene_pts, scene_ok,
                              max_dist=REFINE_MAX_DIST, iters=REFINE_ITERS,
                              model_normals=ricp_nrms)
        refined = torch.where(valid[:k, None, None], refined, poses[:k])
        return torch.cat([refined, poses[k:]], 0), refined

    def _score(self, img_u8, depth_u16, depth_origin, cam_K, pts, cols, nrms,
               sa1c, sa1g, sa2c, sa2g, ricp_pts, ricp_nrms, poses, valid, refine: bool = True):
        """The score program; `refine=False` scores the poses as given (a
        hypothesis-parallel shard, whose batch was refined before the split)."""
        img = _blur5(img_u8.to(torch.float32) / 255.0)
        depth = depth_u16.to(torch.float32) / 1000.0
        refined = None
        if refine and self.refine_top > 0:
            poses, refined = self._refine(depth, depth_origin, cam_K, ricp_pts, ricp_nrms, poses, valid)
        point_x, uv, inconst = assemble_score_features(
            img, depth, cam_K, pts, cols, nrms, poses, return_uv=self.need_uv,
            depth_origin=depth_origin, packed_sample=self.packed_sample)
        if uv is None:
            uv = torch.zeros((poses.shape[0], 1, 2), device=poses.device)
        # geometric alignment statistic per hypothesis (see _pick)
        okp = point_x[..., 10]
        aligned = okp * (torch.abs(point_x[..., 6]) < 0.01) * (point_x[..., 3] < 0.05)
        align_stat = aligned.sum(-1) / okp.sum(-1).clamp(min=1.0)
        static_idx = {"sa1": (sa1c, sa1g), "sa2": (sa2c, sa2g)}
        if self.bf16:
            point_x = point_x.to(torch.bfloat16)
        raw = self._score_net()(point_x, static_idx).to(torch.float32)
        neg_inf = torch.full_like(raw, float("-inf"))
        ok = valid & (inconst < self.inconst_ratio_th)
        return (torch.where(ok, raw, neg_inf), torch.where(valid, raw, neg_inf), uv, inconst,
                align_stat, refined)

    # ----------------------------------------------------------------- API
    @torch.inference_mode()
    def score_hypotheses_async(self, data: dict, obj_id=None) -> dict:
        """Launch the score program without waiting; returns a handle for
        `fetch_scores`."""
        poses = np.asarray(data["pose_hypos"], np.float32)
        m = len(poses)
        mb = _bucket(m)
        poses_p = np.concatenate([poses, np.tile(np.eye(4, dtype=np.float32), (mb - m, 1, 1))])
        valid = np.zeros((mb,), bool)
        valid[:m] = True

        # content hash, not id(): python ids are recycled
        key = obj_id if obj_id is not None else hashlib.sha1(
            np.ascontiguousarray(data["model_points"]).tobytes()).hexdigest()
        prep = self.prepare_object(key, data["model_points"], data["model_colors"],
                                   data["model_normals"])

        img = data["img"]
        if isinstance(img, torch.Tensor):  # a uint8 frame already on the device
            if img.dtype != torch.uint8:
                raise TypeError(f"a device frame must be uint8, got {img.dtype}")
        elif not (hasattr(img, "dtype") and img.dtype == np.uint8):
            img = (np.clip(np.asarray(img), 0, 1) * 255).astype(np.uint8)
        depth = data["depth"]
        if isinstance(depth, torch.Tensor):  # integer millimetres already on the device
            if depth.dtype.is_floating_point:
                raise TypeError(f"a device depth must hold integer millimetres, got {depth.dtype}")
        elif not (hasattr(depth, "dtype") and depth.dtype == np.uint16):
            depth = (np.asarray(depth, np.float64) * 1000.0).round().clip(0, 65535).astype(np.uint16)
        origin = np.asarray(data.get("depth_origin", (0, 0)), np.int32)

        def dev(a, dtype=None):
            t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(a))
            return t.to(self.device, dtype=dtype)

        scores, raw, uv, inconst, align_stat, refined = self._score(
            dev(img), dev(depth if isinstance(depth, torch.Tensor) else depth.astype(np.int32)), dev(origin),
            dev(np.asarray(data["cam_K"], np.float32)), *prep,
            dev(poses_p), dev(valid))
        return {"dev": (scores, raw, inconst, align_stat), "uv_dev": uv,
                "poses": poses, "m": m, "refined_dev": refined}

    def _pick(self, scores_np: np.ndarray, stat_np: np.ndarray) -> int:
        """Winning hypothesis: argmax of the net score, or with rank_blend of
        z-scored net score + rank_blend * z-scored alignment statistic over
        the non-pruned entries."""
        lam = self.rank_blend
        finite = np.isfinite(scores_np)
        if not lam or finite.sum() < 2:
            return np.argmax(scores_np)
        s = scores_np[finite]
        sz = (s - s.mean()) / max(float(s.std()), 1e-6)
        t = stat_np[finite]
        tz = (t - t.mean()) / max(float(t.std()), 1e-6)
        return np.flatnonzero(finite)[np.argmax(sz + lam * tz)]

    def fetch_scores(self, handle: dict, fetched=None, refined_fetched=None) -> dict:
        """Wait for the score outputs and build the result dict ('scores',
        'align_stat', 'inconst_ratio', 'pred_idx/score/pose', device 'uv_dev').
        With refinement, 'pred_pose' is the refined pose that was scored, and
        'refined' holds the refined rows (refine_top, 4, 4). `fetched` (the
        four arrays of handle['dev']) and `refined_fetched` inject host
        arrays that a bundled fetch already copied."""
        poses, m = handle["poses"], handle["m"]
        scores_np, raw_np, inconst_np, stat_np = (
            fetched if fetched is not None else [t.cpu().numpy() for t in handle["dev"]])
        scores_np = np.asarray(scores_np)[:m]
        raw_np = np.asarray(raw_np)
        inconst_np = np.asarray(inconst_np)[:m]
        stat_np = np.asarray(stat_np)[:m]
        if m and not np.isfinite(scores_np).any():
            # every hypothesis was pruned by the free-space check: fall back to
            # the raw network scores so the caller always gets a pose
            scores_np = raw_np[:m]
        idx = int(self._pick(scores_np, stat_np)) if m else -1
        pred_pose = poses[idx] if m else np.eye(4)
        refined = handle.get("refined_dev")
        if refined is not None:
            refined = np.asarray(refined_fetched) if refined_fetched is not None else refined.cpu().numpy()
            if 0 <= idx < len(refined):
                pred_pose = refined[idx]
        return {
            "scores": scores_np,
            "align_stat": stat_np,
            "inconst_ratio": inconst_np,
            "uv_dev": handle["uv_dev"],
            "pred_idx": idx,
            "pred_score": float(scores_np[idx]) if m else -np.inf,
            "pred_pose": pred_pose,
            "refined": refined,
        }

    def score_hypotheses(self, data: dict, obj_id=None, fetch_uv: bool = False) -> dict:
        """data: img (H,W,3) uint8 or float [0,1]; depth (H,W) float meters or
        uint16 mm; cam_K (3,3); model_points/colors/normals (N,3);
        pose_hypos (M,4,4). Returns numpy 'scores' (M,), 'inconst_ratio',
        'pred_idx', 'pred_score', 'pred_pose', and device 'uv_dev'."""
        out = self.fetch_scores(self.score_hypotheses_async(data, obj_id=obj_id))
        if fetch_uv:
            out["uv"] = out["uv_dev"].cpu().numpy()[: len(data["pose_hypos"])]
        return out

    def fetch_uv(self, out: dict, index: int) -> np.ndarray:
        """The projected uv of one hypothesis (for ICP cropping)."""
        return out["uv_dev"][index].cpu().numpy()
