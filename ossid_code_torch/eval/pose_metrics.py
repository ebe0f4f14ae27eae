"""6D pose error metrics: ADD and ADD-S (interface of zephyr.utils.metrics.add/adi,
SURVEY.md Z6; call sites ref scripts/online_learning.py:336-339,452,482).

The `pred_add01d` success criterion is err < 0.1 * object diameter
(ref online_learning.py:578). The port's copy of
ossid_code_tpu/eval/pose_metrics.py; the per-hypothesis diagnostic runs in
torch on the device."""

from __future__ import annotations

import numpy as np
import torch
from scipy.spatial import cKDTree


def add_err(R_pred, t_pred, R_gt, t_gt, model_points) -> float:
    """Average distance between corresponding transformed model points."""
    p = model_points @ np.asarray(R_pred).T + np.asarray(t_pred).reshape(1, 3)
    q = model_points @ np.asarray(R_gt).T + np.asarray(t_gt).reshape(1, 3)
    return float(np.linalg.norm(p - q, axis=1).mean())


def adi_err(R_pred, t_pred, R_gt, t_gt, model_points) -> float:
    """Average closest-point distance (symmetric objects)."""
    p = model_points @ np.asarray(R_pred).T + np.asarray(t_pred).reshape(1, 3)
    q = model_points @ np.asarray(R_gt).T + np.asarray(t_gt).reshape(1, 3)
    dist, _ = cKDTree(q).query(p)
    return float(dist.mean())


def object_diameter(model_points) -> float:
    """Max pairwise extent approximation via bounding-box diagonal upper bound
    refined by convex support points (exact enough for the 0.1d threshold)."""
    pts = np.asarray(model_points)
    if len(pts) > 1000:
        pts = pts[np.linspace(0, len(pts) - 1, 1000).round().astype(int)]
    d2 = 0.0
    # exact max pairwise distance over the (sub)sampled cloud
    from scipy.spatial.distance import pdist

    d2 = pdist(pts).max()
    return float(d2)


def add_err_batch(poses, mat_gt, model_points) -> np.ndarray:
    """Vectorized ADD over M pose hypotheses (ref online_learning.py:452
    computes this in a per-pose Python loop). poses (M, 4, 4)."""
    poses = np.asarray(poses, np.float32)
    q = model_points @ np.asarray(mat_gt)[:3, :3].T + np.asarray(mat_gt)[:3, 3]
    p = np.einsum("mij,nj->mni", poses[:, :3, :3], model_points) + poses[:, None, :3, 3]
    return np.linalg.norm(p - q[None], axis=2).mean(axis=1)


def adi_err_batch(poses, mat_gt, model_points, max_points: int = 1000) -> np.ndarray:
    """Vectorized ADD-S over M pose hypotheses: one KD-tree on the GT cloud,
    queried per hypothesis. Query points are subsampled to max_points for
    per-frame tractability (the per-hypothesis diagnostic, not the reported
    pred_err, which uses the full cloud via adi_err)."""
    poses = np.asarray(poses, np.float32)
    pts = np.asarray(model_points)
    if len(pts) > max_points:
        pts_q = pts[np.linspace(0, len(pts) - 1, max_points).round().astype(int)]
    else:
        pts_q = pts
    q = pts @ np.asarray(mat_gt)[:3, :3].T + np.asarray(mat_gt)[:3, 3]
    tree = cKDTree(q)
    p = np.einsum("mij,nj->mni", poses[:, :3, :3], pts_q) + poses[:, None, :3, 3]
    return np.asarray([tree.query(pm)[0].mean() for pm in p])


# ------------------------------------------------------------- device pp_err
# The per-hypothesis diagnostic (ref online_learning.py:452) runs on the
# device beside the scoring: two small einsums, fetched with the scores.

def pp_err_batch(poses: torch.Tensor, mat_gt: torch.Tensor, pts: torch.Tensor,
                 symmetric: bool = False, pts_q: torch.Tensor | None = None) -> torch.Tensor:
    """ADD (or, symmetric, ADD-S with query points pts_q) of each pose
    (M, 4, 4) against mat_gt (4, 4), over the model cloud pts (N, 3), on
    the tensors' device. ADD-S takes the closest point by the
    |p|^2 + |q|^2 - 2 p.q matmul, as the JAX package does."""
    q = pts @ mat_gt[:3, :3].T + mat_gt[:3, 3]
    src = pts_q if symmetric and pts_q is not None else pts
    p = torch.einsum("mij,nj->mni", poses[:, :3, :3], src) + poses[:, None, :3, 3]
    if not symmetric:
        return torch.linalg.norm(p - q[None], dim=2).mean(dim=1)
    d2 = ((p * p).sum(-1)[:, :, None] + (q * q).sum(-1)[None, None, :]
          - 2.0 * torch.einsum("mnc,kc->mnk", p, q))
    return torch.sqrt(d2.amin(dim=2).clamp(min=0.0)).mean(dim=1)


def pp_err_batch_async(poses, mat_gt, pts_dev: torch.Tensor, symmetric: bool = False,
                       pts_q_dev: torch.Tensor | None = None) -> torch.Tensor:
    """pp_err_batch on host poses and GT (float32), launched on the device
    of the cached model cloud `pts_dev`; returns the device tensor
    (`pp_err_fetch` copies it to the host)."""
    dev = pts_dev.device
    return pp_err_batch(torch.as_tensor(np.asarray(poses, np.float32), device=dev),
                        torch.as_tensor(np.asarray(mat_gt, np.float32), device=dev),
                        pts_dev, symmetric, pts_q_dev)


def pp_err_fetch(handle: torch.Tensor, fetched=None) -> np.ndarray:
    """The pp_err of `pp_err_batch_async` on the host; `fetched` injects the
    array that a bundled fetch already copied."""
    return np.asarray(fetched) if fetched is not None else handle.cpu().numpy()
