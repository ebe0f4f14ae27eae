"""Point-cloud ops of the PointNet++ scorer's training forward, in torch on
tensors (the port's counterpart of ossid_code_tpu/ops/pointcloud.py).

Training groups each hypothesis's points inside the network (the rigid
transform differs per hypothesis only in the features, but the JAX package
trains through the in-graph grouping); scoring uses the static per-object
indices of `ZephyrModel.prepare_object` instead. Each function is batched
over a leading axis and follows the JAX package's arithmetic, so the indices
agree exactly: FPS starts at point 0 and takes the first of equal maxima,
the ball query keeps the lowest in-radius indices.
"""

from __future__ import annotations

import torch


def _sqnorm(d: torch.Tensor) -> torch.Tensor:
    """Sum of squares over a last axis of 3, in XLA's order."""
    return (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]


def pairwise_sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., N, 3) x (..., M, 3) -> (..., N, M) squared distances,
    |a|^2 - 2 a.b + |b|^2 clipped at 0."""
    a2 = _sqnorm(a)[..., :, None]
    b2 = _sqnorm(b)[..., None, :]
    return (a2 - 2.0 * torch.matmul(a, b.transpose(-1, -2)) + b2).clamp(min=0.0)


def farthest_point_sample(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """Furthest-point sampling. xyz: (B, N, 3) -> indices (B, npoint), int64.
    A loop of npoint - 1 small steps, each over the whole batch."""
    b, n, _ = xyz.shape
    rows = torch.arange(b, device=xyz.device)
    dists = torch.full((b, n), float("inf"), dtype=xyz.dtype, device=xyz.device)
    idxs = torch.zeros((b, npoint), dtype=torch.long, device=xyz.device)
    last = torch.zeros(b, dtype=torch.long, device=xyz.device)
    for i in range(1, npoint):
        dists = torch.minimum(dists, _sqnorm(xyz - xyz[rows, last][:, None, :]))
        last = torch.argmax(dists, dim=1)
        idxs[:, i] = last
    return idxs


def ball_query(centers: torch.Tensor, xyz: torch.Tensor, radius: float, nsample: int) -> torch.Tensor:
    """For each center, the first `nsample` point indices (by index order)
    within `radius`; the rest of the row repeats the first hit, and a row
    with no hit is 0 (CUDA ball_query semantics).
    centers (B, S, 3), xyz (B, N, 3) -> (B, S, nsample), int64."""
    inside = pairwise_sqdist(centers, xyz) <= radius * radius
    n = xyz.shape[1]
    order = torch.where(inside, torch.arange(n, dtype=xyz.dtype, device=xyz.device),
                        torch.tensor(float("inf"), dtype=xyz.dtype, device=xyz.device))
    idx = torch.topk(order, nsample, dim=-1, largest=False, sorted=True).indices
    picked = torch.gather(inside, -1, idx)
    idx = torch.where(picked, idx, idx[..., :1])
    return torch.where(inside.any(-1, keepdim=True), idx, torch.zeros_like(idx))


def gather_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """points (B, N, C); idx (B, ...) -> (B, ..., C)."""
    b = points.shape[0]
    flat = idx.reshape(b, -1)
    out = torch.gather(points, 1, flat[..., None].expand(-1, -1, points.shape[-1]))
    return out.reshape(*idx.shape, points.shape[-1])
