"""Fixed-shape greedy NMS (counterpart of ossid_code_tpu/ops/nms.py).

The dense IoU matrix of the K candidate boxes is built once; then
`keep[i] = not any(keep[j] and iou[j, i] > th, j before i)` is iterated to its
fixed point, which from all-kept is exactly sequential greedy NMS. Every
sweep is one (K,) x (K, K) product; the loop checks convergence every few
sweeps (a sweep at the fixed point changes nothing), so the host waits for
the device only a few times per frame. Ties in score are broken by index, as
torchvision's NMS and `jax.lax.top_k` break them.
"""

from __future__ import annotations

import torch

_SWEEPS_PER_CHECK = 4


def batched_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU, (N, 4) x (M, 4) -> (N, M); boxes are (x1, y1, x2, y2),
    union clamped at 1e-8 as in the reference loss."""
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    iw = torch.minimum(a[:, None, 2], b[None, :, 2]) - torch.maximum(a[:, None, 0], b[None, :, 0])
    ih = torch.minimum(a[:, None, 3], b[None, :, 3]) - torch.maximum(a[:, None, 1], b[None, :, 1])
    inter = iw.clamp(min=0.0) * ih.clamp(min=0.0)
    union = (area_a[:, None] + area_b[None, :] - inter).clamp(min=1e-8)
    return inter / union


def topk_stable(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k values and indices, descending, ties lowest index first (the order
    `jax.lax.top_k` returns; `torch.topk` promises none for ties)."""
    vals, idx = torch.sort(x, descending=True, stable=True)
    return vals[:k], idx[:k]


def nms_fixed(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
              valid: torch.Tensor | None = None) -> torch.Tensor:
    """Greedy NMS over K boxes (need not be sorted); boolean keep mask (K,).
    `valid` masks out padding boxes (never kept, never suppress)."""
    k = boxes.shape[0]
    iou = batched_iou(boxes, boxes)
    order = torch.argsort(torch.argsort(-scores, stable=True), stable=True)
    precede = order[:, None] < order[None, :]
    adj = (iou > iou_threshold) & precede
    if valid is not None:
        adj = adj & valid[:, None]
    adj_f = adj.to(torch.float32)

    keep = torch.ones((k,), dtype=torch.bool, device=boxes.device)
    while True:
        prev = keep
        for _ in range(_SWEEPS_PER_CHECK):
            keep = ~((keep.to(torch.float32) @ adj_f) > 0.5)
        if torch.equal(keep, prev):
            break
    if valid is not None:
        keep = keep & valid
    return keep


def nms_topk(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float, topk: int,
             valid: torch.Tensor | None = None):
    """NMS, then the top-`topk` survivors by score. Fixed shapes: scores
    (topk,), boxes (topk, 4), indices (topk,), keep_valid (topk,) marking real
    survivors."""
    keep = nms_fixed(boxes, scores, iou_threshold, valid=valid)
    masked = torch.where(keep, scores, torch.full_like(scores, float("-inf")))
    k_eff = min(topk, boxes.shape[0])
    top_scores, top_idx = topk_stable(masked, k_eff)
    if k_eff < topk:
        pad = topk - k_eff
        top_scores = torch.cat([top_scores, top_scores.new_full((pad,), float("-inf"))])
        top_idx = torch.cat([top_idx, top_idx.new_zeros((pad,))])
    keep_valid = torch.isfinite(top_scores)
    top_scores = torch.where(keep_valid, top_scores, torch.zeros_like(top_scores))
    return top_scores, boxes[top_idx], top_idx, keep_valid
