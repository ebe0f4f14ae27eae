"""Perspective warping on tensors (the port of ossid_code_tpu/ops/warp.py,
which replaced the reference's kornia warp_perspective, ref
utils/homographies.py:15-48). Plain PyTorch on the caller's device."""

from __future__ import annotations

import torch


def bilinear_sample_nhwc(img: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """img (H, W, C); u (cols), v (rows) float coords of any shape ->
    (..., C); zero outside the image. The clamps are the JAX package's, so
    a coordinate on the last row or column samples it with weight 1."""
    h, w = img.shape[0], img.shape[1]
    inside = (u >= 0) & (u <= w - 1) & (v >= 0) & (v <= h - 1)
    u = u.clamp(0.0, w - 1.0)
    v = v.clamp(0.0, h - 1.0)
    u0 = torch.floor(u).clamp(0, w - 2).long()
    v0 = torch.floor(v).clamp(0, h - 2).long()
    du = (u - u0).clamp(0.0, 1.0)[..., None]
    dv = (v - v0).clamp(0.0, 1.0)[..., None]
    p00 = img[v0, u0]
    p01 = img[v0, u0 + 1]
    p10 = img[v0 + 1, u0]
    p11 = img[v0 + 1, u0 + 1]
    out = p00 * (1 - du) * (1 - dv) + p01 * du * (1 - dv) + p10 * (1 - du) * dv + p11 * du * dv
    return torch.where(inside[..., None], out, torch.zeros((), dtype=out.dtype, device=out.device))


def warp_perspective(img: torch.Tensor, H: torch.Tensor, out_hw=None) -> torch.Tensor:
    """Warp (B, H, W, C) by homographies (B, 3, 3): output pixel (x, y) samples
    the source at H^-1 (x, y), as kornia and cv2.warpPerspective do."""
    b, h, w, c = img.shape
    oh, ow = out_hw or (h, w)
    hinv = torch.linalg.inv(H.to(img.dtype))
    ys, xs = torch.meshgrid(torch.arange(oh, dtype=img.dtype, device=img.device),
                            torch.arange(ow, dtype=img.dtype, device=img.device), indexing="ij")
    grid = torch.stack([xs, ys, torch.ones_like(xs)], dim=-1)  # (oh, ow, 3), (x, y, 1)
    src = torch.einsum("bij,hwj->bhwi", hinv, grid)
    u = src[..., 0] / src[..., 2]
    v = src[..., 1] / src[..., 2]
    return torch.stack([bilinear_sample_nhwc(im, uu, vv) for im, uu, vv in zip(img, u, v)])
