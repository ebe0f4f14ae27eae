"""Resize ops, NHWC (counterpart of ossid_code_tpu/ops/resize.py), with torch
F.interpolate semantics where the reference network uses them."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def upsample_nearest(x: torch.Tensor, scale: int = 2) -> torch.Tensor:
    """Exact integer-factor nearest upsampling (pixel duplication)."""
    b, h, w, c = x.shape
    x = x[:, :, None, :, None, :].expand(b, h, scale, w, scale, c)
    return x.reshape(b, h * scale, w * scale, c)


def resize_nearest(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Nearest resize with torch-style source indexing, src = floor(dst * in/out),
    computed in float32 as the JAX package computes it."""
    _, h, w, _ = x.shape
    oh, ow = out_hw
    rows = torch.floor(torch.arange(oh, dtype=torch.float32, device=x.device) * (h / oh)).long()
    cols = torch.floor(torch.arange(ow, dtype=torch.float32, device=x.device) * (w / ow)).long()
    return x.index_select(1, rows).index_select(2, cols)


def resize_bilinear(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Bilinear resize, half-pixel centers, no antialiasing (== torch
    align_corners=False == jax.image.resize 'linear', antialias=False)."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(out_hw), mode="bilinear",
                      align_corners=False, antialias=False)
    return y.permute(0, 2, 3, 1)
