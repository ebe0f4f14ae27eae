"""Plain 3x3 depthwise correlation and pooling for the reference: the port's
plain versions (ops/conv.py), frozen here, with no hand-written kernel
behind them on any device."""

from __future__ import annotations

import torch
import torch.nn.functional as F

_PLAIN_DTYPES = (torch.float32, torch.bfloat16, torch.float64)


def _dtype_of(x: torch.Tensor, other: torch.Tensor, what: str,
              dtypes: tuple = (torch.float32, torch.bfloat16)) -> torch.dtype:
    """The operands' common dtype; a mix, or a dtype outside `dtypes`, raises."""
    if x.dtype != other.dtype or x.dtype not in dtypes:
        raise TypeError(f"{what} takes two tensors of one dtype of {dtypes}, got {x.dtype} and {other.dtype}")
    return x.dtype


def _cross(x: torch.Tensor, kernel: torch.Tensor) -> tuple:
    """x (F, H, W, C) and kernel (T, kh, kw, C) as F * T samples, sample
    f * T + t the pair (frame f, template t): broadcast views, not copies."""
    f, t = x.shape[0], kernel.shape[0]
    return (x[:, None].expand(f, t, *x.shape[1:]).reshape(f * t, *x.shape[1:]),
            kernel[None].expand(f, t, *kernel.shape[1:]).reshape(f * t, *kernel.shape[1:]))


def depthwise_corr_plain(x: torch.Tensor, kernel: torch.Tensor, padding: int = 0,
                         cross: bool = False) -> torch.Tensor:
    """x (B, H, W, C); kernel (B, kh, kw, C): each batch element correlated with
    its own kernel, channel by channel. The reference's reshape trick: the
    batch folds into the channels and one grouped conv runs B*C groups.
    bf16 operands: the float32 result rounded once to bf16. `cross`: x (F, H,
    W, C) frames and kernel (T, kh, kw, C) templates, every frame against
    every template: (F * T, H, W, C), sample f * T + t."""
    if cross:
        return depthwise_corr_plain(*_cross(x, kernel), padding)
    if _dtype_of(x, kernel, "depthwise_corr_plain", _PLAIN_DTYPES) == torch.bfloat16:
        return depthwise_corr_plain(x.float(), kernel.float(), padding).to(torch.bfloat16)
    b, h, w, c = x.shape
    kh, kw = kernel.shape[1], kernel.shape[2]
    # contiguous first: a stride-0 (broadcast) batch is materialised
    xi = x.permute(0, 3, 1, 2).contiguous().reshape(1, b * c, h, w)
    k = kernel.permute(0, 3, 1, 2).contiguous().reshape(b * c, 1, kh, kw)
    out = F.conv2d(xi, k, groups=b * c, padding=padding)
    return out.reshape(b, c, out.shape[2], out.shape[3]).permute(0, 2, 3, 1)


def max_pool_ceil(x: torch.Tensor, k: int, s: int, ceil_mode: bool = True) -> torch.Tensor:
    """Max pool with torch's ceil_mode (NHWC)."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), k, s, ceil_mode=ceil_mode)
    return y.permute(0, 2, 3, 1)


def avg_pool(x: torch.Tensor, k: int, s: int | None = None, padding: int = 0) -> torch.Tensor:
    """Average pool, floor mode, count_include_pad=True (NHWC)."""
    y = F.avg_pool2d(x.permute(0, 3, 1, 2), k, s or k, padding=padding,
                     count_include_pad=True)
    return y.permute(0, 2, 3, 1)


def depthwise_corr(x: torch.Tensor, kernel: torch.Tensor, padding: int = 0, cross: bool = False) -> torch.Tensor:
    """Per-sample depthwise cross-correlation, NHWC: the plain version on
    every device."""
    return depthwise_corr_plain(x, kernel, padding, cross)
