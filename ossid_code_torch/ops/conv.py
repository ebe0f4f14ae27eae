"""Convolution-adjacent ops: per-sample depthwise correlation and pooling
(counterpart of ossid_code_tpu/ops/conv.py). Public functions take NHWC
tensors, as the JAX package's do.

`depthwise_corr` dispatches by tensor device for the 3x3 / padding-1 case: a
CPU tensor takes the plain PyTorch version, a CUDA tensor the hand-written
kernel `csrc/dw_corr3x3.cu` (or the wrapper raises). There is no other
switch and no fallback.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ossid_code_torch.kernels.build import check, library, stream_ptr


def depthwise_corr_plain(x: torch.Tensor, kernel: torch.Tensor, padding: int = 0) -> torch.Tensor:
    """x (B, H, W, C); kernel (B, kh, kw, C): each batch element correlated with
    its own kernel, channel by channel. The reference's reshape trick: the
    batch folds into the channels and one grouped conv runs B*C groups."""
    b, h, w, c = x.shape
    kh, kw = kernel.shape[1], kernel.shape[2]
    xi = x.permute(0, 3, 1, 2).reshape(1, b * c, h, w)
    k = kernel.permute(0, 3, 1, 2).reshape(b * c, 1, kh, kw)
    out = F.conv2d(xi, k, groups=b * c, padding=padding)
    return out.reshape(b, c, out.shape[2], out.shape[3]).permute(0, 2, 3, 1)


def _batch_stride(t: torch.Tensor) -> int:
    return 0 if t.shape[0] == 1 else t.stride(0)


def _inner_contiguous(t: torch.Tensor) -> bool:
    _, h, w, c = t.shape
    return t.stride(3) == 1 and (w == 1 or t.stride(2) == c) and (h == 1 or t.stride(1) == w * c)


_SIGNATURES = {"dw_corr3x3_f32": ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                                  + [ctypes.c_longlong] * 2 + [ctypes.c_void_p], ctypes.c_int)}


def dw_corr3x3_cuda(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Kernel 1: 3x3 / padding-1 depthwise correlation on the card.

    x (B, H, W, C) with (H, W, C) contiguous and any batch stride (0 for a
    broadcast); kernel (B, 3, 3, C) likewise. Returns a contiguous
    (B, H, W, C) float32 tensor. Raises on what the kernel does not take."""
    if not (x.is_cuda and kernel.is_cuda and x.device == kernel.device):
        raise ValueError("dw_corr3x3_cuda needs both tensors on one CUDA device")
    if x.dtype != torch.float32 or kernel.dtype != torch.float32:
        raise TypeError("dw_corr3x3_cuda takes float32")
    if torch.is_grad_enabled() and (x.requires_grad or kernel.requires_grad):
        raise RuntimeError("dw_corr3x3_cuda has no backward; run under torch.inference_mode()")
    b, h, w, c = x.shape
    if kernel.shape != (b, 3, 3, c):
        raise ValueError(f"kernel shape {tuple(kernel.shape)} does not fit x {tuple(x.shape)}")
    if c % 4:
        raise ValueError(f"dw_corr3x3_cuda needs C % 4 == 0, got C={c}")
    if not (_inner_contiguous(x) and _inner_contiguous(kernel)):
        raise ValueError("dw_corr3x3_cuda needs (H, W, C) contiguous in x and kernel")
    xs, ks = _batch_stride(x), _batch_stride(kernel)
    if (x.data_ptr() % 16 or kernel.data_ptr() % 16 or xs % 4 or ks % 4):
        raise ValueError("dw_corr3x3_cuda needs 16-byte aligned rows")
    out = torch.empty((b, h, w, c), device=x.device, dtype=torch.float32)
    err = library("dw_corr3x3", _SIGNATURES).dw_corr3x3_f32(
        x.data_ptr(), kernel.data_ptr(), out.data_ptr(), b, h, w, c, xs, ks, stream_ptr(x.device))
    check(err, "dw_corr3x3_f32")
    dw_corr3x3_cuda.launches += 1
    return out


dw_corr3x3_cuda.launches = 0


def depthwise_corr(x: torch.Tensor, kernel: torch.Tensor, padding: int = 0) -> torch.Tensor:
    """Per-sample depthwise cross-correlation, NHWC (ref DTOID's
    conv2d_dw_group). The 3x3 / padding-1 case on a CUDA tensor launches
    kernel 1; on a CPU tensor it runs the plain version."""
    if padding == 1 and kernel.shape[1] == 3 and kernel.shape[2] == 3 and x.is_cuda:
        return dw_corr3x3_cuda(x, kernel)
    if x.is_cuda:
        raise ValueError("on the card depthwise_corr takes only the 3x3 / padding-1 case")
    return depthwise_corr_plain(x, kernel, padding)


def max_pool_ceil(x: torch.Tensor, k: int, s: int, ceil_mode: bool = True) -> torch.Tensor:
    """Max pool with torch's ceil_mode (NHWC)."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), k, s, ceil_mode=ceil_mode)
    return y.permute(0, 2, 3, 1)


def avg_pool(x: torch.Tensor, k: int, s: int | None = None, padding: int = 0) -> torch.Tensor:
    """Average pool, floor mode, count_include_pad=True (NHWC)."""
    y = F.avg_pool2d(x.permute(0, 3, 1, 2), k, s or k, padding=padding,
                     count_include_pad=True)
    return y.permute(0, 2, 3, 1)
