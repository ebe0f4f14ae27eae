"""Convolution-adjacent ops: per-sample depthwise correlation and pooling
(counterpart of ossid_code_tpu/ops/conv.py). Public functions take NHWC
tensors, as the JAX package's do.

`depthwise_corr` dispatches by tensor device for the 3x3 / padding-1 case: a
CPU tensor takes the plain PyTorch version (whose autograd is PyTorch's), a
CUDA tensor the autograd Function `DwCorr3x3`, whose forward is the
hand-written kernel `csrc/dw_corr3x3.cu` and whose backward is that kernel
again on the output gradient with the taps turned by 180 degrees (dx) and
the reduction kernel `csrc/dw_corr3x3_bwd.cu` (dk). The wrappers raise on
what their kernels do not take. There is no other switch and no fallback.

Both operands are float32 or both bfloat16; each kernel has an instance of
each (1 / 1b, 3 / 3b) and the wrappers choose it by dtype, a mix raises. In
bf16 every function accumulates in float32 and rounds once to bf16, as the
JAX package's bf16 grouped convolution does. Each wrapper counts its
launches per dtype: `.launches` (float32) and `.launches_bf16`.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ossid_code_torch.kernels.build import check, library, stream_ptr


def _dtype_of(x: torch.Tensor, other: torch.Tensor, what: str,
              dtypes: tuple = (torch.float32, torch.bfloat16)) -> torch.dtype:
    """The operands' common dtype; a mix, or a dtype outside `dtypes`, raises."""
    if x.dtype != other.dtype or x.dtype not in dtypes:
        raise TypeError(f"{what} takes two tensors of one dtype of {dtypes}, got {x.dtype} and {other.dtype}")
    return x.dtype


_PLAIN_DTYPES = (torch.float32, torch.bfloat16, torch.float64)


def depthwise_corr_plain(x: torch.Tensor, kernel: torch.Tensor, padding: int = 0) -> torch.Tensor:
    """x (B, H, W, C); kernel (B, kh, kw, C): each batch element correlated with
    its own kernel, channel by channel. The reference's reshape trick: the
    batch folds into the channels and one grouped conv runs B*C groups.
    bf16 operands: the float32 result rounded once to bf16."""
    if _dtype_of(x, kernel, "depthwise_corr_plain", _PLAIN_DTYPES) == torch.bfloat16:
        return depthwise_corr_plain(x.float(), kernel.float(), padding).to(torch.bfloat16)
    b, h, w, c = x.shape
    kh, kw = kernel.shape[1], kernel.shape[2]
    # contiguous first: a stride-0 (broadcast) batch is materialised
    xi = x.permute(0, 3, 1, 2).contiguous().reshape(1, b * c, h, w)
    k = kernel.permute(0, 3, 1, 2).contiguous().reshape(b * c, 1, kh, kw)
    out = F.conv2d(xi, k, groups=b * c, padding=padding)
    return out.reshape(b, c, out.shape[2], out.shape[3]).permute(0, 2, 3, 1)


def dw_corr3x3_dk_plain(x: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel 3: dk[b, i, j, c] = sum over (y, x) of
    xpad[b, y + i, x + j, c] * dout[b, y, x, c], nine shifted products
    (bf16 operands: the float32 sums rounded once to bf16)."""
    if _dtype_of(x, dout, "dw_corr3x3_dk_plain", _PLAIN_DTYPES) == torch.bfloat16:
        return dw_corr3x3_dk_plain(x.float(), dout.float()).to(torch.bfloat16)
    _, h, w, _ = dout.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    taps = [(xp[:, i:i + h, j:j + w] * dout).sum((1, 2)) for i in range(3) for j in range(3)]
    return torch.stack(taps, 1).reshape(dout.shape[0], 3, 3, dout.shape[3])


def _batch_stride(t: torch.Tensor) -> int:
    return 0 if t.shape[0] == 1 else t.stride(0)


def _inner_contiguous(t: torch.Tensor) -> bool:
    _, h, w, c = t.shape
    return t.stride(3) == 1 and (w == 1 or t.stride(2) == c) and (h == 1 or t.stride(1) == w * c)


_FWD_ARGS = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 2 + [ctypes.c_void_p],
             ctypes.c_int)
_SIGNATURES = {"dw_corr3x3_f32": _FWD_ARGS, "dw_corr3x3_bf16": _FWD_ARGS}
_DK_ARGS = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_longlong, ctypes.c_void_p], ctypes.c_int)
_BWD_SIGNATURES = {
    "dw_corr3x3_dk_chunks": ([ctypes.c_int] * 3, ctypes.c_int),
    "dw_corr3x3_dk_f32": _DK_ARGS,
    "dw_corr3x3_dk_bf16": _DK_ARGS,
}
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


def _check_operands(what: str, x: torch.Tensor, other: torch.Tensor, other_shape: tuple,
                    bf16_vector: int) -> torch.dtype:
    """Raise on what the kernels do not take; returns the common dtype. A
    thread reads one vector of channels: 4 float32 (16 bytes), or
    `bf16_vector` bf16 (8 for kernel 1b, 4 for kernel 3b)."""
    dtype = _dtype_of(x, other, what)
    if not (x.is_cuda and other.is_cuda and x.device == other.device):
        raise ValueError(f"{what} needs both tensors on one CUDA device")
    if other.shape != other_shape:
        raise ValueError(f"{what}: shape {tuple(other.shape)} does not fit x {tuple(x.shape)}")
    vec = 4 if dtype == torch.float32 else bf16_vector
    if x.shape[3] % vec:
        raise ValueError(f"{what} needs C % {vec} == 0 in {dtype}, got C={x.shape[3]}")
    if not (_inner_contiguous(x) and _inner_contiguous(other)):
        raise ValueError(f"{what} needs (H, W, C) contiguous in both tensors")
    align = vec * x.element_size()
    if x.data_ptr() % align or other.data_ptr() % align or _batch_stride(x) % vec or _batch_stride(other) % vec:
        raise ValueError(f"{what} needs {align}-byte aligned rows")
    return dtype


def _count(fn, dtype: torch.dtype) -> None:
    if dtype == torch.bfloat16:
        fn.launches_bf16 += 1
    else:
        fn.launches += 1


def _launch_dw_corr3x3(x: torch.Tensor, kernel: torch.Tensor, what: str) -> torch.Tensor:
    b, h, w, c = x.shape
    dtype = _check_operands(what, x, kernel, (b, 3, 3, c), 8)
    out = torch.empty((b, h, w, c), device=x.device, dtype=dtype)
    err = getattr(library("dw_corr3x3", _SIGNATURES), f"dw_corr3x3_{_SUFFIX[dtype]}")(
        x.data_ptr(), kernel.data_ptr(), out.data_ptr(), b, h, w, c,
        _batch_stride(x), _batch_stride(kernel), stream_ptr(x.device))
    check(err, what)
    return out


def dw_corr3x3_cuda(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Kernel 1 (float32) or 1b (bf16): 3x3 / padding-1 depthwise
    correlation on the card.

    x (B, H, W, C) with (H, W, C) contiguous and any batch stride (0 for a
    broadcast); kernel (B, 3, 3, C) likewise, of x's dtype (C % 8 == 0 in
    bf16). Returns a contiguous (B, H, W, C) tensor of that dtype. Raises on
    what the kernel does not take. It records no gradient: `depthwise_corr`
    is the differentiable entry."""
    if torch.is_grad_enabled() and (x.requires_grad or kernel.requires_grad):
        raise RuntimeError("dw_corr3x3_cuda records no gradient; call depthwise_corr")
    out = _launch_dw_corr3x3(x, kernel, "dw_corr3x3_cuda")
    _count(dw_corr3x3_cuda, out.dtype)
    return out


def dw_corr3x3_dx_cuda(dout: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """dx of kernel 1 (1b): kernel 1 (1b) on dout (B, H, W, C), contiguous,
    with the taps of kernel (B, 3, 3, C) turned by 180 degrees."""
    flipped = kernel.flip(1, 2).contiguous()
    out = _launch_dw_corr3x3(dout, flipped, "dw_corr3x3_dx_cuda")
    _count(dw_corr3x3_dx_cuda, out.dtype)
    return out


def dw_corr3x3_dk_cuda(x: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """Kernel 3 (float32) or 3b (bf16): dk (B, 3, 3, C) of kernel 1, the sum
    over H * W of the padded x window times dout, in float32 in a fixed
    order (bitwise repeatable), stored in the operands' dtype. x as kernel 1
    takes it (any batch stride); dout contiguous (B, H, W, C). The gradient
    is per sample even where k was broadcast: autograd's expand sums it."""
    b, h, w, c = x.shape
    if not dout.is_contiguous():
        raise ValueError("dw_corr3x3_dk_cuda needs a contiguous dout")
    dtype = _check_operands("dw_corr3x3_dk_cuda", x, dout, (b, h, w, c), 4)
    lib = library("dw_corr3x3_bwd", _BWD_SIGNATURES)
    partial = torch.empty((b, lib.dw_corr3x3_dk_chunks(h, w, c), 9, c), device=x.device,
                          dtype=torch.float32)
    dk = torch.empty((b, 3, 3, c), device=x.device, dtype=dtype)
    name = f"dw_corr3x3_dk_{_SUFFIX[dtype]}"
    err = getattr(lib, name)(x.data_ptr(), dout.data_ptr(), partial.data_ptr(), dk.data_ptr(),
                             b, h, w, c, _batch_stride(x), stream_ptr(x.device))
    check(err, name)
    _count(dw_corr3x3_dk_cuda, dtype)
    return dk


for _fn in (dw_corr3x3_cuda, dw_corr3x3_dx_cuda, dw_corr3x3_dk_cuda):
    _fn.launches = _fn.launches_bf16 = 0


class DwCorr3x3(torch.autograd.Function):
    """3x3 / padding-1 depthwise correlation on the card with its gradient:
    forward kernel 1; backward kernel 1 on dout for dx, kernel 3 for dk (in
    bf16: 1b and 3b)."""

    @staticmethod
    def forward(ctx, x, kernel):
        ctx.save_for_backward(x, kernel)
        return dw_corr3x3_cuda(x, kernel)

    @staticmethod
    def backward(ctx, dout):
        x, kernel = ctx.saved_tensors
        dout = dout.contiguous()
        dx = dw_corr3x3_dx_cuda(dout, kernel) if ctx.needs_input_grad[0] else None
        dk = dw_corr3x3_dk_cuda(x, dout) if ctx.needs_input_grad[1] else None
        return dx, dk


def depthwise_corr(x: torch.Tensor, kernel: torch.Tensor, padding: int = 0) -> torch.Tensor:
    """Per-sample depthwise cross-correlation, NHWC (ref DTOID's
    conv2d_dw_group). The 3x3 / padding-1 case on a CUDA tensor goes through
    `DwCorr3x3` (kernels 1 and 3); on a CPU tensor it runs the plain version."""
    if padding == 1 and kernel.shape[1] == 3 and kernel.shape[2] == 3 and x.is_cuda:
        return DwCorr3x3.apply(x, kernel)
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
