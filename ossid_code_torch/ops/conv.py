"""Convolution-adjacent ops: per-sample depthwise correlation and pooling
(counterpart of ossid_code_tpu/ops/conv.py). Public functions take NHWC
tensors, as the JAX package's do.

`depthwise_corr` dispatches by tensor device for the 3x3 / padding-1 case: a
CPU tensor takes the plain PyTorch version (whose autograd is PyTorch's), a
CUDA tensor the autograd Function `DwCorr3x3`, whose forward is the
hand-written kernel `csrc/dw_corr3x3.cu` and whose backward is that kernel
again on the output gradient with the taps turned by 180 degrees (dx) and
the reduction kernel `csrc/dw_corr3x3_bwd.cu` (dk: 16-byte vectors of 4
float32 or 8 bf16 channels, one launch whose bands meet in a thread-block
cluster, no scratch in device memory; `dw_corr3x3_dk_plan` sizes it). The
bf16 forward (1b) is bit for bit bf16(kernel 1 on the widened operands); its
library chooses between two kernels per call (a row walk, with 2 templates a
thread where x is shared over few samples, and a shared-memory tile where x
is shared over 32 or more, 16 with T odd; `dw_corr3x3_bf16_plan` says which
and how) and reads dx's taps turned in place. The wrappers raise on
what their kernels do not take. There is no other switch and no fallback.

`cross=True` (the serving farm's head) correlates F frames of x with T
tap sets in one launch of kernel 1: sample f * T + t is frame f against
template t (a frame and a template stride an operand); the plain version
takes the same argument. It has no gradient on the card.

Both operands are float32 or both bfloat16; each kernel has an instance of
each (1 / 1b, 3 / 3b) and the wrappers choose it by dtype, a mix raises. In
bf16 every function accumulates in float32 and rounds once to bf16, as the
JAX package's bf16 grouped convolution does. Each wrapper counts its
launches per dtype: `.launches` (float32) and `.launches_bf16`, and the
floating-point operations its launches did, `.flops` (2 * 9 * B * H * W * C a
launch of kernel 1, its dx or kernel 3: a multiply and an add a tap), which
`scripts/roofline.py::program_flops` adds to what PyTorch's FLOP counter sees
(it cannot see a ctypes launch). Each launch runs inside a
`utils/profiling.py::annotate` span named after its kernel ("dw_corr3x3",
"dw_corr3x3_dx", "dw_corr3x3_dk").
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F

from ossid_code_torch.kernels.build import check, library, stream_ptr
from ossid_code_torch.utils.profiling import annotate


def _dtype_of(x: torch.Tensor, other: torch.Tensor, what: str,
              dtypes: tuple = (torch.float32, torch.bfloat16)) -> torch.dtype:
    """The operands' common dtype; a mix, or a dtype outside `dtypes`, raises."""
    if x.dtype != other.dtype or x.dtype not in dtypes:
        raise TypeError(f"{what} takes two tensors of one dtype of {dtypes}, got {x.dtype} and {other.dtype}")
    return x.dtype


_PLAIN_DTYPES = (torch.float32, torch.bfloat16, torch.float64)


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


_FWD_ARGS = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 4 + [ctypes.c_void_p],
             ctypes.c_int)
_SIGNATURES = {"dw_corr3x3_f32": _FWD_ARGS, "dw_corr3x3_bf16": _FWD_ARGS, "dw_corr3x3_bf16_flipped": _FWD_ARGS,
               "dw_corr3x3_bf16_planned": (_FWD_ARGS[0][:-1] + [ctypes.c_int] * 4 + [ctypes.c_void_p], ctypes.c_int),
               "dw_corr3x3_bf16_plan": ([ctypes.c_int] * 5 + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 5
                                        + [ctypes.POINTER(ctypes.c_int)], ctypes.c_int)}
_DK_ARGS = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_longlong] + [ctypes.c_int] * 3
            + [ctypes.c_void_p], ctypes.c_int)
_BWD_SIGNATURES = {"dw_corr3x3_dk_f32": _DK_ARGS, "dw_corr3x3_dk_bf16": _DK_ARGS,
                   "dw_corr3x3_dk_clusters": ([ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)], ctypes.c_int)}
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
_VEC = {torch.float32: 4, torch.bfloat16: 8}  # channels in 16 bytes


def _check_operands(what: str, x: torch.Tensor, other: torch.Tensor, other_shape: tuple) -> torch.dtype:
    """Raise on what the kernels do not take; returns the common dtype. A
    thread reads one 16-byte vector of channels: 4 float32 or 8 bf16."""
    dtype = _dtype_of(x, other, what)
    if not (x.is_cuda and other.is_cuda and x.device == other.device):
        raise ValueError(f"{what} needs both tensors on one CUDA device")
    if other.shape != other_shape:
        raise ValueError(f"{what}: shape {tuple(other.shape)} does not fit x {tuple(x.shape)}")
    vec = _VEC[dtype]
    if x.shape[3] % vec:
        raise ValueError(f"{what} needs C % {vec} == 0 in {dtype}, got C={x.shape[3]}")
    if not (_inner_contiguous(x) and _inner_contiguous(other)):
        raise ValueError(f"{what} needs (H, W, C) contiguous in both tensors")
    align = vec * x.element_size()
    if x.data_ptr() % align or other.data_ptr() % align or _batch_stride(x) % vec or _batch_stride(other) % vec:
        raise ValueError(f"{what} needs {align}-byte aligned rows")
    return dtype


def _count(fn, dtype: torch.dtype, shape: torch.Size) -> None:
    """One launch of `fn`'s kernel in `dtype` over (B, H, W, C) = `shape`:
    9 multiply-adds an element."""
    if dtype == torch.bfloat16:
        fn.launches_bf16 += 1
    else:
        fn.launches += 1
    fn.flops += 2 * 9 * shape.numel()


def _call_shape(x: torch.Tensor, kernel: torch.Tensor, cross: bool) -> tuple:
    """(B, T, (x frame, x template, taps frame, taps template strides)) of
    kernel 1's C entry points for depthwise_corr's operands: a per-sample
    batch is T = 1 with the batch strides; `cross` is F frames of x against
    T tap sets."""
    t = kernel.shape[0] if cross else 1
    xs, ks = _batch_stride(x), _batch_stride(kernel)
    return x.shape[0] * t, t, ((xs, 0, 0, ks) if cross else (xs, 0, ks, 0))


def _launch_dw_corr3x3(x: torch.Tensor, kernel: torch.Tensor, what: str, cross: bool = False,
                       span: str = "dw_corr3x3", flip: bool = False, shape: tuple | None = None) -> torch.Tensor:
    """Kernel 1 (1b) over B = F * T samples, sample i the pair (frame i // T,
    template i % T), each operand with a frame and a template stride (the
    float32 library runs the instance that shares x's rows where x's stride
    is 0; 1b chooses its kernel and shape, `dw_corr3x3_bf16_plan`). `flip`
    (bf16 only): the taps read turned by 180 degrees, as dx takes them.
    `shape` (bf16 only; for tools that time other shapes): 1b's (kernel,
    a, b, c) as `dw_corr3x3_bf16_plan` names them, 0 for the choice's."""
    f, h, w, c = x.shape
    dtype = _check_operands(what, x, kernel, (kernel.shape[0] if cross else f, 3, 3, c))
    if (flip or shape is not None) and dtype != torch.bfloat16:
        raise ValueError(f"{what}: only kernel 1b reads turned taps or takes a shape")
    b, t, strides = _call_shape(x, kernel, cross)
    out = torch.empty((b, h, w, c), device=x.device, dtype=dtype)
    lib = library("dw_corr3x3", _SIGNATURES)
    args = (x.data_ptr(), kernel.data_ptr(), out.data_ptr(), b, t, h, w, c, *strides)
    with annotate(span):
        if shape is not None:
            err = lib.dw_corr3x3_bf16_planned(*args, *shape, stream_ptr(x.device))
        elif flip:
            err = lib.dw_corr3x3_bf16_flipped(*args, stream_ptr(x.device))
        else:
            err = getattr(lib, f"dw_corr3x3_{_SUFFIX[dtype]}")(*args, stream_ptr(x.device))
    check(err, what)
    return out


_BF16_PLAN_KEYS = ("kernel", "a", "b", "c", "smem_bytes", "blocks", "threads", "blocks_per_sm", "registers")
_BF16_KERNELS = {1: "tile", 2: "rows", 3: "rows2"}
_BF16_SHAPE_KEYS = {"tile": ("slice_vectors", "rows", "templates"), "rows": ("templates", "runs", "rows"),
                    "rows2": ("template_pairs", "runs", "rows")}


def dw_corr3x3_bf16_plan(x: torch.Tensor, kernel: torch.Tensor, cross: bool = False, flip: bool = False,
                         shape: tuple = (0, 0, 0, 0)) -> dict:
    """The kernel and shape 1b takes for `dw_corr3x3_cuda(x, kernel, cross)`
    (`flip`: for dx; `shape`: (kernel 1 tile / 2 rows, a, b, c) fixed where
    > 0): "tile" with its slice of 4-channel vectors, output rows and
    templates a block, or "rows" with its templates and runs a block and
    output rows a thread; shared memory a block, blocks in the grid, threads
    a block, blocks an SM holds at once, and the kernel's registers a
    thread. Needs the card."""
    _, h, w, c = x.shape
    b, t, strides = _call_shape(x, kernel, cross)
    out = (ctypes.c_int * len(_BF16_PLAN_KEYS))()
    err = library("dw_corr3x3", _SIGNATURES).dw_corr3x3_bf16_plan(b, t, h, w, c, strides[0], strides[1], *shape,
                                                                   int(flip), out)
    check(err, "dw_corr3x3_bf16_plan")
    got = dict(zip(_BF16_PLAN_KEYS, out))
    name = _BF16_KERNELS[got.pop("kernel")]
    return {"kernel": name, **dict(zip(_BF16_SHAPE_KEYS[name], (got.pop(k) for k in "abc"))), **got}


def dw_corr3x3_cuda(x: torch.Tensor, kernel: torch.Tensor, cross: bool = False) -> torch.Tensor:
    """Kernel 1 (float32) or 1b (bf16): 3x3 / padding-1 depthwise
    correlation on the card.

    x (B, H, W, C) with (H, W, C) contiguous and any batch stride (0 for a
    broadcast); kernel (B, 3, 3, C) likewise, of x's dtype (C % 8 == 0 in
    bf16). Returns a contiguous (B, H, W, C) tensor of that dtype. `cross`:
    x (F, H, W, C) frames and kernel (T, 3, 3, C) templates, every frame
    against every template in one launch: (F * T, H, W, C), sample f * T + t
    (the serving farm's head). Raises on what the kernel does not take. It
    records no gradient: `depthwise_corr` is the differentiable entry."""
    if torch.is_grad_enabled() and (x.requires_grad or kernel.requires_grad):
        raise RuntimeError("dw_corr3x3_cuda records no gradient; call depthwise_corr")
    out = _launch_dw_corr3x3(x, kernel, "dw_corr3x3_cuda", cross)
    _count(dw_corr3x3_cuda, out.dtype, out.shape)
    return out


def dw_corr3x3_dx_cuda(dout: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """dx of kernel 1 (1b): kernel 1 (1b) on dout (B, H, W, C), contiguous,
    with the taps of kernel (B, 3, 3, C) turned by 180 degrees: a turned
    copy for kernel 1; 1b reads them turned in place."""
    bf16 = kernel.dtype == torch.bfloat16
    taps = kernel if bf16 else kernel.flip(1, 2).contiguous()
    out = _launch_dw_corr3x3(dout, taps, "dw_corr3x3_dx_cuda", span="dw_corr3x3_dx", flip=bf16)
    _count(dw_corr3x3_dx_cuda, out.dtype, out.shape)
    return out


class DkPlan(NamedTuple):
    """Kernel 3's launch: block (band, slice, b) of grid (bands, slices, B)
    sums rows [band * band_rows, + band_rows) of channel vectors [slice *
    slice_vectors, + slice_vectors) of sample b, in `tiles` column tiles of
    tile_cols columns (the last may be narrower): each of the block's 256
    threads owns one column of a tile and 4 channels; the bands of one
    (b, slice) are one thread-block cluster."""
    slice_vectors: int
    slices: int
    band_rows: int
    bands: int
    tile_cols: int
    tiles: int


# Kernel 3's geometry, as csrc/dw_corr3x3_bwd.cu names it (THREADS,
# SLICE_CHANNELS, MAX_BANDS); the kernel rejects a plan beyond these limits.
_DK_THREADS = 256
_DK_SLICE_CHANNELS = 128   # a slice's channels, at most
_DK_MAX_BANDS = 8          # blocks of a cluster: the portable limit


def dw_corr3x3_dk_plan(b: int, h: int, w: int, c: int, vec: int, sms: int,
                       fits: Callable[[int, int], int] | None = None) -> DkPlan:
    """Kernel 3's launch plan for dk of x (b, h, w, c) in vectors of `vec`
    channels on a card of `sms` SMs: the widest channel slice (a power of
    two, at most 32 vectors and 128 channels) whose blocks, at up to 8
    bands, outnumber the SMs, then as few bands as give about two blocks an
    SM (the kernel's occupancy); a tile is as many columns as 256 threads of
    4 channels cover. `fits(cs, bands)`, where given, is how many clusters
    of that plan the card holds at once: the plan then takes the most
    bands, at most those, whose b * slices clusters all fit, so that no
    cluster waits for a second wave (none at all fitting leaves the bands as
    they are). Finetune shapes on an H100 (132 SMs; slice vectors x bands
    of rows x tiles of columns): head (8, 29, 39, 640) float32 32 x 5 of 6
    x 5 of 8, bf16 16 x 5 of 6 x 5 of 8; stem (8, 240, 320, 64) float32 4 x
    7 of 35 x 5 of 64, bf16 2 x 7 of 35 x 5 of 64 (without `fits`: 6 of 5
    rows and 8 of 30)."""
    cv, h1, w1 = max(c // vec, 1), max(h, 1), max(w, 1)
    blocks = lambda cs, nb: b * -(-cv // cs) * nb
    cs = min(32, _DK_SLICE_CHANNELS // vec)
    while cs > 1 and (cs // 2 >= cv or blocks(cs, min(_DK_MAX_BANDS, h1)) <= sms):
        cs //= 2
    slices = -(-cv // cs)
    bands = max(1, min(_DK_MAX_BANDS, h1, -(-2 * sms // (b * slices))))
    if fits is not None:
        bands = next((nb for nb in range(bands, 0, -1) if b * slices <= fits(cs, nb)), bands)
    rows = -(-h1 // bands)
    cols = _DK_THREADS // (cs * vec // 4)
    return DkPlan(cs, slices, rows, -(-h1 // rows), cols, -(-w1 // cols))


@functools.cache
def _dk_clusters(bf16: bool, cs: int, bands: int, device: int) -> int:
    """Clusters of kernel 3's (3b's) plan (cs, bands) that card `device`
    holds at once (0 where the runtime cannot say)."""
    n = ctypes.c_int()
    with torch.cuda.device(device):
        err = library("dw_corr3x3_bwd", _BWD_SIGNATURES).dw_corr3x3_dk_clusters(int(bf16), cs, bands, ctypes.byref(n))
    return n.value if err == 0 else 0


def dw_corr3x3_dk_cuda(x: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """Kernel 3 (float32) or 3b (bf16): dk (B, 3, 3, C) of kernel 1, the sum
    over H * W of the padded x window times dout, in float32 in a fixed
    order (bitwise repeatable), stored in the operands' dtype; one launch,
    no scratch (the bands' partial sums meet in a thread-block cluster's
    shared memory). x as kernel 1 takes it (any batch stride); dout
    contiguous (B, H, W, C); C % 4 == 0 in float32, C % 8 == 0 in bf16 (one
    16-byte vector). The gradient is per sample even where k was broadcast:
    autograd's expand sums it."""
    b, h, w, c = x.shape
    if not dout.is_contiguous():
        raise ValueError("dw_corr3x3_dk_cuda needs a contiguous dout")
    dtype = _check_operands("dw_corr3x3_dk_cuda", x, dout, (b, h, w, c))
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    plan = dw_corr3x3_dk_plan(b, h, w, c, _VEC[dtype], sms,
                              lambda cs, nb: _dk_clusters(dtype == torch.bfloat16, cs, nb, x.device.index))
    dk = torch.empty((b, 3, 3, c), device=x.device, dtype=dtype)
    name = f"dw_corr3x3_dk_{_SUFFIX[dtype]}"
    fn = getattr(library("dw_corr3x3_bwd", _BWD_SIGNATURES), name)
    with annotate("dw_corr3x3_dk"):
        err = fn(x.data_ptr(), dout.data_ptr(), dk.data_ptr(), b, h, w, c, _batch_stride(x),
                 plan.slice_vectors, plan.band_rows, plan.bands, stream_ptr(x.device))
    check(err, name)
    _count(dw_corr3x3_dk_cuda, dtype, dout.shape)
    return dk


for _fn in (dw_corr3x3_cuda, dw_corr3x3_dx_cuda, dw_corr3x3_dk_cuda):
    _fn.launches = _fn.launches_bf16 = _fn.flops = 0


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


def depthwise_corr(x: torch.Tensor, kernel: torch.Tensor, padding: int = 0, cross: bool = False) -> torch.Tensor:
    """Per-sample depthwise cross-correlation, NHWC (ref DTOID's
    conv2d_dw_group). The 3x3 / padding-1 case on a CUDA tensor goes through
    `DwCorr3x3` (kernels 1 and 3); on a CPU tensor it runs the plain version.
    `cross` (F frames of x against T templates, as `dw_corr3x3_cuda` takes
    it) has no gradient on the card: training batches pair one image with
    one template."""
    if x.is_cuda and not (padding == 1 and kernel.shape[1] == 3 and kernel.shape[2] == 3):
        raise ValueError("on the card depthwise_corr takes only the 3x3 / padding-1 case")
    if x.is_cuda and cross:
        return dw_corr3x3_cuda(x, kernel, cross=True)
    if x.is_cuda:
        return DwCorr3x3.apply(x, kernel)
    return depthwise_corr_plain(x, kernel, padding, cross)


def max_pool_ceil(x: torch.Tensor, k: int, s: int, ceil_mode: bool = True) -> torch.Tensor:
    """Max pool with torch's ceil_mode (NHWC)."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), k, s, ceil_mode=ceil_mode)
    return y.permute(0, 2, 3, 1)


def avg_pool(x: torch.Tensor, k: int, s: int | None = None, padding: int = 0) -> torch.Tensor:
    """Average pool, floor mode, count_include_pad=True (NHWC)."""
    y = F.avg_pool2d(x.permute(0, 3, 1, 2), k, s or k, padding=padding,
                     count_include_pad=True)
    return y.permute(0, 2, 3, 1)
