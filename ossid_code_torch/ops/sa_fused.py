"""Fused PointNet++ SetAbstraction inference (counterpart of
ossid_code_tpu/ops/sa_fused.py).

One SA stage is: gather each group's k member points around its centre,
`[xyz[g] - xyz[c], feats[g]]`, run three shared 1x1 layers with the inference
BatchNorm folded in (`relu(x W_i + b_i)`), and take the max over the k
members: (M hypotheses, S centres) groups -> (M, S, C_out).

`sa_mlp_max` dispatches by tensor device: a CPU tensor takes the plain
version (gather, three matmuls, max), a CUDA tensor a hand-written kernel
(or the wrapper raises), which gathers inside the kernel and never writes
the (M, S, k, Cin) grouped tensor to memory. The wrapper chooses the
kernel by dtype:
  * float32: `csrc/sa_mlp_max.cu` (kernel 2) runs the three layers on the
    tensor cores in 3xTF32 from weights that `pack_sa_weights` splits and
    lays out;
  * bfloat16 points, features and weights with float32 biases (the JAX
    package's bf16 scorer): `csrc/sa_mlp_max_bf16.cu` (kernel 2b), one
    bf16 `wgmma` pass from weights that `pack_sa_weights_bf16` lays out.
    As in JAX, each layer sums in float32, adds the float32 bias, applies
    relu and rounds to bf16; the xyz offsets are bf16 differences. Each
    warpgroup gathers its next group while the current one's layers run:
    feature rows 16-byte aligned (rows of their own, as SA2's input) by
    16-byte `cp.async`, others (a view into the point rows, as SA1's) and
    the xyz rows through registers.

The wrapper counts its launches (`.launches` float32, `.launches_bf16`) and
the floating-point operations they did, `.flops`: 2 * M * S * k * (Cin * C1
+ C1 * C2 + C2 * C3) a launch, the three layers' multiply-adds (the max and
the bias are not counted), which `scripts/roofline.py::program_flops` adds
to what PyTorch's FLOP counter sees. Each launch runs inside a
`utils/profiling.py::annotate` span named "sa_mlp_max".
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ossid_code_torch.kernels.build import check, library, stream_ptr
from ossid_code_torch.utils.profiling import annotate

EPS = 1e-5  # BatchNorm epsilon of the JAX package (flax default)
_MAX_GROUP = 64


def fold_bn(kernel2d: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
            mean: torch.Tensor, var: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Fold an inference BatchNorm into the preceding bias-free matmul.
    kernel2d (Cin, Cout) -> (W (Cin, Cout), b (Cout,)), float32."""
    s = scale.float() / torch.sqrt(var.float() + EPS)
    w = kernel2d.float() * s[None, :]
    b = bias.float() - mean.float() * s
    return w, b


def _grouped(xyz, feats, center_idx, group_idx):
    cidx, gidx = center_idx.long(), group_idx.long()
    rel = xyz[:, gidx] - xyz[:, cidx][:, :, None, :]
    return torch.cat([rel, feats[:, gidx]], dim=-1)  # (M, S, k, 3 + Cf)


def dense_relu(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """relu(x W + b). In bf16 (JAX's bf16 dense chain, `preferred_element_type`
    float32): x and W rounded to bf16, their product summed in float32, the
    float32 bias added, relu, then one round to bf16."""
    if x.dtype == torch.bfloat16:
        return torch.matmul(x.float(), w.to(torch.bfloat16).float()).add_(b).relu_().to(torch.bfloat16)
    return torch.matmul(x, w).add_(b).relu_()  # in place: the grouped rows are large on the CPU


def _check_dtypes(what: str, xyz, feats, Ws, bs) -> torch.dtype:
    """float32 points, features, weights and biases, or bf16 points, features
    and weights with float32 biases; anything else raises (no quiet cast)."""
    dtype = xyz.dtype
    if dtype not in (torch.float32, torch.bfloat16) or any(t.dtype != dtype for t in (feats, *Ws)) \
            or any(b.dtype != torch.float32 for b in bs):
        raise TypeError(f"{what} takes float32 points, features, weights and biases, or bf16 points, "
                        f"features and weights with float32 biases")
    return dtype


def sa_mlp_max_plain(xyz, feats, center_idx, group_idx, Ws, bs) -> torch.Tensor:
    """Plain version: materialise the grouped tensor, three layers, max over k
    (float32, or bf16 by dense_relu's rule: JAX's _mlp_max_ref)."""
    _check_dtypes("sa_mlp_max_plain", xyz, feats, Ws, bs)
    x = _grouped(xyz, feats, center_idx, group_idx)
    for w, b in zip(Ws, bs):
        x = dense_relu(x, w, b)
    return x.amax(dim=2)


def _check_rows(name: str, t: torch.Tensor) -> None:
    if t.dim() != 3 or t.stride(2) != 1:
        raise ValueError(f"sa_mlp_max_cuda: {name} must be (M, N, C) with unit channel stride")


_NMAX = 128  # widest wgmma N: layer 3 runs in parts of at most this many columns
# (K1, KS) of the kernel's instance for each width set: layer-1 depth (3 + Cf
# padded to a multiple of 8) and K-slice depth of the packed weights. The
# library reports its own (sa_mlp_max_layout); the wrapper checks that the two
# agree before it launches.
SA_LAYOUT = {(64, 64, 128): (16, 32), (128, 128, 256): (136, 32)}
# K order of layers 2 and 3 within each group of 8: the kernel feeds the
# previous layer's accumulator fragment straight in as the A fragment, whose
# k = tig is column 2 tig and k = tig + 4 is column 2 tig + 1.
_PERM8 = np.array([0, 2, 4, 6, 1, 3, 5, 7])


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value, ties away from zero (PTX
    cvt.rna.tf32.f32): add half a unit of the 10-bit mantissa to the bit
    pattern, clear the 13 low bits."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def sa_slices(widths, k1: int, ks: int) -> list[tuple[int, int, int, int, int]]:
    """The packed weights' slices in the kernel's order: (layer, n0, rows,
    k0, kc). Layer 1 is K1 deep in KS slices (the last may be shorter),
    layers 2 and 3 are C1 and C2 deep; layer 3 runs in parts of <= 128
    columns."""
    c1, c2, c3 = widths
    np3 = min(c3, _NMAX)
    out = [(0, 0, c1, k0, min(ks, k1 - k0)) for k0 in range(0, k1, ks)]
    out += [(1, 0, c2, k0, ks) for k0 in range(0, c1, ks)]
    out += [(2, n0, np3, k0, ks) for n0 in range(0, c3, np3) for k0 in range(0, c2, ks)]
    return out


def _w_row(layer: int, k: np.ndarray, cf: int) -> np.ndarray:
    """Row of W_layer that logical depth index k of the packed W^T holds; -1
    for padding. Layer 1's input row is [feats (cf), xyz - centre (3), 0...],
    W1's rows are [xyz (3), feats (cf)]."""
    if layer == 0:
        return np.where(k < cf, k + 3, np.where(k < cf + 3, k - cf, -1))
    return 8 * (k // 8) + _PERM8[k % 8]


_PACK_INDEX: dict = {}


def _pack_index(widths, cf: int, k1: int, ks: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(src, is_lo): packed position -> index into cat(W1, W2, W3 flattened,
    [0]) (the last entry for padding), and whether it holds the lo part.
    Within a slice the hi block (rows x kc) comes first, then the lo block,
    each in wgmma core matrices of 8 rows x 4 k (128 contiguous bytes),
    K-adjacent core matrices 128 B apart, N-adjacent ones kc / 4 * 128 B."""
    key = (tuple(widths), cf, k1, ks, str(device))
    if key not in _PACK_INDEX:
        cins = (3 + cf,) + tuple(widths[:2])
        base = np.cumsum([0] + [cin * c for cin, c in zip(cins, widths)])
        zero = base[-1]
        src, is_lo = [], []
        for layer, n0, rows, k0, kc in sa_slices(widths, k1, ks):
            ng, kg, r8, c4 = np.meshgrid(np.arange(rows // 8), np.arange(kc // 4), np.arange(8),
                                         np.arange(4), indexing="ij")
            n = (n0 + 8 * ng + r8).ravel()
            wrow = _w_row(layer, k0 + 4 * kg.ravel() + c4.ravel(), cf)
            idx = np.where(wrow >= 0, base[layer] + wrow * widths[layer] + n, zero)
            src += [idx, idx]
            is_lo += [np.zeros(idx.size, bool), np.ones(idx.size, bool)]
        _PACK_INDEX[key] = (torch.from_numpy(np.concatenate(src)).to(device),
                            torch.from_numpy(np.concatenate(is_lo)).to(device))
    return _PACK_INDEX[key]


def pack_sa_weights(Ws, cf: int, k1: int, ks: int) -> torch.Tensor:
    """The folded weights W_i (Cin_i, C_i) of one SA stage as the kernel reads
    them: W^T split into TF32 hi and lo (hi + lo = W within 2^-21 relative),
    padded with exact zeros to the layer-1 depth k1, in K-slices ks deep of
    wgmma core matrices (see _pack_index). One flat float32 tensor on the
    weights' device."""
    widths = tuple(w.shape[1] for w in Ws)
    src, is_lo = _pack_index(widths, cf, k1, ks, Ws[0].device)
    flat = torch.cat([w.reshape(-1) for w in Ws] + [Ws[0].new_zeros(1)])
    v = flat[src]
    hi = tf32_round(v)
    return torch.where(is_lo, tf32_round(v - hi), hi)


SA_LAYOUT_BF16 = {(64, 64, 128): 16, (128, 128, 256): 144}  # K1 of kernel 2b's instances


def _pack_index_bf16(widths, cf: int, k1: int, device) -> torch.Tensor:
    """Packed position -> index into cat(W1, W2, W3 flattened, [0]) (the last
    entry for padding). Layer by layer, W_i^T (C_i rows, K_i = k1, C1, C2
    deep) in wgmma core matrices of 8 rows x 8 k (128 contiguous bytes),
    K-adjacent core matrices 128 B apart, N-adjacent ones K_i / 8 * 128 B.
    Layer 1's K order is the kernel's input row [feats (cf), xyz (3), 0 ...];
    layers 2 and 3 keep their natural K order."""
    key = ("bf16", tuple(widths), cf, k1, str(device))
    if key not in _PACK_INDEX:
        cins = (3 + cf,) + tuple(widths[:2])
        base = np.cumsum([0] + [cin * c for cin, c in zip(cins, widths)])
        src = []
        for layer, (rows, kc) in enumerate(zip(widths, (k1,) + tuple(widths[:2]))):
            ng, kg, r8, c8 = np.meshgrid(np.arange(rows // 8), np.arange(kc // 8), np.arange(8),
                                         np.arange(8), indexing="ij")
            n, k = (8 * ng + r8).ravel(), (8 * kg + c8).ravel()
            wrow = _w_row(0, k, cf) if layer == 0 else k
            src.append(np.where(wrow >= 0, base[layer] + wrow * widths[layer] + n, base[-1]))
        _PACK_INDEX[key] = torch.from_numpy(np.concatenate(src)).to(device)
    return _PACK_INDEX[key]


def pack_sa_weights_bf16(Ws, cf: int, k1: int) -> torch.Tensor:
    """The folded bf16 weights W_i (Cin_i, C_i) of one SA stage as kernel 2b
    reads them: W^T, layer 1 padded with exact zeros to depth k1, in wgmma
    core matrices (see _pack_index_bf16). One flat bf16 tensor on the
    weights' device."""
    widths = tuple(w.shape[1] for w in Ws)
    src = _pack_index_bf16(widths, cf, k1, Ws[0].device)
    return torch.cat([w.reshape(-1) for w in Ws] + [Ws[0].new_zeros(1)])[src]


def sa_mlp_max_cuda(xyz, feats, center_idx, group_idx, Ws, bs) -> torch.Tensor:
    """Kernel 2 (float32, 3xTF32 on the tensor cores) or kernel 2b (bf16, one
    bf16 pass on the tensor cores): one SA stage on the card.

    xyz (M, N, 3) and feats (M, N, Cf), any row and hypothesis strides with
    unit channel stride (views into one point tensor are fine);
    center_idx (S,), group_idx (S, k) integer indices into N, k <= 64;
    Ws 3 x (Cin_i, C_i), bs 3 x (C_i,) with widths (64, 64, 128) (Cf <= 13)
    or (128, 128, 256) (Cf <= 133). Either everything float32, or xyz, feats
    and Ws bf16 with float32 bs. Returns a contiguous (M, S, C3) tensor of
    xyz's dtype."""
    dtype = _check_dtypes("sa_mlp_max_cuda", xyz, feats, Ws, bs)
    dev = xyz.device
    tensors = (xyz, feats, center_idx, group_idx, *Ws, *bs)
    if not all(t.is_cuda and t.device == dev for t in tensors):
        raise ValueError("sa_mlp_max_cuda needs every tensor on one CUDA device")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError("sa_mlp_max_cuda has no backward; run under torch.inference_mode()")
    _check_rows("xyz", xyz)
    _check_rows("feats", feats)
    m, n, d = xyz.shape
    cf = feats.shape[2]
    if d != 3 or feats.shape[:2] != (m, n):
        raise ValueError(f"xyz {tuple(xyz.shape)} / feats {tuple(feats.shape)} do not match")
    s, k = group_idx.shape
    if center_idx.shape != (s,) or not 1 <= k <= _MAX_GROUP:
        raise ValueError(f"center_idx {tuple(center_idx.shape)} / group_idx {tuple(group_idx.shape)}")
    widths = tuple(w.shape[1] for w in Ws)
    bf16 = dtype == torch.bfloat16
    layout = (SA_LAYOUT_BF16 if bf16 else SA_LAYOUT).get(widths)
    if layout is None or 3 + cf > (layout if bf16 else layout[0]):
        raise ValueError(f"sa_mlp_max_cuda has no {dtype} instance for widths {widths} with {cf} features")
    lib = _lib_bf16() if bf16 else _lib()
    have = _layout_bf16(lib, widths) if bf16 else _layout(lib, widths)
    if have != layout:
        raise RuntimeError(f"the {dtype} kernel lays out {have} for widths {widths}, "
                           f"SA_LAYOUT{'_BF16' if bf16 else ''} says {layout}")
    cins = (3 + cf,) + widths[:2]
    for w, b, cin, cout in zip(Ws, bs, cins, widths):
        if w.shape != (cin, cout) or b.shape != (cout,):
            raise ValueError(f"weight {tuple(w.shape)} / bias {tuple(b.shape)} != ({cin}, {cout})")
    packed = pack_sa_weights_bf16(Ws, cf, layout) if bf16 else pack_sa_weights(Ws, cf, *layout)
    bs = [b.contiguous() for b in bs]
    if any(b.data_ptr() % 16 for b in bs):
        raise ValueError("sa_mlp_max_cuda needs 16-byte aligned biases")
    cidx = center_idx.to(torch.int32).contiguous()
    gidx = group_idx.to(torch.int32).contiguous()
    out = torch.empty((m, s, widths[2]), device=dev, dtype=dtype)
    vec = 8 if bf16 else 4  # channels in 16 bytes
    aligned = int(feats.data_ptr() % 16 == 0 and all(v % vec == 0 for v in (feats.stride(0), feats.stride(1), cf)))
    name = "sa_mlp_max_bf16" if bf16 else "sa_mlp_max_tf32"
    with annotate("sa_mlp_max"):
        err = getattr(lib, name)(
            xyz.data_ptr(), xyz.stride(0), xyz.stride(1),
            feats.data_ptr(), feats.stride(0), feats.stride(1), cf, aligned,
            cidx.data_ptr(), gidx.data_ptr(), m, s, k, *widths, packed.data_ptr(),
            bs[0].data_ptr(), bs[1].data_ptr(), bs[2].data_ptr(), out.data_ptr(), stream_ptr(dev))
    check(err, name)
    if bf16:
        sa_mlp_max_cuda.launches_bf16 += 1
    else:
        sa_mlp_max_cuda.launches += 1
    sa_mlp_max_cuda.flops += 2 * m * s * k * sum(cin * cout for cin, cout in zip(cins, widths))
    return out


sa_mlp_max_cuda.launches = 0       # kernel 2, float32
sa_mlp_max_cuda.launches_bf16 = 0  # kernel 2b
sa_mlp_max_cuda.flops = 0          # both


_vp, _ll, _ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_LAUNCH_ARGS = ([_vp, _ll, _ll, _vp, _ll, _ll, _ci, _ci, _vp, _vp, _ci, _ci, _ci,
                 _ci, _ci, _ci, _vp, _vp, _vp, _vp, _vp, _vp], _ci)
_SIGNATURES = {"sa_mlp_max_tf32": _LAUNCH_ARGS,
               "sa_mlp_max_layout": ([_ci, _ci, _ci, ctypes.POINTER(_ci), ctypes.POINTER(_ci)], _ci)}
_SIGNATURES_BF16 = {"sa_mlp_max_bf16": _LAUNCH_ARGS,
                    "sa_mlp_max_bf16_layout": ([_ci, _ci, _ci, ctypes.POINTER(_ci)], _ci)}


def _lib() -> ctypes.CDLL:
    return library("sa_mlp_max", _SIGNATURES)


def _lib_bf16() -> ctypes.CDLL:
    return library("sa_mlp_max_bf16", _SIGNATURES_BF16)


@functools.cache
def _layout(lib: ctypes.CDLL, widths: tuple[int, int, int]) -> tuple[int, int] | None:
    """(K1, KS) of the library's kernel instance for `widths`, None if it has
    none."""
    k1, ks = _ci(), _ci()
    if lib.sa_mlp_max_layout(*widths, ctypes.byref(k1), ctypes.byref(ks)) != 0:
        return None
    return k1.value, ks.value


@functools.cache
def _layout_bf16(lib: ctypes.CDLL, widths: tuple[int, int, int]) -> int | None:
    """K1 of kernel 2b's instance for `widths`, None if it has none."""
    k1 = _ci()
    if lib.sa_mlp_max_bf16_layout(*widths, ctypes.byref(k1)) != 0:
        return None
    return k1.value


def sa_mlp_max(xyz, feats, center_idx, group_idx, Ws, bs) -> torch.Tensor:
    """SetAbstraction stage (M, N, 3) + (M, N, Cf) -> (M, S, C3); kernel 2 on a
    CUDA tensor, the plain version on a CPU tensor."""
    if xyz.is_cuda:
        return sa_mlp_max_cuda(xyz, feats, center_idx, group_idx, Ws, bs)
    return sa_mlp_max_plain(xyz, feats, center_idx, group_idx, Ws, bs)
