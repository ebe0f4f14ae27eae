"""Fused PointNet++ SetAbstraction inference (counterpart of
ossid_code_tpu/ops/sa_fused.py).

One SA stage is: gather each group's k member points around its centre,
`[xyz[g] - xyz[c], feats[g]]`, run three shared 1x1 layers with the inference
BatchNorm folded in (`relu(x W_i + b_i)`), and take the max over the k
members: (M hypotheses, S centres) groups -> (M, S, C_out).

`sa_mlp_max` dispatches by tensor device: a CPU tensor takes the plain
version (gather, three matmuls, max), a CUDA tensor the hand-written kernel
`csrc/sa_mlp_max.cu`, which gathers inside the kernel and never writes the
(M, S, k, Cin) grouped tensor to memory (or the wrapper raises).
"""

from __future__ import annotations

import ctypes

import torch

from ossid_code_torch.kernels.build import check, library, stream_ptr

EPS = 1e-5  # BatchNorm epsilon of the JAX package (flax default)
_KERNEL_WIDTHS = ((64, 64, 128), (128, 128, 256))
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


def sa_mlp_max_plain(xyz, feats, center_idx, group_idx, Ws, bs) -> torch.Tensor:
    """Plain version: materialise the grouped tensor, three layers, max over k."""
    x = _grouped(xyz, feats, center_idx, group_idx)
    for w, b in zip(Ws, bs):
        x = torch.relu(torch.matmul(x, w) + b)
    return x.amax(dim=2)


def _check_rows(name: str, t: torch.Tensor) -> None:
    if t.dim() != 3 or t.stride(2) != 1:
        raise ValueError(f"sa_mlp_max_cuda: {name} must be (M, N, C) with unit channel stride")


def sa_mlp_max_cuda(xyz, feats, center_idx, group_idx, Ws, bs) -> torch.Tensor:
    """Kernel 2: one SA stage on the card.

    xyz (M, N, 3) and feats (M, N, Cf) float32, any row and hypothesis strides
    with unit channel stride (views into one point tensor are fine);
    center_idx (S,), group_idx (S, k) integer indices into N, k <= 64;
    Ws 3 x (Cin_i, C_i), bs 3 x (C_i,) with widths (64, 64, 128) or
    (128, 128, 256). Returns a contiguous (M, S, C3) float32 tensor."""
    dev = xyz.device
    tensors = (xyz, feats, center_idx, group_idx, *Ws, *bs)
    if not all(t.is_cuda and t.device == dev for t in tensors):
        raise ValueError("sa_mlp_max_cuda needs every tensor on one CUDA device")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError("sa_mlp_max_cuda has no backward; run under torch.inference_mode()")
    if any(t.dtype != torch.float32 for t in (xyz, feats, *Ws, *bs)):
        raise TypeError("sa_mlp_max_cuda takes float32 points and weights")
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
    if widths not in _KERNEL_WIDTHS:
        raise ValueError(f"sa_mlp_max_cuda has no instance for widths {widths}")
    cins = (3 + cf,) + widths[:2]
    Ws = [w.contiguous() for w in Ws]
    bs = [b.contiguous() for b in bs]
    for w, b, cin, cout in zip(Ws, bs, cins, widths):
        if w.shape != (cin, cout) or b.shape != (cout,):
            raise ValueError(f"weight {tuple(w.shape)} / bias {tuple(b.shape)} != ({cin}, {cout})")
        if w.data_ptr() % 16 or b.data_ptr() % 16:
            raise ValueError("sa_mlp_max_cuda needs 16-byte aligned weights")
    cidx = center_idx.to(torch.int32).contiguous()
    gidx = group_idx.to(torch.int32).contiguous()
    out = torch.empty((m, s, widths[2]), device=dev, dtype=torch.float32)

    fn = library("sa_mlp_max").sa_mlp_max_f32
    vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fn.argtypes = [vp, ll, ll, vp, ll, ll, ci, vp, vp, ci, ci, ci, ci, ci, ci,
                   vp, vp, vp, vp, vp, vp, vp, vp]
    fn.restype = ci
    err = fn(xyz.data_ptr(), xyz.stride(0), xyz.stride(1),
             feats.data_ptr(), feats.stride(0), feats.stride(1), cf,
             cidx.data_ptr(), gidx.data_ptr(), m, s, k, *widths,
             Ws[0].data_ptr(), bs[0].data_ptr(), Ws[1].data_ptr(), bs[1].data_ptr(),
             Ws[2].data_ptr(), bs[2].data_ptr(), out.data_ptr(), stream_ptr(dev))
    check(err, "sa_mlp_max_f32")
    sa_mlp_max_cuda.launches += 1
    return out


sa_mlp_max_cuda.launches = 0


def sa_mlp_max(xyz, feats, center_idx, group_idx, Ws, bs) -> torch.Tensor:
    """SetAbstraction stage (M, N, 3) + (M, N, Cf) -> (M, S, C3); kernel 2 on a
    CUDA tensor, the plain version on a CPU tensor."""
    if xyz.is_cuda:
        return sa_mlp_max_cuda(xyz, feats, center_idx, group_idx, Ws, bs)
    return sa_mlp_max_plain(xyz, feats, center_idx, group_idx, Ws, bs)
