"""Resize ops, NHWC (counterpart of ossid_code_tpu/ops/resize.py), with torch
F.interpolate semantics where the reference network uses them.

`resize_nearest` and `resize_bilinear` compute their forward with PyTorch's
own ops (index_select; F.interpolate), but their gradient by gathers: on the
card PyTorch's backward of both (index_add; upsample_bilinear2d_backward)
adds each output's gradient into its source pixels with float atomics, in
an order that changes from run to run, so two finetune steps from the same
state part in the last bits. `_Resize.backward` sums, for each source
pixel, the gradients of the outputs that read it in a fixed order (their
output index), axis by axis: the same gradient to rounding, and the same
bits every run.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def upsample_nearest(x: torch.Tensor, scale: int = 2) -> torch.Tensor:
    """Exact integer-factor nearest upsampling (pixel duplication)."""
    b, h, w, c = x.shape
    x = x[:, :, None, :, None, :].expand(b, h, scale, w, scale, c)
    return x.reshape(b, h * scale, w * scale, c)


def _nearest_index(n_in: int, n_out: int, device) -> torch.Tensor:
    """Torch-style nearest source index, src = floor(dst * in/out), computed
    in float32 as the JAX package computes it."""
    return torch.floor(torch.arange(n_out, dtype=torch.float32, device=device) * (n_in / n_out)).long()


@functools.lru_cache(maxsize=64)
def _backward_taps(n_in: int, n_out: int, mode: str) -> tuple:
    """The transpose of resizing one axis of `n_in` samples to `n_out`: for
    each source sample, the outputs that read it and their weights, in
    output order, padded with weight 0 to the most any source has. Nearest:
    `_nearest_index`'s map; bilinear: PyTorch's upsample_bilinear2d taps
    (align_corners=False: src = max((dst + 0.5) * in/out - 0.5, 0), the two
    neighbours weighted 1 - frac and frac), in float32. Returns numpy
    (n_in, k) indices and weights."""
    dst = np.arange(n_out, dtype=np.float32)
    scale = np.float32(n_in / n_out)
    if mode == "nearest":
        src = _nearest_index(n_in, n_out, "cpu").numpy()
        taps = [(src, np.ones(n_out, np.float32))]
    else:
        pos = np.maximum(scale * (dst + np.float32(0.5)) - np.float32(0.5), np.float32(0.0))
        i0 = pos.astype(np.int64)
        i1 = np.minimum(i0 + 1, n_in - 1)
        frac = (pos - i0).astype(np.float32)
        taps = [(i0, np.float32(1.0) - frac), (i1, frac)]
    readers: list = [[] for _ in range(n_in)]
    for o in range(n_out):
        for idx, wt in taps:
            if wt[o] != 0:
                readers[idx[o]].append((o, wt[o]))
    k = max(1, max(len(r) for r in readers))
    index = np.zeros((n_in, k), np.int64)
    weight = np.zeros((n_in, k), np.float32)
    for i, r in enumerate(readers):
        for j, (o, wt) in enumerate(r):
            index[i, j], weight[i, j] = o, wt
    return index, weight


def _gather_sum(g: torch.Tensor, dim: int, n_in: int, mode: str) -> torch.Tensor:
    """The gradient of resizing axis `dim` to g's size, from n_in samples:
    for each source sample, its readers' gradients times their weights,
    summed in output order."""
    index, weight = _backward_taps(n_in, g.shape[dim], mode)
    index = torch.from_numpy(index).to(g.device)
    shape = [1] * g.dim()
    shape[dim] = n_in
    out = None
    for j in range(index.shape[1]):
        w = torch.from_numpy(weight[:, j]).to(device=g.device, dtype=g.dtype).reshape(shape)
        term = g.index_select(dim, index[:, j]) * w
        out = term if out is None else out + term
    return out


class _Resize(torch.autograd.Function):
    """NHWC resize whose backward sums by gathers in a fixed order."""

    @staticmethod
    def forward(ctx, x, out_hw, mode):
        ctx.hw, ctx.mode = tuple(x.shape[1:3]), mode
        return _resize(x, out_hw, mode)

    @staticmethod
    def backward(ctx, g):
        (h, w), mode = ctx.hw, ctx.mode
        return _gather_sum(_gather_sum(g, 1, h, mode), 2, w, mode), None, None


def _resize(x: torch.Tensor, out_hw, mode: str) -> torch.Tensor:
    if mode == "nearest":
        _, h, w, _ = x.shape
        oh, ow = out_hw
        return x.index_select(1, _nearest_index(h, oh, x.device)).index_select(2, _nearest_index(w, ow, x.device))
    y = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(out_hw), mode="bilinear", align_corners=False,
                      antialias=False)
    return y.permute(0, 2, 3, 1)


def _resize_differentiable(x: torch.Tensor, out_hw, mode: str) -> torch.Tensor:
    if torch.is_grad_enabled() and x.requires_grad:
        return _Resize.apply(x, tuple(out_hw), mode)
    return _resize(x, out_hw, mode)


def resize_nearest(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Nearest resize with torch-style source indexing, src = floor(dst * in/out),
    computed in float32 as the JAX package computes it."""
    return _resize_differentiable(x, out_hw, "nearest")


def resize_bilinear(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Bilinear resize, half-pixel centers, no antialiasing (== torch
    align_corners=False == jax.image.resize 'linear', antialias=False)."""
    return _resize_differentiable(x, out_hw, "bilinear")
