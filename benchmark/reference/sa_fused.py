"""The set-abstraction layer's plain arithmetic for the reference (the
port's ops/sa_fused.py plain versions, frozen here): `sa_mlp_max` is the
plain grouped MLP and max on every device."""

from __future__ import annotations

import torch

EPS = 1e-5  # BatchNorm epsilon of the JAX package (flax default)


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


sa_mlp_max = sa_mlp_max_plain
