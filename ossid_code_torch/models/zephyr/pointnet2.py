"""PointNet++ (SSG) hypothesis-scoring network, inference (counterpart of
ossid_code_tpu/models/zephyr/pointnet2.py).

Input is a batch of hypotheses, point_x (M, N, D), whose first 3 channels are
centered camera-frame xyz (see features.py); output is one score each.

  SA1: 512 centres, r=0.2, k=64, MLP (64, 64, 128)   -> sa_mlp_max (kernel 2)
  SA2: 128 centres, r=0.4, k=64, MLP (128, 128, 256) -> sa_mlp_max (kernel 2)
  SA3: global, MLP (256, 512, 1024), then FC 512 -> 256 -> num_class, plain
       torch.matmul (the JAX package leaves these to XLA)

In bf16 (the network's weights cast to bf16 and bf16 points, as
`ZephyrModel(bf16=True)` runs it) the forward follows the JAX package's
`pointnet2_fused_apply`: the BatchNorm folds in float32 from the bf16
weights and statistics and the folded matrices are cast to bf16; SA1 and SA2
run kernel 2b; SA3 and the FC head sum bf16 products in float32, add the
float32 bias, apply relu and round to bf16 (`dense_relu`); the last layer's
logit stays float32.

Grouping is static: FPS and ball query depend only on distances, which the
rigid per-hypothesis transform preserves, so `ZephyrModel.prepare_object`
computes the indices once per object. BatchNorm runs in its inference form,
folded into the preceding matmul. Module names follow the erikwijmans
Pointnet2_PyTorch layout that `export_pointnet2_state_dict` emits.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ossid_code_torch.ops.sa_fused import dense_relu, fold_bn, sa_mlp_max

ALIGN_TAU_D = (0.005, 0.01, 0.015, 0.02)
ALIGN_TAU_H = (0.05, 0.12, 0.5)


def alignment_fractions(point_x: torch.Tensor) -> torch.Tensor:
    """Per-hypothesis fraction of valid projected points that are depth-aligned
    AND hue-consistent, over a 4x3 tolerance grid -> (M, 12) in [0, 1]."""
    dh = point_x[..., 3].float()
    dd = torch.abs(point_x[..., 6]).float()
    ok = point_x[..., 10].float()
    nval = ok.sum(-1).clamp(min=1.0)
    stats = [(ok * (dd < td) * (dh < th)).sum(-1) / nval
             for td in ALIGN_TAU_D for th in ALIGN_TAU_H]
    return torch.stack(stats, dim=-1)


class _BN(nn.Module):
    """The `.bn.bn.` nesting of etw_pytorch_utils' BatchNorm wrapper."""

    def __init__(self, c: int, cls=nn.BatchNorm2d):
        super().__init__()
        self.bn = cls(c)

    def fold(self, kernel2d: torch.Tensor):
        bn = self.bn
        return fold_bn(kernel2d, bn.weight, bn.bias, bn.running_mean, bn.running_var)


class _ConvBN(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 1, bias=False)
        self.bn = _BN(cout)

    def folded(self):
        return self.bn.fold(self.conv.weight[:, :, 0, 0].t())


class SharedMLP(nn.Module):
    def __init__(self, widths):
        super().__init__()
        for j in range(len(widths) - 1):
            self.add_module(f"layer{j}", _ConvBN(widths[j], widths[j + 1]))

    def folded(self):
        Ws, bs = zip(*(layer.folded() for layer in self.children()))
        return list(Ws), list(bs)


class SetAbstraction(nn.Module):
    def __init__(self, cin: int, mlp):
        super().__init__()
        self.mlps = nn.ModuleList([SharedMLP((cin,) + tuple(mlp))])

    def forward(self, xyz, feats, static_idx):
        """xyz (M, N, 3); feats (M, N, C); static_idx (center_idx (S,),
        group_idx (S, k)) -> (new_xyz (M, S, 3), new_feats (M, S, mlp[-1]))."""
        center_idx, group_idx = static_idx
        Ws, bs = self.mlps[0].folded()
        new_feats = sa_mlp_max(xyz, feats, center_idx, group_idx, [w.to(xyz.dtype) for w in Ws], bs)
        return xyz[:, center_idx.long()], new_feats


class GlobalAbstraction(nn.Module):
    def __init__(self, cin: int, mlp):
        super().__init__()
        self.mlps = nn.ModuleList([SharedMLP((cin,) + tuple(mlp))])

    def forward(self, xyz, feats):
        x = torch.cat([xyz, feats], dim=-1)
        for w, b in zip(*self.mlps[0].folded()):
            x = dense_relu(x, w, b)
        return x.amax(dim=1)


class _FC(nn.Module):
    def __init__(self, cin: int, cout: int, bn: bool):
        super().__init__()
        self.fc = nn.Linear(cin, cout, bias=not bn)
        self.bn = _BN(cout, nn.BatchNorm1d) if bn else None

    def forward(self, x):
        if self.bn is None:  # the logit layer: float32 out, from bf16 operands in bf16
            return F.linear(x.float(), self.fc.weight.float(), self.fc.bias.float())
        w, b = self.bn.fold(self.fc.weight.t())
        return dense_relu(x, w, b)


class PointNet2SSG(nn.Module):
    def __init__(self, num_class: int = 1, dim_point: int = 11, align_feats: bool = False):
        super().__init__()
        self.num_class = num_class
        cf = dim_point - 3
        self.SA_modules = nn.ModuleList([
            SetAbstraction(3 + cf, (64, 64, 128)),
            SetAbstraction(3 + 128, (128, 128, 256)),
            GlobalAbstraction(3 + 256, (256, 512, 1024)),
        ])
        # FC(bn) . Dropout . FC(bn) . Dropout . FC — dropout is inert at inference
        self.FC_layer = nn.Sequential(_FC(1024, 512, True), nn.Dropout(0.5),
                                      _FC(512, 256, True), nn.Dropout(0.5),
                                      _FC(256, num_class, False))
        # residual alignment head, zero-initialised and set post hoc
        self.align_head = nn.Linear(len(ALIGN_TAU_D) * len(ALIGN_TAU_H), num_class) if align_feats else None

    def forward(self, point_x: torch.Tensor, static_idx: dict) -> torch.Tensor:
        """point_x (M, N, dim_point); static_idx {'sa1': (cidx, gidx),
        'sa2': (cidx, gidx)} -> scores (M,) if num_class == 1 else (M, C)."""
        xyz, feats = point_x[..., :3], point_x[..., 3:]
        xyz, feats = self.SA_modules[0](xyz, feats, static_idx["sa1"])
        xyz, feats = self.SA_modules[1](xyz, feats, static_idx["sa2"])
        x = self.FC_layer(self.SA_modules[2](xyz, feats))
        if self.align_head is not None:
            head = self.align_head
            x = x + F.linear(alignment_fractions(point_x), head.weight.float(), head.bias.float())
        return x[..., 0] if self.num_class == 1 else x
