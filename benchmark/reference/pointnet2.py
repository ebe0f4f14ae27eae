"""PointNet++ (SSG) hypothesis-scoring network (counterpart of
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

Inference grouping is static: FPS and ball query depend only on distances,
which the rigid per-hypothesis transform preserves, so
`ZephyrModel.prepare_object` computes the indices once per object. BatchNorm
runs in its inference form, folded into the preceding matmul. Module names
follow the erikwijmans Pointnet2_PyTorch layout that
`export_pointnet2_state_dict` emits.

Training (`forward(..., train=True)`, float32) runs as the JAX package trains
the network, never through the fused kernel: each hypothesis is grouped in
the graph (ops/pointcloud.py), SA1 and SA2 run unfused (1x1 layer, BatchNorm
in train mode by flax's rule, relu, max), the head's two dropouts (0.5) draw
from an explicit `torch.Generator`, and the alignment head gets no gradient
(JAX `stop_gradient`). flax's train-mode BatchNorm normalises with the biased
batch variance E[x^2] - E[x]^2 (clipped at 0) and moves the running
statistics by momentum 0.9 towards the batch's (torch momentum 0.1).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .pointcloud import ball_query, farthest_point_sample, gather_points
from .sa_fused import dense_relu, fold_bn, sa_mlp_max

FLAX_MOMENTUM = 0.9  # flax BatchNorm(momentum=0.9), the JAX package's setting

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


def bn_train(x: torch.Tensor, bn: nn.BatchNorm2d | nn.BatchNorm1d) -> torch.Tensor:
    """flax train-mode BatchNorm over every axis but the last (channels-last
    x), with `bn`'s scale and bias; updates `bn`'s running statistics in
    place by flax's rule."""
    dims = tuple(range(x.dim() - 1))
    mean = x.mean(dims)
    var = ((x * x).mean(dims) - mean * mean).clamp(min=0.0)
    y = (x - mean) * (bn.weight * torch.rsqrt(var + bn.eps)) + bn.bias
    with torch.no_grad():
        for buf, stat in ((bn.running_mean, mean), (bn.running_var, var)):
            buf.mul_(FLAX_MOMENTUM).add_(stat.detach(), alpha=1.0 - FLAX_MOMENTUM)
        bn.num_batches_tracked.add_(1)
    return y


class Dropout(nn.Module):
    """flax `nn.Dropout`: in training, each element is kept with probability
    1 - p (drawn from the generator passed to forward) and scaled by
    1 / (1 - p); at inference the identity."""

    def __init__(self, p: float):
        super().__init__()
        self.p = p

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        if generator is None:
            return x
        keep = 1.0 - self.p
        mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros_like(x))


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

    def train_forward(self, x):
        return torch.relu(bn_train(x @ self.conv.weight[:, :, 0, 0].t(), self.bn.bn))


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

    def train_forward(self, xyz, feats, npoint: int, radius: float, nsample: int):
        """In-graph grouping per hypothesis, then the unfused MLP and max."""
        with torch.no_grad():
            idx = farthest_point_sample(xyz, npoint)
            group_idx = ball_query(gather_points(xyz, idx), xyz, radius, nsample)
        new_xyz = gather_points(xyz, idx)
        x = torch.cat([gather_points(xyz, group_idx) - new_xyz[:, :, None, :],
                       gather_points(feats, group_idx)], dim=-1)
        for layer in self.mlps[0].children():
            x = layer.train_forward(x)
        return new_xyz, x.amax(dim=2)


class GlobalAbstraction(nn.Module):
    def __init__(self, cin: int, mlp):
        super().__init__()
        self.mlps = nn.ModuleList([SharedMLP((cin,) + tuple(mlp))])

    def forward(self, xyz, feats):
        x = torch.cat([xyz, feats], dim=-1)
        for w, b in zip(*self.mlps[0].folded()):
            x = dense_relu(x, w, b)
        return x.amax(dim=1)

    def train_forward(self, xyz, feats):
        x = torch.cat([xyz, feats], dim=-1)
        for layer in self.mlps[0].children():
            x = layer.train_forward(x)
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

    def train_forward(self, x):
        if self.bn is None:
            return F.linear(x, self.fc.weight, self.fc.bias)
        return torch.relu(bn_train(x @ self.fc.weight.t(), self.bn.bn))


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
        self.FC_layer = nn.Sequential(_FC(1024, 512, True), Dropout(0.5),
                                      _FC(512, 256, True), Dropout(0.5),
                                      _FC(256, num_class, False))
        # residual alignment head, zero-initialised and set post hoc
        self.align_head = nn.Linear(len(ALIGN_TAU_D) * len(ALIGN_TAU_H), num_class) if align_feats else None

    def forward(self, point_x: torch.Tensor, static_idx: dict | None = None, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """point_x (M, N, dim_point) -> scores (M,) if num_class == 1 else
        (M, C). Inference takes static_idx {'sa1': (cidx, gidx), 'sa2':
        (cidx, gidx)}; training (train=True) groups in the graph and draws
        its dropout masks from `generator`."""
        if train:
            return self._forward_train(point_x, generator)
        xyz, feats = point_x[..., :3], point_x[..., 3:]
        xyz, feats = self.SA_modules[0](xyz, feats, static_idx["sa1"])
        xyz, feats = self.SA_modules[1](xyz, feats, static_idx["sa2"])
        x = self.FC_layer(self.SA_modules[2](xyz, feats))
        if self.align_head is not None:
            head = self.align_head
            x = x + F.linear(alignment_fractions(point_x), head.weight.float(), head.bias.float())
        return x[..., 0] if self.num_class == 1 else x

    def _forward_train(self, point_x, generator):
        n = point_x.shape[1]
        sa1_n = min(512, n)
        sa2_n = min(128, sa1_n)
        xyz, feats = point_x[..., :3], point_x[..., 3:]
        xyz, feats = self.SA_modules[0].train_forward(xyz, feats, sa1_n, 0.2, min(64, n))
        xyz, feats = self.SA_modules[1].train_forward(xyz, feats, sa2_n, 0.4, 64)
        x = self.SA_modules[2].train_forward(xyz, feats)
        fc1, drop1, fc2, drop2, fc3 = self.FC_layer
        x = drop1(fc1.train_forward(x), generator)
        x = drop2(fc2.train_forward(x), generator)
        x = fc3.train_forward(x)
        if self.align_head is not None:
            with torch.no_grad():  # calibrated post hoc, never trained
                head = self.align_head(alignment_fractions(point_x).to(x.dtype))
            x = x + head
        return x[..., 0] if self.num_class == 1 else x
