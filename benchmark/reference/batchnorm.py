"""BatchNorm with flax's running statistics (the port's counterpart of
`flax.linen.BatchNorm(momentum=0.9, epsilon=1e-5)` as the JAX package uses it).

In training mode both normalise with the biased batch variance, but they
update the running variance differently: flax with the biased batch
variance, `torch.nn.BatchNorm2d` with the unbiased one. This class keeps
flax's rule; flax's momentum 0.9 is torch's momentum 0.1. In eval mode it is
`torch.nn.BatchNorm2d`.

bf16 activations in training mode (the mixed-precision finetune step) follow
flax 0.12 under the JAX package's `train_step_mp`: the batch statistics are
reduced in float32 (`force_float32_reductions`), the output is computed in
float32 from the bf16 input, scale and bias and rounded once to bf16, and
the running statistics, which that step hands to flax cast to bf16, update
as

    new = float32(bf16(bf16(0.9) * bf16(old))) + 0.1 * batch_stat

(the weakly typed momentum becomes bf16(0.9) = 0.8984375 and the product is
rounded to bf16 before the float32 batch term is added); they are stored
back in float32.

Inside `global_batch()` (the data-parallel train step of train/offline.py,
one process a device), a layer in training mode under a process group of
more than one process normalises with the statistics of the global batch,
as the JAX package's one GSPMD program does: the per-channel sum and
count, then the sum of squared deviations from the global mean, are
all-reduced over the group with autograd through the reductions (the
gradient of a sum over the group is the sum of the gradients over the
group), and the running statistics update by flax's rule from the global
mean and biased variance (`torch.nn.SyncBatchNorm` updates them with the
unbiased one). With no group, or a group of one process, the layer runs as
it does outside.
"""

from __future__ import annotations

import contextlib
import functools

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

# set inside global_batch(): the processes' batches make one global batch
_GLOBAL = False


@contextlib.contextmanager
def global_batch():
    """BatchNorm layers in training mode take their statistics over the
    global batch of the process group inside the block."""
    global _GLOBAL
    prev, _GLOBAL = _GLOBAL, True
    try:
        yield
    finally:
        _GLOBAL = prev


class _AllReduceSum(torch.autograd.Function):
    """The sum of x over the process group, differentiable: its gradient is
    the sum of the output gradients over the group."""

    @staticmethod
    def forward(ctx, x):
        out = x.clone()
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad)
        return grad


def _global_moments(xf: torch.Tensor) -> tuple | None:
    """(mean, biased variance) per channel of the float32 (B, C, H, W) xf
    over the global batch, with autograd; None outside global_batch() or
    without a group of more than one process."""
    if not _GLOBAL or dist.get_world_size() == 1:
        return None
    c = xf.shape[1]
    tot = _AllReduceSum.apply(torch.cat([xf.sum((0, 2, 3)), xf.new_full((1,), xf.numel() // c)]))
    count = tot[c]
    mean = tot[:c] / count
    dev = xf - mean[None, :, None, None]
    return mean, _AllReduceSum.apply((dev * dev).sum((0, 2, 3))) / count


def _normalise(xf, mean, var, weight, bias, eps):
    inv = torch.rsqrt(var + eps)
    return (xf - mean[None, :, None, None]) * (inv * weight)[None, :, None, None] + bias[None, :, None, None]


@functools.cache
def _bf16(v: float) -> float:
    """v rounded to bf16."""
    return float(torch.tensor(v).to(torch.bfloat16))


def bf16_running_update(buf: torch.Tensor, stat: torch.Tensor, momentum: float) -> None:
    """flax's bf16 rule, in place on float32 running statistics of any shape:
    buf = float32(bf16(bf16(1 - momentum) * bf16(buf))) + momentum * stat.
    bf16(0.9) times a bf16 value is exact in float32, so the bf16 result of
    this product is flax's bf16 product."""
    buf.copy_((buf.to(torch.bfloat16) * _bf16(1.0 - momentum)).float().add_(stat, alpha=momentum))


class BatchNorm2d(nn.BatchNorm2d):
    # A dict, when set on a layer: its bf16 batch statistics go there as
    # (mean, var) instead of into its running statistics, for the bf16
    # step's one update of every layer (models/dtoid/module.py::_Bf16Step).
    stats_sink: dict | None = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        if x.dtype == torch.bfloat16:
            return self._train_bf16(x)
        moments = _global_moments(x)
        if moments is not None:
            y = _normalise(x, *moments, self.weight, self.bias, self.eps)
        else:
            y = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)
        with torch.no_grad():
            if moments is not None:
                mean, var = (m.detach() for m in moments)
            else:
                xd = x.detach()
                mean = xd.mean((0, 2, 3))
                var = xd.var((0, 2, 3), unbiased=False)
            self.running_mean.mul_(1.0 - self.momentum).add_(mean, alpha=self.momentum)
            self.running_var.mul_(1.0 - self.momentum).add_(var, alpha=self.momentum)
            self.num_batches_tracked.add_(1)
        return y

    def _train_bf16(self, x: torch.Tensor) -> torch.Tensor:
        # in float32 and rounded once (PyTorch's own bf16 batch_norm on the CPU
        # rounds intermediates); a float32 scale and bias (the bf16 step's
        # upcasts of its bf16 parameters) are used as they are
        xf = x.float()
        moments = _global_moments(xf)
        if moments is not None:
            y = _normalise(xf, *moments, self.weight.float(), self.bias.float(), self.eps)
        else:
            y = F.batch_norm(xf, None, None, self.weight.float(), self.bias.float(), True, 0.0, self.eps)
        with torch.no_grad():
            if moments is not None:
                mean, var = (m.detach() for m in moments)
            else:
                var, mean = torch.var_mean(xf.detach(), (0, 2, 3), unbiased=False)
            if self.stats_sink is not None:
                if self in self.stats_sink:
                    raise RuntimeError("a BatchNorm layer ran twice in one bf16 step")
                self.stats_sink[self] = (mean, var)
            else:
                bf16_running_update(self.running_mean, mean, self.momentum)
                bf16_running_update(self.running_var, var, self.momentum)
                self.num_batches_tracked.add_(1)
        return y.to(torch.bfloat16)
