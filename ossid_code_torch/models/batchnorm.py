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
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


class BatchNorm2d(nn.BatchNorm2d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        if x.dtype == torch.bfloat16:
            return self._train_bf16(x)
        y = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)
        with torch.no_grad():
            xd = x.detach()
            mean = xd.mean((0, 2, 3))
            var = xd.var((0, 2, 3), unbiased=False)
            self.running_mean.mul_(1.0 - self.momentum).add_(mean, alpha=self.momentum)
            self.running_var.mul_(1.0 - self.momentum).add_(var, alpha=self.momentum)
            self.num_batches_tracked.add_(1)
        return y

    def _train_bf16(self, x: torch.Tensor) -> torch.Tensor:
        # in float32 and rounded once (PyTorch's own bf16 batch_norm on the CPU
        # rounds intermediates)
        xf = x.float()
        y = F.batch_norm(xf, None, None, self.weight.float(), self.bias.float(), True, 0.0, self.eps)
        with torch.no_grad():
            var, mean = torch.var_mean(xf.detach(), (0, 2, 3), unbiased=False)
            # bf16(0.9) times a bf16 value is exact in float32, so the bf16
            # result of this product is flax's bf16 product
            decay = float(torch.tensor(1.0 - self.momentum).to(torch.bfloat16))
            for buf, stat in ((self.running_mean, mean), (self.running_var, var)):
                buf.copy_((buf.to(torch.bfloat16) * decay).float().add_(stat, alpha=self.momentum))
            self.num_batches_tracked.add_(1)
        return y.to(torch.bfloat16)
