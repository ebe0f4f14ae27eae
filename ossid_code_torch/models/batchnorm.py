"""BatchNorm with flax's running statistics (the port's counterpart of
`flax.linen.BatchNorm(momentum=0.9, epsilon=1e-5)` as the JAX package uses it).

In training mode both normalise with the biased batch variance, but they
update the running variance differently: flax with the biased batch
variance, `torch.nn.BatchNorm2d` with the unbiased one. This class keeps
flax's rule; flax's momentum 0.9 is torch's momentum 0.1. In eval mode it is
`torch.nn.BatchNorm2d`.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


class BatchNorm2d(nn.BatchNorm2d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        y = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)
        with torch.no_grad():
            xd = x.detach()
            mean = xd.mean((0, 2, 3))
            var = xd.var((0, 2, 3), unbiased=False)
            self.running_mean.mul_(1.0 - self.momentum).add_(mean, alpha=self.momentum)
            self.running_var.mul_(1.0 - self.momentum).add_(var, alpha=self.momentum)
            self.num_batches_tracked.add_(1)
        return y
