"""The port's optimizers, by optax's rules (the JAX package's optimizers are
optax chains).

`OptaxAmsgrad` is `chain(add_decayed_weights(wd), amsgrad(lr))`, as the JAX
package's DTOID `make_optimizer` and `train/offline.py` build it. It is not
`torch.optim.Adam(amsgrad=True, weight_decay=wd)`: optax keeps the running
maximum of the bias-corrected second moment, torch the maximum of the raw
moment, corrected afterwards; the two part from the second step on.
Per parameter p with gradient g, at step n:

    g  = g + wd * p
    mu = (1 - b1) * g + b1 * mu
    nu = (1 - b2) * g^2 + b2 * nu
    nu_max = max(nu_max, nu / (1 - b2^n))
    p  = p - lr(n - 1) * (mu / (1 - b1^n)) / (sqrt(nu_max) + eps)

`OptaxAdam` is plain `optax.adam(lr)` (the scorer's, JAX
models/zephyr/module.py:131): no decay, and nu / (1 - b2^n) in place of
nu_max. The learning rate is a number or a schedule of the step count
(0-based, as optax's `scale_by_schedule` counts), such as
`piecewise_constant_schedule`.
"""

from __future__ import annotations

import torch


def piecewise_constant_schedule(init_value: float, boundaries_and_scales: dict | None = None):
    """optax.piecewise_constant_schedule: from step `boundary` on, the value
    is multiplied by that boundary's scale."""
    items = sorted((boundaries_and_scales or {}).items())

    def schedule(count: int) -> float:
        v = init_value
        for boundary, scale in items:
            if count >= boundary:
                v = v * scale
        return v

    return schedule


class _OptaxAdamBase(torch.optim.Optimizer):
    amsgrad = False

    def __init__(self, params, lr=1e-3, weight_decay: float = 0.0, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        super().__init__(params, dict(lr=lr, weight_decay=weight_decay, b1=b1, b2=b2, eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        """One step over all parameters with a gradient, in a few multi-tensor
        (`torch._foreach_*`) launches per group: a loop of small ops per
        parameter costs a launch per op and parameter. Each elementwise op is
        the formula's, in its order."""
        if closure is not None:
            raise ValueError(f"{type(self).__name__}.step takes no closure")
        for group in self.param_groups:
            lr, wd, b1, b2, eps = (group[k] for k in ("lr", "weight_decay", "b1", "b2", "eps"))
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            for p in params:
                st = self.state[p]
                if not st:
                    st["count"] = 0
                    st["mu"] = torch.zeros_like(p)
                    st["nu"] = torch.zeros_like(p)
                    if self.amsgrad:
                        st["nu_max"] = torch.zeros_like(p)
                st["count"] += 1
            n = self.state[params[0]]["count"]
            if any(self.state[p]["count"] != n for p in params):
                raise RuntimeError(f"{type(self).__name__} steps all parameters of a group together")
            if callable(lr):
                lr = lr(n - 1)
            mus, nus = ([self.state[p][k] for p in params] for k in ("mu", "nu"))
            g = [p.grad for p in params]
            if wd:
                g = torch._foreach_add(g, torch._foreach_mul(params, wd))
            torch._foreach_mul_(mus, b1)
            torch._foreach_add_(mus, torch._foreach_mul(g, 1.0 - b1))
            g2 = torch._foreach_mul(g, g)
            torch._foreach_mul_(g2, 1.0 - b2)
            torch._foreach_mul_(nus, b2)
            torch._foreach_add_(nus, g2)
            if self.amsgrad:
                nu_hat = [self.state[p]["nu_max"] for p in params]
                torch._foreach_maximum_(nu_hat, torch._foreach_div(nus, 1.0 - b2 ** n))
            else:
                nu_hat = torch._foreach_div(nus, 1.0 - b2 ** n)
            denom = torch._foreach_sqrt(nu_hat)
            torch._foreach_add_(denom, eps)
            upd = torch._foreach_div(torch._foreach_div(mus, 1.0 - b1 ** n), denom)
            torch._foreach_mul_(upd, lr)
            torch._foreach_sub_(params, upd)
        return None


class OptaxAmsgrad(_OptaxAdamBase):
    """optax `chain(add_decayed_weights(weight_decay), amsgrad(lr))`."""

    amsgrad = True

    def __init__(self, params, lr=1e-4, weight_decay: float = 1e-6, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        super().__init__(params, lr=lr, weight_decay=weight_decay, b1=b1, b2=b2, eps=eps)


class OptaxAdam(_OptaxAdamBase):
    """optax `adam(lr)`."""

    def __init__(self, params, lr=1e-3, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        super().__init__(params, lr=lr, weight_decay=0.0, b1=b1, b2=b2, eps=eps)


def make_optimizer(params, learning_rate=1e-4, weight_decay: float = 1e-6) -> OptaxAmsgrad:
    """Adam with amsgrad and coupled L2, by optax's rule (see module doc);
    `learning_rate` may be a schedule."""
    return OptaxAmsgrad(params, lr=learning_rate, weight_decay=weight_decay)
