"""Activation and gradient probing: the reference's NetworkBase debug surface
(ref models/dtoid/network_base.py:7-67: the `probe_activation` dict filled by
forward hooks and `hook_generator`'s gradient hooks); the port of
ossid_code_tpu/utils/probe.py, with hooks as the reference has them:

  * `capture_activations`: a forward hook on every named submodule records
    its output, an OrderedDict of numpy arrays (NetworkBase.load_activations());
  * `capture_activation_gradients`: d loss / d output of every submodule
    whose output is a floating tensor (NetworkBase.hook_generator()), by a
    tensor hook on each output. A submodule called more than once gets the
    sum over its calls, as JAX's shared perturbation gives.

Names are the port's module names (`named_modules`, which follow the
reference's torch keys), not flax paths; the module itself is "__root__". A
submodule called n > 1 times records its outputs as name_0 ... name_{n-1}
(JAX's suffixes). Both run the unmodified module and remove their hooks.
"""

from __future__ import annotations

import collections
import contextlib

import numpy as np
import torch


def _name(name: str) -> str:
    return name or "__root__"


@contextlib.contextmanager
def _forward_hooks(module: torch.nn.Module, hook):
    """Forward hooks calling hook(name, output) on every named submodule; a
    hook's return value, where not None, replaces the output."""
    handles = [m.register_forward_hook(lambda mod, args, out, n=_name(n): hook(n, out))
               for n, m in module.named_modules()]
    try:
        yield
    finally:
        for h in handles:
            h.remove()


def capture_activations(module: torch.nn.Module, *args, **kwargs):
    """Run `module(*args, **kwargs)` recording every submodule's tensor
    output. Returns (outputs, OrderedDict name -> numpy activation), sorted
    by name as JAX's."""
    seen: dict[str, list] = collections.defaultdict(list)

    def record(name, out):
        if isinstance(out, torch.Tensor):
            seen[name].append(out.detach().cpu().numpy().copy())

    with _forward_hooks(module, record):
        out = module(*args, **kwargs)
    acts = collections.OrderedDict()
    for name in sorted(seen):
        vals = seen[name]
        for i, a in enumerate(vals):
            acts[name if len(vals) == 1 else f"{name}_{i}"] = a
    return out, acts


def capture_activation_gradients(module: torch.nn.Module, scalar_loss, *args, **kwargs):
    """Gradient of `scalar_loss(module outputs)` with respect to every
    submodule's floating output. Returns (loss value, OrderedDict name ->
    numpy gradient with the activation's shape), summed over a submodule's
    calls. An output that does not require grad (nothing before it does) is
    made a leaf that does, so its gradient is recorded as well. The
    parameters' `.grad` are left as they were."""
    grads: dict[str, torch.Tensor] = {}

    def hook(name, out):
        if not (isinstance(out, torch.Tensor) and out.is_floating_point()):
            return None
        if not out.requires_grad:
            out = out.detach().requires_grad_(True)

        def add(g, name=name):
            grads[name] = g.detach().clone() if name not in grads else grads[name] + g
        out.register_hook(add)
        return out

    saved = [(p, p.grad) for p in module.parameters()]
    try:
        with _forward_hooks(module, hook), torch.enable_grad():
            loss = scalar_loss(module(*args, **kwargs))
            loss.backward()
    finally:
        for p, g in saved:  # the parameters' gradients are left as they were
            p.grad = g
    return float(loss.detach()), collections.OrderedDict(
        (k, grads[k].cpu().numpy()) for k in sorted(grads))
