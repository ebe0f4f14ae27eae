"""Device->host copies started without waiting (the port's counterpart of
JAX's `copy_to_host_async` followed by a later `jax.device_get`).

`HostCopy(tree)` walks a tree of tuples, lists and dicts. Each CUDA tensor
leaf is copied with `non_blocking=True` into a pinned host tensor of its
shape, and one `torch.cuda.Event` is recorded after the copies on the
calling thread's current stream. `wait()` waits on that event, and on
nothing else, then returns the tree with numpy arrays in place of tensors;
it may run on another thread (it makes no other CUDA call). The pinned
tensors stay referenced by the HostCopy, and the caching host allocator
holds each block until its copy's event has passed, so no buffer is freed
or reused under a copy in flight. CPU tensors are already computed: they
become numpy views at once. Leaves that are HostCopy objects are waited on
in `wait()`; other leaves (None, numpy) pass through. `to_device` is the
upload the other way.
"""

from __future__ import annotations

import numpy as np
import torch


class HostCopy:
    def __init__(self, tree):
        self._cuda = False
        self._tree = self._start(tree)
        self._event = None
        if self._cuda:
            self._event = torch.cuda.Event()
            self._event.record()

    def _start(self, x):
        if isinstance(x, torch.Tensor):
            if x.device.type != "cuda":
                return x.detach().numpy()
            host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            host.copy_(x.detach(), non_blocking=True)
            self._cuda = True
            return host
        if isinstance(x, dict):
            return {k: self._start(v) for k, v in x.items()}
        if isinstance(x, (tuple, list)):
            return type(x)(self._start(v) for v in x)
        return x

    def wait(self):
        """The tree on the host (numpy leaves), once the copies are done."""
        if self._event is not None:
            self._event.synchronize()
        return _finish(self._tree)


def _finish(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    if isinstance(x, HostCopy):
        return x.wait()
    if isinstance(x, dict):
        return {k: _finish(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(_finish(v) for v in x)
    return x


def to_device(a: np.ndarray, device) -> torch.Tensor:
    """Host array -> tensor on `device`. To a CUDA device through pinned
    memory without waiting (the copy is ordered on the current stream, and
    the caching host allocator holds the pinned block until it is done); a
    pageable source would make the copy wait for the stream to drain."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    device = torch.device(device)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)
