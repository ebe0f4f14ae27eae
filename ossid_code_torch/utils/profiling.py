"""Device profiling helpers (the port of ossid_code_tpu/utils/profiling.py, on
PyTorch's own tools).

The reference instruments stages with CUDA-event timers (ref
utils/__init__.py:186-218). Here:

  * `trace(log_dir)` runs `torch.profiler` over a block (CPU and, on the
    card, CUDA activity through CUPTI) and writes a Chrome trace into
    `log_dir`. On the card a trace that recorded no device time raises: it
    is never written empty.
  * `annotate(name)` names a region: a `record_function` span, and on the
    card an NVTX range too. The port's hand-written kernels are launched
    through ctypes, so no ATen op wraps them; each kernel wrapper opens an
    `annotate` span named after its kernel ("dw_corr3x3", "dw_corr3x3_dx",
    "dw_corr3x3_dk", "sa_mlp_max") around its launch, so a trace names them
    even where the runtime-API correlation of a launch to its CPU op fails.
  * `device_timer(fn, ...)`: the median seconds per call, CUDA events on the
    card, the host clock on the CPU; the result names which.
  * `device_summary(prof)`: the device's busy time and idle share over the
    traced window, and the device time under named spans.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from typing import NamedTuple

import numpy as np
import torch
from torch.utils._pytree import tree_leaves

from ossid_code_torch.device import resolve_device


@contextlib.contextmanager
def annotate(name: str):
    """A named span in profiler traces: `torch.profiler.record_function`,
    and where CUDA is available an NVTX range of the same name, so that any
    CUDA tool shows it."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


def _device_kernels(prof) -> list:
    """The profile's device events that are work on the card (kernels,
    copies, memsets): a user annotation's device range spans kernels that
    are counted on their own."""
    from torch.autograd import DeviceType

    return [e for e in prof.events()
            if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)]


@contextlib.contextmanager
def trace(log_dir: str, device: str | torch.device | None = None):
    """Profile everything inside the block with `torch.profiler` and write a
    Chrome trace (`trace_*.json`) into `log_dir`; yields the profiler, whose
    `trace_path` names the file after the block. `device` None means the
    card (`resolve_device`): CPU and CUDA activity; `device="cpu"` traces
    CPU activity only. On the card a profile with no device time raises
    RuntimeError and writes nothing: CUPTI did not trace the card, and
    `device_timer`'s CUDA events are the way to time it."""
    from torch.profiler import ProfilerActivity, profile

    dev = resolve_device(device)
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize(dev)
    with profile(activities=activities) as prof:
        yield prof
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    if dev.type == "cuda" and not any(e.time_range.end > e.time_range.start for e in _device_kernels(prof)):
        raise RuntimeError("torch.profiler recorded no device time on the card (CUPTI did not trace it); "
                           "time with device_timer's CUDA events instead")
    os.makedirs(log_dir, exist_ok=True)
    fd, path = tempfile.mkstemp(prefix="trace_", suffix=".json", dir=log_dir)
    os.close(fd)
    prof.export_chrome_trace(path)
    prof.trace_path = path


def device_summary(prof, names=()) -> dict:
    """What a trace says of the card: the traced window (first to last event,
    ms), the device's busy time (the union of its kernels' and copies'
    intervals, ms), the idle share of the window, the number of device
    events, and for each of `names` the device time under spans of that
    name (`key_averages`' device total: kernels the profiler tied to the
    span's launches, ms) and the kernels whose own name holds it (their
    number and device time, ms). The two can differ: the profiler does not
    always tie a ctypes launch to the span around it (ROADMAP.md §3)."""
    events = list(prof.events())
    kernels = _device_kernels(prof)
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy_us, end = 0.0, float("-inf")
    for s, e in spans:
        if e > end:
            busy_us += e - max(s, end)
            end = e
    window_us = (max(e.time_range.end for e in events) - min(e.time_range.start for e in events)) if events else 0.0
    averages = {a.key: a for a in prof.key_averages()}

    def device_ms(name):
        a = averages.get(name)
        if a is None:
            return 0.0
        return float(getattr(a, "device_time_total", getattr(a, "cuda_time_total", 0.0))) / 1e3

    return {"window_ms": window_us / 1e3, "device_busy_ms": busy_us / 1e3,
            "device_idle_share": 1.0 - busy_us / window_us if spans and window_us > 0 else None,
            "device_events": len(spans), "spans_device_ms": {n: device_ms(n) for n in names},
            "kernels_device_ms": {n: sum(e.time_range.end - e.time_range.start for e in kernels if n in e.name) / 1e3
                                  for n in names},
            "kernels_by_name": {n: sum(n in e.name for e in kernels) for n in names}}


class DeviceTime(NamedTuple):
    """A median time per call and where it was taken: `device` is the card's
    name, or "cpu"; `clock` is "cuda events" or "host clock". A CPU reading
    is the host's time, never a device metric."""
    seconds: float
    device: str
    clock: str


def cuda_device_of(args, kwargs, out) -> torch.device | None:
    """The device of the first CUDA tensor among a call's arguments and
    result, None where there is none."""
    for t in tree_leaves((args, kwargs, out)):
        if isinstance(t, torch.Tensor) and t.is_cuda:
            return t.device
    return None


def device_timer(fn, *args, iters: int = 10, warmup: int = 2, **kwargs) -> DeviceTime:
    """Median seconds per call of `fn(*args, **kwargs)` over `iters` calls
    after `warmup`. Where the arguments or the result hold CUDA tensors, each
    call is timed between two CUDA events on the current stream, then a
    `synchronize()`; otherwise by the host clock, and the result says so."""
    out = None
    for _ in range(max(warmup, 1)):
        out = fn(*args, **kwargs)
    dev = cuda_device_of(args, kwargs, out)
    times = []
    if dev is not None:
        torch.cuda.synchronize(dev)
        for _ in range(iters):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args, **kwargs)
            end.record()
            torch.cuda.synchronize(dev)
            times.append(start.elapsed_time(end) / 1e3)
        return DeviceTime(float(np.median(times)), torch.cuda.get_device_name(dev), "cuda events")
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*args, **kwargs)
        times.append(time.perf_counter() - t0)
    return DeviceTime(float(np.median(times)), "cpu", "host clock")
