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
    traced window, the device time under named spans, and for each kernel
    its device records and how many of them lie inside its span; with the
    program's span log (utils/rpc_stats.py), the device's idle time by the
    host span that was running.
"""

from __future__ import annotations

import contextlib
import os
import re
import tempfile
import time
from typing import NamedTuple

import numpy as np
import torch
from torch.utils._pytree import tree_leaves

from ossid_code_torch.device import resolve_device
from ossid_code_torch.utils.rpc_stats import OUTER_SPANS, loop_thread_spans


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
    `device_timer`'s CUDA events are the way to time it.

    The profiler loses the device records of a session's first launches
    once a process has opened many sessions (on an H100: none up to 12, one
    from about 18 on, two from about 36): a trace that must hold every
    launch runs early in its process."""
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


def _named(symbol: str, name: str) -> bool:
    """Whether a device record's (demangled) name is the kernel `symbol`."""
    return re.search(rf"(?<![A-Za-z0-9_]){re.escape(symbol)}(?![A-Za-z0-9_])", name) is not None


def device_summary(prof, names=(), kernels: dict | None = None, spans: list | None = None) -> dict:
    """What a trace says of the card: the traced window (first to last event,
    ms), the device's busy time (the union of its kernels' and copies'
    intervals, ms), the idle share of the window, the number of device
    events, and for each of `names` the device time under spans of that
    name (`key_averages`' device total, ms) and the kernels whose own name
    holds it (their number and device time, ms; with `kernels`, those of
    the span's kernel).

    `kernels` maps span names to the symbol of the kernel launched inside
    them ({"dw_corr3x3": "dw_corr3x3_kernel", ...}); for each, the summary
    also counts the device records of that kernel (`kernel_records`) and
    those of them whose device interval lies inside a span of that name
    (`records_in_span`: the device range, a GPU user annotation, that the
    profiler draws around the kernels launched inside the span).

    `spans` is the program's span log over the same window (`STATS.snapshot()
    ["spans"]`, on the profiler's clock); the summary then splits the
    device's idle time (the window less its busy time) among the innermost
    spans of the loop's thread (`rpc_stats.loop_thread_spans`) that cover
    it, by overlap (`idle_by_span`, ms; "(none)" where no span runs), and
    gives the share of idle time under a span other than the loop's outer
    ones (`rpc_stats.OUTER_SPANS`: `idle_in_stages_share`)."""
    from torch.autograd import DeviceType

    kernels = dict(kernels or {})
    names = tuple(dict.fromkeys((*names, *kernels)))
    events = list(prof.events())
    records = _device_kernels(prof)
    busy = []  # the union of the records' intervals, in order
    for s, e in sorted((e.time_range.start, e.time_range.end) for e in records):
        if busy and s <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], e)
        else:
            busy.append([s, e])
    busy_us = sum(e - s for s, e in busy)
    window_us = (max(e.time_range.end for e in events) - min(e.time_range.start for e in events)) if events else 0.0
    averages = {a.key: a for a in prof.key_averages()}

    def device_ms(name):
        a = averages.get(name)
        if a is None:
            return 0.0
        return float(getattr(a, "device_time_total", getattr(a, "cuda_time_total", 0.0))) / 1e3

    mine = {n: [e for e in records if (_named(kernels[n], e.name) if n in kernels else n in e.name)] for n in names}
    out = {"window_ms": window_us / 1e3, "device_busy_ms": busy_us / 1e3,
           "device_idle_share": 1.0 - busy_us / window_us if records and window_us > 0 else None,
           "device_events": len(records), "spans_device_ms": {n: device_ms(n) for n in names},
           "kernels_device_ms": {n: sum(e.time_range.end - e.time_range.start for e in mine[n]) / 1e3
                                 for n in names},
           "kernels_by_name": {n: len(mine[n]) for n in names}}
    if spans is not None and events:
        start = min(e.time_range.start for e in events)
        idle, cur = [], start
        for s, e in busy:
            if s > cur:
                idle.append((cur, s))
            cur = max(cur, e)
        if cur < start + window_us:
            idle.append((cur, start + window_us))
        by_span = _idle_by_span(idle, spans, prof.profiler.kineto_results.trace_start_ns())
        total = sum(by_span.values())
        outer = sum(by_span.get(k, 0.0) for k in (*OUTER_SPANS, "(none)"))
        out.update(idle_by_span={k: v / 1e3 for k, v in sorted(by_span.items(), key=lambda kv: -kv[1])},
                   idle_in_stages_share=1.0 - outer / total if total > 0 else None)
    if kernels:
        ranges = {n: [(e.time_range.start, e.time_range.end) for e in events
                      if e.device_type == DeviceType.CUDA and getattr(e, "is_user_annotation", False) and e.name == n]
                  for n in kernels}
        eps = 1e-3  # us: the annotation's bounds are its kernels' own timestamps
        out.update(kernel_records={n: len(mine[n]) for n in kernels},
                   records_in_span={n: sum(any(s - eps <= e.time_range.start and e.time_range.end <= t + eps
                                               for s, t in ranges[n]) for e in mine[n]) for n in kernels})
    return out


def _idle_by_span(idle: list, spans: list, t0_ns: int) -> dict:
    """{span name: us} of the idle intervals `idle` (us from the trace's
    start, in order) by the innermost span of the loop's thread over each
    instant: of the spans open there, the one that started last (the
    shorter of two that started together)."""
    ivs = sorted(((s - t0_ns) / 1e3, (e - t0_ns) / 1e3, name) for name, _, s, e, _ in loop_thread_spans(spans))
    bounds = sorted({x for s, e, _ in ivs for x in (s, e)} | {x for iv in idle for x in iv})
    out: dict = {}
    open_, i, j = [], 0, 0
    for a, b in zip(bounds, bounds[1:]):
        while i < len(ivs) and ivs[i][0] <= a:
            open_.append(ivs[i])
            i += 1
        open_ = [iv for iv in open_ if iv[1] > a]
        while j < len(idle) and idle[j][1] <= a:
            j += 1
        if j < len(idle) and idle[j][0] <= a:
            name = max(open_, key=lambda iv: (iv[0], -iv[1]))[2] if open_ else "(none)"
            out[name] = out.get(name, 0.0) + b - a
    return out


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
