"""The traced pass: one `torch.profiler` session of CUDA activity alone,
opened before any other in the process (the profiler loses a session's
first device records once a process has opened many sessions), and read
from the profiler's raw records. Tracing the host's operators too would
more than half again the pass's time on this host-bound loop; the
benchmark's own spans (hooks.SpanLog) are logged on the wall clock the
profiler stamps its records with instead, and read against the runtime
calls that launched each device record.

What it reads:
  * the traced window (first to last record) and the device's busy time
    (the union of its kernels', copies' and memsets' intervals);
  * for each benchmark span, the device time of the records launched inside
    it: a record's runtime call (linked by its correlation id) lies inside a
    span of that name on the thread that made the call;
  * each hand-written kernel's device records and time, by its symbol;
  * the operations that took most device time, and the longest idle gaps,
    each named by the innermost benchmark span that covers it on the host.
"""

from __future__ import annotations

import re
import time
from collections import Counter, defaultdict

import numpy as np
import torch

# the kernels whose roofline the benchmark reads: wrapper name -> symbol
KERNELS = {"dw_corr3x3": "dw_corr3x3_kernel", "sa_mlp_max": "sa_mlp_max_kernel"}
TOP = 10
COUNTERS = ("launches", "launches_bf16", "flops")


class Profiled:
    """A profiler session over the block (CUDA activity on the card; on the
    CPU, host activity, which records no device work); `prof` is the
    profiler once the block has closed."""

    def __init__(self, device: torch.device):
        self.device = device
        self.prof = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        act = ProfilerActivity.CUDA if self.device.type == "cuda" else ProfilerActivity.CPU
        self._cm = profile(activities=[act])
        self.prof = self._cm.__enter__()
        return self

    def __exit__(self, *exc):
        return self._cm.__exit__(*exc)


def _named(symbol: str, name: str) -> bool:
    return re.search(rf"(?<![A-Za-z0-9_]){re.escape(symbol)}(?![A-Za-z0-9_])", name) is not None


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _inside(points, merged) -> np.ndarray:
    """Which of `points` lie inside one of the merged intervals."""
    if not merged or not len(points):
        return np.zeros(len(points), bool)
    starts = np.asarray([m[0] for m in merged], np.int64)
    ends = np.asarray([m[1] for m in merged], np.int64)
    pts = np.asarray(points, np.int64)
    i = np.searchsorted(starts, pts, side="right") - 1
    ok = i >= 0
    return ok & (pts <= ends[np.clip(i, 0, None)])


def read(prof, spans: list) -> dict:
    """The trace against the benchmark's spans [(name, thread, start ns,
    end ns)]."""
    t_read = time.perf_counter()
    from torch.autograd import DeviceType

    dev, runtime, rt_names = [], {}, Counter()
    t_min, t_max = None, None
    for e in prof.profiler.kineto_results.events():
        s, d = e.start_ns(), e.duration_ns()
        t_min = s if t_min is None or s < t_min else t_min
        t_max = s + d if t_max is None or s + d > t_max else t_max
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                dev.append((s, s + d, e.name(), e.correlation_id()))
        elif e.correlation_id():
            runtime[e.correlation_id()] = (e.start_thread_id(), s)
            rt_names[e.name()] += 1
    window_ns = (t_max - t_min) if t_min is not None else 0
    busy = _merge([(r[0], r[1]) for r in dev])
    busy_ns = sum(e - s for s, e in busy)

    # device time launched inside each span, by the launching thread where
    # the trace names threads as the spans do
    launch = [runtime.get(r[3]) for r in dev]
    l_tid = np.asarray([x[0] if x else -1 for x in launch], np.int64)
    l_t = np.asarray([x[1] if x else 0 for x in launch], np.int64)
    linked = l_tid >= 0
    by_thread = bool({tid for _, tid, _, _ in spans} & set(l_tid[linked].tolist()))
    durations = np.asarray([r[1] - r[0] for r in dev], np.int64)
    named = defaultdict(lambda: defaultdict(list))
    for name, tid, s, e in spans:
        named[name][tid if by_thread else 0].append((s, e))
    span_s, span_records, span_calls = {}, {}, {}
    for name, threads in named.items():
        hit = np.zeros(len(dev), bool)
        for tid, ivs in threads.items():
            mine = np.flatnonzero(linked & ((l_tid == tid) if by_thread else True))
            hit[mine] |= _inside(l_t[mine], _merge(ivs))
        span_s[name] = float(durations[hit].sum()) / 1e9
        span_records[name] = int(hit.sum())
        span_calls[name] = sum(len(v) for v in threads.values())

    kernel_s = {k: sum(r[1] - r[0] for r in dev if _named(sym, r[2])) / 1e9 for k, sym in KERNELS.items()}
    kernel_records = {k: sum(_named(sym, r[2]) for r in dev) for k, sym in KERNELS.items()}

    by_name = defaultdict(int)
    for r in dev:
        by_name[r[2]] += r[1] - r[0]
    device_ops = [[n[:120], v / 1e9] for n, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]]

    gaps = [(busy[i + 1][0] - busy[i][1], busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)]
    if busy:
        gaps += [(busy[0][0] - t_min, t_min, busy[0][0]), (t_max - busy[-1][1], busy[-1][1], t_max)]
    idle_gaps = []
    for length, a, b in sorted(gaps, reverse=True)[:TOP]:
        label, best = "host:other", None
        for name, _, s, e in spans:
            if name != "pass" and s <= a and e >= b and (best is None or e - s < best):
                label, best = f"host:{name}", e - s
        idle_gaps.append([label, length / 1e9])
    return {"window_s": window_ns / 1e9, "busy_s": busy_ns / 1e9, "device_records": len(dev),
            "unlinked_records": int((~linked).sum()), "by_thread": by_thread,
            "runtime_calls": dict(rt_names.most_common(6)), "span_device_s": span_s,
            "span_records": span_records, "span_calls": span_calls, "kernel_device_s": kernel_s,
            "kernel_records": kernel_records, "breakdown": {"device_ops": device_ops, "idle_gaps": idle_gaps},
            "read_s": time.perf_counter() - t_read}


class KernelCalls:
    """Records the shapes of each hand-written kernel call while installed
    (the module attributes that the port's dispatch looks up)."""

    def __init__(self):
        self.dw: list = []
        self.sa: list = []
        self._saved = []

    def install(self) -> None:
        from ossid_code_torch.ops import conv, sa_fused

        def wrap(mod, name, record):
            fn = getattr(mod, name)

            def call(*args, **kwargs):
                record(*args, **kwargs)
                return fn(*args, **kwargs)
            # the port's wrappers count their launches on the name they are
            # bound to: the counters move to the stand-in and back
            for a in COUNTERS:
                setattr(call, a, getattr(fn, a))
            self._saved.append((mod, name, fn, call))
            setattr(mod, name, call)

        def dw(x, kernel, cross=False):
            self.dw.append((tuple(x.shape), tuple(x.stride()), tuple(kernel.shape), tuple(kernel.stride()),
                            x.element_size(), bool(cross)))

        def dx(dout, kernel):
            self.dw.append((tuple(dout.shape), tuple(dout.stride()), tuple(kernel.shape), tuple(kernel.stride()),
                            dout.element_size(), False))

        def sa(xyz, feats, center_idx, group_idx, Ws, bs):
            self.sa.append({"m": xyz.shape[0], "n": xyz.shape[1], "cf": feats.shape[2], "s": group_idx.shape[0],
                            "k": group_idx.shape[1], "dims": [3 + feats.shape[2]] + [int(w.shape[1]) for w in Ws],
                            "w_bytes": sum(w.numel() * w.element_size() + 4 * b.numel() for w, b in zip(Ws, bs)),
                            "elt": feats.element_size()})
        wrap(conv, "dw_corr3x3_cuda", dw)
        wrap(conv, "dw_corr3x3_dx_cuda", dx)
        wrap(sa_fused, "sa_mlp_max_cuda", sa)

    def remove(self) -> None:
        for mod, name, fn, call in reversed(self._saved):
            for a in COUNTERS:
                setattr(fn, a, getattr(call, a))
            setattr(mod, name, fn)
        self._saved = []
