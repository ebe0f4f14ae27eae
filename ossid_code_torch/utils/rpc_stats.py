"""Per-run accounting of device->host fetches and speculation outcomes (the
port's copy of ossid_code_tpu/utils/rpc_stats.py, same kinds and semantics).

The pipelined loop dispatches detections ahead and fetches their results,
bundled with deferred completions, on a fetch thread. Whether that schedule
works shows in these counts: how many fetches a frame takes, how long each
took, how long the main thread blocked on one, and whether the next-frame
speculation hit. Beside the JAX package's kinds the port counts
`spec_redispatch`: a speculative detection that a finetune made stale and
that is dispatched again before its frame comes (its frame then counts a
hit), so that a run's detections are its targets plus spec_stale plus
spec_redispatch. On the card a fetch is one device->host transfer of a
bundle: copies into pinned host memory and an event after them, the fetch
waiting on that event (utils/host_copy.py). The loop records into STATS;
a caller resets it before a run and reads it after.

Counters are thread-safe: the fetch and IO threads record too.

Beside the counters, a span log: `span(name, ids)` records (name, native
thread id, start ns, end ns, ids) on the clock the profiler stamps its
records with (`time.time_ns`), while a `torch.profiler` session is active
or `spans_on` is set; otherwise a span costs one flag check. A profiler
session is its own thread's (PyTorch keeps the profiler's state per
thread): the work a thread hands to side threads records spans inside
`across_threads()`, which the loop's `run` enters. `ids` ties the spans of
one target ((obj_id, scene_id, im_id)) or of one finetune event (its
index). Spans nest on each thread, except the latency spans
(LATENCY_SPANS), which run from one moment of a target to another across
other spans; a name ending in `.wait` is a block on another thread or on
the device. The loop's thread is the thread of its `iteration` spans
(`loop_thread_spans`); its `iteration` and `complete` spans (OUTER_SPANS)
hold the stages of a target's dispatch half and of its completion.
"""

from __future__ import annotations

import contextlib
import threading
import time

import torch

# spans that measure a target's wait between two points, not work
LATENCY_SPANS = ("queue", "deferred")
# the loop's spans around a target's dispatch half and its completion
OUTER_SPANS = ("iteration", "complete")
_OFF = contextlib.nullcontext()


class RunStats:
    def __init__(self):
        self._lock = threading.Lock()
        # spans are recorded while this is set, or while a profiler runs
        self.spans_on = False
        # open across_threads() blocks that found spans on
        self._shared = 0
        self.reset()

    def reset(self):
        with self._lock:
            # event counters (speculation outcomes, ...)
            self.counts: dict[str, int] = {}
            # fetch timings: kind -> [n_calls, total_seconds]
            self.rpcs: dict[str, list] = {}
            # (name, native thread id, start ns, end ns, ids), in end order
            self.spans: list = []

    def count(self, kind: str, n: int = 1):
        with self._lock:
            self.counts[kind] = self.counts.get(kind, 0) + n

    def rpc(self, kind: str, seconds: float):
        """Kinds ending in '_wait' are main-thread blocks on side-thread
        futures, not fetches: reported, but left out of the per-frame
        fetch count."""
        with self._lock:
            e = self.rpcs.setdefault(kind, [0, 0.0])
            e[0] += 1
            e[1] += seconds

    # ------------------------------------------------------------- spans
    def spans_enabled(self) -> bool:
        return self.spans_on or self._shared > 0 or torch._C._autograd._profiler_enabled()

    @contextlib.contextmanager
    def across_threads(self):
        """Where spans are on for the calling thread, on for every thread
        while the block runs: a profiler session on the calling thread
        otherwise leaves the side threads that work for it unrecorded."""
        on = self.spans_enabled()
        if on:
            self._shared += 1
        try:
            yield
        finally:
            if on:
                self._shared -= 1

    def now(self) -> int | None:
        """The span clock's time, or None while spans are off."""
        return time.time_ns() if self.spans_enabled() else None

    def span(self, name: str, ids=None):
        """A context manager that records the block as a span."""
        return _Span(self, name, ids) if self.spans_enabled() else _OFF

    def add_span(self, name: str, start_ns: int | None, end_ns: int | None = None, ids=None) -> None:
        """Record a span whose start was taken earlier (by `now()`); a start
        of None (spans were off) records nothing."""
        if start_ns is None or not self.spans_enabled():
            return
        end_ns = time.time_ns() if end_ns is None else end_ns
        with self._lock:
            self.spans.append((name, threading.get_native_id(), start_ns, end_ns, ids))

    # ------------------------------------------------------------- reporting
    def snapshot(self) -> dict:
        with self._lock:
            return {
                "counts": dict(self.counts),
                "rpcs": {k: (v[0], v[1]) for k, v in self.rpcs.items()},
                "spans": list(self.spans),
            }

    def fetch_rpcs_per_frame(self, n_frames: int) -> float:
        s = self.snapshot()
        return sum(n for k, (n, _) in s["rpcs"].items()
                   if not k.endswith("_wait")) / max(n_frames, 1)

    def spec_hit_rate(self) -> float | None:
        c = self.snapshot()["counts"]
        hits = c.get("spec_hit", 0)
        total = hits + c.get("spec_stale", 0) + c.get("spec_absent", 0)
        return hits / total if total else None


def loop_thread_spans(spans: list) -> list:
    """The spans of the loop's thread, the thread of the `iteration` spans
    (every span's where there is none), the latency spans left out."""
    loop = {tid for name, tid, *_ in spans if name == "iteration"}
    return [sp for sp in spans if (not loop or sp[1] in loop) and sp[0] not in LATENCY_SPANS]


class _Span:
    __slots__ = ("stats", "name", "ids", "t0")

    def __init__(self, stats: RunStats, name: str, ids):
        self.stats, self.name, self.ids = stats, name, ids

    def __enter__(self):
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.stats.add_span(self.name, self.t0, ids=self.ids)


# module-level instance shared by the loop and its callers
STATS = RunStats()
