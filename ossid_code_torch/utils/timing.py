"""Wall-clock stage timing, feeding the per-frame `time_*` result fields that the
reference records (ref scripts/online_learning.py:345-347,584-589); the port's
copy of ossid_code_tpu/utils/timing.py. A timed region measures device work
only if it ends by waiting for the device's results (the loop's stages fetch
theirs to the host); `utils/profiling.py::device_timer` times the card itself.
"""

from __future__ import annotations

import time


class Timer:
    """Context-manager wall-clock timer; `.interval` holds elapsed seconds.
    With `agg_list` each exit appends (heading, interval) to it; `verbose`
    prints the two."""

    def __init__(self, heading: str = "", agg_list: list | None = None, verbose: bool = False):
        self.heading = heading
        self.agg_list = agg_list
        self.verbose = verbose
        self.interval = 0.0

    def __enter__(self):
        self.start = time.perf_counter()
        return self

    def __exit__(self, *args):
        self.interval = time.perf_counter() - self.start
        if self.agg_list is not None:
            self.agg_list.append((self.heading, self.interval))
        if self.verbose:
            print(f"{self.heading} {self.interval:.4f}s")


class _StageTimer(Timer):
    def __init__(self, stages: "StageTimes", name: str):
        super().__init__(heading=name)
        self._stages = stages

    def __exit__(self, *args):
        super().__exit__(*args)
        times = self._stages.times
        times[self.heading] = (times.get(self.heading) or 0.0) + self.interval


class StageTimes:
    """Accumulates named stage durations for one frame of the online loop: a
    stage timed more than once holds the sum of its intervals.

    JAX's class sets `__exit__` on the Timer instance, which a `with`
    statement never calls (it looks the method up on the type), so there a
    `with stages.timer(name):` block records nothing; the port's timer
    subclass records it (ROADMAP.md §3, faults of the reference)."""

    def __init__(self):
        self.times: dict[str, float | None] = {}

    def timer(self, name: str) -> Timer:
        return _StageTimer(self, name)

    def get(self, name: str, default=None):
        return self.times.get(name, default)
