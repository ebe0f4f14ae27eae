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
