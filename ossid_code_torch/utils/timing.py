"""Wall-clock stage timing, feeding the per-frame `time_*` result fields that the
reference records (ref scripts/online_learning.py:345-347,584-589); the port's
copy of ossid_code_tpu/utils/timing.py. A timed region measures device work
only if it ends by waiting for the device's results (the loop's stages fetch
theirs to the host).
"""

from __future__ import annotations

import time


class Timer:
    """Context-manager wall-clock timer; `.interval` holds elapsed seconds."""

    interval = 0.0

    def __enter__(self):
        self.start = time.perf_counter()
        return self

    def __exit__(self, *args):
        self.interval = time.perf_counter() - self.start
