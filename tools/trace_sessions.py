#!/usr/bin/env python3
"""Does a profiling session lose the device records of its first launches
once a process has opened many sessions?

    python3 tools/trace_sessions.py [--sessions 42]   (needs one NVIDIA GPU)

One detect (T=10) a session, one session after another (CUDA activity
only as chip_smoke.trace_pass, CPU and CUDA as chip_smoke.profile_call,
and utils/profiling.py::trace in turn); every 6 sessions, phase 15f's
traced window (5 detect and score calls, utils/profiling.py::trace): the
runtime's launch calls that left no device record (by correlation id,
their ms after the trace's first record), kernel 1's among them
(chip_smoke.launches_without_record), and when the first device record
came. Then the same window with a sleep kernel launched first, and with a
0.5 s idle lead after the profile opens. One JSON line a window. PR 14:
none lost up to 12 sessions, 1 from 18, 2 from 36 (H100 80GB HBM3, 700 W;
also with TEARDOWN_CUPTI=0 in the environment).
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sessions", type=int, default=42)
    args = ap.parse_args()
    import numpy as np
    import torch
    from torch.autograd import DeviceType

    import chip_smoke as cs
    from ossid_code_torch.core.config import default_config
    from ossid_code_torch.models.dtoid.module import DtoidModel
    from ossid_code_torch.models.zephyr.module import ZephyrModel
    from ossid_code_torch.ops import conv, sa_fused as sa
    from ossid_code_torch.scripts import roofline
    from ossid_code_torch.utils import profiling

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    det_fn, det_args = roofline.detect_program(DtoidModel(default_config(), seed=0, device="cuda"),
                                               np.random.default_rng(1))
    zm = ZephyrModel(num_points=cs.NUM_POINTS, inconst_ratio_th=100.0, seed=0, need_uv=False, device="cuda")
    sc_fn, sc_args = roofline.score_program(zm, roofline.score_inputs(np.random.default_rng(1)), 128)
    det_fn(*det_args)
    sc_fn(*sc_args)
    t_start = time.perf_counter()

    def window(prime=None, lead_s=0.0) -> dict:
        read = cs.zero_launches(conv, sa)
        with tempfile.TemporaryDirectory() as d:
            with profiling.trace(d) as prof:
                time.sleep(lead_s)
                if prime:
                    prime()
                for _ in range(5):
                    det_fn(*det_args)
                    sc_fn(*sc_args)
        raw = prof.profiler.kineto_results.events()
        t0 = min(e.start_ns() for e in raw)
        recorded = {e.correlation_id() for e in raw if e.device_type() == DeviceType.CUDA}
        launches = [e for e in raw if e.device_type() == DeviceType.CPU and "Launch" in e.name()]
        lost = [round((e.start_ns() - t0) / 1e6, 3) for e in launches if e.correlation_id() not in recorded]
        first = min(e.start_ns() for e in raw if e.device_type() == DeviceType.CUDA)
        return {"kernel1_launched": read()["dw_corr3x3"], "runtime_launches": len(launches),
                "lost_ms": lost[:20], "lost": len(lost),
                "kernel1_lost": cs.launches_without_record(prof, "dw_corr3x3", "dw_corr3x3_kernel"),
                "first_device_record_ms": (first - t0) / 1e6}

    for session in range(1, args.sessions + 1):
        if session % 3 == 0:
            cs.trace_pass(torch, lambda: det_fn(*det_args))
        elif session % 3 == 1:
            cs.profile_call(torch, lambda: det_fn(*det_args))
        else:
            with tempfile.TemporaryDirectory() as d, profiling.trace(d):
                det_fn(*det_args)
        if session % 6 == 0:
            print(json.dumps({"sessions": session, "s": round(time.perf_counter() - t_start, 1), **window()}),
                  flush=True)
    print(json.dumps({"primed with a sleep kernel": True, **window(prime=lambda: torch.cuda._sleep(1_000_000))}))
    print(json.dumps({"lead_s": 0.5, **window(lead_s=0.5)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
