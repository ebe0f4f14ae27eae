#!/usr/bin/env python3
"""Where the host's time goes in the benchmark's cells, from the program's
span log (ossid_code_torch/utils/rpc_stats.py), and what the log costs.

    python3 tools/loop_spans.py --workload lmo_t10_ttt --workload lmo_t160_serve --seed N [--pairs 3]
        (needs one NVIDIA GPU)

For each cell of BENCHMARK.json named, one process builds the benchmark's
session (benchmark/drive.py: the world and weights from the seed, set-up as
a measured run has it), then:
  1. one traced pass (the benchmark's trace: a torch.profiler session of
     CUDA activity alone, opened first), with the spans the session turns
     on: the device's idle time by the host span that was running
     (utils/profiling.py::device_summary(prof, spans=)), each per-layer
     reader of the span log (benchmark/metrics/) on that pass, the
     host's split of the pass a target (dispatch + completion + waits +
     the finetune events) against the pass's seconds a target, and the IO
     and fetch threads' time a target (each span's, and each thread's busy
     time);
  2. `--pairs` pairs of untraced passes with `STATS.spans_on` false and
     true, in turns (off, on, on, off, ...): each pass's seconds, the
     median of each side and the share the spans cost;
  3. the host's cost of one span, off and on (a span around nothing, timed
     over many), times the traced pass's spans, over its seconds.
Prints one JSON line a cell; the card's name and power limit come first.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import tempfile
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

READERS = ("host_wait_ms", "dispatch_host_ms", "complete_host_ms", "feed_ms", "finetune_event_ms",
           "queue_wait_ms", "deferral_ms")


def spread(values: list) -> float:
    """The distance between the quartiles over the median."""
    q = statistics.quantiles(values, n=4)
    return (q[2] - q[0]) / statistics.median(values)


def span_cost_s(n: int = 20000) -> dict:
    """{spans on: the host's seconds a span costs} (a span around nothing)."""
    from ossid_code_torch.utils.rpc_stats import RunStats

    stats, out = RunStats(), {}
    for on in (False, True):
        stats.spans_on = on
        t0 = time.perf_counter()
        for _ in range(n):
            with stats.span("probe", (0, 0, 0)):
                pass
        out[on] = (time.perf_counter() - t0) / n
    return out


def side_threads_ms(spans: list, targets: int) -> dict:
    """The side threads' ms a target: {"spans": {name: summed ms}, "busy":
    {thread: the union of its spans}}, a thread named by its spans' first
    word (`io`, `fetch`)."""
    from benchmark.metrics.host_wait_ms import union

    loop = {tid for name, tid, *_ in spans if name == "iteration"}
    by_name, by_tid, words = {}, {}, {}
    for name, tid, start, end, _ in spans:
        if tid in loop:
            continue
        by_name[name] = by_name.get(name, 0.0) + (end - start) / 1e6 / targets
        by_tid.setdefault(tid, []).append((start, end))
        words.setdefault(tid, set()).add(name.split(".")[0])
    busy = {"+".join(sorted(words[tid])): sum(e - s for s, e in union(ivs)) / 1e6 / targets
            for tid, ivs in by_tid.items()}
    return {"spans": by_name, "busy": busy}


def cell(workload: str, seed: int, pairs: int, device) -> dict:
    import torch

    from benchmark import run as bench, trace
    from benchmark.drive import Session
    from benchmark.metrics.host_wait_ms import length_less, main_thread, union, waits
    from ossid_code_torch.utils.profiling import device_summary
    from ossid_code_torch.utils.rpc_stats import STATS

    spec = bench.load_json(ROOT / "BENCHMARK.json")
    c, entry = bench.cell_of(spec, workload)
    config = bench.load_json(ROOT / entry["file"])
    traffic = bench.load_json(ROOT / "benchmark" / "traffic" / f"{c['traffic']}.json")
    out = {"workload": workload, "seed": seed}
    with tempfile.TemporaryDirectory(prefix="loop_spans_") as root:
        t0 = time.perf_counter()
        session = Session(config, traffic, seed, device, root)
        session.prepare()
        out["setup_s"] = time.perf_counter() - t0

        traced = trace.Profiled(device)
        passes = session.measure(0, traced)
        spans = session.stats["spans"]
        run = types.SimpleNamespace(passes=passes, rows=[r["row"] for r in session.hooks.records],
                                    stats=session.stats)
        t1 = time.perf_counter()
        s = device_summary(traced.prof, spans=spans)
        targets = passes[0]["targets"]
        main = main_thread(run)
        finetune_ms = length_less(union(main.get("finetune", [])), waits(main)) / 1e6 / targets
        metrics = {name: bench.reader(name)(run) for name in READERS}
        split = sum(metrics[k] for k in ("host_wait_ms", "dispatch_host_ms", "complete_host_ms")) + finetune_ms
        pass_ms = 1e3 * passes[0]["seconds"] / targets
        out["traced"] = {
            "pass_s": passes[0]["seconds"], "targets": targets, "spans": len(spans),
            "window_s": s["window_ms"] / 1e3, "device_busy_s": s["device_busy_ms"] / 1e3,
            "device_idle_share": s["device_idle_share"], "idle_by_span_ms": s["idle_by_span"],
            "idle_in_stages_share": s["idle_in_stages_share"], "metrics": metrics,
            "finetune_host_ms": finetune_ms, "split_ms": split, "pass_ms": pass_ms,
            "split_over_pass": split / pass_ms, "side_threads_ms": side_threads_ms(spans, targets),
            "summary_s": time.perf_counter() - t1}

        seconds = {False: [], True: []}
        for i in range(2 * pairs):
            on = i % 4 in (1, 2)
            STATS.spans_on = on
            seconds[on] += [p["seconds"] for p in session.measure(0)]
            STATS.spans_on = False
        off, on = (statistics.median(seconds[k]) for k in (False, True))
        out["turns"] = {"off_s": seconds[False], "on_s": seconds[True], "median_off_s": off, "median_on_s": on,
                        "cost_share": on / off - 1.0,
                        "spread_off": spread(seconds[False]) if len(seconds[False]) > 1 else None,
                        "spread_on": spread(seconds[True]) if len(seconds[True]) > 1 else None}
        cost = span_cost_s()
        out["span_cost"] = {"off_us": 1e6 * cost[False], "on_us": 1e6 * cost[True],
                            "share_on": len(spans) * cost[True] / passes[0]["seconds"]}
        session.release()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", action="append", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--pairs", type=int, default=3)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args()
    import torch

    from benchmark import run as bench

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the spans' device numbers need the card (--device cpu for a rehearsal)")
    print(json.dumps({"card": bench.card_info()["nvidia_smi"] if device.type == "cuda" else "cpu",
                      "torch": torch.__version__}), flush=True)
    for workload in args.workload:
        print(json.dumps(cell(workload, args.seed, args.pairs, device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
