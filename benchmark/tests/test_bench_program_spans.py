"""The readers of the program's span log (`run.stats["spans"]`, the
traced pass's `STATS.snapshot()`), on one hand-made pass: two targets, the
first deferred past the second's dispatch and finetuning when it completes,
the second completed after the loop; side threads' spans beside them."""

import importlib.util
import types
from pathlib import Path

import pytest

METRICS = Path(__file__).resolve().parents[1] / "metrics"
READERS = ("host_wait_ms", "dispatch_host_ms", "complete_host_ms", "feed_ms", "finetune_event_ms", "queue_wait_ms",
           "deferral_ms")
A, B = (1, 0, 0), (2, 0, 0)
# (name, thread, start ms, end ms, ids); thread 1 runs the loop
SPANS = [("queue", 1, 0, 1, A), ("iteration", 1, 1, 30, A), ("frame.wait", 1, 1, 3, A),
         ("detect.dispatch", 1, 3, 6, A), ("detect.wait", 1, 6, 10, A), ("hypotheses", 1, 10, 20, A),
         ("score.dispatch", 1, 20, 25, A), ("deferred", 1, 30, 40, A), ("queue", 1, 2, 30, B),
         ("iteration", 1, 30, 70, B), ("detect.wait", 1, 32, 35, B), ("complete", 1, 40, 60, A),
         ("complete.wait", 1, 40, 44, A), ("label", 1, 44, 50, A), ("finetune", 1, 50, 58, 0),
         ("finetune.feed", 1, 50, 52, 0), ("finetune.step", 1, 52, 58, 0), ("row", 1, 58, 60, A),
         ("complete", 1, 70, 95, B), ("complete.wait", 1, 70, 75, B), ("label", 1, 75, 95, B),
         ("resolve.wait", 1, 95, 100, None), ("io.prefetch", 2, 0, 50, B), ("fetch.wait", 3, 0, 100, None)]
T0 = 1_700_000_000 * 10**9


def _read(name):
    spec = importlib.util.spec_from_file_location(f"metric_{name}", METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _run(spans=SPANS):
    stats = {"counts": {}, "rpcs": {}}
    if spans is not None:
        stats["spans"] = [(n, tid, T0 + a * 10**6, T0 + b * 10**6, ids) for n, tid, a, b, ids in spans]
    rows = [dict(zip(("obj_id", "scene_id", "im_id"), A), finetune=True, time_finetune=0.0375),
            dict(zip(("obj_id", "scene_id", "im_id"), B), finetune=False, time_finetune=0)]
    return types.SimpleNamespace(passes=[{"targets": 2, "seconds": 0.1}], rows=rows, stats=stats)


def test_each_reader_on_the_hand_made_pass():
    got = {name: _read(name)(_run()) for name in READERS}
    assert got == pytest.approx({
        # frame 2 + detect 4 + 3 + complete 4 + 5 + resolve 5 ms, over 2 targets
        "host_wait_ms": 23 / 2,
        # iterations 1-70 less A's completion (20) and their waits (9)
        "dispatch_host_ms": (69 - 20 - 9) / 2,
        # completions 40-60 and 70-95 less their waits (9) and the finetune (8)
        "complete_host_ms": (45 - 9 - 8) / 2,
        "feed_ms": 2.0, "finetune_event_ms": 37.5, "queue_wait_ms": (1 + 28) / 2, "deferral_ms": 10 / 2})


def test_the_host_splits_add_up_to_the_pass():
    """Dispatch, completion and waits, with the finetune's own time, give the
    main thread's time under its spans: here all of the pass but its first
    millisecond."""
    run = _run()
    split = sum(_read(name)(run) for name in ("host_wait_ms", "dispatch_host_ms", "complete_host_ms"))
    finetune = 8 / 2
    assert split + finetune == pytest.approx(99 / 2)
    assert split + finetune <= 1e3 * run.passes[0]["seconds"] / run.passes[0]["targets"]


@pytest.mark.parametrize("spans", [None, []], ids=["no_log", "empty_log"])
def test_without_spans_every_reader_reads_nothing(spans):
    """A program without the span log (`STATS.snapshot()` with no "spans"),
    or a pass that logged none, gives no reading, and raises nothing."""
    run = _run(spans)
    assert {name: _read(name)(run) for name in READERS} == dict.fromkeys(READERS)
