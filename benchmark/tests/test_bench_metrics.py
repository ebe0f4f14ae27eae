"""The end-to-end metrics are taken over all the window's work: the rate
over every target and every second of every pass, the percentile over
every target of the window, not per pass."""

import importlib.util
import types
from pathlib import Path

import numpy as np
import pytest

METRICS = Path(__file__).resolve().parents[1] / "metrics"


def _read(name):
    spec = importlib.util.spec_from_file_location(f"metric_{name}", METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _run():
    rng = np.random.default_rng(3)
    passes = [{"targets": 72, "seconds": 16.0, "latency_s": list(rng.uniform(0.2, 0.5, 72))},
              {"targets": 72, "seconds": 20.0, "latency_s": list(rng.uniform(0.4, 1.5, 72))},
              {"targets": 30, "seconds": 5.0, "latency_s": list(rng.uniform(0.1, 0.2, 30))}]
    return types.SimpleNamespace(passes=passes)


def test_rate_is_all_targets_over_all_pass_seconds():
    assert _read("loop_targets_per_s")(_run()) == pytest.approx(174 / 41.0)


def test_p90_is_over_every_target_of_the_window():
    run = _run()
    every = [s for p in run.passes for s in p["latency_s"]]
    got = _read("target_latency_p90_ms")(run)
    assert got == pytest.approx(np.percentile(every, 90) * 1e3)
    per_pass = np.mean([np.percentile(p["latency_s"], 90) for p in run.passes]) * 1e3
    assert got != pytest.approx(per_pass)
    # at least ten targets lie beyond it
    assert sum(s * 1e3 > got for s in every) >= 10


def test_no_targets_reads_nothing():
    run = types.SimpleNamespace(passes=[])
    assert _read("loop_targets_per_s")(run) is None
    assert _read("target_latency_p90_ms")(run) is None
