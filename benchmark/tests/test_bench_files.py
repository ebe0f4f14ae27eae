"""A cell, a configuration, a traffic mix and a metric are files found by
name: a copy of the benchmark gains two tiny cells and a metric by files and
entries alone (tiny.py), and runs them on the CPU."""

import json

import pytest

from benchmark.tests.tiny import run_cell

DUMMY = "def read(run):\n    \"\"\"Passes in the window.\"\"\"\n    return float(len(run.passes))\n"


@pytest.fixture(scope="module")
def with_metric(tiny_copy):
    (tiny_copy / "benchmark" / "metrics" / "dummy_passes.py").write_text(DUMMY)
    spec = json.loads((tiny_copy / "BENCHMARK.json").read_text())
    if not any(m["name"] == "dummy_passes" for m in spec["end_to_end"]):
        spec["end_to_end"].append({"name": "dummy_passes", "unit": "passes", "better": "higher", "bound": 0.25,
                                   "source": "host_clock", "workloads": ["tiny_serve"]})
    (tiny_copy / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return tiny_copy


def test_an_added_cell_runs_with_its_metric(with_metric):
    rc, res, err = run_cell(with_metric, "tiny_serve", 2**31 + 11)
    assert rc == 0, err[-4000:]
    assert res["correct"] is True, err[-4000:]
    assert set(res["metrics"]) == {"loop_targets_per_s", "target_latency_p90_ms", "setup_s", "dummy_passes"}
    assert res["metrics"]["dummy_passes"]["value"] >= 1
    assert res["attempted"] > 0 and res["failed"] == 0
    assert list(res)[-1] == "checked" and res["checked"]
    assert all(c["value"] <= c["limit"] for c in res["checked"].values())


def test_the_finetune_cell_runs_traced(with_metric):
    rc, res, err = run_cell(with_metric, "tiny_ttt", 2**33 + 5, trace=1)
    assert rc == 0, err[-4000:]
    assert res["correct"] is True, err[-4000:]
    spec = json.loads((with_metric / "BENCHMARK.json").read_text())
    assert set(res["metrics"]) <= {m["name"] for m in spec["per_layer"]}
    assert {"ppf_ms", "spec_hit_pct"} <= set(res["metrics"])
    assert {"grad_gap", "update_gap", "window_loss_gap", "window_update_gap", "det_p90", "score_gap",
            "schedule_steps", "schedule_events"} <= set(res["checked"])
    assert "busy_s" in res["device"] and "window_s" in res["device"]


def test_a_directory_without_the_program_prints_no_result(tmp_path):
    import shutil
    from benchmark.tests.tiny import REPO

    shutil.copytree(REPO / "benchmark", tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    rc, res, err = run_cell(tmp_path, "lmo_t160_serve", 1)
    assert rc != 0 and res is None
