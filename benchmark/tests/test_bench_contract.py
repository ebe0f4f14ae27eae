"""BENCHMARK.json against the shape the benchmark's checker takes: keys,
names, units, sources, bounds, the files each entry names, and the time a
full check of 24 cells takes at `run_seconds`."""

import importlib.util
import json
import re
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n\r]{1,200}$")


def test_top_level_keys_and_paths():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(SPEC["paths"]) <= 16
    for p in SPEC["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and not p.startswith("/") and ".." not in p
        assert (REPO / p).is_dir()
    assert 1 <= len(SPEC["command"]) <= 32 and all(LINE.match(w) for w in SPEC["command"])
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    # a full check of 24 cells fits its 43,200 s
    assert (2 + 14 * 24) * (SPEC["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert len(json.dumps(SPEC)) <= 64 * 1024


def test_configs_name_their_files_and_cuts():
    assert 1 <= len(SPEC["configs"]) <= 24
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert LINE.match(c["source"]) and LINE.match(c["why"])
        assert c["file"].startswith(tuple(p + "/" for p in SPEC["paths"]))
        body = json.loads((REPO / c["file"]).read_text())
        assert body["name"] == c["name"] and body["source"] == c["source"]
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert sorted(c["reduced"]) == sorted(body["reduced"])
        for k in c["reduced"]:
            assert not re.search(r"(_dim|_rank|width|hidden|channels|size)$", k)
            assert k in body["loop"] and k in body["assumed"]
    assert len({c["file"] for c in SPEC["configs"]}) == len(SPEC["configs"])
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}


def test_workloads_name_their_mixes_and_limits():
    assert 1 <= len(SPEC["workloads"]) <= 24
    pairs = set()
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and LINE.match(w["why"])
        assert w["chips"] in (1, 4)
        assert (REPO / "benchmark" / "traffic" / f"{w['traffic']}.json").is_file()
        assert (REPO / "benchmark" / "limits" / f"{w['name']}.json").is_file()
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    assert sum(w["chips"] == 4 for w in SPEC["workloads"]) <= max(1, len(SPEC["workloads"]) // 4)


def _cells_of(m):
    return m.get("workloads", [w["name"] for w in SPEC["workloads"]])


@pytest.mark.parametrize("m", SPEC["end_to_end"] + SPEC["per_layer"], ids=lambda m: m["name"])
def test_metric_entry_and_reader(m):
    keys = {"name", "unit", "better", "source"} | ({"bound"} if m in SPEC["end_to_end"] else {"layer", "moves"})
    assert set(m) - {"workloads"} == keys
    assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    if m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        if m["name"] == "setup_s":
            assert m["bound"] == 0.25
    else:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert LINE.match(m["layer"])
        moves = next(e for e in SPEC["end_to_end"] if e["name"] == m["moves"])
        assert set(_cells_of(m)) <= set(_cells_of(moves))
    if m["name"].endswith("_roofline") or "mfu" in m["name"].split("_"):
        assert m["unit"] == "%"
    path = REPO / "benchmark" / "metrics" / f"{m['name']}.py"
    spec = importlib.util.spec_from_file_location(f"reader_{m['name']}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert callable(mod.read)


def test_every_cell_reports_setup_another_end_to_end_metric_and_a_layer():
    names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(names) == len(set(names))
    for w in SPEC["workloads"]:
        e2e = [m["name"] for m in SPEC["end_to_end"] if w["name"] in _cells_of(m)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(w["name"] in _cells_of(m) for m in SPEC["per_layer"])
