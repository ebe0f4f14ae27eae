#!/usr/bin/env python3
"""The benchmark of two trees in turns, on one card.

    python3 tools/bench_turns.py <old tree> <new tree> --workload lmo_t10_ttt --seed N [--seed M]
        [--seconds 30] [--out DIR]   (needs one NVIDIA GPU)

For each cell and seed, runs `python3 -m benchmark.run --workload <cell>
--seed <n> --seconds <s> --trace 0` from the old tree's directory, then the
new tree's twice, then the old tree's (old, new, new, old), each tree with
its own program and its own benchmark files. Writes each run's standard
output and error under `--out` (default `_cmp/turns/`, which git ignores;
`<cell>_<seed>_<i>_<old|new>.out` / `.err`)
and prints one JSON line a run: the tree, its exit code and the result
line's `correct`, end-to-end numbers and pass seconds; then one line a cell with each
tree's medians. The card's name and power limit come first.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ORDER = ("old", "new", "new", "old")


def run_one(tree: Path, workload: str, seed: int, seconds: int, stem: Path) -> dict:
    cmd = [sys.executable, "-m", "benchmark.run", "--workload", workload, "--seed", str(seed),
           "--seconds", str(seconds), "--trace", "0"]
    p = subprocess.run(cmd, cwd=tree, capture_output=True, text=True)
    stem.with_suffix(".out").write_text(p.stdout)
    stem.with_suffix(".err").write_text(p.stderr)
    lines = p.stdout.strip().splitlines()
    try:
        result = json.loads(lines[-1]) if lines else {}
    except json.JSONDecodeError:
        result = {}
    metrics = {k: v["value"] for k, v in result.get("metrics", {}).items()}
    return {"rc": p.returncode, "correct": result.get("correct"), "end_to_end": metrics,
            "passes": result.get("passes")}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("old", type=Path)
    ap.add_argument("new", type=Path)
    ap.add_argument("--workload", action="append", required=True)
    ap.add_argument("--seed", type=int, action="append", required=True)
    ap.add_argument("--seconds", type=int, default=30)
    ap.add_argument("--out", type=Path, default=ROOT / "_cmp" / "turns")
    args = ap.parse_args()
    args.out.mkdir(parents=True, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"card": smi}), flush=True)
    trees = {"old": args.old.resolve(), "new": args.new.resolve()}
    for workload in args.workload:
        got: dict = {"old": [], "new": []}
        for seed in args.seed:
            for i, side in enumerate(ORDER):
                r = run_one(trees[side], workload, seed, args.seconds, args.out / f"{workload}_{seed}_{i}_{side}")
                got[side].append(r["end_to_end"])
                print(json.dumps({"workload": workload, "seed": seed, "turn": i, "tree": side, **r}), flush=True)
        medians = {side: {k: statistics.median(e[k] for e in runs if k in e)
                          for k in sorted({k for e in runs for k in e})}
                   for side, runs in got.items()}
        print(json.dumps({"workload": workload, "medians": medians}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
