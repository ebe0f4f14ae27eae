#!/usr/bin/env python3
"""Kernels 3 / 3b (dk of the dw-corr backward) of two trees, timed in turns
on one card.

    python3 tools/dk_turns.py OLD_TREE NEW_TREE [--pairs N]   (needs one NVIDIA GPU)

Each tree is a checkout of the repo, e.g. a `git archive` unpacked under
_cmp/. For N pairs, in the order old, new, new, old, old, new, ..., a fresh
Python process in the tree's root imports that tree's own chip_smoke.py and
ossid_code_torch (building its kernels into its own _build/ the first time)
and times dk with chip_smoke.measure_dw_bwd at the finetune's head and stem
shapes (chip_smoke.dw_bwd_cases), in float32 and bf16: CUDA events, the
median of 10 runs of 20 launches, each result held against the plain
version first. Prints one JSON line a run, then every reading of each tree
by shape and dtype. The card's name and power limit come first.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

RUN = """
import json, sys, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from ossid_code_torch.ops import conv
torch.backends.cudnn.allow_tf32 = False
ms = {}
for bf16 in (False, True):
    tols = (2 * cs.BF16_STEP, 2 * cs.BF16_STEP + 1e-4) if bf16 else (cs.DX_TOL, cs.DK_TOL)
    cases = cs.dw_bwd_cases(torch, torch.device("cuda"), bf16)[:2]
    with torch.inference_mode():
        for (label, *_), row in zip(cases, cs.measure_dw_bwd(torch, conv, cases, tols)):
            ms[label + (", bf16" if bf16 else ", float32")] = row["ms"]
print(json.dumps(ms))
"""


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("old", type=Path)
    ap.add_argument("new", type=Path)
    ap.add_argument("--pairs", type=int, default=3)
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip())
    trees = {"old": args.old, "new": args.new}
    readings: dict[str, dict[str, list[float]]] = {"old": {}, "new": {}}
    order = [("old", "new") if i % 2 == 0 else ("new", "old") for i in range(args.pairs)]
    for which in (w for pair in order for w in pair):
        proc = subprocess.run([sys.executable, "-c", RUN], cwd=trees[which], capture_output=True, text=True)
        if proc.returncode != 0:
            print(f"dk_turns: the {which} tree's run failed:\n{proc.stderr[-3000:]}", file=sys.stderr)
            return 1
        ms = json.loads(proc.stdout.strip().splitlines()[-1])
        print(json.dumps({"tree": which, **ms}))
        for key, t in ms.items():
            readings[which].setdefault(key, []).append(t)
    print(json.dumps({"readings_ms": readings}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
