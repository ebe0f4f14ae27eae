#!/usr/bin/env python3
"""The DTOID train step of two trees, float32 and bf16, timed in turns on one
card.

    python3 tools/step_turns.py OLD_TREE NEW_TREE [--pairs N]   (needs one NVIDIA GPU)

Each tree is a checkout of the repo, e.g. a `git archive` unpacked under
_cmp/. For N pairs, in the order old, new, new, old, old, new, ..., a fresh
Python process in the tree's root imports that tree's own chip_smoke.py and
ossid_code_torch and times `train_step_u8` at batch 8 at full width
(chip_smoke.time_train_step: the host clock of 5 steps after a warm-up,
synchronised; the host spans where the tree records them), once with a
float32 model and once with `bf16_finetune`, from the same weights. Prints
one JSON line a run, then every reading of each tree. The card's name and
power limit come first.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

RUN = """
import json, sys, numpy as np, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from ossid_code_torch.core.config import default_config
from ossid_code_torch.models.dtoid.module import DtoidModel
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
cfg = default_config()
out = {}
for bf16 in (False, True):
    m = DtoidModel(cfg.merged({"model": {"bf16_finetune": bf16}}), seed=1, device=torch.device("cuda"))
    cs.perturb_heads(m.net, 2)
    r = cs.time_train_step(torch, m, np.random.default_rng(5), steps=5)
    ms, spans = r if isinstance(r, tuple) else (r, {})
    out["bf16" if bf16 else "float32"] = {"ms": ms, "spans_ms": spans}
    del m
    torch.cuda.empty_cache()
print(json.dumps(out))
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
            print(f"step_turns: the {which} tree's run failed:\n{proc.stderr[-3000:]}", file=sys.stderr)
            return 1
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        print(json.dumps({"tree": which, **res}))
        for key, r in res.items():
            readings[which].setdefault(key, []).append(r["ms"])
    print(json.dumps({"readings_ms": readings}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
