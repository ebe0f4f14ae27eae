#!/usr/bin/env python3
"""Kernel 1 (head and stem) and kernel 2 (SA1 and SA2 at M = 128) of two
trees, timed in turns on one card.

    python3 tools/kernel_turns.py OLD_TREE NEW_TREE [--pairs N]   (needs one NVIDIA GPU)

Each tree is a checkout of the repo, e.g. a `git archive` unpacked under
_cmp/. For N pairs, in the order old, new, new, old, old, new, ..., a fresh
Python process in the tree's root imports that tree's own chip_smoke.py and
ossid_code_torch (building its kernels into its own _build/ the first time)
and times the kernels with chip_smoke.measure_dw_corr and measure_sa at the
serving shapes (CUDA events, the median of 10 runs of 20 launches, each
result held against the plain version first), with TF32 off. Each run also
names the libcudart files the process maps and the tree's nvcc flags (PR
14 compared the static runtime with `-cudart shared` this way). Prints one
JSON line a run, then every reading of each tree by shape. The card's name
and power limit come first.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

RUN = """
import json, sys, numpy as np, torch
import torch.nn.functional as F
sys.path.insert(0, ".")
import chip_smoke as cs
from ossid_code_torch.kernels import build
from ossid_code_torch.models.zephyr.module import ZephyrModel
from ossid_code_torch.ops import conv, sa_fused as sa
build.build(["dw_corr3x3", "sa_mlp_max"])
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda")
scene = cs.make_scene(np.random.default_rng(0))
zephyr = ZephyrModel(num_points=cs.NUM_POINTS, inconst_ratio_th=100.0, seed=0, need_uv=False, device=dev)
prep = zephyr.prepare_object(scene["obj_id"], scene["model_points"], scene["model_colors"], scene["model_normals"])
with torch.inference_mode():
    rows = (cs.measure_dw_corr(torch, F, conv, cs.dw_corr_cases(torch, dev), cs.dw_check(torch, False))
            + cs.measure_sa(torch, sa, zephyr, prep, 128))
with open("/proc/self/maps") as f:
    mapped = sorted({ln.split()[-1] for ln in f if "libcudart" in ln})
print(json.dumps({"ms": {r["shape"]: r["ms"] for r in rows}, "libcudart": mapped,
                  "nvcc_flags": list(build.NVCC_FLAGS)}))
"""


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("old", type=Path)
    ap.add_argument("new", type=Path)
    ap.add_argument("--pairs", type=int, default=2)
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
            print(f"kernel_turns: the {which} tree's run failed:\n{proc.stderr[-3000:]}", file=sys.stderr)
            return 1
        out = json.loads(proc.stdout.strip().splitlines()[-1])
        print(json.dumps({"tree": which, **out}))
        for key, t in out["ms"].items():
            readings[which].setdefault(key, []).append(t)
    print(json.dumps({"readings_ms": readings}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
