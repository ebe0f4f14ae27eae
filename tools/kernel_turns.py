#!/usr/bin/env python3
"""Kernels 1 and 1b (the dw-corr forward in float32 and bf16, and 1b as the
step's dx) and kernel 2 (SA1 and SA2 at M = 128) of two trees, timed in
turns on one card.

    python3 tools/kernel_turns.py OLD_TREE NEW_TREE [--pairs N]   (needs one NVIDIA GPU)

Each tree is a checkout of the repo, e.g. a `git archive` unpacked under
_cmp/. For N pairs, in the order old, new, new, old, old, new, ..., a fresh
Python process in the tree's root imports that tree's own chip_smoke.py and
ossid_code_torch (building its kernels into its own _build/ the first time)
and times, with CUDA events (chip_smoke.cuda_ms: the median of 10 runs of 20
launches) and TF32 off: kernel 1 at serving's head and stem and at
configuration 1's head (T = 160); 1b at every main-path shape (serving's
head and stem, the step's forward and dx at batch 8, the farm's 2 x 10,
stem of 2 frames and 3 x 7, the head at T = 160); kernel 2 with
chip_smoke.measure_sa. The shapes are built here from seeds, through the
wrapper both trees have (ops/conv.py::dw_corr3x3_cuda, dw_corr3x3_dx_cuda),
so the two trees time the same inputs. Each kernel-1 result is held against
the plain version first (chip_smoke.DW_TOL), and each 1b result is compared
bit for bit with bf16(kernel 1 on the widened operands) (`bitwise`: the
count of elements that differ, 0 for each shape in a sound tree). Each run
also names the libcudart files the process maps and the tree's nvcc flags
(PR 14 compared the static runtime with `-cudart shared` this way). Prints
one JSON line a run, then every reading of each tree by shape. The card's
name and power limit come first.
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
g = torch.Generator(device="cuda").manual_seed(31)
r = lambda *s: torch.randn(*s, device="cuda", generator=g)
feat = r(1, 29, 39, 640)
cases = {  # label: (x, k, cross), float32; 1b takes their bf16 roundings
    "head T=10": (feat.expand(10, 29, 39, 640), r(10, 3, 3, 640), False),
    "stem": (r(1, 240, 320, 64), r(1, 3, 3, 64), False),
    "head T=160": (feat.expand(160, 29, 39, 640), r(160, 3, 3, 640), False),
    "step head b=8": (r(8, 29, 39, 640), r(8, 3, 3, 640), False),
    "step stem b=8": (r(8, 240, 320, 64), r(8, 3, 3, 64), False),
    "farm 2x10": (r(2, 29, 39, 640), r(10, 3, 3, 640), True),
    "farm stem F=2": (r(2, 240, 320, 64), r(1, 3, 3, 64).expand(2, 3, 3, 64), False),
    "farm 3x7": (r(3, 29, 39, 640), r(7, 3, 3, 640), True),
}
bf = lambda t: t[:1].bfloat16().expand(t.shape) if t.shape[0] > 1 and t.stride(0) == 0 else t.bfloat16()
wide = lambda t: t[:1].float().expand(t.shape) if t.shape[0] > 1 and t.stride(0) == 0 else t.float()
ms, bitwise = {}, {}
with torch.inference_mode():
    for label in ("head T=10", "stem", "head T=160"):
        x, k, cross = cases[label]
        cs.check_close(torch, label, conv.dw_corr3x3_cuda(x, k, cross=cross),
                       conv.depthwise_corr_plain(x, k, 1, cross=cross), cs.DW_TOL)
        ms["f32 " + label] = cs.cuda_ms(torch, lambda: conv.dw_corr3x3_cuda(x, k, cross=cross))
    calls = [(label, *cases[label], conv.dw_corr3x3_cuda) for label in cases]
    calls += [("dx " + label[5:], *cases[label], conv.dw_corr3x3_dx_cuda) for label in ("step head b=8", "step stem b=8")]
    for label, x, k, cross, fn in calls:
        x16, k16 = bf(x), bf(k)
        call = (lambda: fn(x16, k16)) if fn is conv.dw_corr3x3_dx_cuda else (lambda: fn(x16, k16, cross=cross))
        kw = k16.flip(1, 2) if fn is conv.dw_corr3x3_dx_cuda else k16
        want = conv.dw_corr3x3_cuda(wide(x16), wide(kw), cross=cross).bfloat16().view(torch.int16)
        got = call().view(torch.int16)
        torch.cuda.synchronize()
        bitwise["bf16 " + label] = int((got != want).sum())
        ms["bf16 " + label] = cs.cuda_ms(torch, call)
    scene = cs.make_scene(np.random.default_rng(0))
    zephyr = ZephyrModel(num_points=cs.NUM_POINTS, inconst_ratio_th=100.0, seed=0, need_uv=False, device=dev)
    prep = zephyr.prepare_object(scene["obj_id"], scene["model_points"], scene["model_colors"], scene["model_normals"])
    ms.update({r["shape"]: r["ms"] for r in cs.measure_sa(torch, sa, zephyr, prep, 128)})
with open("/proc/self/maps") as f:
    mapped = sorted({ln.split()[-1] for ln in f if "libcudart" in ln})
print(json.dumps({"ms": ms, "bitwise": bitwise, "libcudart": mapped, "nvcc_flags": list(build.NVCC_FLAGS)}))
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
