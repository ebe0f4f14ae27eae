#!/usr/bin/env python3
"""Kernel 1b (bf16, csrc/dw_corr3x3.cu): its two kernels (the tile and the
row walk) under the choice dw_corr3x3_bf16 makes and under other shapes, at
every main-path shape, on one card.

    python3 tools/dw_bf16_plans.py [--quick]   (needs one NVIDIA GPU; about 3 minutes)

Builds csrc/dw_corr3x3.cu and prints ptxas's registers and spills. Holds the
edges (chip_smoke.dw16_edge_cases) bit for bit against bf16(kernel 1 on the
widened operands) under chip_smoke.DW16_EDGE_SHAPES. Then, for each shape of
chip_smoke.dw16_cases: the same check under those shapes (and as dx), the
choice (kernel, its shape, shared memory, blocks, threads, blocks an SM
holds, registers), and the time (chip_smoke.cuda_ms: CUDA events, the
median of 10 runs of 20 launches) of the choice and of every other shape of
SHAPES that fits, beside the byte bound. --quick times the choice only. The
card's name and power limit come first; one JSON line a shape, then the
choice's time against the fastest shape's for each.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from ossid_code_torch.kernels import build  # noqa: E402
from ossid_code_torch.ops import conv  # noqa: E402

# (kernel, a, b, c): the tile (1: slice vectors, rows, templates a block),
# the row walk (2: templates, runs a block, rows a thread) and the row walk
# with 2 templates a thread (3: template pairs, runs, rows); 0: the choice's
SHAPES = ([(1, 0, ry, tg) for ry in (1, 2, 4) for tg in (1, 2, 4, 5, 8, 10, 16)]
          + [(1, 16, 1, 0), (1, 16, 2, 0)]
          + [(2, tw, rw, ry) for tw in (1, 2) for rw in (1, 2) for ry in (4, 8, 16)]
          + [(3, tw, rw, ry) for tw in (1, 2) for rw in (1, 2) for ry in (4, 8, 16)])


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true", help="time the choice only")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("dw_bf16_plans: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip())
    for src, log in build.build(["dw_corr3x3"]).items():
        for kernel, report in cs.ptxas_report(log):
            print(f"ptxas {src} {kernel}: {report}")
    dev = torch.device("cuda")
    summary = {}
    with torch.inference_mode():
        edges = cs.dw16_edge_cases(torch, dev)
        cs.check_dw16_bitwise(torch, conv, edges, cs.DW16_EDGE_SHAPES)
        print(f"edges bit for bit (and as dx) under {cs.DW16_EDGE_SHAPES}: {[label for label, *_ in edges]}")
        for label, x, k, cross in cs.dw16_cases(torch, dev):
            choice = cs.check_dw16_bitwise(torch, conv, [(label, x, k, cross)], cs.DW16_EDGE_SHAPES)[label]
            out_bytes = x.shape[0] * (k.shape[0] if cross else 1) * x[0].numel() * 2
            bound, by = cs.bound_ms(cs.unique_bytes(x) + cs.unique_bytes(k) + out_bytes, 9.0 * out_bytes)
            rows, seen = [], set()
            for shape in [(0, 0, 0, 0)] + ([] if args.quick else SHAPES):
                plan = conv.dw_corr3x3_bf16_plan(x, k, cross, shape=shape)
                key = tuple(sorted(plan.items()))
                if key in seen:
                    continue
                seen.add(key)
                ms = cs.cuda_ms(torch, lambda: conv._launch_dw_corr3x3(x, k, "dw_bf16_plans", cross, shape=shape))
                rows.append({"shape": shape, "plan": plan, "ms": ms})
            if not cross:
                dx = conv.dw_corr3x3_bf16_plan(x, k, flip=True)
                rows.append({"shape": "dx", "plan": dx,
                             "ms": cs.cuda_ms(torch, lambda: conv._launch_dw_corr3x3(x, k, "dw_bf16_plans", flip=True))})
            print(json.dumps({"case": label, "x": list(x.shape), "k": list(k.shape), "cross": cross,
                              "bound_ms": bound, "bound_by": by, "choice": choice, "rows": rows}))
            fastest = min((r for r in rows if r["shape"] != "dx"), key=lambda r: r["ms"])
            summary[label] = {"choice_ms": rows[0]["ms"], "fastest_ms": fastest["ms"], "fastest": fastest["plan"],
                              "bound_ms": bound}
    print(json.dumps({"choice_against_fastest": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
