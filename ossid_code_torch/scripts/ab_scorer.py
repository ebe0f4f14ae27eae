"""A/B of the scorer's sampling paths on the card (the port of
ossid_code_tpu/scripts/ab_scorer.py): the score program with four-tap
bilinear sampling ("baseline", `ZephyrModel(packed_sample=False)`, JAX's
OSSID_PACKED_SAMPLE=0) against one gather of packed taps ("packed", the
default), at M in {128, 512}, float32 and bf16.

The JAX script's "fused" axis (OSSID_FUSED_SCORER: the Pallas SetAbstraction
kernel against XLA's unfused layers) has no counterpart here: on the card the
hand-written SetAbstraction kernel (kernel 2, 2b in bf16) is the scorer's only
path, and its plain version serves the CPU. Each row also counts that
kernel's launches a call (2: SA1 and SA2; 0 on the CPU).

Timing: `scripts/roofline.py::amortized_time` (CUDA events on the card). Each
row's `score_sum` is the sum of its finite scores, as in the JAX script; the
two sampling paths give the same values, so a row's sum equals its
baseline's.

Usage: python -m ossid_code_torch.scripts.ab_scorer [--hypos 128 512] [--device cpu]
Runs on the card unless --device cpu. Prints one markdown table + a JSON
line. Beyond the JAX script's arguments: `--device`, and `--num_points`
and `--img_h` / `--img_w` (default the JAX script's fixed 512 and 480x640)
for small runs on the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from ossid_code_torch.device import resolve_device

CONFIGS = (("baseline", False), ("packed", True))  # (name, packed_sample)


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--hypos", type=int, nargs="+", default=[128, 512])
    parser.add_argument("--iters", type=int, default=12)
    parser.add_argument("--bf16", type=int, nargs="+", default=[0, 1])
    parser.add_argument("--num_points", type=int, default=512)
    parser.add_argument("--img_h", type=int, default=480)
    parser.add_argument("--img_w", type=int, default=640)
    parser.add_argument("--device", type=str, default=None, help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    from ossid_code_torch.models.zephyr.module import ZephyrModel
    from ossid_code_torch.scripts.roofline import amortized_time, launches_of, score_inputs, score_program

    dev = resolve_device(args.device)
    device_name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    log(f"device: {device_name}")
    inputs = score_inputs(np.random.default_rng(0), (args.img_h, args.img_w))

    rows = []
    for bf16 in args.bf16:
        for name, packed in CONFIGS:
            zm = ZephyrModel(num_points=args.num_points, inconst_ratio_th=100.0, seed=0, need_uv=False,
                             bf16=bool(bf16), packed_sample=packed, device=dev)
            for m in args.hypos:
                fn, sargs = score_program(zm, inputs, m)
                scores = fn(*sargs)[1].float().cpu().numpy()
                secs = amortized_time(fn, sargs, args.iters)
                launches = launches_of(fn, *sargs)
                rows.append({"config": name, "m": m, "bf16": bool(bf16), "ms": secs * 1e3,
                             "score_sum": float(np.nansum(np.where(np.isfinite(scores), scores, 0.0))),
                             "sa_mlp_max_launches": launches.get("sa_mlp_max_bf16" if bf16 else "sa_mlp_max", 0),
                             "device": device_name})
                log(f"  {name} M={m} {'bf16' if bf16 else 'f32'}: {secs * 1e3:.3f} ms")

    print("| config | M | prec | ms | vs baseline |")
    print("|---|---|---|---|---|")
    base = {(r["m"], r["bf16"]): r["ms"] for r in rows if r["config"] == "baseline"}
    for r in rows:
        b = base.get((r["m"], r["bf16"]), float("nan"))
        print(f"| {r['config']} | {r['m']} | {'bf16' if r['bf16'] else 'f32'} "
              f"| {r['ms']:.3f} | {b / r['ms']:.2f}x |")
    print(json.dumps({"ab_scorer": rows}))
    return rows


if __name__ == "__main__":
    main()
