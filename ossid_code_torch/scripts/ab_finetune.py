"""A/B of the finetune step at the production geometry (the port of
ossid_code_tpu/scripts/ab_finetune.py): the train step at 480x640, batch 8,
bf16 (`model.bf16_finetune`) and float32, each with full- and
half-resolution segmentation supervision (`model.seg_loss_half`: the seg
logits decoded at half resolution against the 2x2-mean mask), timed by
`scripts/roofline.py::amortized_time` (CUDA events on the card): the JAX
script's four rows, in its order. Each line also counts the step's launches
of kernel 1's dx and of kernel 3 (1b's dx and 3b in bf16): 2 each a step on
the card (the correlation head and the stem), 0 on the CPU.

Usage: python -m ossid_code_torch.scripts.ab_finetune [--iters 8] [--device cpu]
Runs on the card unless --device cpu. Prints one JSON line per config.
Beyond the JAX script's arguments: `--device`, and `--img_h` / `--img_w` and
`--densenet_blocks` (default 480x640 and 12 24 16) for small CPU runs.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from ossid_code_torch.device import resolve_device


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--iters", type=int, default=8)
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--img_h", type=int, default=480)
    parser.add_argument("--img_w", type=int, default=640)
    parser.add_argument("--densenet_blocks", type=int, nargs=3, default=[12, 24, 16])
    parser.add_argument("--device", type=str, default=None, help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    from ossid_code_torch.core.config import default_config
    from ossid_code_torch.models.dtoid.module import DtoidModel
    from ossid_code_torch.scripts.roofline import amortized_time, finetune_program, launches_of

    dev = resolve_device(args.device)
    device_name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    rng = np.random.default_rng(0)
    lines = []
    for bf16, seg_half in ((True, False), (True, True), (False, False), (False, True)):
        cfg = default_config()
        cfg.model.img_h, cfg.model.img_w = args.img_h, args.img_w
        cfg.model.heatmap_h, cfg.model.heatmap_w = args.img_h // 16 - 1, args.img_w // 16 - 1
        cfg.model.densenet_blocks = tuple(args.densenet_blocks)
        cfg.model.bf16_finetune = bf16
        cfg.model.seg_loss_half = seg_half
        model = DtoidModel(cfg, seed=0, device=dev)
        fn, ft_args = finetune_program(model, rng, args.batch)
        secs = amortized_time(fn, ft_args, args.iters)
        launches = launches_of(fn, *ft_args)
        sfx = "_bf16" if bf16 else ""
        line = {
            "metric": "finetune_step_ms", "bf16": bf16, "seg_half": seg_half,
            "batch": args.batch, "value": secs * 1e3, "unit": "ms",
            "dw_corr3x3_dx_launches": launches.get(f"dw_corr3x3_dx{sfx}", 0),
            "dw_corr3x3_dk_launches": launches.get(f"dw_corr3x3_dk{sfx}", 0),
            "device": device_name,
        }
        log(str(line))
        print(json.dumps(line))
        sys.stdout.flush()
        lines.append(line)
    return lines


if __name__ == "__main__":
    main()
