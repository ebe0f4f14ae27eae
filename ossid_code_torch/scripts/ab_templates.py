"""Serving at the reference's template scale: one detect at n_local_test up to
160, 480x640 (the port of ossid_code_tpu/scripts/ab_templates.py).

The reference's author-checkpoint inference runs 160 local templates per
frame, chunked 120 at a time through the torch net (ref
models/dtoid/__init__.py:92-98, readme.md:74); the repo's worlds run 6-10.
This script times the one-batch all-templates detect (`DtoidModel.
clear_cache`, `get_template_features`, `detect_async`) at T in {10, 40, 80,
160}: the amortized time a frame (`scripts/roofline.py::amortized_time`:
CUDA events on the card), the first call, the template featurization, the
peak device memory (`torch.cuda.max_memory_allocated`, reset before each T;
null on the CPU) and kernel 1's launches a detect (2 on the card: the
correlation head and the stem; 0 on the CPU, where the plain version runs).

Usage: python -m ossid_code_torch.scripts.ab_templates [--sizes 10 40 160] [--device cpu]
Runs on the card unless --device cpu. Prints one JSON line per T. Beyond
the JAX script's arguments: `--device` and `--densenet_blocks` (default the
JAX script's fixed 12 24 16), for small runs on the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ossid_code_torch.device import resolve_device


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--sizes", type=int, nargs="+", default=[10, 40, 80, 160])
    parser.add_argument("--img_h", type=int, default=480)
    parser.add_argument("--img_w", type=int, default=640)
    parser.add_argument("--iters", type=int, default=8)
    parser.add_argument("--densenet_blocks", type=int, nargs=3, default=[12, 24, 16])
    parser.add_argument("--device", type=str, default=None, help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    from ossid_code_torch.core.config import default_config
    from ossid_code_torch.models.dtoid.module import DtoidModel
    from ossid_code_torch.scripts.roofline import amortized_time, launches_of

    dev = resolve_device(args.device)
    cuda = dev.type == "cuda"
    cfg = default_config()
    cfg.model.img_h, cfg.model.img_w = args.img_h, args.img_w
    cfg.model.heatmap_h = args.img_h // 16 - 1
    cfg.model.heatmap_w = args.img_w // 16 - 1
    cfg.model.densenet_blocks = tuple(args.densenet_blocks)
    model = DtoidModel(cfg, seed=0, device=dev)
    device_name = torch.cuda.get_device_name(dev) if cuda else "cpu"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    rng = np.random.default_rng(0)
    img = rng.integers(0, 255, (1, args.img_h, args.img_w, 3), dtype=np.uint8)
    ts = int(cfg.dataset.get("template_size", 124))
    lines = []
    for t_count in args.sizes:
        limg = rng.random((t_count, ts, ts, 3), dtype=np.float32)
        lmask = (rng.random((t_count, ts, ts, 1)) > 0.5).astype(np.float32)
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)

        # one-off template featurization (cache fill)
        model.clear_cache()
        sync()
        t0 = time.perf_counter()
        model.get_template_features(t_count, limg, lmask)
        sync()
        t_feat = time.perf_counter() - t0

        batch = {"img": img, "obj_id": t_count, "limg": limg, "lmask": lmask}
        # first call: cuDNN's plans for the batch of T, the allocator
        t0 = time.perf_counter()
        model.detect_async(batch)
        sync()
        t_first = time.perf_counter() - t0

        t_amort = amortized_time(model.detect_async, (batch,), iters=args.iters)
        launches = launches_of(model.detect_async, batch)
        sync()
        line = {
            "metric": "detect_ms_per_frame", "templates": t_count,
            "img": [args.img_h, args.img_w],
            "value": t_amort * 1e3, "unit": "ms",
            "template_featurize_s": t_feat,
            "first_call_s": t_first,
            "fps_equiv": 1.0 / t_amort,
            "peak_memory_mb": torch.cuda.max_memory_allocated(dev) / 1e6 if cuda else None,
            "dw_corr3x3_launches_per_detect": launches.get("dw_corr3x3", 0),
            "device": device_name,
        }
        log(f"T={t_count}: {line}")
        print(json.dumps(line))
        sys.stdout.flush()
        lines.append(line)
    return lines


if __name__ == "__main__":
    main()
