#!/usr/bin/env python3
"""How many PyTorch operations one SIFT call dispatches (ops/sift.py), by
operator, on the card unless `--device cpu` is given.

    python3 tools/sift_ops.py [--device cuda|cpu]

Runs `detect_and_compute` (500 features, the whole frame) on a seeded
480x640 image of smooth noise, once to warm up and once counted under a
dispatch hook, and prints one JSON line: the total, the pyramid's share, the
keypoints found and the most frequent operators. Counts, not times; the
kernels each operator launches and the device's busy share are in
chip_smoke.py's SIFT profile (phase 9).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from ossid_code_torch.device import resolve_device  # noqa: E402
from ossid_code_torch.ops import sift  # noqa: E402


class Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.by_op: dict = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func.overloadpacket)
        self.by_op[name] = self.by_op.get(name, 0) + 1
        return func(*args, **(kwargs or {}))


def image(h: int = 480, w: int = 640, seed: int = 3) -> torch.Tensor:
    """Bicubic-upsampled noise with fine noise on top, as uint8."""
    rng = np.random.default_rng(seed)
    coarse = torch.from_numpy(rng.uniform(0, 255, (h // 4, w // 4)).astype(np.float32))
    img = torch.nn.functional.interpolate(coarse[None, None], size=(h, w), mode="bicubic")[0, 0]
    return (img.clamp(0, 255) + torch.from_numpy(rng.normal(0, 4, (h, w)).astype(np.float32))).clamp(0, 255).to(
        torch.uint8)


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default=None, help="cuda (the default) or cpu")
    dev = resolve_device(parser.parse_args().device)
    gray = image().to(dev)
    mask = torch.ones(gray.shape, dtype=torch.bool, device=dev)
    sift.detect_and_compute(gray, mask, 500)
    with Count() as all_ops:
        kps, _ = sift.detect_and_compute(gray, mask, 500)
    with Count() as pyr_ops:
        sift.gaussian_pyramid(gray)
    total = sum(all_ops.by_op.values())
    top = sorted(all_ops.by_op.items(), key=lambda kv: -kv[1])[:10]
    print(json.dumps({"device": str(dev), "ops": total, "pyramid_ops": sum(pyr_ops.by_op.values()),
                      "keypoints": kps.count, "top": top}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
