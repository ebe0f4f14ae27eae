#!/usr/bin/env python3
"""Is the DTOID finetune step bitwise repeatable on the card?

    python3 tools/step_repeat.py [--repeats 3] [--steps 4]   (needs one NVIDIA GPU)

At full width (480x640, DenseNet-121) with cuDNN's deterministic
algorithms and TF32 off, for bf16 and float32 steps: `--steps`
train_step_u8 calls on fixed batches of 8 from one state, `--repeats`
times, and after each repeat chip_smoke.bits_checksum of the parameters,
BatchNorm statistics and optimiser state. Three ways to take the resizes'
gradients: "native" (PyTorch's index_add and upsample_bilinear2d_backward,
as before PR 14), "gathers" (ops/resize.py's fixed-order sums), and
"native, deterministic mode" (native under
torch.use_deterministic_algorithms, warn-only). Prints one JSON line: the
distinct checksums of each (1 = repeatable) and the seconds each took.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--steps", type=int, default=4)
    args = ap.parse_args()
    import numpy as np
    import torch

    import chip_smoke as cs
    from ossid_code_torch.core.config import default_config
    from ossid_code_torch.models.dtoid.module import DtoidModel
    from ossid_code_torch.ops import resize

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True

    def feed_of(batch):
        b = len(batch["img"])
        return {"img_u8": torch.from_numpy((batch["img"] * 255).astype(np.uint8)).cuda(),
                "mask_bits": np.packbits(batch["mask"].reshape(b, -1) > 0, axis=1, bitorder="little"),
                "limg_u8": (batch["limg"] * 255).astype(np.uint8), "lmask_u8": batch["lmask"].astype(np.uint8),
                "gimg_u8": (batch["gimg"] * 255).astype(np.uint8), "gmask_u8": batch["gmask"].astype(np.uint8),
                "bbox_gt": batch["bbox_gt"], "heatmap": batch["heatmap"]}

    feeds = [feed_of(cs.finetune_batch(np.random.default_rng(40 + i), 8)) for i in range(args.steps)]
    gathers = resize._resize_differentiable
    native = lambda x, hw, mode: resize._resize(x, hw, mode)  # noqa: E731
    out = {}
    try:
        for bf16 in (True, False):
            m = DtoidModel(default_config().merged({"model": {"bf16_finetune": bf16}}), seed=1, device="cuda")
            cs.perturb_heads(m.net, 2)
            sd = {k: v.clone() for k, v in m.state_dict().items()}
            for variant in ("native", "gathers", "native, deterministic mode"):
                resize._resize_differentiable = gathers if variant == "gathers" else native
                torch.use_deterministic_algorithms(variant.endswith("mode"), warn_only=True)
                sums, t0 = [], time.perf_counter()
                for _ in range(args.repeats):
                    m.load_state_dict(sd)
                    m.reset_optimizer()
                    for f in feeds:
                        m.train_step_u8(f)
                    opt = [v for st in m.optimizer.state.values() for v in st.values() if isinstance(v, torch.Tensor)]
                    sums.append(int(cs.bits_checksum(torch, [*m.net.state_dict().values(), *opt])))
                torch.use_deterministic_algorithms(False)
                out[f"{'bf16' if bf16 else 'float32'} steps, {variant}"] = {
                    "distinct_checksums": len(set(sums)), "s": round(time.perf_counter() - t0, 2)}
    finally:
        resize._resize_differentiable = gathers
        torch.use_deterministic_algorithms(False)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
