#!/usr/bin/env python3
"""What chip_smoke.py's gradient checks read, on sound and on faulty runs.

    python3 tools/step_gradients.py         (needs one NVIDIA GPU)
    python3 tools/step_gradients.py --bf16

One full-width DTOID finetune step (480x640, DenseNet-121, batch 2, the
weights and batch of chip_smoke.py's phase 7) is differentiated on the card,
on the CPU in float32 and on the CPU in float64, and under deliberate faults:
half the batch, dk doubled, dk of the first sample only, dx doubled. For each
run it prints the leaf-by-leaf relative L2 gradient error that
chip_smoke.grad_errors computes, against the float32 CPU run and against the
float64 one, then runs chip_smoke.compare_step on the sound models.

With --bf16 it measures phase 7b instead: the mixed-precision step
(bf16_finetune, batch 8, the weights and batch of phase 7b) against the
card's float32 step, sound (twice) and under the faults half the batch, dk
(kernel 3b) doubled and dx (kernel 1b) doubled: the largest, 90th-percentile
and median leaf errors, then chip_smoke.compare_step_bf16 on sound models.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from ossid_code_torch.core.config import default_config  # noqa: E402
from ossid_code_torch.kernels import build  # noqa: E402
from ossid_code_torch.models.dtoid.losses import dtoid_losses  # noqa: E402
from ossid_code_torch.models.dtoid.module import DtoidModel  # noqa: E402
from ossid_code_torch.ops import conv  # noqa: E402


def gradients(model, weights, cfg, batch, dtype=torch.float32):
    """Loss and {leaf: gradient} of one training forward and backward from
    `weights`, in `dtype`, without an optimizer step."""
    net = model.net
    net.load_state_dict({k: v.to(model.device) for k, v in weights.items()})
    net.to(dtype).train()
    t = {k: torch.from_numpy(np.asarray(v)).to(model.device, dtype) for k, v in batch.items()}
    m = cfg.model
    for p in net.parameters():
        p.grad = None
    out = net(t["img"], t["limg"], t["lmask"], t["gimg"], t["gmask"])
    loss, _ = dtoid_losses(out, t, model.anchors.to(dtype), lam_seg=m.lam_seg, lam_center=m.lam_center,
                           lam_cls=m.lam_cls, lam_reg=m.lam_reg)
    loss.backward()
    grads = {n: p.grad.detach().double().cpu().clone() for n, p in net.named_parameters()}
    net.to(torch.float32).eval()
    return float(loss.detach()), grads


def patched(name, fn):
    """Replace conv.<name> (a counted wrapper) by fn for one run."""
    fn.launches = fn.launches_bf16 = fn.flops = 0
    orig = getattr(conv, name)

    class Patch:
        def __enter__(self):
            setattr(conv, name, fn)

        def __exit__(self, *exc):
            setattr(conv, name, orig)
    return Patch()


def step_gradients(model, weights, batch):
    """Loss and {leaf: gradient} of one train_step of `model` (float32 or
    bf16_finetune) from `weights` and a fresh optimizer."""
    model.load_state_dict({k: v.to(model.device) for k, v in weights.items()})
    model.reset_optimizer()
    loss = float(model.train_step(batch)["loss"])
    return loss, cs.step_gradients(model)


def main_bf16() -> int:
    """Phase 7b's check: bf16 step gradients against the float32 step's."""
    cfg = default_config()
    m32 = DtoidModel(cfg, seed=3, device="cuda")
    cs.perturb_heads(m32.net, 4)
    m16 = DtoidModel(cfg.merged({"model": {"bf16_finetune": True}}), seed=3, device="cuda")
    weights = {k: v.cpu() for k, v in m32.state_dict().items()}
    batch = cs.finetune_batch(np.random.default_rng(6), cs.FINETUNE_BATCH)
    dk, dx = conv.dw_corr3x3_dk_cuda, conv.dw_corr3x3_dx_cuda
    t0 = time.perf_counter()
    runs = {"card float32": step_gradients(m32, weights, batch),
            "card bf16": step_gradients(m16, weights, batch),
            "card bf16 again": step_gradients(m16, weights, batch),
            "fault: bf16, half the batch": step_gradients(m16, weights, {k: v[:4] for k, v in batch.items()})}
    with patched("dw_corr3x3_dk_cuda", lambda x, d: 2 * dk(x, d)):
        runs["fault: bf16, dk (3b) doubled"] = step_gradients(m16, weights, batch)
    with patched("dw_corr3x3_dx_cuda", lambda d, k: 2 * dx(d, k)):
        runs["fault: bf16, dx (1b) doubled"] = step_gradients(m16, weights, batch)
    print(f"{len(runs)} runs in {time.perf_counter() - t0:.1f} s; losses "
          f"{json.dumps({k: v[0] for k, v in runs.items()})}")
    for ref in ("card float32", "card bf16"):
        for name, (_, grads) in runs.items():
            if name == ref:
                continue
            errs, dropped = cs.grad_errors(grads, runs[ref][1])
            vals = np.array(sorted(errs.values()))
            worst = max(errs, key=errs.get)
            print(f"against {ref}: {name}: relative L2 error largest {vals[-1]:.4g} ({worst}), 90th "
                  f"percentile {np.percentile(vals, 90):.4g}, median {np.median(vals):.4g}; {len(errs)} leaves, "
                  f"left out {dropped}")
    m32.load_state_dict({k: v.cuda() for k, v in weights.items()})
    m32.reset_optimizer()
    m16.load_state_dict({k: v.cuda() for k, v in weights.items()})
    m16.reset_optimizer()
    print(f"compare_step_bf16: {json.dumps(cs.compare_step_bf16(torch, m16, m32, batch))}")
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("step_gradients: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_num_threads(8)
    build.build()
    if "--bf16" in sys.argv[1:]:
        return main_bf16()
    cfg = default_config()
    gpu = DtoidModel(cfg, seed=3, device="cuda")
    cs.perturb_heads(gpu.net, 4)
    cpu = DtoidModel(cfg, seed=3, device="cpu")
    weights = {k: v.cpu() for k, v in gpu.state_dict().items()}
    batch = cs.finetune_batch(np.random.default_rng(6), 2)
    dk, dx = conv.dw_corr3x3_dk_cuda, conv.dw_corr3x3_dx_cuda

    def dk_first_sample(x, dout):
        k = dk(x, dout)
        k[1:] = 0
        return k

    t0 = time.perf_counter()
    runs = {"card": gradients(gpu, weights, cfg, batch),
            "card again": gradients(gpu, weights, cfg, batch),
            "cpu": gradients(cpu, weights, cfg, batch),
            "cpu float64": gradients(cpu, weights, cfg, batch, torch.float64),
            "fault: cpu, first sample only": gradients(cpu, weights, cfg, {k: v[:1] for k, v in batch.items()})}
    with patched("dw_corr3x3_dk_cuda", lambda x, d: 2 * dk(x, d)):
        runs["fault: card, dk doubled"] = gradients(gpu, weights, cfg, batch)
    with patched("dw_corr3x3_dk_cuda", dk_first_sample):
        runs["fault: card, dk of the first sample only"] = gradients(gpu, weights, cfg, batch)
    with patched("dw_corr3x3_dx_cuda", lambda d, k: 2 * dx(d, k)):
        runs["fault: card, dx doubled"] = gradients(gpu, weights, cfg, batch)
    print(f"{len(runs)} runs in {time.perf_counter() - t0:.1f} s; losses "
          f"{json.dumps({k: v[0] for k, v in runs.items()})}")
    for ref in ("cpu", "cpu float64"):
        for name, (_, grads) in runs.items():
            if name == ref:
                continue
            errs, dropped = cs.grad_errors(grads, runs[ref][1])
            worst = max(errs, key=errs.get)
            print(f"against {ref}: {name}: largest relative L2 error {errs[worst]:.4g} ({worst}), "
                  f"median {np.median(list(errs.values())):.4g}; {len(errs)} leaves, left out {dropped}")
    gpu2 = DtoidModel(cfg, seed=3, device="cuda")
    cpu2 = DtoidModel(cfg, seed=3, device="cpu")
    gpu2.load_state_dict({k: v.cuda() for k, v in weights.items()})
    cpu2.load_state_dict(weights)
    print(f"compare_step: {json.dumps(cs.compare_step(torch, gpu2, cpu2, batch))}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
