"""FLOP and roofline accounting for the three hot programs on the card (the
port of ossid_code_tpu/scripts/roofline.py):

  * the DTOID detect program (480x640, 10 templates),
  * the DTOID finetune train step (batch 8),
  * the Zephyr score program at M=128 and M=512 (float32 and bf16).

FLOP counts: `program_flops` runs the program once under PyTorch's
`FlopCounterMode` (convolutions and matrix products, at the ATen level) and
adds the operations of the port's hand-written kernels, which no ATen op
wraps (they launch through ctypes): each kernel wrapper keeps a tally from
its shapes (ops/conv.py, ops/sa_fused.py: `.flops`). On the CPU the
kernels' plain versions run instead, a grouped convolution and matrix
products that the counter sees and the wrappers do not tally, so the same
program at the same shapes counts the same on the CPU as on the card. The
counter's formula for a grouped convolution's weight gradient counts it
`groups` times over; this module counts it as the forward's multiply-adds.
Where the work depends on the data (the detect's NMS sweeps, ops/nms.py),
the count is what this run's data needed. The JAX script reads XLA's
post-fusion cost model instead, which is not the same quantity (it leaves out
the products with a convolution's zero padding and counts element-wise work).

Times: `amortized_time` on the card takes CUDA events around `iters`
back-to-back calls after a warm-up, the minimum of 3 repeats; on the CPU the
host clock. (The JAX script's `(t(k) - t(1)) / (k - 1)` cancels the fixed
fetch cost of the TPU's remote link; the card has no such cost.)

Peaks are the H100 SXM data sheet's at its 700 W limit: 67 TFLOP/s float32
outside the tensor cores, 495 TF32, 989 bf16 (dense). The float32
rows divide by the TF32 peak where `torch.backends.cudnn.allow_tf32` is on
(PyTorch's default) and by 67 otherwise; OSSID_PEAK_TFLOPS_F32 and
OSSID_PEAK_TFLOPS_BF16 override them. The card's name and power limit are
printed beside the table.

Usage: python -m ossid_code_torch.scripts.roofline [--hypos 128 512] [--device cpu]
Runs on the card unless --device cpu. Prints one markdown table + a JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode, conv_flop_count

from ossid_code_torch.device import resolve_device
from ossid_code_torch.utils.profiling import cuda_device_of

# H100 SXM, NVIDIA data sheet, dense, at the 700 W limit
H100_PEAK_TFLOPS = {"fp32": 67.0, "tf32": 495.0, "bf16": 989.0}


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def card_line() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    lines = smi.stdout.strip().splitlines()
    return lines[0] if lines else "nvidia-smi: no output"


def peaks() -> dict:
    """FLOP/s peaks the rows divide by, and what chose the float32 one."""
    tf32 = bool(torch.backends.cudnn.allow_tf32)
    f32 = os.environ.get("OSSID_PEAK_TFLOPS_F32")
    bf16 = os.environ.get("OSSID_PEAK_TFLOPS_BF16")
    return {
        "f32": float(f32) * 1e12 if f32 else H100_PEAK_TFLOPS["tf32" if tf32 else "fp32"] * 1e12,
        "bf16": float(bf16) * 1e12 if bf16 else H100_PEAK_TFLOPS["bf16"] * 1e12,
        "f32_source": "OSSID_PEAK_TFLOPS_F32" if f32 else ("TF32" if tf32 else "FP32"),
        "cudnn_allow_tf32": tf32, "matmul_allow_tf32": bool(torch.backends.cuda.matmul.allow_tf32),
    }


def amortized_time(fn, args, iters: int = 12) -> float:
    """Seconds per call over `iters` back-to-back calls, the minimum of 3
    repeats after a warm-up of 2 calls: CUDA events and a synchronize where
    the arguments or the result hold CUDA tensors, the host clock
    otherwise."""
    out = None
    for _ in range(2):
        out = fn(*args)
    dev = cuda_device_of(args, {}, out)
    best = float("inf")
    for _ in range(3):
        if dev is not None:
            torch.cuda.synchronize(dev)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn(*args)
            end.record()
            torch.cuda.synchronize(dev)
            secs = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn(*args)
            secs = time.perf_counter() - t0
        best = min(best, secs / iters)
    return max(best, 1e-9)


def _conv_backward_flop(grad_out_shape, x_shape, w_shape, _bias, _stride, _padding, _dilation, transposed,
                        _output_padding, _groups, output_mask, out_shape=None, **kwargs) -> int:
    """aten.convolution_backward: the input gradient and the weight gradient
    each do the forward's multiply-adds, grouped or not."""
    forward = conv_flop_count(x_shape, w_shape, grad_out_shape, transposed)
    return forward * (int(output_mask[0]) + int(output_mask[1]))


def _kernel_wrappers() -> tuple:
    from ossid_code_torch.ops import conv, sa_fused

    return (conv.dw_corr3x3_cuda, conv.dw_corr3x3_dx_cuda, conv.dw_corr3x3_dk_cuda, sa_fused.sa_mlp_max_cuda)


def flop_breakdown(fn, *args) -> dict:
    """FLOPs of one call of fn(*args) by ATen op (PyTorch's counter) and, as
    "hand-written kernels", the kernel wrappers' tally over the call."""
    wrappers = _kernel_wrappers()
    before = sum(w.flops for w in wrappers)
    aten = torch.ops.aten
    with FlopCounterMode(display=False, custom_mapping={aten.convolution_backward: _conv_backward_flop}) as fc:
        fn(*args)
    out = {str(op): int(n) for op, n in fc.get_flop_counts()["Global"].items()}
    out["hand-written kernels"] = int(sum(w.flops for w in wrappers) - before)
    return out


def launches_of(fn, *args) -> dict:
    """Launches of each hand-written kernel in one call of fn(*args), by
    wrapper and dtype ("dw_corr3x3", "dw_corr3x3_bf16", ...), the kernels
    launched at least once."""
    names = ("dw_corr3x3", "dw_corr3x3_dx", "dw_corr3x3_dk", "sa_mlp_max")
    wrappers = _kernel_wrappers()

    def read():
        out = {n: w.launches for n, w in zip(names, wrappers)}
        out.update({f"{n}_bf16": w.launches_bf16 for n, w in zip(names, wrappers)})
        return out

    before = read()
    fn(*args)
    return {k: v - before[k] for k, v in read().items() if v != before[k]}


def program_flops(fn, *args) -> float:
    """FLOPs of one call of fn(*args): PyTorch's counter plus the port's
    hand-written kernels (`flop_breakdown`)."""
    return float(sum(flop_breakdown(fn, *args).values()))


# ---------------------------------------------------------------- programs
def detect_program(model, rng, t_count: int = 10):
    """(fn, args) of one detect over `t_count` templates, the templates
    featurized (cached) first, as JAX's `_infer` takes their features."""
    h, w = model.img_size
    ts = int(model.cfg.dataset.get("template_size", 124))
    img = rng.integers(0, 255, (1, h, w, 3), dtype=np.uint8)
    limg = rng.uniform(0, 1, (t_count, ts, ts, 3)).astype(np.float32)
    lmask = np.ones((t_count, ts, ts, 1), np.float32)
    model.get_template_features(1, limg, lmask)
    batch = {"img": torch.from_numpy(img).to(model.device), "obj_id": 1, "limg": limg, "lmask": lmask}
    return model.detect_async, (batch,)


def finetune_program(model, rng, b: int = 8):
    """(fn, args) of one finetune step at batch `b` (JAX's roofline batch)."""
    h, w = model.img_size
    ts = int(model.cfg.dataset.get("template_size", 124))
    fh, fw = model.feat_size
    dev = model.device

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    batch = {
        "img": t(rng.uniform(0, 1, (b, h, w, 3))), "limg": t(rng.uniform(0, 1, (b, ts, ts, 3))),
        "lmask": t(np.ones((b, ts, ts, 1))), "gimg": t(rng.uniform(0, 1, (b, ts, ts, 3))),
        "gmask": t(np.ones((b, ts, ts, 1))),
        "bbox_gt": t(np.tile([[100, 100, 200, 200, 1]], (b, 1, 1))),
        "heatmap": t(np.zeros((b, fh, fw, 1))), "mask": t(np.zeros((b, h, w, 1))),
    }
    return (lambda bt: model.train_step(bt)["loss"]), (batch,)


def score_inputs(rng, img_hw=(480, 640)) -> dict:
    """The JAX script's score inputs: a 2048-point model cloud, a frame, a
    256x256 depth crop at (100, 150), K."""
    return {
        "pts": rng.normal(0, 0.03, (2048, 3)).astype(np.float32),
        "cols": rng.uniform(0, 1, (2048, 3)).astype(np.float32),
        "nrms": np.tile(np.asarray([[0, 0, -1.0]], np.float32), (2048, 1)),
        "img": rng.integers(0, 255, (*img_hw, 3), dtype=np.uint8),
        "depth": rng.uniform(400, 900, (256, 256)).astype(np.uint16),
        "K": np.array([[572.0, 0, 325], [0, 573.0, 242], [0, 0, 1]], np.float32),
        "origin": np.array([100, 150], np.int32),
    }


def score_program(zm, inputs: dict, m: int):
    """(fn, args) of one score call on M identity hypotheses at 0.6 m, all
    valid (JAX's `_score` on the same arguments)."""
    dev = zm.device
    prep = zm.prepare_object(1, inputs["pts"], inputs["cols"], inputs["nrms"])
    poses = np.tile(np.eye(4, dtype=np.float32), (m, 1, 1))
    poses[:, 2, 3] = 0.6
    args = (torch.from_numpy(inputs["img"]).to(dev), torch.from_numpy(inputs["depth"].astype(np.int32)).to(dev),
            torch.from_numpy(inputs["origin"]).to(dev), torch.from_numpy(inputs["K"]).to(dev), *prep,
            torch.from_numpy(poses).to(dev), torch.ones((m,), dtype=torch.bool, device=dev))

    def run(*a):
        with torch.inference_mode():
            return zm._score(*a)
    return run, args


def row(name: str, fn, args, iters: int, peak: float, device: str) -> dict:
    flops = program_flops(fn, *args)
    secs = amortized_time(fn, args, iters)
    tf = flops / secs / 1e12
    r = {"program": name, "gflops": flops / 1e9, "ms": secs * 1e3, "tflops": tf,
         "mfu_pct": 100.0 * flops / secs / peak, "peak_tflops": peak / 1e12, "device": device}
    log(f"  {name}: {flops / 1e9:.1f} GFLOP, {secs * 1e3:.2f} ms, {tf:.1f} TFLOP/s, "
        f"{r['mfu_pct']:.1f}% of {peak / 1e12:.1f} TFLOP/s ({device})")
    return r


def rows(cfg, hypos=(128, 512), iters: int = 12, device=None, num_points: int = 512,
         img_hw=(480, 640)) -> list:
    """The table's rows: detect at T=10, the finetune step at batch 8, the
    score call at each M in float32 and bf16. `cfg` sets the detector's
    sizes (the script: the default 480x640 DenseNet-121)."""
    from ossid_code_torch.models.dtoid.module import DtoidModel
    from ossid_code_torch.models.zephyr.module import ZephyrModel

    dev = resolve_device(device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    pk = peaks()
    rng = np.random.default_rng(0)
    out = []
    log("DTOID detect program ...")
    model = DtoidModel(cfg, seed=0, device=dev)
    out.append(row("detect t=10 f32", *detect_program(model, rng), iters, pk["f32"], name))
    log("DTOID finetune step ...")
    out.append(row("finetune b=8 f32", *finetune_program(model, rng), max(1, iters // 2), pk["f32"], name))
    for bf16 in (False, True):
        zm = ZephyrModel(num_points=num_points, inconst_ratio_th=100.0, seed=0, need_uv=False, bf16=bf16,
                         device=dev)
        inputs = score_inputs(rng, img_hw)
        for m in hypos:
            out.append(row(f"score M={m} {'bf16' if bf16 else 'f32'}", *score_program(zm, inputs, m), iters,
                           pk["bf16" if bf16 else "f32"], name))
    return out


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--hypos", type=int, nargs="+", default=[128, 512])
    parser.add_argument("--iters", type=int, default=12)
    parser.add_argument("--device", type=str, default=None, help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    from ossid_code_torch.core.config import default_config

    dev = resolve_device(args.device)
    pk = peaks()
    if dev.type == "cuda":
        print(f"card: {card_line()}")
    print(f"device: {torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'cpu'}; peaks (TFLOP/s): f32 "
          f"{pk['f32'] / 1e12:.1f} ({pk['f32_source']}), bf16 {pk['bf16'] / 1e12:.1f}; "
          f"cudnn.allow_tf32={pk['cudnn_allow_tf32']} matmul.allow_tf32={pk['matmul_allow_tf32']}")
    out = rows(default_config(), args.hypos, args.iters, dev)  # 480x640 production geometry
    print("| program | GFLOP | ms | TFLOP/s | % peak | peak TFLOP/s | device |")
    print("|---|---|---|---|---|---|---|")
    for r in out:
        print(f"| {r['program']} | {r['gflops']:.1f} | {r['ms']:.2f} | {r['tflops']:.1f} | {r['mfu_pct']:.1f} "
              f"| {r['peak_tflops']:.1f} | {r['device']} |")
    print(json.dumps({"roofline": out}))
    return out


if __name__ == "__main__":
    main()
