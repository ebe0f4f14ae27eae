#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (ossid_code_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:
  1. print the card (nvidia-smi name and power limit) and build every CUDA
     kernel from ossid_code_torch/csrc (one nvcc per source, in parallel);
  2. hold each kernel against its plain PyTorch version at the shapes the
     serving path gives it and at inputs that reach its edges, and time
     kernel, plain version and (where one PyTorch call computes the same
     function) the library call; sa_mlp_max's bound is the TF32
     tensor-core one, with its 3-pass floor and the FP32-pipe bound beside;
  3. serve frames at full width through the port's entry points: DtoidModel
     (480x640, DenseNet-121 12/24/16, T=10 templates) forward_test_time, then
     FakeHypoGen, then ZephyrModel(num_points=512) score_hypotheses on 100
     hypotheses; the kernels' launch counters must show 2 launches per detect
     and 2 per score call; then one detect and one score call run under
     torch.profiler (device busy time, idle share, the kernels that take it);
  4. run the first frame again through the plain path on the CPU with the
     same weights and compare.
Weights are random, from fixed seeds. The whole run is in float32 with TF32
off for cuDNN convolutions and cuBLAS matmuls (main path and comparisons).

Before the last line it prints a `kernels` JSON line; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Without CUDA, or without the ossid_code_torch package beside it, it exits
non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

N_FRAMES = 3
N_TEMPLATES = 10
N_HYPOS = 100
NUM_POINTS = 512
DW_TOL = 1e-5   # 9-term sums in another order than cuDNN's
SA_TOL = 1e-4   # 3 chained layers of up to 131-term sums, another order
# published peaks of one H100 SXM at its 700 W limit (NVIDIA data sheet):
# HBM bytes/s, FP32 flop/s outside the tensor cores, dense TF32 flop/s on
# the tensor cores; the card's own name and power limit are printed beside
# every run
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
TF32_FLOPS = 495e12
SLEEP_CYCLES = 20_000_000  # ~10 ms of a 1.98 GHz SM clock: longer than enqueueing one timed run


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def cuda_ms(torch, fn, reps: int = 10, launches: int = 20) -> float:
    """Device time of one fn() call: the median over `reps` runs of the mean
    over `launches` back-to-back calls between two CUDA events. A sleep
    kernel queued first keeps the card busy while the host enqueues the
    calls, so the host's launch overhead stays out of the time."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return float(np.median(times))


def host_ms(torch, fn, calls: int = 50) -> float:
    """Host-clock time of one fn() call over `calls` calls in a row, then a
    sync: for a chain of small launches, the host's cost of issuing them."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / calls


def profile_call(torch, fn) -> dict:
    """One call of fn under torch.profiler: the host-clock wall time, the
    device's busy time (sum of its kernels and copies, one stream) and the
    kernels that took most of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start) / 1e3
    busy_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms if by_name else None,
            "top_kernels_ms": [(name[:70], ms) for name, ms in top]}


def bound_ms(bytes_moved: float, flops: float, flops_per_s: float = FP32_FLOPS):
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S * 1e3, flops / flops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def unique_bytes(t) -> int:
    """Bytes a tensor's distinct elements occupy (a stride-0 broadcast counts once)."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


def check_close(torch, name, got, want, tol):
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, rtol=tol, atol=tol):
        fail(f"{name}: kernel disagrees with its plain version, max abs err {err:.3g} > tol {tol}")
    return err


def dw_corr_cases(torch, device):
    """The two main-path calls of kernel 1: the correlation head (image
    feature broadcast over T) and the image-encoder stem."""
    g = torch.Generator(device=device).manual_seed(1)
    feat = torch.randn(1, 29, 39, 640, device=device, generator=g)
    stem = torch.randn(1, 240, 320, 64, device=device, generator=g)
    return [
        ("correlation head", feat.expand(N_TEMPLATES, 29, 39, 640),
         torch.randn(N_TEMPLATES, 3, 3, 640, device=device, generator=g)),
        ("image-encoder stem", stem, torch.randn(1, 3, 3, 64, device=device, generator=g)),
    ]


def dw_corr_edge_cases(torch, device):
    """Shapes off the main path that reach the kernel's edges: a W that is
    not a multiple of the run length (4), k broadcast with stride 0 over B,
    one column, C = 4."""
    g = torch.Generator(device=device).manual_seed(3)
    r = lambda *shape: torch.randn(*shape, device=device, generator=g)
    return [
        ("W 39, k stride 0 over B", r(1, 6, 39, 64).expand(3, 6, 39, 64), r(1, 3, 3, 64).expand(3, 3, 3, 64)),
        ("W 7, both per sample", r(2, 5, 7, 12), r(2, 3, 3, 12)),
        ("W 1, C 4", r(3, 4, 1, 4), r(3, 3, 3, 4)),
        ("W 322, k stride 0 over B", r(2, 3, 322, 64), r(1, 3, 3, 64).expand(2, 3, 3, 64)),
    ]


def check_dw_corr_edges(torch, conv, cases):
    errs = []
    for label, x, k in cases:
        errs.append(check_close(torch, f"dw_corr3x3 ({label})", conv.dw_corr3x3_cuda(x, k),
                                conv.depthwise_corr_plain(x, k, 1), DW_TOL))
    return max(errs)


def measure_dw_corr(torch, F, conv, cases):
    rows = []
    for label, x, k in cases:
        b, h, w, c = x.shape
        got = conv.dw_corr3x3_cuda(x, k)
        want = conv.depthwise_corr_plain(x, k, 1)
        err = check_close(torch, f"dw_corr3x3 ({label})", got, want, DW_TOL)
        xi = x.permute(0, 3, 1, 2).reshape(1, b * c, h, w).contiguous()
        ki = k.permute(0, 3, 1, 2).reshape(b * c, 1, 3, 3).contiguous()
        bnd, by = bound_ms(unique_bytes(x) + unique_bytes(k) + got.numel() * 4, 18.0 * got.numel())
        rows.append({
            "shape": f"x {tuple(x.shape)}{' (stride 0 over B)' if x.stride(0) == 0 and b > 1 else ''}, k {tuple(k.shape)}",
            "max_abs_err": err,
            "ms": cuda_ms(torch, lambda: conv.dw_corr3x3_cuda(x, k)),
            "plain_ms": cuda_ms(torch, lambda: conv.depthwise_corr_plain(x, k, 1)),
            "library_ms": cuda_ms(torch, lambda: F.conv2d(xi, ki, groups=b * c, padding=1)),
            "bound_ms": bnd, "bound_by": by,
        })
    return rows


def sa_flops(m, s, k, dims):
    return 2.0 * m * s * k * sum(dims[i] * dims[i + 1] for i in range(3))


def measure_sa(torch, sa, zephyr, prep):
    """Kernel 2 at its two main-path stages, on the prepared object's real
    grouping indices and the scorer's folded weights, at the M = 128 bucket.
    bound_ms is the TF32 tensor-core bound (the kernel's 3 passes make
    three times that its floor); the FP32-pipe bound is reported beside,
    and the time the wrapper spends packing the weights (pack_sa_weights)
    on each call, on the device and on the host clock."""
    g = torch.Generator(device=zephyr.device).manual_seed(2)
    m = 128
    point_x = torch.randn(m, NUM_POINTS, 11, device=zephyr.device, generator=g) * 0.05
    _, _, _, sa1c, sa1g, sa2c, sa2g = prep
    mods = zephyr.net.SA_modules
    stages = []
    xyz, feats = point_x[..., :3], point_x[..., 3:]
    stages.append(("SA1", xyz, feats, sa1c, sa1g, *mods[0].mlps[0].folded()))
    f1 = sa.sa_mlp_max_cuda(xyz, feats, sa1c, sa1g, *stages[0][5:])
    stages.append(("SA2", xyz[:, sa1c.long()].contiguous(), f1, sa2c, sa2g, *mods[1].mlps[0].folded()))
    rows = []
    for label, x3, fx, cidx, gidx, Ws, bs in stages:
        args = (x3, fx, cidx, gidx, Ws, bs)
        got = sa.sa_mlp_max_cuda(*args)
        want = sa.sa_mlp_max_plain(*args)
        err = check_close(torch, f"sa_mlp_max ({label})", got, want, SA_TOL)
        s, k = gidx.shape
        dims = [3 + fx.shape[2]] + [w.shape[1] for w in Ws]
        flops = sa_flops(m, s, k, dims)
        nbytes = (unique_bytes(x3) + unique_bytes(fx) + 4 * (cidx.numel() + gidx.numel())
                  + sum(4 * (w.numel() + b.numel()) for w, b in zip(Ws, bs)) + 4 * got.numel())
        bnd, by = bound_ms(nbytes, flops, TF32_FLOPS)
        layout = sa.SA_LAYOUT[tuple(dims[1:])]
        pack = lambda: sa.pack_sa_weights(Ws, fx.shape[2], *layout)
        rows.append({
            "shape": f"{label}: (M={m}, S={s}, k={k}, Cin={dims[0]}) -> {dims[1:]}",
            "max_abs_err": err,
            "ms": cuda_ms(torch, lambda: sa.sa_mlp_max_cuda(*args)),
            "plain_ms": cuda_ms(torch, lambda: sa.sa_mlp_max_plain(*args), reps=10),
            "library_ms": None,
            "bound_ms": bnd, "bound_by": by,
            "three_pass_floor_ms": 3 * flops / TF32_FLOPS * 1e3,
            "fp32_pipe_bound_ms": flops / FP32_FLOPS * 1e3, "gflop": flops / 1e9,
            "pack_ms": cuda_ms(torch, pack), "pack_host_ms": host_ms(torch, pack),
        })
    return rows


def check_sa_edges(torch, sa, device):
    """Inputs that reach the kernel's edges, against the plain version:
    k = 13 and 29 (padding rows in every tile), odd group counts (a partial
    last tile, and more tiles than blocks), and weights whose layer-3 outputs
    are mostly negative (W3 shifted down, b3 up): relu hits zero on the real
    rows while a padding row, relu(b) of the chain, would win the max if it
    were not masked; the case checks that it would."""
    rng = np.random.default_rng(9)
    errs = []
    # (widths, cf, M, S, k, mean of W3, mean of b3)
    for widths, cf, m, s, k, w3, b3 in (((64, 64, 128), 8, 3, 37, 13, -0.1, 0.3),
                                        ((128, 128, 256), 128, 3, 37, 13, -0.05, 0.3),
                                        ((64, 64, 128), 8, 5, 301, 64, 0.0, 0.0),
                                        ((128, 128, 256), 128, 5, 301, 29, -0.05, 0.3),
                                        ((64, 64, 128), 8, 1, 1, 1, 0.0, 0.0)):
        n = max(200, s)
        pts = torch.from_numpy(rng.normal(0, 0.3, (m, n, 3 + cf)).astype(np.float32)).to(device)
        cidx = torch.from_numpy(rng.choice(n, s, replace=False).astype(np.int32)).to(device)
        gidx = torch.from_numpy(rng.integers(0, n, (s, k)).astype(np.int32)).to(device)
        dims = (3 + cf,) + widths
        Ws = [torch.from_numpy(rng.normal(w3 * (i == 2), 0.2, (dims[i], dims[i + 1]))
                               .astype(np.float32)).to(device) for i in range(3)]
        bs = [torch.from_numpy(rng.normal(b3 * (i == 2), 0.2, dims[i + 1]).astype(np.float32)).to(device)
              for i in range(3)]
        args = (pts[..., :3], pts[..., 3:], cidx, gidx, Ws, bs)
        want = sa.sa_mlp_max_plain(*args)
        label = f"widths {widths}, M={m}, S={s}, k={k}, W3 mean {w3}, b3 mean {b3}"
        if w3:
            x, pad = sa._grouped(*args[:4]), torch.zeros(dims[0], device=device)
            for w, b in zip(Ws, bs):
                pre = torch.matmul(x, w) + b
                x, pad = torch.relu(pre), torch.relu(torch.matmul(pad, w) + b)
            negative = float((pre < 0).float().mean())
            if negative < 0.5 or not bool((pad > want).any()):
                fail(f"sa_mlp_max edge case ({label}): layer 3 {negative:.2f} negative, "
                     f"padding row wins nowhere")
        errs.append(check_close(torch, f"sa_mlp_max ({label})", sa.sa_mlp_max_cuda(*args), want, SA_TOL))
    return max(errs)


def summary(name, source, replaces, launches, rows, edge_err, bound_peak):
    worst = max(rows, key=lambda r: r["bound_ms"])
    total = lambda key: None if rows[0][key] is None else sum(r[key] for r in rows)
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches, "max_abs_err": max([r["max_abs_err"] for r in rows] + [edge_err]),
        "ms": total("ms"), "plain_ms": total("plain_ms"), "bound_ms": total("bound_ms"),
        "bound_by": worst["bound_by"], "bound_peak": bound_peak, "library_ms": total("library_ms"),
        "per_call": rows,
    }


def make_scene(rng):
    """A 5 cm sphere of 2000 coloured points, LM-O-like intrinsics, a depth
    plane at 0.9 m, T random templates."""
    n = 2000
    nrm = rng.normal(0, 1, (n, 3))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    h, w = 480, 640
    return {
        "cam_K": np.array([[572.4, 0, 325.3], [0, 573.6, 242.0], [0, 0, 1]], np.float32),
        "model_points": (0.05 * nrm).astype(np.float32),
        "model_normals": nrm.astype(np.float32),
        "model_colors": (0.5 + 0.4 * nrm[:, [2, 0, 1]]).astype(np.float32),
        "depth": np.full((h, w), 900, np.uint16) + rng.integers(0, 5, (h, w)).astype(np.uint16),
        "limg": rng.uniform(0, 1, (N_TEMPLATES, 124, 124, 3)).astype(np.float32),
        "lmask": (rng.uniform(0, 1, (N_TEMPLATES, 124, 124)) > 0.3).astype(np.float32),
        "obj_id": 1,
    }


def serve_frame(dtoid, zephyr, gen_cls, scene, img):
    """detect -> hypotheses around the top box at 0.9 m -> score. Returns
    (det, poses, scored, detect ms, score ms), times on the host clock around
    calls that end with their results on the host."""
    batch = dict(scene, img=img)
    t0 = time.perf_counter()
    det = dtoid.forward_test_time(batch)
    t1 = time.perf_counter()
    x1, y1, x2, y2 = det["pred_bbox"][0]
    k, z = scene["cam_K"], 0.9
    anchor = np.eye(4)
    anchor[:3, 3] = ((x1 + x2) / 2 - k[0, 2]) * z / k[0, 0], ((y1 + y2) / 2 - k[1, 2]) * z / k[1, 1], z
    gen = gen_cls(n_hypos=N_HYPOS, seed=0)
    gen.set_anchor(anchor)
    poses, _, _ = gen.find_surface_model(np.zeros((0, 3)))
    t2 = time.perf_counter()
    scored = zephyr.score_hypotheses(dict(batch, pose_hypos=poses), obj_id=scene["obj_id"])
    t3 = time.perf_counter()
    return det, poses, scored, (t1 - t0) * 1e3, (t3 - t2) * 1e3


def check_frame(det, scored, img_hw):
    h, w = img_hw
    shapes = {"pred_bbox": (500, 4), "pred_scores": (500,), "pred_template_ids": (500,),
              "valid": (500,), "segmentation": (h, w), "heat_map": (h // 16 - 1, w // 16 - 1)}
    for key, shape in shapes.items():
        if det[key].shape != shape:
            fail(f"detection {key} has shape {det[key].shape}, expected {shape}")
    for key in ("pred_bbox", "pred_scores", "heat_map", "segmentation"):
        if not np.isfinite(det[key]).all():
            fail(f"detection {key} is not finite")
    if not det["valid"].any() or not (0 <= det["pred_template_ids"]).all() \
            or not (det["pred_template_ids"] < N_TEMPLATES).all():
        fail("detections are empty or name a template that does not exist")
    if scored["scores"].shape != (N_HYPOS,) or not np.isfinite(scored["scores"]).all():
        fail(f"scores {scored['scores'].shape} are not {N_HYPOS} finite values")


def compare_with_cpu(det, scored, det_cpu, scored_cpu):
    """GPU vs CPU on the same frame and weights. Tolerances: heat map and
    scores 1e-3 (float32 through 121 conv layers, different summation order
    on each device); boxes 0.05 px; seg mask mismatch <= 1e-3 of the pixels;
    >= 98% of the detections matched (a near-tied score may swap, a box near
    the NMS threshold may flip)."""
    out = {}
    out["heat_map_max_abs_err"] = float(np.abs(det["heat_map"] - det_cpu["heat_map"]).max())
    if out["heat_map_max_abs_err"] > 1e-3:
        fail(f"heat map GPU vs CPU differs by {out['heat_map_max_abs_err']:.3g}")
    out["seg_mismatch"] = float((det["segmentation"] != det_cpu["segmentation"]).mean())
    if out["seg_mismatch"] > 1e-3:
        fail(f"seg mask GPU vs CPU mismatch {out['seg_mismatch']:.3g}")
    n = int(det["valid"].sum())
    cs, cb, ct = (det_cpu[k][: int(det_cpu["valid"].sum())]
                  for k in ("pred_scores", "pred_bbox", "pred_template_ids"))
    matched = 0
    for s, b, t in zip(det["pred_scores"][:n], det["pred_bbox"][:n], det["pred_template_ids"][:n]):
        cand = np.nonzero(np.abs(cs - s) <= 1e-3)[0]
        matched += any(ct[j] == t and np.abs(cb[j] - b).max() <= 0.05 for j in cand)
    out["detections_matched"] = matched / max(n, 1)
    if out["detections_matched"] < 0.98 or abs(float(det["pred_scores"][0] - det_cpu["pred_scores"][0])) > 1e-3:
        fail(f"detections GPU vs CPU: {out['detections_matched']:.3f} matched")
    out["score_max_abs_err"] = float(np.abs(scored["scores"] - scored_cpu["scores"]).max())
    if not np.allclose(scored["scores"], scored_cpu["scores"], rtol=1e-3, atol=1e-3):
        fail(f"Zephyr scores GPU vs CPU differ by {out['score_max_abs_err']:.3g}")
    top2 = np.sort(scored_cpu["scores"])[-2:]
    if scored["pred_idx"] != scored_cpu["pred_idx"] and top2[1] - top2[0] > 2e-3:
        fail("Zephyr picks a different hypothesis on the GPU than on the CPU")
    return out


def perturb_heads(net, seed):
    """Random weights for the zero-initialised output convs, so that scores,
    boxes and masks differ between anchors."""
    import torch

    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for conv, std, bias in ((net.classification.output, 0.05, None),
                                (net.regression.output, 0.01, None),
                                (net.correlation_model.corr_conv_heatmap, 0.05, None),
                                (net.correlation_model.seg_final, 0.1, 0.0)):
            conv.weight.copy_(torch.randn(conv.weight.shape, generator=g) * std)
            if bias is not None:
                conv.bias.fill_(bias)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import torch.nn.functional as F

    from ossid_code_torch.core.config import default_config
    from ossid_code_torch.hypo.fake import FakeHypoGen
    from ossid_code_torch.kernels import build
    from ossid_code_torch.models.dtoid.module import DtoidModel
    from ossid_code_torch.models.zephyr.module import ZephyrModel
    from ossid_code_torch.ops import conv, sa_fused as sa

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "nvidia-smi: no output")
    name = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; precision float32, TF32 off "
          f"(cuDNN and matmul); peaks used for bounds: {HBM_BYTES_PER_S / 1e12} TB/s, "
          f"{FP32_FLOPS / 1e12} TFLOP/s FP32, {TF32_FLOPS / 1e12} TFLOP/s TF32")

    # -- 1. build -----------------------------------------------------------
    t0 = time.perf_counter()
    logs = build.build()
    print(f"built {[s.name for s in build.sources()]} in {time.perf_counter() - t0:.1f} s")
    for src, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {src}: {line.strip()}")

    # -- 2. kernels against their plain versions ----------------------------
    device = torch.device("cuda")
    rng = np.random.default_rng(0)
    scene = make_scene(rng)
    frames = [rng.integers(0, 256, (480, 640, 3), dtype=np.uint8) for _ in range(N_FRAMES + 1)]
    cfg = default_config()  # 480x640, DenseNet-121 (12, 24, 16), top-1000 / NMS 0.5 / top-500
    dtoid = DtoidModel(cfg, seed=0, device=device)
    perturb_heads(dtoid.net, 1)
    zephyr = ZephyrModel(num_points=NUM_POINTS, inconst_ratio_th=100.0, seed=0, need_uv=False,
                         device=device)
    prep = zephyr.prepare_object(scene["obj_id"], scene["model_points"], scene["model_colors"],
                                 scene["model_normals"])
    with torch.inference_mode():
        dw_edge_err = check_dw_corr_edges(torch, conv, dw_corr_edge_cases(torch, device))
        sa_edge_err = check_sa_edges(torch, sa, device)
        print(f"edge cases agree: dw_corr3x3 max abs err {dw_edge_err:.3g}, "
              f"sa_mlp_max max abs err {sa_edge_err:.3g}")
        dw_cases = dw_corr_cases(torch, device)
        dw_rows = measure_dw_corr(torch, F, conv, dw_cases)
        sa_rows = measure_sa(torch, sa, zephyr, prep)
    for label, rows in (("dw_corr3x3", dw_rows), ("sa_mlp_max", sa_rows)):
        for r in rows:
            extra = (f"; 3-pass floor {r['three_pass_floor_ms']:.4f} ms, FP32-pipe bound "
                     f"{r['fp32_pipe_bound_ms']:.4f} ms; weight packing {r['pack_ms']:.4f} ms "
                     f"device, {r['pack_host_ms']:.4f} ms host" if "fp32_pipe_bound_ms" in r else "")
            print(f"{label} {r['shape']}: err {r['max_abs_err']:.3g}, kernel {r['ms']:.4f} ms, "
                  f"plain {r['plain_ms']:.4f} ms, library {r['library_ms']}, "
                  f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}){extra}")

    # -- 3. serve full-width frames through the port's entry points ----------
    serve_frame(dtoid, zephyr, FakeHypoGen, scene, frames[0])  # warm-up: templates, cuDNN plans
    torch.cuda.synchronize()
    conv.dw_corr3x3_cuda.launches = 0
    sa.sa_mlp_max_cuda.launches = 0
    results = [serve_frame(dtoid, zephyr, FakeHypoGen, scene, img) for img in frames[1:]]
    for det, _, scored, _, _ in results:
        check_frame(det, scored, dtoid.img_size)
    dw_launches, sa_launches = conv.dw_corr3x3_cuda.launches, sa.sa_mlp_max_cuda.launches
    print(f"served {N_FRAMES} frames: detect {[round(r[3], 3) for r in results]} ms, "
          f"score {[round(r[4], 3) for r in results]} ms (host clock, results fetched); "
          f"launches dw_corr3x3 {dw_launches}, sa_mlp_max {sa_launches}; "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if dw_launches != 2 * N_FRAMES or sa_launches != 2 * N_FRAMES:
        fail(f"expected {2 * N_FRAMES} launches of each kernel, got dw_corr3x3 {dw_launches}, "
             f"sa_mlp_max {sa_launches}")
    batch = dict(scene, img=frames[1])
    poses = results[0][1]
    for label, fn in (("detect", lambda: dtoid.forward_test_time(batch)),
                      ("score", lambda: zephyr.score_hypotheses(dict(batch, pose_hypos=poses),
                                                                obj_id=scene["obj_id"]))):
        print(f"profile {label}: {json.dumps(profile_call(torch, fn))}")

    # -- 4. the first served frame again, plain path on the CPU ---------------
    torch.set_num_threads(os.cpu_count() or 1)
    t0 = time.perf_counter()
    dtoid_cpu = DtoidModel(cfg, seed=0, device="cpu")
    dtoid_cpu.load_state_dict({k: v.cpu() for k, v in dtoid.state_dict().items()})
    zephyr_cpu = ZephyrModel(num_points=NUM_POINTS, inconst_ratio_th=100.0, seed=0, need_uv=False,
                             device="cpu")
    zephyr_cpu.load_state_dict({k: v.cpu() for k, v in zephyr.state_dict().items()})
    det, _, scored, _, _ = results[0]
    det_cpu = dtoid_cpu.forward_test_time(batch)
    scored_cpu = zephyr_cpu.score_hypotheses(dict(batch, pose_hypos=poses), obj_id=scene["obj_id"])
    cmp = compare_with_cpu(det, scored, det_cpu, scored_cpu)
    print(f"GPU vs CPU plain path on frame 1 ({time.perf_counter() - t0:.1f} s): {json.dumps(cmp)}")

    kernels = [
        summary("dw_corr3x3", "ossid_code_torch/csrc/dw_corr3x3.cu",
                "ossid_code_tpu/ops/pallas_kernels.py:49", dw_launches, dw_rows, dw_edge_err,
                f"HBM {HBM_BYTES_PER_S / 1e12} TB/s"),
        summary("sa_mlp_max", "ossid_code_torch/csrc/sa_mlp_max.cu",
                "ossid_code_tpu/ops/sa_fused.py:85", sa_launches, sa_rows, sa_edge_err,
                f"TF32 tensor cores {TF32_FLOPS / 1e12} TFLOP/s"),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
