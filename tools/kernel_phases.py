#!/usr/bin/env python3
"""Where kernel 2b (csrc/sa_mlp_max_bf16.cu), kernels 3 / 3b
(csrc/dw_corr3x3_bwd.cu, dk) and kernel 1b (csrc/dw_corr3x3.cu) spend their
cycles, by phase.

    python3 tools/kernel_phases.py      (needs one NVIDIA GPU; about a minute)

Builds the three sources with their phase counters (-DSA_PHASES,
-DDK_PHASES, -DDW16_PHASES: clock64 reads between a warpgroup's, a block's
or a warp's phases, summed on the device) into
ossid_code_torch/_build/phases/, one nvcc each, started together, and
prints ptxas's registers and spills. Then it launches each counted build
once through its C entry point, with the arguments the port's wrapper
passes, at the main-path shapes:

- 2b at SA1 (512 centres, 11 -> 64 -> 64 -> 128) and SA2 (128 centres,
  131 -> 128 -> 128 -> 256), M = 128 and 256 hypotheses, k = 64, random
  indices: each phase's share of a warpgroup's cycles and the cycles a group
  takes one warpgroup;
- dk at the finetune's head and stem shapes (chip_smoke.dw_bwd_cases), in
  float32 and bf16, with the plan ops/conv.py::dw_corr3x3_dk_plan gives the
  card: a block's cycles in each phase, averaged over blocks, and the
  launch's span on the global timer;
- 1b at every main-path shape (chip_smoke.dw16_cases), under the choice it
  makes (ops/conv.py::dw_corr3x3_bf16_plan): a warp's cycles in its
  prologue (the tile's copies and barrier, the row walk's taps) and in the
  rest, the warps, and the launch's span and its warps' start spread on the
  global timer, beside the uncounted kernel's time (chip_smoke.cuda_ms):
  what the span leaves of that time is the launch's own cost.

Each result is held against its plain version first. The counters cost
time, so nothing here is a kernel time (chip_smoke.py measures those). The
card's name and power limit come first.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from ossid_code_torch.kernels import build  # noqa: E402
from ossid_code_torch.ops import conv, sa_fused as sa  # noqa: E402

SA_PHASES = ("wait", "fragments+issue", "layer1", "layer2", "layer3 MMA", "max", "stores")
DK_PHASES = ("prologue", "ring waits", "copies and sums", "block reduction", "cluster reduction")
DW16_PHASES = ("prologue", "walk")
_COUNTS = ctypes.POINTER(ctypes.c_ulonglong)


def build_counted() -> dict[str, tuple[ctypes.CDLL, str]]:
    """{source: (library, nvcc log)} of both sources built with their counters."""
    out_dir = build.BUILD_DIR / "phases"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, define in (("sa_mlp_max_bf16", "SA_PHASES"), ("dw_corr3x3_bwd", "DK_PHASES"),
                         ("dw_corr3x3", "DW16_PHASES")):
        out = out_dir / f"{name}.so"
        cmd = [build._nvcc(), *build._nvcc_flags(), f"-D{define}", "-o", str(out), str(build.CSRC_DIR / f"{name}.cu")]
        jobs[name] = (out, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (out, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log[-4000:]}")
        libs[name] = (ctypes.CDLL(str(out)), log)
    return libs


def sa_cases(rng):
    """(label, m, (xyz, feats, cidx, gidx, Ws, bs)) of SA1 and SA2 at M = 128
    and 256, random bf16 weights and points, float32 biases."""
    cases = []
    for widths, cf, s in (((64, 64, 128), 8, 512), ((128, 128, 256), 128, 128)):
        dims = (3 + cf,) + widths
        Ws = [torch.from_numpy(rng.normal(0, 0.2, (dims[i], dims[i + 1])).astype(np.float32)).cuda().bfloat16()
              for i in range(3)]
        bs = [torch.from_numpy(rng.normal(0, 0.2, dims[i + 1]).astype(np.float32)).cuda() for i in range(3)]
        cidx = torch.from_numpy(rng.choice(512, s, replace=False).astype(np.int32)).cuda()
        gidx = torch.from_numpy(rng.integers(0, 512, (s, 64)).astype(np.int32)).cuda()
        for m in (128, 256):
            if cf == 8:  # SA1: a view into the point rows, as the scorer passes them
                p = torch.from_numpy(rng.normal(0, 0.05, (m, 512, 11)).astype(np.float32)).cuda().bfloat16()
                xyz, feats = p[..., :3], p[..., 3:]
            else:        # SA2: the centres' xyz and SA1's output, rows of their own
                xyz = torch.from_numpy(rng.normal(0, 0.05, (m, 512, 3)).astype(np.float32)).cuda().bfloat16()
                feats = torch.from_numpy(rng.uniform(0, 1, (m, 512, cf)).astype(np.float32)).cuda().bfloat16()
            cases.append((f"SA{1 if cf == 8 else 2} M={m}", m, (xyz, feats, cidx, gidx, Ws, bs)))
    return cases


def sa_phases(lib: ctypes.CDLL) -> None:
    lib.sa_mlp_max_bf16.argtypes, lib.sa_mlp_max_bf16.restype = sa._LAUNCH_ARGS
    lib.sa_mlp_max_bf16_phases.argtypes = [_COUNTS]
    counts = (ctypes.c_ulonglong * 8)()
    stream = build.stream_ptr(torch.device("cuda"))
    for label, m, (xyz, feats, cidx, gidx, Ws, bs) in sa_cases(np.random.default_rng(0)):
        widths, cf = tuple(w.shape[1] for w in Ws), feats.shape[2]
        s, k = gidx.shape
        packed = sa.pack_sa_weights_bf16(Ws, cf, sa.SA_LAYOUT_BF16[widths])
        out = torch.empty((m, s, widths[2]), device="cuda", dtype=torch.bfloat16)
        aligned = int(feats.data_ptr() % 16 == 0 and all(v % 8 == 0 for v in (feats.stride(0), feats.stride(1), cf)))
        lib.sa_mlp_max_bf16_phases(counts)  # zero the counters
        build.check(lib.sa_mlp_max_bf16(
            xyz.data_ptr(), xyz.stride(0), xyz.stride(1), feats.data_ptr(), feats.stride(0), feats.stride(1),
            cf, aligned, cidx.data_ptr(), gidx.data_ptr(), m, s, k, *widths, packed.data_ptr(),
            bs[0].data_ptr(), bs[1].data_ptr(), bs[2].data_ptr(), out.data_ptr(), stream), "sa_mlp_max_bf16")
        torch.cuda.synchronize()
        lib.sa_mlp_max_bf16_phases(counts)
        err = cs.check_bf16(torch, f"2b {label}", out, sa.sa_mlp_max_plain(xyz, feats, cidx, gidx, Ws, bs),
                            steps=2.0)
        total = sum(counts[:7]) or 1
        print(json.dumps({"kernel": "2b", "case": label, "max_abs_err": err,
                          "phase_share": {n: round(counts[i] / total, 4) for i, n in enumerate(SA_PHASES)},
                          "cycles_per_group_per_warpgroup": total / (m * s)}))


def dk_phases(lib: ctypes.CDLL) -> None:
    for name in ("dw_corr3x3_dk_f32", "dw_corr3x3_dk_bf16"):
        getattr(lib, name).argtypes, getattr(lib, name).restype = conv._DK_ARGS
    lib.dw_corr3x3_dk_phases.argtypes = [_COUNTS]
    counts = (ctypes.c_ulonglong * 9)()
    stream = build.stream_ptr(torch.device("cuda"))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for bf16 in (False, True):
        vec, dtype = (8, "bf16") if bf16 else (4, "f32")
        for label, x, _, dout in cs.dw_bwd_cases(torch, torch.device("cuda"), bf16)[:2]:
            b, h, w, c = x.shape
            plan = conv.dw_corr3x3_dk_plan(b, h, w, c, vec, sms,
                                           lambda slice_vectors, bands: conv._dk_clusters(bf16, slice_vectors, bands, 0))
            dk = torch.empty((b, 3, 3, c), device="cuda", dtype=x.dtype)
            lib.dw_corr3x3_dk_phases(counts)  # reset the counters
            build.check(getattr(lib, f"dw_corr3x3_dk_{dtype}")(
                x.data_ptr(), dout.data_ptr(), dk.data_ptr(), b, h, w, c, x.stride(0),
                plan.slice_vectors, plan.band_rows, plan.bands, stream), f"dw_corr3x3_dk_{dtype}")
            torch.cuda.synchronize()
            lib.dw_corr3x3_dk_phases(counts)
            err = cs.rel_err(torch, dk, conv.dw_corr3x3_dk_plain(x, dout))
            if err > (2 * cs.BF16_STEP + 1e-4 if bf16 else cs.DK_TOL):  # chip_smoke.py's dk limits
                cs.fail(f"dk {dtype} {label}: relative error {err:.3g}")
            blocks = max(counts[5], 1)
            print(json.dumps({"kernel": "3b" if bf16 else "3", "case": label, "error": err, "plan": plan._asdict(),
                              "blocks": counts[5],
                              "phase_cycles_per_block": {n: counts[i] / blocks for i, n in enumerate(DK_PHASES)},
                              "span_us": (counts[8] - counts[6]) / 1e3,
                              "start_spread_us": (counts[7] - counts[6]) / 1e3}))


def dw16_phases(lib: ctypes.CDLL) -> None:
    lib.dw_corr3x3_bf16.argtypes, lib.dw_corr3x3_bf16.restype = conv._FWD_ARGS
    lib.dw_corr3x3_bf16_phases.argtypes = [_COUNTS]
    counts = (ctypes.c_ulonglong * 6)()
    stream = build.stream_ptr(torch.device("cuda"))
    for label, x, k, cross in cs.dw16_cases(torch, torch.device("cuda")):
        b, t, strides = conv._call_shape(x, k, cross)
        out = torch.empty((b, *x.shape[1:]), device="cuda", dtype=torch.bfloat16)
        lib.dw_corr3x3_bf16_phases(counts)  # reset the counters
        build.check(lib.dw_corr3x3_bf16(x.data_ptr(), k.data_ptr(), out.data_ptr(), b, t, *x.shape[1:], *strides,
                                        stream), "dw_corr3x3_bf16")
        torch.cuda.synchronize()
        lib.dw_corr3x3_bf16_phases(counts)
        want = conv.dw_corr3x3_cuda(cs.widened(x), cs.widened(k), cross=cross).bfloat16()
        if not torch.equal(out.view(torch.int16), want.view(torch.int16)):
            cs.fail(f"1b ({label}), counted build: differs from bf16(kernel 1 on the widened operands)")
        warps = max(counts[2], 1)
        print(json.dumps({"kernel": "1b", "case": label, "choice": conv.dw_corr3x3_bf16_plan(x, k, cross),
                          "warps": counts[2],
                          "phase_cycles_per_warp": {n: counts[i] / warps for i, n in enumerate(DW16_PHASES)},
                          "span_us": (counts[5] - counts[3]) / 1e3, "start_spread_us": (counts[4] - counts[3]) / 1e3,
                          "uncounted_us": 1e3 * cs.cuda_ms(torch, lambda: conv.dw_corr3x3_cuda(x, k, cross=cross))}))


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_phases: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip())
    libs = build_counted()
    for name, (_, log) in libs.items():
        print(json.dumps({"source": name, "ptxas": [f"{k}: {r}" for k, r in cs.ptxas_report(log)]}))
    with torch.inference_mode():
        sa_phases(libs["sa_mlp_max_bf16"][0])
        dk_phases(libs["dw_corr3x3_bwd"][0])
        dw16_phases(libs["dw_corr3x3"][0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
