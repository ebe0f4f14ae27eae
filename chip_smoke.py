#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (ossid_code_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:
  1. print the card (nvidia-smi name and power limit) and build every CUDA
     kernel from ossid_code_torch/csrc (one nvcc per source, in parallel)
     and the loop's host libraries from native/ppf.cpp and
     native/rasterizer.cpp (g++);
  2. hold each kernel against its plain PyTorch version at the shapes the
     serving path gives it and at inputs that reach its edges, and time
     kernel, plain version and (where one PyTorch call computes the same
     function) the library call; sa_mlp_max's bound is the TF32
     tensor-core one, with its 3-pass floor and the FP32-pipe bound beside;
     the same for the bf16 instances 1b (dw-corr) and 2b (sa_mlp_max, bound
     by dense BF16 tensor cores), against their plain bf16 versions;
  3. serve frames at full width through the port's entry points: DtoidModel
     (480x640, DenseNet-121 12/24/16, T=10 templates) forward_test_time, then
     FakeHypoGen, then ZephyrModel(num_points=512) score_hypotheses on 100
     hypotheses; the kernels' launch counters must show 2 launches per detect
     and 2 per score call; then one detect and one score call run under
     torch.profiler (device busy time, idle share, the kernels that take it);
     3b. the same frames and hypotheses in bf16 (bf16_infer and
     ZephyrModel(bf16=True), the same weights): 2 launches of 1b per detect
     and of 2b per score call and none of a float32 kernel, the JAX
     package's bf16 criteria against the float32 results, and a profile;
  4. run the first frame again through the plain path on the CPU with the
     same weights and compare (and its bf16 scores with the CPU's bf16);
  5. hold the backward of dw_corr3x3 (dx: kernel 1 on the output gradient
     with the taps turned; dk: kernel 3, csrc/dw_corr3x3_bwd.cu) against its
     plain version at the finetune's shapes and at edge inputs, check that
     dk is bitwise repeatable, and time both against their bounds, the
     plain versions and cuDNN's convolution_backward; then the same for the
     bf16 instances (dx: 1b; dk: 3b);
  6. run the online loop (loop/online_learning.py) on a synthetic world of
     8 frames at 480x640 with 2 objects (16 targets) under the bench's
     gating profile: 256 hypotheses from native PPF, device ICP of the top
     24, a 256-px depth crop, oracle labels, always the DTOID mask, and a
     finetune at batch 8 every 8 buffered targets, once with float32 steps
     and once with bf16_finetune (the bench's default), on its default
     pipelined schedule; the launch counts of every kernel instance must be
     those the schedule implies (kernel 1: 2 a detection, the speculative
     detections a finetune made stale and that went again included; every
     target one hit, stale or absent speculation, and at most 2
     redispatches a finetune event, here, in the demo and in the CLI);
  7. run one finetune step at full width (batch 2) on the card and through
     the plain path on the CPU from the same weights and compare the loss,
     the gradients leaf by leaf, the parameters after the step and the
     BatchNorm running statistics; 7b. one bf16_finetune step against the
     card's own float32 step from the same weights (batch 8): the loss, the
     gradients leaf by leaf, float32 master state, and the loss falling
     over 3 bf16 steps; the host-clock split of a float32 and of a bf16
     step by span (DtoidModel.step_spans) beside their times, and the two
     steps timed in turns on the same weights;
  8. the end-to-end demo (ossid_code_torch/scripts/demo_e2e.py) with the JAX
     bench's reduced quality protocol (--hard --n_objects 2 --frames 24
     --epochs 8 --zephyr_epochs 6 --pretrain_frames 12; 240x320,
     DenseNet-121, T=6, a 256-point scorer, batch 4): first kernels 1, its
     dx, 3 and 2 against their plain versions at the demo's shapes, then
     the demo itself (world, DTOID evaluation, offline pretraining, PPF with
     host ICP, scorer training and calibration, the full-scene bootstrap,
     the online loop with host ICP, BOP AR) with each kernel's launches per
     stage checked against the schedule, AR >= 0.30 (the JAX bench's floor),
     and the bf16 scorer on the trained weights against the float32 one on
     the calibration sets (pick agreement, ADD-correct picks, which must
     be float32's within BF16_SCORER_ADD_SLACK);
  9. the online-learning CLI (scripts/online_learning.py's main, in
     process) at full width on a synthetic world named ycbv (8 frames of
     480x640, 2 textured objects, one frame blanked; the grid and scorer
     pickle under the JAX names, a model-shift JSON, two scorer checkpoints
     of different seeds, a DTOID checkpoint with an empty segmentation
     head) with --use_sift_hypos --always_dtoid_mask --use_dtoid_segmask
     --use_oracle_gt --finetune_interval 8 --refine_device --refine_top 24
     and PPF: a row a target, each scorer only its parity of object, SIFT's
     poses on textured frames and its fallback (20 identity poses,
     time_sift None) on the blanked one, the CSV read back equal to the
     rows' picks, finite AR and mAP, a finetune, the launches the schedule
     implies and no bf16 kernel; then SIFT on the card against the CPU on
     the world's frames and templates (SIFT_MATCH_SHARE, SIFT_DESC_TOL), its
     time a textured frame (the blanked frame's apart), one textured frame
     under the profiler (kernels, device busy time, idle share) and the
     loop's frames/s;
 10. the class-conditional detector (models/maskrcnn.py: 480x640,
     DenseNet-121, the dataset config's 15 classes) through the CLI with
     --use_maskrcnn on phase 9's world (PPF, two scorers, host ICP, device
     ICP of the top 24, finetune at batch 8 every 8 targets from the host
     loader): a row a target, the CSV, finite AR and mAP, 2 finetune
     events, kernel 2 twice a score call and no dw-corr kernel (the
     detector has no correlation); the train CLI (scripts/train.py) for
     dataset=detect and dataset=dtoid_bop on the same world, 2 epochs each:
     its files and metric rows, the loss moving, and the launches (DTOID: 2
     of kernel 1 a step and a validation batch, 2 of its dx and of kernel 3
     a step; the detector: none), each step timed, then kernel 1 and the
     backward against their plain versions at every shape the run gave
     them; one frame and one train step of the detector on the card
     against the CPU (phase 4's and phase 7's limits; the stem's first
     BatchNorm scale at its own), and at two seeds both devices' float32
     gradients against a float64 CPU gradient; its detect and batch-8 step
     times with one traced call each; and the demo
     with --use_maskrcnn (fewer epochs than phase 8), which fails unless the
     pretrained detector's IoU exceeds the untrained one's.
 11. (run inside phase 6, on its world and bf16-step weights) the loop with
     --yuv_transfer, synchronous and pipelined in turns (PIPE_TURNS, after a
     warm-up run) from the same weights with cuDNN deterministic, each run
     fingerprinted (the detector's state after each finetune, the depth
     crop and pose count of each hypothesis generation): the same gates,
     finetune schedule and hypothesis counts in every run, the synchronous
     runs' scores and poses equal and the pipelined runs' no further
     (hold_turns: a failure names the first divergent target, its fields in
     both runs, the row counts and the stage where the runs part); the
     launches of each run (kernel 1: 2 a detection, redispatches included;
     kernel 2: 2 a score call; 1b, its dx and 3b: 2 a step) and its
     speculation as in phase 6; frames/s of each run, the speculation's hit
     rate, fetches a frame, the fetch and wait times by kind, one traced
     pipelined pass (CUDA activity only). Then a 480x640 frame's YUV upload
     and unpack against the direct upload (the card's unpack within 1 of
     the CPU's). The default configuration's turns are phase 16b's.
 12. the train CLI's legacy families at the presets' widths on a world built
     here (10 frames of 480x640 with 2 textured wedges, object 2 seen and 1
     unseen on a ycbv-named world; 128x128 and 124x124 template grids; an
     FSS-1000 layout of 4 classes x 5 images of 224x224 written with
     utils/jpeg.py): dataset=fewshot_bop, dataset=fss_1000, dataset=ycbv_sift
     and model=superglue, 2 epochs at batch 4 each, with phase 10c's checks
     and times, no kernel launched, the monitored metric in the stream and
     the matcher's loss falling; a 224x224 JPEG decode timed; one first
     step of the few-shot model and of the matcher card against CPU at full
     width (and the matcher's log assignment); DTOIDWrapper (480x640,
     DenseNet-121, n_local 10 of 16 views) from a checkpoint: 2 launches of
     kernel 1 a call and nothing else, a frame against the CPU plain path,
     its host time and one traced call.
 13. the BlenderProc render family at full width: a world of 6 sampled
     objects (6 scenes of 480x640, 10 template renders of 128x128 an
     object) written by utils/hdf5.py and read back equal, load_hdf5 timed;
     DTOID (480x640, DenseNet-121, the dtoid preset's 480 / 29 / 10) trained
     by OfflineTrainer on DtoidRenderDataset batches of 4 for 2 epochs, then
     validate and log_figures: the launches held to the schedule (kernel 1
     twice a step, a validation batch and a figure batch; its dx and kernel
     3 twice a step), the step and epoch times, one traced step, the
     figures decoded at their size, and one step card against CPU (phase
     7's limits); dataset=render model=fewshot_seg through the train CLI
     (run_train_cli: no kernel); dataset=dtoid through the CLI, which stops
     with KeyError 'limg' as the JAX CLI does; and kernel 1 at
     configuration 1's 160 templates (x (160, 29, 39, 640) with stride 0
     over T, a 463 MB output) against its plain version, timed beside its
     byte bound and cuDNN.
 14. scale-out on the one card: (a) kernel 1 and 1b over frames x
     templates (one launch for a round's head, 2 x 10 and 3 x 7, and the
     stem of 2 frames with the taps at stride 0) against their plain
     versions, timed beside the byte bound and cuDNN; (b) a farm round
     (loop/multi_stream.py::make_farm_detect on a one-device mesh: 2 of
     phase 3's frames, one trunk pass and kernel 1 twice) against
     DtoidModel's one-frame detect of each frame (phase 4's detection
     limits, the top pick's template and box equal), its host time and a
     traced round beside two one-frame detects'; (c) MultiStreamLoop on
     phase 6's kind of world cut to 2 scenes (streams) x 4 frames, native
     PPF, device ICP of the top 24, a finetune at batch 8 every 8 targets,
     twice from the same weights: a row list a stream covering its
     targets, a finetune, the weights moved, and the launches the schedule
     implies (kernel 1 twice a round and twice a step, its dx and kernel 3
     twice a step, kernel 2 twice a score call), frames/s; (d) the
     template-parallel, hypothesis-parallel (device ICP of the global top
     24) and 2-D farm forwards on the meshes [cuda:0] and [cuda:0, cuda:0]
     against the unsplit calls (scores within MESH_TOL, refined poses
     equal); (e) one OfflineTrainer step under a one-process NCCL group
     against the trainer with no group, from the same weights (phase 7's
     limits).
 15. the measuring tools: the roofline, the four A/B scripts, and (15f,
     run before phase 3: the profiler loses a session's first records once
     a process has opened about 15 sessions) the CUDA runtime the kernels
     resolve (built with `-cudart shared`: the one libcudart PyTorch maps,
     or the phase fails naming both), then 5 detect and score calls in one
     trace, where every launch of kernel 1 and 2 must be one device record
     under the kernel's own name inside a span of its name (trace_kernels);
     the log readers.
 16. the main path at the canonical configurations: (a) BASELINE config 3
     at its full length, 72 targets (36 frames x 2 objects), a finetune
     every 32 at batch 8, bf16 steps, RGB uploads, cuDNN deterministic, in
     turns (4 synchronous, 4 pipelined), held by hold_turns and each run's
     launch schedule, the dw-corr calls of one run against their plain
     versions, one pipelined pass traced; (b) the same turns in the port's
     default configuration (float32 steps, RGB, cuDNN's normal algorithms):
     launches and speculation held, medians and spreads of frames/s,
     schedules, divergences and spread reported; (c) configuration 1's 160
     templates through the CLI on a world named lmo (LMO_ARGV, 36 targets,
     a grid of 160 views an object), synchronous and pipelined: a row a
     target, the gates and schedule equal, the launches of the schedule, a
     finite CSV, kernel 1's T=160 calls against the plain version; (d)
     ossid_code_torch/entry.py: entry() and dryrun_multidevice(2) on the
     card.
Weights are random, from fixed seeds (the demo trains its own). The float32 paths run with TF32 off
for cuDNN convolutions and cuBLAS matmuls (main path and comparisons).

Before the last line it prints a `kernels` JSON line (six kernel instances,
each with its launches by path: the loop, the demo and the CLI for float32,
the bf16 runs and the CLI for bf16, and phase 10's CLI, demo and two train
runs, phase 11's pipelined and synchronous runs, phase 12's four train
runs and the wrapper, phase 13's three render runs, and phase 14's farm
round and multi-stream loop (its warm pass) for all; kernel 1's entry also
holds the T=160 row, and kernel 1's and 1b's the frame-indexed rows of
phase 14a; phase 16's runs are among the paths);
the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Without CUDA, or without the ossid_code_torch package beside it, it exits
non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
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
# backward of dw_corr3x3, relative to the reference's largest magnitude:
# dx sums 9 terms, dk sums H * W terms in another order
DX_TOL = 1e-5
DK_TOL = 1e-4
LOOP_FRAMES = 8          # x 2 objects = 16 targets
LOOP_HYPOS = 256         # the bench's gating profile (bench.py:300-304)
REFINE_TOP = 24
DEPTH_CROP = 256
FINETUNE_INTERVAL = 8    # the gating profile's 32, cut so 16 targets give 2 events
FINETUNE_BATCH = 8
# 7b times the float32 and bf16 steps in turns (f32, bf16, bf16, f32, ...),
# this many readings of each; the loop phases time each once, minutes apart
STEP_TURNS = 4
# one step on the card against the CPU. Loss and BatchNorm statistics:
# relative to the largest magnitude. Gradients, leaf by leaf: the L2 norm of
# the difference over the L2 norm of the CPU gradient. At full width the
# float32 gradients of this network are noisy: on an H100 the CPU's own
# float32 gradients read up to 0.029 against a float64 CPU run, the card's
# 0.035 against the CPU's; half the batch, dk or dx doubled, or a dk of the
# first sample only read 1.1 or more (tools/step_gradients.py prints these).
# A leaf whose largest CPU gradient is below STEP_GRAD_NOISE of the largest
# over all leaves is at float32 rounding level (float32's epsilon is 1.2e-7)
# and is left out. Parameters after Adam's first step (each element moves by
# about lr times the sign of its gradient): held to STEP_PARAM_TOL where the
# CPU gradient (weight decay included) exceeds twice its leaf's largest
# card-CPU gradient difference, so both devices step the same way there.
STEP_LOSS_TOL = 1e-4
STEP_STAT_TOL = 1e-4
STEP_GRAD_TOL = 0.1
STEP_GRAD_NOISE = 1e-6
STEP_PARAM_TOL = 1e-5
# A conv's bias that feeds a training-mode BatchNorm has a gradient of zero
# in exact arithmetic (the BatchNorm subtracts the batch mean); in float32 at
# phase 12's full width what is left is rounding above STEP_GRAD_NOISE (on an
# H100, 3.1e-6 of the largest gradient: zero_leaves_max_rel), so such leaves
# are held by their size on each device instead of against each other.
ZERO_GRAD_TOL = 1e-4
ROW_KEYS = ("obj_id", "pred_pose", "pred_score", "pred_err", "pred_add01d", "pred_mask_visib",
            "pred_iou_visib", "dtoid_bbox", "dtoid_score", "time_dtoid", "time_finetune",
            "use_dtoid_mask", "finetune")
# published peaks of one H100 SXM at its 700 W limit (NVIDIA data sheet):
# HBM bytes/s, FP32 flop/s outside the tensor cores, dense TF32 flop/s on
# the tensor cores; the card's own name and power limit are printed beside
# every run
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
TF32_FLOPS = 495e12
BF16_FLOPS = 989e12
# bf16: the largest relative size of one rounding step (8 significant bits). A
# bf16 kernel and its plain version sum in float32 in other orders, so a sum
# near a rounding midpoint may round to either neighbour: each bf16 kernel is
# held to one step (dw-corr, dx; dk also 1e-4 of the largest magnitude for
# its float32 order) or two (sa_mlp_max: a flipped layer-1 or layer-2 value
# moves the next layers) of the largest magnitude, with at most 1% of the
# elements more than one step of their own magnitude apart.
BF16_STEP = 2.0 ** -7
# bf16 serving against the float32 serving on the same weights and frames:
# the JAX package's criteria for its bf16 detect (tests/test_dtoid.py:204-236).
# The scorer, which the JAX package gives no bf16 criterion: every bf16 score
# within BF16_SCORE_TOL of the largest float32 score magnitude, and the bf16
# pick's float32 score within BF16_SCORE_TOL of the float32 pick's. The
# scorer's random head scores near 0 (|score| <= 0.006), so its bf16 scores
# sit several percent of the largest from its float32 ones: on an H100 the
# three served frames read 0.104 and a pick 0.034 below the float32 pick;
# the CPU plain path read 0.030-0.042 on poses from the same frames' boxes
# and 0.100 at a centred anchor, where the card's bf16 scores were 0.033
# from the CPU's. The limit is twice the largest reading. Phase 4 holds the
# card's bf16 scores against the CPU plain path's to the same limit.
BF16_TOP10_TOL = 0.05
BF16_SEG_AGREE = 0.98
BF16_SCORE_TOL = 0.2
# one bf16 step against the card's float32 step from the same weights, batch
# 8 at full width: the first-step loss within 5% (the JAX package's own
# criterion, tests/test_dtoid.py:250-282), and the gradients leaf by leaf,
# the L2 norm of the difference over that of the float32 step's. At random
# weights most of this network's bf16 gradient is rounding noise: on an H100
# the sound bf16 step reads 0.775 median, 1.173 at the 90th percentile and
# 1.80 at most over 549 leaves (twice, bit for bit in those statistics); half
# the batch reads 1.40 / 1.755, dk (3b) doubled 0.867 / 1.532, dx (1b)
# doubled 1.067 / 1.521 (tools/step_gradients.py --bf16). The check holds
# the 90th percentile, the statistic that parts sound runs from all three.
STEP16_LOSS_TOL = 0.05
STEP16_GRAD_P90_TOL = 1.35
# the JAX bench's reduced hard-world quality protocol (bench.py:454-461) and
# its AR floor (bench.py:462-469)
DEMO_ARGV = ["--hard", "--n_objects", "2", "--frames", "24", "--epochs", "8", "--zephyr_epochs", "6",
             "--pretrain_frames", "12"]
DEMO_AR_FLOOR = 0.30
# the bf16 scorer on the demo's trained weights: its picks ADD-correct on as
# many calibration sets as float32's, within this many (PERF.md's criterion)
BF16_SCORER_ADD_SLACK = 2
DEMO_TEMPLATES = 6
DEMO_POINTS = 256
SLEEP_CYCLES = 20_000_000  # ~10 ms of a 1.98 GHz SM clock: longer than enqueueing one timed run


T_START = time.perf_counter()


def stamp(what: str) -> None:
    """A line with the seconds since the script started, before `what`."""
    print(f"-- {what} at {time.perf_counter() - T_START:.1f} s", flush=True)


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
    device's busy time (sum of its kernels and copies, one stream), how many
    kernels and copies (or memsets) ran on the device, and the kernels that
    took most of the time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name: dict[str, float] = {}
    n_kernels = n_copies = 0
    for e in prof.events():
        # a user annotation's device range spans kernels counted on their own
        if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
            by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start) / 1e3
            if e.name.startswith(("Memcpy", "Memset")):
                n_copies += 1
            else:
                n_kernels += 1
    busy_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    host = sorted(prof.key_averages(), key=lambda a: -a.self_cpu_time_total)[:8]
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms if by_name else None,
            "device_kernels": n_kernels, "device_copies": n_copies,
            "top_kernels_ms": [(name[:70], ms) for name, ms in top],
            "host_top_ops_self_ms": [(a.key[:50], a.self_cpu_time_total / 1e3, a.count) for a in host]}


def trace_pass(torch, fn) -> dict:
    """One call of fn under torch.profiler with CUDA activity alone, read from
    the profiler's raw records (a loop pass launches some 3,500 kernels a
    target; building the CPU ops' event tree would take longer than the
    pass): the host-clock wall time, the device's busy time (the union of
    its kernels' and copies' intervals), the idle share of the wall time,
    the kernels and copies, the kernels that took most of the time, and the
    seconds the records took to read."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    t_read = time.perf_counter()
    intervals, by_name = [], {}
    n_kernels = n_copies = 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA or e.is_user_annotation():
            continue
        start, dur = e.start_ns(), e.duration_ns()
        intervals.append((start, start + dur))
        name = e.name()
        by_name[name] = by_name.get(name, 0.0) + dur / 1e6
        if name.startswith(("Memcpy", "Memset")):
            n_copies += 1
        else:
            n_kernels += 1
    busy_ns, end = 0, None
    for a, b in sorted(intervals):
        if end is None or b > end:
            busy_ns += b - (a if end is None else max(a, end))
            end = b
    busy_ms = busy_ns / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms if intervals else None,
            "device_kernels": n_kernels, "device_copies": n_copies,
            "top_kernels_ms": [(name[:70], ms) for name, ms in top], "read_s": time.perf_counter() - t_read}


def zero_launches(conv, sa):
    """Sets every kernel wrapper's launch counts (and FLOP tally) to 0 and
    returns a reader: a call gives {kernel: float32 launches, kernel_bf16:
    bf16 launches} since then (kernel 1, its dx, kernel 3 and kernel 2; 1b,
    3b and 2b). A wrapper replaced for a run (recording_dw_calls) gets the
    counters here: the wrappers count on the name they are bound to."""
    counters = {"dw_corr3x3": conv.dw_corr3x3_cuda, "dw_corr3x3_dx": conv.dw_corr3x3_dx_cuda,
                "dw_corr3x3_dk": conv.dw_corr3x3_dk_cuda, "sa_mlp_max": sa.sa_mlp_max_cuda}
    for c in counters.values():
        c.launches = c.launches_bf16 = c.flops = 0

    def read() -> dict:
        out = {name: c.launches for name, c in counters.items()}
        out.update({f"{name}_bf16": c.launches_bf16 for name, c in counters.items()})
        return out
    return read


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


def ptxas_report(log: str) -> list[tuple[str, str]]:
    """(kernel, "N registers, S bytes smem, spills ...") for each entry
    function in an `nvcc -Xptxas -v` log."""
    out, kernel, spills = [], "?", ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            kernel = line.split("'")[1] if "'" in line else line.strip()
        elif "spill" in line:
            spills = line.strip()
        elif "Used" in line and "registers" in line:
            out.append((kernel[:60], f"{line.split('Used', 1)[1].strip()}; {spills}"))
    return out


def check_close(torch, name, got, want, tol):
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, rtol=tol, atol=tol):
        fail(f"{name}: kernel disagrees with its plain version, max abs err {err:.3g} > tol {tol}")
    return err


def check_bf16(torch, name, got, want, steps=1.0, floor=0.0, share=0.01):
    """A bf16 kernel against its plain bf16 version (see BF16_STEP): every
    element within `steps` bf16 steps (plus `floor`) of the largest
    magnitude, at most `share` of them more than one step of their own
    magnitude (plus `floor`) apart. Returns the largest absolute error."""
    torch.cuda.synchronize()
    g, w = got.float(), want.float()
    err, scale = (g - w).abs(), float(w.abs().max())
    worst = float(err.max())
    off = float((err > BF16_STEP * w.abs() + floor * scale).float().mean())
    if worst > (steps * BF16_STEP + floor) * scale or off > share:
        fail(f"{name}: bf16 kernel disagrees with its plain version, max abs err {worst:.3g} of "
             f"{scale:.3g}, {off:.3g} of the elements beyond one bf16 step")
    return worst


def as_bf16(t):
    """t in bf16; a stride-0 broadcast over the batch stays a broadcast."""
    if t.shape[0] > 1 and t.stride(0) == 0:
        return t[:1].bfloat16().expand(t.shape)
    return t.bfloat16()


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


def demo_dw_corr_cases(torch, device):
    """Kernel 1 at the demo's detection shapes (240x320, T = 6): the
    correlation head and the image-encoder stem."""
    g = torch.Generator(device=device).manual_seed(11)
    feat = torch.randn(1, 14, 19, 640, device=device, generator=g)
    return [
        ("demo correlation head", feat.expand(DEMO_TEMPLATES, 14, 19, 640),
         torch.randn(DEMO_TEMPLATES, 3, 3, 640, device=device, generator=g)),
        ("demo image-encoder stem", torch.randn(1, 120, 160, 64, device=device, generator=g),
         torch.randn(1, 3, 3, 64, device=device, generator=g)),
    ]


def demo_dw_bwd_cases(torch, device):
    """The backward (dx: kernel 1; dk: kernel 3) at the demo's training
    shapes (batch 4 at 240x320)."""
    g = torch.Generator(device=device).manual_seed(12)
    r = lambda *shape: torch.randn(*shape, device=device, generator=g)
    return [("demo correlation head", r(4, 14, 19, 640), r(4, 3, 3, 640), r(4, 14, 19, 640)),
            ("demo image-encoder stem", r(4, 120, 160, 64), r(4, 3, 3, 64), r(4, 120, 160, 64))]


def dw_corr_edge_cases(torch, device, bf16=False):
    """Shapes off the main path that reach the kernel's edges: a W that is
    not a multiple of the run length (4), k broadcast with stride 0 over B,
    one column, C = 4 (bf16: C = 8, one vector; and 16 for 12)."""
    g = torch.Generator(device=device).manual_seed(3)
    r = lambda *shape: torch.randn(*shape, device=device, generator=g)
    c1, c2 = (16, 8) if bf16 else (12, 4)
    cases = [
        ("W 39, k stride 0 over B", r(1, 6, 39, 64).expand(3, 6, 39, 64), r(1, 3, 3, 64).expand(3, 3, 3, 64)),
        ("W 7, both per sample", r(2, 5, 7, c1), r(2, 3, 3, c1)),
        (f"W 1, C {c2}", r(3, 4, 1, c2), r(3, 3, 3, c2)),
        ("W 322, k stride 0 over B", r(2, 3, 322, 64), r(1, 3, 3, 64).expand(2, 3, 3, 64)),
    ]
    return [(label, as_bf16(x), as_bf16(k)) for label, x, k in cases] if bf16 else cases


def dw_check(torch, bf16):
    """The agreement check of kernel 1 (float32, DW_TOL) or 1b (bf16, one step)."""
    if bf16:
        return lambda name, got, want: check_bf16(torch, name, got, want)
    return lambda name, got, want: check_close(torch, name, got, want, DW_TOL)


def check_dw_corr_edges(torch, conv, cases, check):
    errs = []
    for label, x, k in cases:
        errs.append(check(f"dw_corr3x3 ({label})", conv.dw_corr3x3_cuda(x, k), conv.depthwise_corr_plain(x, k, 1)))
    return max(errs)


def measure_dw_corr(torch, F, conv, cases, check):
    rows = []
    for label, x, k in cases:
        b, h, w, c = x.shape
        got = conv.dw_corr3x3_cuda(x, k)
        want = conv.depthwise_corr_plain(x, k, 1)
        err = check(f"dw_corr3x3 ({label})", got, want)
        xi = x.permute(0, 3, 1, 2).reshape(1, b * c, h, w).contiguous()
        ki = k.permute(0, 3, 1, 2).reshape(b * c, 1, 3, 3).contiguous()
        bnd, by = bound_ms(unique_bytes(x) + unique_bytes(k) + got.numel() * got.element_size(),
                           18.0 * got.numel())
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


def measure_sa(torch, sa, zephyr, prep, m, bf16=False):
    """Kernel 2 (or 2b) at its two main-path stages, on the prepared
    object's real grouping indices and the scorer's folded weights (cast to
    bf16 for 2b, as the bf16 scorer casts them), at the M = m bucket (128:
    serving's 100 hypotheses; 256: the gating profile's). bound_ms is the
    TF32 (2b: dense bf16) tensor-core bound; for kernel 2 the 3-pass floor
    and the FP32-pipe bound are reported beside, and the time the wrapper
    spends packing the weights on each call, on the device and the host
    clock."""
    dt = torch.bfloat16 if bf16 else torch.float32
    g = torch.Generator(device=zephyr.device).manual_seed(2)
    point_x = (torch.randn(m, zephyr.num_points, 11, device=zephyr.device, generator=g) * 0.05).to(dt)
    _, _, _, sa1c, sa1g, sa2c, sa2g = prep[:7]
    mods = zephyr.net.SA_modules
    folded = [[w.to(dt) for w in Ws] + list(bs) for Ws, bs in (mods[i].mlps[0].folded() for i in range(2))]
    stages = []
    xyz, feats = point_x[..., :3], point_x[..., 3:]
    stages.append(("SA1", xyz, feats, sa1c, sa1g, folded[0][:3], folded[0][3:]))
    f1 = sa.sa_mlp_max_cuda(xyz, feats, sa1c, sa1g, *stages[0][5:])
    stages.append(("SA2", xyz[:, sa1c.long()].contiguous(), f1, sa2c, sa2g, folded[1][:3], folded[1][3:]))
    rows = []
    for label, x3, fx, cidx, gidx, Ws, bs in stages:
        args = (x3, fx, cidx, gidx, Ws, bs)
        got = sa.sa_mlp_max_cuda(*args)
        want = sa.sa_mlp_max_plain(*args)
        if bf16:
            err = check_bf16(torch, f"sa_mlp_max bf16 ({label})", got, want, steps=2.0)
        else:
            err = check_close(torch, f"sa_mlp_max ({label})", got, want, SA_TOL)
        s, k = gidx.shape
        dims = [3 + fx.shape[2]] + [w.shape[1] for w in Ws]
        flops = sa_flops(m, s, k, dims)
        nbytes = (unique_bytes(x3) + unique_bytes(fx) + 4 * (cidx.numel() + gidx.numel())
                  + sum(w.numel() * w.element_size() + 4 * b.numel() for w, b in zip(Ws, bs))
                  + got.numel() * got.element_size())
        bnd, by = bound_ms(nbytes, flops, BF16_FLOPS if bf16 else TF32_FLOPS)
        if bf16:
            pack = lambda: sa.pack_sa_weights_bf16(Ws, fx.shape[2], sa.SA_LAYOUT_BF16[tuple(dims[1:])])
        else:
            pack = lambda: sa.pack_sa_weights(Ws, fx.shape[2], *sa.SA_LAYOUT[tuple(dims[1:])])
        row = {
            "shape": f"{label}: (M={m}, S={s}, k={k}, Cin={dims[0]}) -> {dims[1:]}",
            "max_abs_err": err,
            "ms": cuda_ms(torch, lambda: sa.sa_mlp_max_cuda(*args)),
            "plain_ms": cuda_ms(torch, lambda: sa.sa_mlp_max_plain(*args), reps=10),
            "library_ms": None,
            "bound_ms": bnd, "bound_by": by, "gflop": flops / 1e9,
            "pack_ms": cuda_ms(torch, pack), "pack_host_ms": host_ms(torch, pack),
        }
        if not bf16:
            row.update(three_pass_floor_ms=3 * flops / TF32_FLOPS * 1e3,
                       fp32_pipe_bound_ms=flops / FP32_FLOPS * 1e3)
        rows.append(row)
    return rows


def check_sa_edges(torch, sa, device, bf16=False):
    """Inputs that reach the kernel's edges, against the plain version:
    k = 13 and 29 (padding rows in every tile), odd group counts (a partial
    last tile, and more tiles than blocks), k = 13 with several groups per
    warpgroup (the next group's gather in flight) from 16-byte aligned and
    from unaligned features, one group (fewer groups than warpgroups), and
    weights whose layer-3 outputs are mostly negative (W3 shifted down, b3
    up): relu hits zero on the real rows while a padding row, relu(b) of the
    chain, would win the max if it were not masked; the case checks that it
    would. bf16: the same inputs cast (biases stay float32), against kernel
    2b."""
    dt = torch.bfloat16 if bf16 else torch.float32
    rng = np.random.default_rng(9)
    errs = []
    # (widths, cf, M, S, k, mean of W3, mean of b3, features in rows of their own)
    for widths, cf, m, s, k, w3, b3, own in (((64, 64, 128), 8, 3, 37, 13, -0.1, 0.3, False),
                                             ((128, 128, 256), 128, 3, 37, 13, -0.05, 0.3, False),
                                             ((64, 64, 128), 8, 5, 301, 64, 0.0, 0.0, False),
                                             ((128, 128, 256), 128, 5, 301, 29, -0.05, 0.3, False),
                                             ((64, 64, 128), 8, 1, 1, 1, 0.0, 0.0, False),
                                             ((64, 64, 128), 8, 16, 301, 13, 0.0, 0.0, False),
                                             ((64, 64, 128), 8, 16, 301, 13, 0.0, 0.0, True),
                                             ((128, 128, 256), 128, 8, 301, 13, 0.0, 0.0, True)):
        n = max(200, s)
        pts = torch.from_numpy(rng.normal(0, 0.3, (m, n, 3 + cf)).astype(np.float32)).to(device, dt)
        cidx = torch.from_numpy(rng.choice(n, s, replace=False).astype(np.int32)).to(device)
        gidx = torch.from_numpy(rng.integers(0, n, (s, k)).astype(np.int32)).to(device)
        dims = (3 + cf,) + widths
        Ws = [torch.from_numpy(rng.normal(w3 * (i == 2), 0.2, (dims[i], dims[i + 1]))
                               .astype(np.float32)).to(device, dt) for i in range(3)]
        bs = [torch.from_numpy(rng.normal(b3 * (i == 2), 0.2, dims[i + 1]).astype(np.float32)).to(device)
              for i in range(3)]
        args = (pts[..., :3], pts[..., 3:].contiguous() if own else pts[..., 3:], cidx, gidx, Ws, bs)
        want = sa.sa_mlp_max_plain(*args)
        label = (f"{'bf16, ' if bf16 else ''}widths {widths}, M={m}, S={s}, k={k}, W3 mean {w3}, b3 mean {b3}"
                 f"{', aligned features' if own else ''}")
        if w3:
            x, pad = sa._grouped(*args[:4]), torch.zeros(dims[0], device=device, dtype=dt)
            for w, b in zip(Ws, bs):
                pre = torch.matmul(x.float(), w.float()) + b
                x, pad = sa.dense_relu(x, w, b), sa.dense_relu(pad, w, b)
            negative = float((pre < 0).float().mean())
            if negative < 0.5 or not bool((pad > want).any()):
                fail(f"sa_mlp_max edge case ({label}): layer 3 {negative:.2f} negative, "
                     f"padding row wins nowhere")
        got = sa.sa_mlp_max_cuda(*args)
        errs.append(check_bf16(torch, f"sa_mlp_max ({label})", got, want, steps=2.0) if bf16
                    else check_close(torch, f"sa_mlp_max ({label})", got, want, SA_TOL))
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
    out = compare_detections(det, det_cpu)
    out["score_max_abs_err"] = float(np.abs(scored["scores"] - scored_cpu["scores"]).max())
    if not np.allclose(scored["scores"], scored_cpu["scores"], rtol=1e-3, atol=1e-3):
        fail(f"Zephyr scores GPU vs CPU differ by {out['score_max_abs_err']:.3g}")
    top2 = np.sort(scored_cpu["scores"])[-2:]
    if scored["pred_idx"] != scored_cpu["pred_idx"] and top2[1] - top2[0] > 2e-3:
        fail("Zephyr picks a different hypothesis on the GPU than on the CPU")
    return out


def compare_detections(det, det_cpu):
    """A DTOID detection on the card against the CPU's: compare_with_cpu's
    limits for the heat map, the segmentation and the detections."""
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


def dw_bwd_cases(torch, device, bf16=False):
    """The finetune's two calls of the backward (per-sample x and k, batch 8)
    and edge inputs: B = 1 with C = 4, W = 13 with k broadcast over B, x
    broadcast over B, and a last channel slice only partly filled (C = 80:
    dk's plan takes slices of 16 vectors, 20 vectors in all, in clusters of
    6 bands of 2 rows over H = 12, W = 21). At the head, H = 29 is not a
    multiple of dk's 5-row bands and W = 39 not of its column lanes. Each
    case is (label, x, k, dout); a broadcast input is a stride-0 expand.
    bf16: the same in bf16 with C = 8, 16 and 160 for 4, 12 and 80 (a
    thread reads 16 bytes, 8 bf16 channels)."""
    g = torch.Generator(device=device).manual_seed(4)
    r = lambda *shape: torch.randn(*shape, device=device, generator=g)
    c1, c2, c3 = (8, 16, 160) if bf16 else (4, 12, 80)
    cases = [
        ("correlation head", r(8, 29, 39, 640), r(8, 3, 3, 640), r(8, 29, 39, 640)),
        ("image-encoder stem", r(8, 240, 320, 64), r(8, 3, 3, 64), r(8, 240, 320, 64)),
        (f"B 1, C {c1}", r(1, 5, 7, c1), r(1, 3, 3, c1), r(1, 5, 7, c1)),
        ("W 13, k stride 0 over B", r(3, 6, 13, c2), r(1, 3, 3, c2).expand(3, 3, 3, c2), r(3, 6, 13, c2)),
        ("W 39, x stride 0 over B", r(1, 6, 39, 64).expand(4, 6, 39, 64), r(4, 3, 3, 64), r(4, 6, 39, 64)),
        (f"C {c3}, a partial slice", r(16, 12, 21, c3), r(16, 3, 3, c3), r(16, 12, 21, c3)),
    ]
    return [(label, *map(as_bf16, ts)) for label, *ts in cases] if bf16 else cases


def rel_err(torch, got, want):
    torch.cuda.synchronize()
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)


def check_dw_bwd(torch, conv, label, x, k, dout, tols=(DX_TOL, DK_TOL)):
    """depthwise_corr's gradients on the card (DwCorr3x3: kernel 1 for dx,
    kernel 3 for dk; 1b and 3b in bf16) against the plain version's
    autograd, relative to the largest magnitude, within tols (dx, dk). A
    broadcast input's gradient is the sum over B, taken by autograd's
    expand."""
    dx_tol, dk_tol = tols
    b, h, w, c = dout.shape
    leaves = [t[:1].detach().clone() if t.stride(0) == 0 and b > 1 else t.detach().clone()
              for t in (x, k)]
    grads = []
    for fn in (conv.depthwise_corr, conv.depthwise_corr_plain):
        xl, kl = (t.clone().requires_grad_(True) for t in leaves)
        out = fn(xl.expand(b, h, w, c), kl.expand(b, 3, 3, c), 1)
        grads.append(torch.autograd.grad(out, (xl, kl), dout))
    (dx, dk), (want_dx, want_dk) = grads
    ex, ek = rel_err(torch, dx, want_dx), rel_err(torch, dk, want_dk)
    if ex > dx_tol or ek > dk_tol:
        fail(f"dw_corr3x3 backward ({label}): relative error dx {ex:.3g} (tol {dx_tol}), "
             f"dk {ek:.3g} (tol {dk_tol})")
    return ex, ek


def measure_dw_bwd(torch, conv, cases, tols=(DX_TOL, DK_TOL)):
    """dx (kernel 1 on dout with the taps turned) and dk (kernel 3), or 1b
    and 3b in bf16, on their own at the finetune's shapes: errors against
    the plain versions, dk's bitwise repeatability over 3 runs, device
    times, bounds (each input read once, each output written once, over the
    HBM rate) and cuDNN's convolution_backward of the grouped conv for the
    same gradients."""
    dx_tol, dk_tol = tols
    rows = []
    for label, x, k, dout in cases:
        b, h, w, c = dout.shape
        dk = conv.dw_corr3x3_dk_cuda(x, dout)
        dx = conv.dw_corr3x3_dx_cuda(dout, k)
        ek = rel_err(torch, dk, conv.dw_corr3x3_dk_plain(x, dout))
        ex = rel_err(torch, dx, conv.depthwise_corr_plain(dout, k.flip(1, 2), 1))
        if ex > dx_tol or ek > dk_tol:
            fail(f"dw_corr3x3 backward ({label}): relative error dx {ex:.3g}, dk {ek:.3g}")
        repeatable = all(torch.equal(conv.dw_corr3x3_dk_cuda(x, dout), dk) for _ in range(3))
        if not repeatable:
            fail(f"dw_corr3x3 dk ({label}) is not bitwise repeatable")
        xi = x.permute(0, 3, 1, 2).reshape(1, b * c, h, w).contiguous()
        ki = k.permute(0, 3, 1, 2).reshape(b * c, 1, 3, 3).contiguous()
        gi = dout.permute(0, 3, 1, 2).reshape(1, b * c, h, w).contiguous()
        lib = lambda mask: torch.ops.aten.convolution_backward(
            gi, xi, ki, None, [1, 1], [1, 1], [1, 1], False, [0, 0], b * c, mask)
        dk_bound, dk_by = bound_ms(unique_bytes(x) + unique_bytes(dout) + dk.numel() * dk.element_size(),
                                   18.0 * dout.numel())
        dx_bound, _ = bound_ms(unique_bytes(dout) + unique_bytes(k) + dx.numel() * dx.element_size(),
                               18.0 * dout.numel())
        rows.append({
            "shape": f"x {tuple(x.shape)}{' (stride 0 over B)' if x.stride(0) == 0 and b > 1 else ''}, "
                     f"dout {tuple(dout.shape)}",
            "max_abs_err": float((dk - conv.dw_corr3x3_dk_plain(x, dout)).abs().max()),
            "dk_rel_err": ek, "dx_rel_err": ex, "dk_bitwise_repeatable": repeatable,
            "ms": cuda_ms(torch, lambda: conv.dw_corr3x3_dk_cuda(x, dout)),
            "plain_ms": cuda_ms(torch, lambda: conv.dw_corr3x3_dk_plain(x, dout)),
            "library_ms": cuda_ms(torch, lambda: lib([False, True, False])),
            "bound_ms": dk_bound, "bound_by": dk_by,
            "dx_ms": cuda_ms(torch, lambda: conv.dw_corr3x3_dx_cuda(dout, k)),
            "dx_plain_ms": cuda_ms(torch, lambda: conv.depthwise_corr_plain(dout, k.flip(1, 2), 1)),
            "dx_library_ms": cuda_ms(torch, lambda: lib([True, False, False])),
            "dx_bound_ms": dx_bound,
        })
    return rows


@contextlib.contextmanager
def recording_dw_calls(conv):
    """Within, kernel 1's and kernel 3's wrappers in ops/conv.py (which
    DwCorr3x3, the path's entry, calls by name) also record the shapes they
    launch on. Yields the set of (call, x shape, x broadcast over B, k
    broadcast over B): call "forward" for kernel 1, "backward" for kernel 3
    (dk), whose backward launches dx with it."""
    calls = set()
    fwd, dk = conv.dw_corr3x3_cuda, conv.dw_corr3x3_dk_cuda
    bcast = lambda t: t.shape[0] > 1 and t.stride(0) == 0  # noqa: E731

    def recorded_fwd(x, k):
        calls.add(("forward", tuple(x.shape), bcast(x), bcast(k)))
        return fwd(x, k)

    def recorded_dk(x, dout):
        calls.add(("backward", tuple(x.shape), bcast(x), False))
        return dk(x, dout)

    conv.dw_corr3x3_cuda, conv.dw_corr3x3_dk_cuda = recorded_fwd, recorded_dk
    try:
        yield calls
    finally:
        conv.dw_corr3x3_cuda, conv.dw_corr3x3_dk_cuda = fwd, dk


def hold_dw_calls(torch, conv, calls):
    """Kernel 1 (DW_TOL) and the backward (dx: kernel 1, dk: kernel 3;
    DX_TOL, DK_TOL) against their plain versions on fresh random float32
    operands at each shape recording_dw_calls saw, broadcasts kept, after
    the run's counts were read. Returns a row a shape."""
    g = torch.Generator(device="cuda").manual_seed(14)
    r = lambda *shape: torch.randn(*shape, device="cuda", generator=g)  # noqa: E731
    rows = []
    for call, shape, xb, kb in sorted(calls):
        b, h, w, c = shape
        x = r(1, h, w, c).expand(shape) if xb else r(*shape)
        label = f"x {shape}{' stride 0 over B' if xb else ''}{', k stride 0 over B' if kb else ''}"
        if call == "forward":
            k = r(1, 3, 3, c).expand(b, 3, 3, c) if kb else r(b, 3, 3, c)
            err = check_close(torch, f"dw_corr3x3 ({label})", conv.dw_corr3x3_cuda(x, k),
                              conv.depthwise_corr_plain(x, k, 1), DW_TOL)
            rows.append({"call": call, "shape": label, "max_abs_err": err})
        else:
            ex, ek = check_dw_bwd(torch, conv, label, x, r(b, 3, 3, c), r(*shape))
            rows.append({"call": call, "shape": label, "dx_rel_err": ex, "dk_rel_err": ek})
    return rows


def loop_world(root, cfg, n_frames=LOOP_FRAMES):
    """The port's synthetic BOP world at 480x640 (the JAX bench's world,
    bench.py:77-110): `n_frames` frames of 2 objects, 10-view template
    grids, precomputed results (GT + noise, score 50) for the loaders."""
    import pickle

    from ossid_code_torch.data.bop import BopDataset, BopDatasetArgs
    from ossid_code_torch.data.synthetic import (
        default_objects, make_synthetic_bop, make_template_grid, make_zephyr_results_pkl,
    )

    make_synthetic_bop(root, n_frames=n_frames, img_h=480, img_w=640)
    make_template_grid(os.path.join(root, "grid"), default_objects(), n_views=10)
    d = cfg.dataset
    d.bop_root, d.test_dataset_name, d.grid_root = root, "synth", os.path.join(root, "grid")
    d.n_local_test, d.load_zephyr_result = N_TEMPLATES, True
    d.cache_frames = d.proc_cache_frames = 4 * n_frames
    d.zephyr_result_path = os.path.join(root, "zr.pkl")
    bop = BopDataset(BopDatasetArgs(bop_root=root, dataset_name="synth"))
    make_zephyr_results_pkl(d.zephyr_result_path, bop, score=50.0)
    with open(d.zephyr_result_path, "rb") as f:
        zr_list = pickle.load(f)
    return bop, zr_list


def hypo_gens(bop):
    """The bench's PPF matcher settings (bench.py:136-148), native/ppf.cpp."""
    from ossid_code_torch.hypo.ppf import PPFModelMeters

    return {oid: PPFModelMeters(bop.getObjPath(oid), ModelSamplingDist=0.04, scene_sampling_dist=0.05,
                                ref_pt_rate=0.25, refine_top=0, max_poses=LOOP_HYPOS) for oid in bop.obj_ids}


def run_loop(torch, dtoid, zephyr, cfg, bop, zr_list, gens, pipeline_scoring=True, yuv_transfer=False,
             interval=FINETUNE_INTERVAL):
    """The loop under the gating profile (a finetune every `interval`
    buffered targets), pipelined (the default) or not; returns its rows,
    the host-clock wall time of the run (synchronised at both ends) and the
    loop."""
    import argparse

    from ossid_code_torch.data.dtoid_bop import get_dataloaders
    from ossid_code_torch.loop.online_learning import OnlineLearningLoop

    args = argparse.Namespace(
        dataset_name="synth", exp_name="chip_smoke", use_dtoid_segmask=False,
        ignore_dtoid_mask=False, always_dtoid_mask=True, use_oracle_gt=True,
        use_sift_hypos=False, use_maskrcnn=False, finetune_interval=interval,
        finetune_warmup=0, finetune_epochs=1, finetune_reset=False,
        finetune_batch_size=FINETUNE_BATCH, non_cum=False, save_each=False, raw_dtoid=False,
        no_finetune=False, fast=True, zephyr_depth_crop=DEPTH_CROP, yuv_transfer=yuv_transfer)
    train_loader, _, test_loader = get_dataloaders(cfg, zr_list)
    test_loader.dataset.sortTargets()
    train_ds = train_loader.dataset
    train_ds.clearTargets()
    zr = {(r["obj_id"], r["scene_id"], r["im_id"]): dict(r) for r in zr_list}
    train_ds.zephyr_results = dict(zr)
    loop = OnlineLearningLoop(args, cfg, dtoid, bop, train_ds, test_loader, zr,
                              zephyr_model=zephyr, hypo_gens=gens, pipeline_scoring=pipeline_scoring)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rows = loop.run(progress=False)
    torch.cuda.synchronize()
    return rows, time.perf_counter() - t0, loop


def finetune_batch(rng, b):
    """A float finetune batch at full width (the feed of train_step)."""
    ann = np.full((b, 1, 5), -1.0, np.float32)
    for i in range(b):
        x1, y1 = rng.uniform(0, 500), rng.uniform(0, 340)
        ann[i, 0] = [x1, y1, x1 + rng.uniform(60, 140), y1 + rng.uniform(60, 140), 1]
    return {
        "img": rng.uniform(0, 1, (b, 480, 640, 3)).astype(np.float32),
        "limg": rng.uniform(0, 1, (b, 124, 124, 3)).astype(np.float32),
        "lmask": (rng.uniform(0, 1, (b, 124, 124, 1)) > 0.4).astype(np.float32),
        "gimg": rng.uniform(0, 1, (b, 124, 124, 3)).astype(np.float32),
        "gmask": (rng.uniform(0, 1, (b, 124, 124, 1)) > 0.4).astype(np.float32),
        "bbox_gt": ann,
        "heatmap": rng.uniform(0, 1, (b, 29, 39, 1)).astype(np.float32),
        "mask": (rng.uniform(0, 1, (b, 480, 640, 1)) > 0.8).astype(np.float32),
    }


def time_train_step(torch, dtoid, rng, steps: int = 3):
    """Host-clock ms of one train_step_u8 at batch FINETUNE_BATCH, the
    replay feed the loop uses, after one warm-up step, synchronised; and the
    host-clock ms of each of the step's spans (DtoidModel.step_spans: the
    host's time to issue each part, without waiting for the device)."""
    b = FINETUNE_BATCH
    batch = finetune_batch(rng, b)
    feed = {"img_u8": torch.from_numpy((batch["img"] * 255).astype(np.uint8)).cuda(),
            "mask_bits": np.packbits(batch["mask"].reshape(b, -1) > 0, axis=1, bitorder="little"),
            "limg_u8": (batch["limg"] * 255).astype(np.uint8), "lmask_u8": batch["lmask"].astype(np.uint8),
            "gimg_u8": (batch["gimg"] * 255).astype(np.uint8), "gmask_u8": batch["gmask"].astype(np.uint8),
            "bbox_gt": batch["bbox_gt"], "heatmap": batch["heatmap"]}
    dtoid.train_step_u8(feed)
    torch.cuda.synchronize()
    dtoid.step_spans = {}
    t0 = time.perf_counter()
    for _ in range(steps):
        dtoid.train_step_u8(feed)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / steps
    spans = {k: v * 1e3 / steps for k, v in dtoid.step_spans.items()}
    dtoid.step_spans = None
    return ms, spans


def check_loop(rows, n_frames, launches, expected):
    if len(rows) != n_frames:
        fail(f"the loop returned {len(rows)} rows for {n_frames} targets")
    for r in rows:
        missing = [k for k in ROW_KEYS if k not in r]
        if missing:
            fail(f"a loop row lacks {missing}")
        if not np.isfinite(r["pred_pose"]).all():
            fail(f"a picked (refined) pose is not finite: {r['pred_pose']}")
    if sum(r["finetune"] for r in rows) < 2:
        fail(f"{sum(r['finetune'] for r in rows)} finetune events, expected at least 2")
    if launches != expected:
        fail(f"loop launches {launches} differ from the schedule's {expected}")


def grad_errors(grads, ref):
    """Leaf by leaf, the L2 norm of grads - ref over that of ref, for the
    leaves above float32 rounding level (STEP_GRAD_NOISE). Returns {leaf:
    error} and the names of the leaves left out."""
    scale = max(float(g.abs().max()) for g in ref.values())
    errs, dropped = {}, []
    for name, want in ref.items():
        if float(want.abs().max()) < STEP_GRAD_NOISE * scale:
            dropped.append(name)
        else:
            errs[name] = float((grads[name] - want).norm() / want.norm())
    return errs, dropped


def hold_grads(errs, leaf_tols, what, grad_tol=STEP_GRAD_TOL):
    """Fails where a leaf's error exceeds its limit: its own in leaf_tols,
    else grad_tol."""
    for name, err in errs.items():
        tol = leaf_tols.get(name, grad_tol)
        if err > tol:
            fail(f"gradient of {name} differs between {what} by {err:.3g} (relative L2, tol {tol})")


def compare_step(torch, dtoid_gpu, dtoid_cpu, batch, leaf_tols=None, grad_tol=STEP_GRAD_TOL, zero_leaves=()):
    """One float32 train step on the card and on the CPU from the same
    weights and fresh optimizer state (see the STEP_* tolerances; gradients
    to `grad_tol`); a leaf named in `leaf_tols` is held to its own limit
    there, and a leaf in `zero_leaves`, whose exact gradient is zero, to
    ZERO_GRAD_TOL of the largest gradient on each device. Any model with the
    train-step interface (`train_step`, `net`, `optimizer`, `state_dict`):
    DTOID, the detector, the legacy models."""
    leaf_tols = leaf_tols or {}
    out = {}
    before = {name: p.detach().double().clone() for name, p in dtoid_cpu.net.named_parameters()}
    losses = [float(m.train_step(batch)["loss"]) for m in (dtoid_gpu, dtoid_cpu)]
    out["loss_gpu"], out["loss_cpu"] = losses
    out["loss_rel_err"] = abs(losses[0] - losses[1]) / abs(losses[1])
    if out["loss_rel_err"] > STEP_LOSS_TOL:
        fail(f"finetune step loss GPU {losses[0]} vs CPU {losses[1]}")
    g_cpu = {name: p.grad.double() for name, p in dtoid_cpu.net.named_parameters()}
    g_gpu = {name: p.grad.double().cpu() for name, p in dtoid_gpu.net.named_parameters()}
    if zero_leaves:
        scale = max(float(g.abs().max()) for g in g_cpu.values())
        zero = {n: max(float(g[n].abs().max()) for g in (g_gpu, g_cpu)) / scale for n in zero_leaves}
        out["zero_leaves_max_rel"] = max(zero.values())
        if out["zero_leaves_max_rel"] > ZERO_GRAD_TOL:
            fail(f"gradients that are zero in exact arithmetic reach {out['zero_leaves_max_rel']:.3g} of the "
                 f"largest (tol {ZERO_GRAD_TOL}): {max(zero, key=zero.get)}")
        g_cpu = {n: g for n, g in g_cpu.items() if n not in zero}
    errs, dropped = grad_errors(g_gpu, g_cpu)
    dropped = dropped + list(zero_leaves)
    hold_grads(errs, leaf_tols, "card and CPU", grad_tol)
    rest = {n: e for n, e in errs.items() if n not in leaf_tols}
    worst = max(rest, key=rest.get)
    out.update(grad_leaves=len(errs), grad_leaves_at_rounding_level=dropped,
               grad_max_rel_l2_err=rest[worst], grad_worst_leaf=worst,
               grad_median_rel_l2_err=float(np.median(list(errs.values()))),
               grad_rel_l2_err_own_limit={n: errs[n] for n in leaf_tols if n in errs})
    group = dtoid_cpu.optimizer.param_groups[0]
    wd = group["weight_decay"]
    gpu_params = dict(dtoid_gpu.net.named_parameters())
    n_par = n_held = 0
    worst_param = 0.0
    for name, p in dtoid_cpu.net.named_parameters():
        n_par += p.numel()
        if name in dropped:
            continue
        delta = float((g_gpu[name] - g_cpu[name]).abs().max())
        held = (g_cpu[name] + wd * before[name]).abs() > 2.0 * delta
        d = (gpu_params[name].detach().cpu().double() - p.detach().double()).abs()[held]
        n_held += d.numel()
        if d.numel():
            worst_param = max(worst_param, float(d.max()))
    out.update(params=n_par, params_held=n_held, param_max_abs_err=worst_param)
    if worst_param > STEP_PARAM_TOL:
        fail(f"parameters after one step differ by {worst_param:.3g} where both devices' gradients "
             f"agree in sign (tol {STEP_PARAM_TOL})")
    worst_stat = 0.0
    sd_gpu, sd_cpu = dtoid_gpu.state_dict(), dtoid_cpu.state_dict()
    for name, buf in dtoid_cpu.net.named_buffers():
        if buf.dtype.is_floating_point:
            d = float((sd_gpu[name].cpu() - sd_cpu[name]).abs().max())
            worst_stat = max(worst_stat, d / max(float(sd_cpu[name].abs().max()), 1e-30))
    out["stat_max_rel_err"] = worst_stat
    if worst_stat > STEP_STAT_TOL:
        fail(f"BatchNorm running statistics after one step differ by {worst_stat:.3g} (relative)")
    return out


SPEC_KINDS = ("spec_hit", "spec_stale", "spec_absent", "spec_redispatch")
SPEC_AHEAD = 2   # OSSID_FETCH_BUNDLE's default: detections dispatched ahead of their frame


def speculation(stats) -> dict:
    """The speculation's counts of a run (utils/rpc_stats.py)."""
    c = stats.snapshot()["counts"]
    return {k: c.get(k, 0) for k in SPEC_KINDS}


def hold_speculation(spec: dict, targets: int, finetune_events: int, where: str) -> int:
    """The detections a pipelined run dispatched again after a finetune made
    them stale (at their frame: spec_stale; ahead of it: spec_redispatch),
    held to the schedule rather than to the loop's own count alone: every
    target is one hit, stale or absent speculation, and a finetune event
    makes stale at most the SPEC_AHEAD detections dispatched ahead of it.
    Returns the redispatches."""
    n = spec["spec_stale"] + spec["spec_redispatch"]
    seen = spec["spec_hit"] + spec["spec_stale"] + spec["spec_absent"]
    if seen != targets or n > SPEC_AHEAD * finetune_events:
        fail(f"{where}: speculation {spec} for {targets} targets and {finetune_events} finetune events (hit + stale "
             f"+ absent must be the targets, the redispatches at most {SPEC_AHEAD} an event)")
    return n


def drive_loop(torch, conv, sa, dtoid, zephyr, cfg, bop, zr_list, gens):
    """One counted run of the (pipelined) loop, every launch counter and the
    loop's STATS at 0 just before and read just after, then a second pass
    under torch.profiler. Returns (rows, wall s, loop, launches {kernel:
    count, and "redispatches": the detections dispatched again after a
    finetune made them stale}, peak GiB, profile)."""
    from ossid_code_torch.utils.rpc_stats import STATS

    torch.cuda.reset_peak_memory_stats()
    STATS.reset()
    read_launches = zero_launches(conv, sa)
    rows, wall_s, loop = run_loop(torch, dtoid, zephyr, cfg, bop, zr_list, gens)
    launches = read_launches()
    launches["redispatches"] = hold_speculation(speculation(STATS), len(rows), sum(r["finetune"] for r in rows),
                                                "the loop")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    # the same loop again under torch.profiler (device busy time and the
    # kernels that take it), after the launch counts were read
    profile = trace_pass(torch, lambda: run_loop(torch, dtoid, zephyr, cfg, bop, zr_list, gens))
    return rows, wall_s, loop, launches, peak_gib, profile


def loop_summary(rows, wall_s, loop, launches, peak_gib, step_ms) -> dict:
    n_steps = sum(len(ep) for logs in loop.finetune_logs for ep in logs)
    events = [r["time_finetune"] for r in rows if r["finetune"]]
    return {
        "frames": len(rows), "wall_s": wall_s, "frames_per_s": len(rows) / wall_s,
        "frame_ms": [round((r["time_iter"] + r["time_complete"]) * 1e3, 2) for r in rows],
        "hypotheses": [int(r["n_hypos"]) for r in rows],
        "finetune_events": len(events), "finetune_event_ms": [e * 1e3 for e in events],
        "train_steps": n_steps, "train_step_ms_in_loop": sum(events) * 1e3 / max(n_steps, 1),
        "train_step_ms_b8": step_ms, "detect_ms": [r["time_dtoid"] * 1e3 for r in rows],
        "score_ms": [None if r["time_zephyr"] is None else r["time_zephyr"] * 1e3 for r in rows],
        "ppf_ms": [None if r["time_ppf"] is None else r["time_ppf"] * 1e3 for r in rows],
        "label_ms": [r["time_label"] * 1e3 for r in rows],
        "launches": launches, "peak_memory_gib": peak_gib,
        "pred_add01d": float(np.mean([r["pred_add01d"] for r in rows])),
    }


# phase 11: the pipelined loop against the synchronous one, in turns on
# phase 6's world and bf16-step weights, with the YUV 4:2:0 transport
PIPE_TURNS = ("sync", "pipelined", "pipelined", "sync")
PIPE_KEYS = ("obj_id", "scene_id", "im_id", "dtoid_confident", "zephyr_confident", "use_dtoid_mask", "finetune",
             "n_hypos")
YUV_TIMES = 20   # uploads timed, host clock, each way


def max_diff(a, b) -> float:
    """The largest |a - b| over two arrays of one shape, NaN against NaN and
    equal infinities counting as equal; NaN against a number, or shapes
    that differ, as inf."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if a.shape != b.shape:
        return float("inf")
    same = (a == b) | (np.isnan(a) & np.isnan(b))
    if same.all():
        return 0.0
    with np.errstate(invalid="ignore"):
        d = np.abs(a - b)[~same]
    return float(np.where(np.isnan(d), np.inf, d).max())


def row_ids(r) -> tuple:
    return int(r["obj_id"]), int(r["scene_id"]), int(r["im_id"])


def run_spread(a: list, b: list) -> dict:
    """The largest differences between two runs' rows, target by target:
    picked score, hypothesis scores (of the targets scored with as many
    hypotheses in both runs) and picked pose (max_diff: NaN equals NaN);
    the number of targets whose hypothesis counts differ; and the rows that
    do not pair with a row of the same target (`rows_misaligned`: another
    count or another order), which make every spread inf. Counts may differ
    where cuDNN's normal algorithms let the finetuned detector's masks
    drift (phase 16b)."""
    d = {"pred_score": 0.0, "hypo_scores": 0.0, "pred_pose": 0.0, "hypo_counts_differ": 0,
         "rows_misaligned": abs(len(a) - len(b))}
    for ra, rb in zip(a, b):
        if row_ids(ra) != row_ids(rb):
            d["rows_misaligned"] += 1
            continue
        d["pred_score"] = max(d["pred_score"], max_diff(ra["pred_score"], rb["pred_score"]))
        ha, hb = ra["hypo_scores"], rb["hypo_scores"]
        if (ha is None) != (hb is None) or (ha is not None and np.shape(ha) != np.shape(hb)):
            d["hypo_counts_differ"] += 1
        elif ha is not None:
            d["hypo_scores"] = max(d["hypo_scores"], max_diff(ha, hb))
        d["pred_pose"] = max(d["pred_pose"], max_diff(ra["pred_pose"], rb["pred_pose"]))
    if d["rows_misaligned"]:
        d.update(pred_score=float("inf"), hypo_scores=float("inf"), pred_pose=float("inf"))
    return d


def first_divergence(a: list, b: list) -> dict | None:
    """The first target at which run b's rows depart from run a's in
    PIPE_KEYS (the gates, the finetune schedule, the hypothesis count), a
    row that one run lacks included: its index, its PIPE_KEYS fields in
    both runs (None for a missing row) and the runs' row counts; None where
    every row agrees."""
    def keys(rows, i):
        return None if i >= len(rows) else {k: (v.item() if hasattr(v, "item") else v)
                                            for k, v in ((k, rows[i][k]) for k in PIPE_KEYS)}
    for i in range(max(len(a), len(b))):
        ka, kb = keys(a, i), keys(b, i)
        if ka != kb:
            return {"index": i, "a": ka, "b": kb, "rows": [len(a), len(b)]}
    return None


def digest(*arrays) -> str:
    """A digest of the arrays' shapes, dtypes and bytes (None counts as an empty array)."""
    import hashlib

    h = hashlib.blake2b(digest_size=8)
    for x in arrays:
        x = np.ascontiguousarray(np.asarray([] if x is None else x))
        h.update(f"{x.shape}{x.dtype}".encode())
        h.update(x.tobytes())
    return h.hexdigest()


def bits_checksum(torch, tensors):
    """A checksum of the tensors' bits, left on their device (no wait): each
    tensor's elements read as integers of their width, weighted by their
    position in the concatenation of those of that width, summed in int64
    (an integer sum wraps to the same value in any order)."""
    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    groups: dict = {}
    for t in tensors:
        t = t.detach()
        t = t.to(torch.uint8) if t.dtype == torch.bool else t
        groups.setdefault(t.element_size(), []).append(t.reshape(-1).view(ints[t.element_size()]))
    total = 0
    for size, parts in sorted(groups.items()):
        flat = torch.cat(parts).to(torch.int64)
        weight = torch.arange(flat.numel(), device=flat.device, dtype=torch.int64) % 65521 + size
        total = total + (flat * weight).sum()
    return total


@contextlib.contextmanager
def fingerprinting(torch, gens: dict):
    """Within, every finetune the loop runs (loop/online_learning.py's
    finetune_dtoid) leaves a checksum of the detector's parameters,
    BatchNorm statistics and optimiser state after it (bits_checksum, read
    when the block ends), and every hypothesis generation by `gens`
    (wrapped in place) a digest of its input cloud (the depth crop under
    the detection's mask) and its pose count. Nothing enters the loop's
    rows. Yields {"finetunes": [(buffered targets, checksum, the optimiser's
    distinct step counts)], "ppf": [(obj_id, input digest, poses)]}."""
    import ossid_code_torch.loop.online_learning as ol

    rec = {"finetunes": [], "ppf": []}
    finetune = ol.finetune_dtoid

    def recorded(model, train_dataset, *args, **kwargs):
        out = finetune(model, train_dataset, *args, **kwargs)
        opt = [v for st in model.optimizer.state.values() for v in st.values()]
        rec["finetunes"].append((len(train_dataset), bits_checksum(torch, [
            *model.net.state_dict().values(), *(v for v in opt if isinstance(v, torch.Tensor))]),
            sorted({int(v) for v in opt if not isinstance(v, torch.Tensor)})))
        return out

    def recording(oid, find):
        def find_recorded(scene_pc, *args, **kwargs):
            out = find(scene_pc, *args, **kwargs)
            rec["ppf"].append((oid, digest(scene_pc), len(out[0])))
            return out
        return find_recorded

    for oid, gen in gens.items():
        gen.find_surface_model = recording(oid, gen.find_surface_model)
    ol.finetune_dtoid = recorded
    try:
        yield rec
    finally:
        ol.finetune_dtoid = finetune
        rec["finetunes"] = [(n, int(c), counts) for n, c, counts in rec["finetunes"]]


def divergent_stage(a: dict, b: dict) -> dict | None:
    """Where run b first departs from run a (each a pipe_turns run: rows and
    fingerprints), target by target in the loop's order: "detection" (the
    detection's boxes, scores and mask bits; "before any finetune" where no
    event ran before that target), "mask" (the detection agrees, the depth
    crop PPF reads does not), "host PPF" (equal input, another pose count),
    "schedule" (another gate or finetune flag), "scoring" (scores, picked
    pose), then "finetune" (the checksum after an event, or an event one
    run lacks) before the next target. None where every stage agrees."""
    ra, rb = a["rows"], b["rows"]
    pa, pb = a["fingerprints"]["ppf"], b["fingerprints"]["ppf"]
    fa, fb = a["fingerprints"]["finetunes"], b["fingerprints"]["finetunes"]
    det = lambda r: digest(r["dtoid_bbox"], r["dtoid_score"], r["dtoid_pred_mask"])  # noqa: E731
    score = lambda r: digest(r["hypo_scores"], r["pred_pose"], r["pred_score"])  # noqa: E731
    events = 0
    for i in range(max(len(ra), len(rb))):
        if i >= len(ra) or i >= len(rb) or row_ids(ra[i]) != row_ids(rb[i]):
            return {"index": i, "stage": "rows", "rows": [len(ra), len(rb)]}
        x, y = ra[i], rb[i]
        where = {"index": i, "target": row_ids(x), "finetunes_before": events}
        if det(x) != det(y):
            return dict(where, stage="detection" + ("" if events else " before any finetune"),
                        top_scores=[np.asarray(x["dtoid_score"])[:3].tolist(), np.asarray(y["dtoid_score"])[:3].tolist()])
        crop = [p[i] if i < len(p) else None for p in (pa, pb)]
        if crop[0] != crop[1]:
            stage = "mask" if crop[0] is None or crop[1] is None or crop[0][1] != crop[1][1] else "host PPF"
            return dict(where, stage=stage, ppf=crop)
        d = first_divergence([x], [y])
        if d is not None:
            return dict(where, stage="schedule", a=d["a"], b=d["b"])
        if score(x) != score(y):
            return dict(where, stage="scoring", pred_score=[x["pred_score"], y["pred_score"]])
        if x["finetune"]:
            ev = [f[events] if events < len(f) else None for f in (fa, fb)]
            if ev[0] != ev[1]:
                return dict(where, stage="finetune", event=events, fingerprints=ev)
            events += 1
    return None


def yuv_transport(torch, frame: np.ndarray) -> dict:
    """The YUV 4:2:0 upload of one 480x640 frame (host pack, one upload,
    unpack on the card) against the direct RGB upload: host clock a frame
    (synchronised, median of YUV_TIMES, in turns), the unpack's device time
    (CUDA events), and the card's unpack against the CPU's (within 1)."""
    from ossid_code_torch.ops.yuv import pack_i420, ship_rgb_yuv420, unpack_i420
    from ossid_code_torch.utils.host_copy import to_device

    buf = pack_i420(frame)
    cpu = unpack_i420(torch.from_numpy(buf)).numpy()
    card = ship_rgb_yuv420(frame, "cuda").cpu().numpy()
    diff = np.abs(card.astype(int) - cpu.astype(int))
    if diff.max() > 1:
        fail(f"the card's YUV unpack differs from the CPU's by {diff.max()}")
    times = {"yuv": [], "rgb": []}
    for i in range(YUV_TIMES):
        for name, fn in ((("yuv", lambda: ship_rgb_yuv420(frame, "cuda")),
                          ("rgb", lambda: to_device(frame[None], "cuda")))[::1 if i % 2 == 0 else -1]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3)
    dev_buf = torch.from_numpy(buf).cuda()
    return {"bytes_yuv": int(buf.nbytes), "bytes_rgb": int(frame.nbytes),
            "upload_unpack_ms": float(np.median(times["yuv"])), "direct_upload_ms": float(np.median(times["rgb"])),
            "unpack_device_ms": cuda_ms(torch, lambda: unpack_i420(dev_buf)),
            "card_vs_cpu_max_diff": int(diff.max()), "card_vs_cpu_exact_share": float((diff == 0).mean())}


def pipe_turns(torch, conv, sa, dtoid, zephyr, cfg, bop, zr_list, make_gens, yuv: bool, warm_up: bool,
               turns=PIPE_TURNS, targets=2 * LOOP_FRAMES, interval=FINETUNE_INTERVAL, where="phase 11",
               record_dw=False) -> list:
    """The loop synchronous and pipelined in turns (`turns`, after one
    pipelined warm-up run when `warm_up`) from the same weights, a finetune
    every `interval` buffered targets, each run with fresh hypothesis
    generators from `make_gens`, fingerprinted (fingerprinting), and the
    launch counters and STATS at 0 just before and read just after. Every
    counted run's launches are held to its own schedule (kernel 1: 2 a
    detection, redispatches included; kernel 2: 2 a score call; the step's
    three kernels, float32 or bf16: 2 a step), its rows to `targets`, a
    pipelined run's speculation to hold_speculation and a synchronous run
    to none. With `record_dw`, the first counted run records the shapes
    kernels 1 and 3 launch on (recording_dw_calls, its "dw_calls"). Returns
    the runs, the warm-up first (mode "warm-up")."""
    from ossid_code_torch.utils.rpc_stats import STATS

    sd = dtoid.state_dict()
    step_kernels = ("dw_corr3x3_bf16", "dw_corr3x3_dx_bf16", "dw_corr3x3_dk_bf16") if dtoid.bf16_finetune else \
        ("dw_corr3x3", "dw_corr3x3_dx", "dw_corr3x3_dk")
    runs = []
    for i, mode in enumerate(("warm-up",) * warm_up + tuple(turns)):
        dtoid.load_state_dict(sd)
        dtoid.reset_optimizer()
        gens = make_gens()
        STATS.reset()
        recording = record_dw and i == int(warm_up)
        with fingerprinting(torch, gens) as prints, \
                (recording_dw_calls(conv) if recording else contextlib.nullcontext()) as dw_calls:
            read_launches = zero_launches(conv, sa)
            rows, wall_s, loop = run_loop(torch, dtoid, zephyr, cfg, bop, zr_list, gens,
                                          pipeline_scoring=mode != "sync", yuv_transfer=yuv, interval=interval)
            launches = read_launches()
        run = {"mode": mode, "rows": rows, "wall_s": wall_s, "launches": launches, "stats": STATS.snapshot(),
               "fingerprints": prints, "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
        if recording:
            run["dw_calls"] = dw_calls
        runs.append(run)
        if mode == "warm-up":
            continue
        spec = speculation(STATS)
        n_steps = sum(len(ep) for logs in loop.finetune_logs for ep in logs)
        if mode == "sync":
            stale = 0
            if any(spec.values()):
                fail(f"{where}: the synchronous run speculated: {spec}")
        else:
            stale = hold_speculation(spec, len(rows), sum(r["finetune"] for r in rows), f"{where} {mode}")
        expected = dict.fromkeys(launches, 0)
        expected.update({"dw_corr3x3": 2 * (len(rows) + stale),
                         "sa_mlp_max": 2 * sum(x["n_hypos"] > 0 for x in rows)})
        for name in step_kernels:
            expected[name] += 2 * n_steps
        events = sum(r["finetune"] for r in rows)
        if launches != expected or events != targets // interval or len(rows) != targets:
            fail(f"{where}: {mode} launches {launches} differ from the schedule's {expected} "
                 f"({len(rows)} targets of {targets}, {events} finetune events of {targets // interval}, "
                 f"{n_steps} steps, {stale} redispatched)")
        run.update(fetches_per_frame=STATS.fetch_rpcs_per_frame(len(rows)), hit_rate=STATS.spec_hit_rate(),
                   steps=n_steps, redispatches=stale)
    dtoid.load_state_dict(sd)
    dtoid.reset_optimizer()
    return runs


def turns_summary(runs: list) -> dict:
    """Frames/s of each mode, the spread of scores and poses within and
    between the modes, whether every run's gates, finetune schedule and
    hypothesis counts are the first synchronous run's (first_divergence of
    each run from it, and the stage where it departs: divergent_stage),
    each run's targets that differ by key, and each run's counts, fetches
    and waits by kind, and launches. The warm-up run is left out."""
    runs = [r for r in runs if r["mode"] != "warm-up"]
    sync = [r["rows"] for r in runs if r["mode"] == "sync"]
    pipe = [r["rows"] for r in runs if r["mode"] == "pipelined"]
    first = next(r for r in runs if r["mode"] == "sync")
    worst = lambda ds: {k: max(d[k] for d in ds) for k in ds[0]}  # noqa: E731
    fps = {m: [len(r["rows"]) / r["wall_s"] for r in runs if r["mode"] == m] for m in ("sync", "pipelined")}
    divergence = [first_divergence(sync[0], r["rows"]) for r in runs]
    return {"frames_per_s": fps, "frames_per_s_median": {m: float(np.median(v)) for m, v in fps.items()},
            "frames_per_s_spread": {m: float(max(v) - min(v)) for m, v in fps.items()},
            "schedules_equal": all(d is None for d in divergence), "first_divergence": divergence,
            "divergent_stage": [divergent_stage(first, r) for r in runs],
            "schedule_diffs": [dict({k: n for k in PIPE_KEYS if (n := int(sum(x[k] != y[k] for x, y in
                                                                                zip(r["rows"], sync[0]))))},
                                    **({"rows": len(r["rows"]) - len(sync[0])} if len(r["rows"]) != len(sync[0])
                                       else {})) for r in runs],
            "spread": {"sync_vs_sync": worst([run_spread(sync[0], b) for b in sync[1:]]),
                       "pipelined_vs_pipelined": worst([run_spread(pipe[0], b) for b in pipe[1:]]),
                       "pipelined_vs_sync": [run_spread(b, sync[0]) for b in pipe]},
            "peak_memory_gib": max(r["peak_gib"] for r in runs),
            "turns": [{"mode": r["mode"], "frames_per_s": len(r["rows"]) / r["wall_s"], "wall_s": r["wall_s"],
                       "spec_hit_rate": r["hit_rate"], "fetches_per_frame": r["fetches_per_frame"],
                       "counts": r["stats"]["counts"], "steps": r["steps"], "redispatches": r["redispatches"],
                       "finetune_checksums": [f[1] for f in r["fingerprints"]["finetunes"]],
                       "fetches": {k: {"n": n, "ms": t * 1e3} for k, (n, t) in r["stats"]["rpcs"].items()},
                       "launches": r["launches"]} for r in runs]}


def hold_turns(out: dict, where: str) -> None:
    """Fails unless every run's gates, finetune schedule and hypothesis
    counts are the first synchronous run's, the synchronous runs' scores and
    poses agree exactly, and the pipelined runs' no further from them;
    the message names the first divergent target and its stage."""
    spread = out["spread"]
    bad = [f"run {i} ({t['mode']}): first divergent target {json.dumps(d)}, stage {json.dumps(st)}"
           for i, (d, st, t) in enumerate(zip(out["first_divergence"], out["divergent_stage"], out["turns"]))
           if d is not None]
    if bad:
        fail(f"{where}: the runs' gates, finetune schedules or hypotheses differ from the first synchronous run's: "
             + "; ".join(bad))
    for k in ("pred_score", "hypo_scores", "pred_pose", "hypo_counts_differ", "rows_misaligned"):
        if spread["sync_vs_sync"][k] != 0:
            st = [x for x in out["divergent_stage"] if x is not None]
            fail(f"{where}: {k} differs by {spread['sync_vs_sync'][k]} between synchronous runs; first divergent "
                 f"stage {json.dumps(st[:1])} ({json.dumps(spread)})")
        for cross in spread["pipelined_vs_sync"]:
            if cross[k] > spread["sync_vs_sync"][k]:
                fail(f"{where}: {k} differs by {cross[k]} between the modes, by {spread['sync_vs_sync'][k]} between "
                     f"the synchronous runs ({json.dumps(spread)}; stages {json.dumps(out['divergent_stage'])})")


def phase11(torch, conv, sa, dtoid16, zephyr, cfg16, bop, zr_list, make_gens) -> dict:
    """The loop with --yuv_transfer and bf16 steps in turns (pipe_turns,
    after a warm-up run), cuDNN held to its deterministic algorithms so
    that two runs can agree bit for bit: hold_turns (every run's gates,
    finetune schedule and hypothesis counts equal, the synchronous runs'
    scores and poses equal, the pipelined runs' no further). Then one
    pipelined pass traced (trace_pass) and the transport timed. The default
    configuration's turns (float32 steps, RGB, cuDNN's normal algorithms)
    are phase 16b's. Returns what it measured."""
    t_phase = time.perf_counter()
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        runs = pipe_turns(torch, conv, sa, dtoid16, zephyr, cfg16, bop, zr_list, make_gens, yuv=True, warm_up=True)
        gens = make_gens()
        profile = trace_pass(torch, lambda: run_loop(torch, dtoid16, zephyr, cfg16, bop, zr_list, gens,
                                                     yuv_transfer=True))
    finally:
        torch.backends.cudnn.deterministic = det
    out = turns_summary(runs)
    hold_turns(out, "phase 11")
    out.update({"targets": 2 * LOOP_FRAMES, "profile_pipelined": profile,
                "transport": yuv_transport(torch, np.random.default_rng(11).integers(0, 256, (480, 640, 3), np.uint8)),
                "phase_s": time.perf_counter() - t_phase})
    return out


def compare_bf16_serving(results32, results16):
    """bf16 serving against float32 serving on the same weights, frames and
    hypotheses: per frame, the top-10 detection scores, the segmentation
    agreement at 0.5 and the scorer's pick (BF16_* limits)."""
    out = {"top10_max_abs_err": 0.0, "seg_agreement_min": 1.0, "picks_equal": 0, "pick_gaps": []}
    for (det32, _, scored32, _, _), (det16, scored16) in zip(results32, results16):
        out["top10_max_abs_err"] = max(out["top10_max_abs_err"], float(
            np.abs(det16["pred_scores"][:10] - det32["pred_scores"][:10]).max()))
        out["seg_agreement_min"] = min(out["seg_agreement_min"], float(
            np.mean((det16["segmentation"] > 0.5) == (det32["segmentation"] > 0.5))))
        s32 = scored32["scores"]
        if scored16["pred_idx"] == scored32["pred_idx"]:
            out["picks_equal"] += 1
        else:
            out["pick_gaps"].append(float(s32.max() - s32[scored16["pred_idx"]]) / float(np.abs(s32).max()))
        out["score_max_rel_err"] = max(out.get("score_max_rel_err", 0.0), float(
            np.abs(scored16["scores"] - s32).max() / np.abs(s32).max()))
    if out["top10_max_abs_err"] > BF16_TOP10_TOL or out["seg_agreement_min"] <= BF16_SEG_AGREE:
        fail(f"bf16 detect against float32: top-10 scores {out['top10_max_abs_err']:.3g} apart "
             f"(tol {BF16_TOP10_TOL}), seg agreement {out['seg_agreement_min']:.4f} (> {BF16_SEG_AGREE})")
    if out["score_max_rel_err"] > BF16_SCORE_TOL or any(gap > BF16_SCORE_TOL for gap in out["pick_gaps"]):
        fail(f"bf16 scores {out['score_max_rel_err']:.3g} of the largest apart from float32, picks "
             f"{out['pick_gaps']} below the float32 picks (tol {BF16_SCORE_TOL})")
    return out


def step_gradients(model) -> dict:
    return {name: p.grad.detach().double().cpu() for name, p in model.net.named_parameters()}


def compare_step_bf16(torch, m16, m32, batch, steps: int = 3):
    """One bf16_finetune step against the float32 step from the same weights
    and fresh optimizer state (STEP16_* limits), then steps - 1 more bf16
    steps on the same batch: the loss must fall, and the master weights,
    statistics and optimizer state stay float32."""
    out = {}
    l32 = float(m32.train_step(batch)["loss"])
    g32 = step_gradients(m32)
    losses = [float(m16.train_step(batch)["loss"])]
    errs, dropped = grad_errors(step_gradients(m16), g32)
    for _ in range(steps - 1):
        losses.append(float(m16.train_step(batch)["loss"]))
    vals = sorted(errs.values())
    out.update(loss_f32=l32, losses_bf16=losses, loss_rel_err=abs(losses[0] - l32) / abs(l32),
               grad_leaves=len(errs), grad_leaves_at_rounding_level=dropped,
               grad_max_rel_l2_err=vals[-1], grad_worst_leaf=max(errs, key=errs.get),
               grad_median_rel_l2_err=float(np.median(vals)), grad_p90_rel_l2_err=float(np.percentile(vals, 90)))
    if out["loss_rel_err"] > STEP16_LOSS_TOL:
        fail(f"bf16 step loss {losses[0]} against the float32 step's {l32} (tol {STEP16_LOSS_TOL})")
    if not losses[-1] < losses[0]:
        fail(f"bf16 steps on one batch do not lower the loss: {losses}")
    state = list(m16.state_dict().values()) + [v for st in m16.optimizer.state.values()
                                               for v in st.values() if isinstance(v, torch.Tensor)]
    if any(t.dtype != torch.float32 for t in state if t.is_floating_point()):
        fail("the bf16 step left a master weight, statistic or optimizer state outside float32")
    if out["grad_p90_rel_l2_err"] > STEP16_GRAD_P90_TOL:
        fail(f"bf16 step gradients against float32: 90th percentile of the leaves' relative L2 errors "
             f"{out['grad_p90_rel_l2_err']:.3g} (tol {STEP16_GRAD_P90_TOL})")
    return out


def demo_kernels(torch, F, conv, sa, device):
    """Kernels 1, its dx, 3 and 2 against their plain versions at the demo's
    shapes, timed as in phases 2 and 5: detection at 240x320 with T = 6,
    training steps at batch 4, and the 256-point scorer's SA stages at the
    calibration's and the loop's bucket 128 and the bootstrap's 256."""
    from ossid_code_torch.models.zephyr.module import ZephyrModel

    with torch.inference_mode():
        dw = measure_dw_corr(torch, F, conv, demo_dw_corr_cases(torch, device), dw_check(torch, False))
    cases = demo_dw_bwd_cases(torch, device)
    for case in cases:
        check_dw_bwd(torch, conv, *case)
    with torch.inference_mode():
        bwd = measure_dw_bwd(torch, conv, cases)
        z = ZephyrModel(num_points=DEMO_POINTS, inconst_ratio_th=100.0, seed=0, need_uv=False, align_feats=True,
                        device=device)
        scene = make_scene(np.random.default_rng(13))
        prep = z.prepare_object(0, scene["model_points"], scene["model_colors"], scene["model_normals"])
        sa_rows = measure_sa(torch, sa, z, prep, 128) + measure_sa(torch, sa, z, prep, 256)
    return dw, bwd, sa_rows


def demo_launch_schedule(stage: str, counts: dict, redispatches: int = 0) -> dict:
    """The float32 kernels' launches that the demo's code fixes for one stage:
    2 of kernel 1 per detect (stem and correlation head; in the pipelined
    loop a target's, and again for each of the `redispatches` speculative
    detections a finetune made stale) and per train step (its forward), 2
    of dx and of dk per train step, 2 of kernel 2 per score call (SA1, SA2),
    none in scorer training (unfused, as the JAX package trains)."""
    zero = {"dw_corr3x3": 0, "dw_corr3x3_dx": 0, "dw_corr3x3_dk": 0, "sa_mlp_max": 0}
    if stage in ("eval_untrained", "eval_pretrained"):
        return dict(zero, dw_corr3x3=2 * counts["detects_per_eval"])
    if stage == "pretraining":
        n = counts["pretrain_steps"]
        return dict(zero, dw_corr3x3=2 * n, dw_corr3x3_dx=2 * n, dw_corr3x3_dk=2 * n)
    if stage in ("calibration", "bootstrap"):
        return dict(zero, sa_mlp_max=2 * counts[f"{stage}_scored"])
    if stage == "loop":
        n = counts["finetune_steps"]
        return dict(zero, dw_corr3x3=2 * (counts["loop_frames"] + redispatches) + 2 * n, dw_corr3x3_dx=2 * n,
                    dw_corr3x3_dk=2 * n, sa_mlp_max=2 * counts["loop_scored"])
    return zero


def bf16_scorer_picks(torch, ztrainer) -> dict:
    """The demo's trained scorer in bf16 (ZephyrModel(bf16=True) on the same
    weights) against float32 on the calibration's real PPF sets: how often
    the picks agree, and how often each pick is ADD-correct."""
    from ossid_code_torch.models.zephyr.module import ZephyrModel
    from ossid_code_torch.train.zephyr_offline import ZephyrOfflineTrainer

    z32 = ztrainer.model
    z16 = ZephyrModel(num_points=z32.num_points, inconst_ratio_th=z32.inconst_ratio_th, need_uv=False,
                      align_feats=True, bf16=True, device=z32.device)
    z16.load_state_dict(z32.state_dict())
    t16 = ZephyrOfflineTrainer(z16, ztrainer.bop, ztrainer.model_clouds, hypo_gens=ztrainer.hypo_gens)
    targets = list(ztrainer.bop.targets)
    w, b = (t.detach().cpu().numpy() for t in (z32.net.align_head.weight, z32.net.align_head.bias))
    out = {"frames": 0, "picks_equal": 0, "add_correct_f32": 0, "add_correct_bf16": 0, "winnable": 0}
    for r32, r16 in zip(ztrainer._collect_real_sets(targets), t16._collect_real_sets(targets)):
        if r32 is None:
            continue
        i32 = int(np.argmax(r32["scores"] + r32["stats9"] @ w[0] + b[0]))
        i16 = int(np.argmax(r16["scores"] + r16["stats9"] @ w[0] + b[0]))
        out["frames"] += 1
        out["picks_equal"] += i32 == i16
        out["add_correct_f32"] += bool(r32["errs"][i32] < r32["th"])
        out["add_correct_bf16"] += bool(r16["errs"][i16] < r16["th"])
        out["winnable"] += bool(r32["errs"].min() < r32["th"])
    return out


def scorer_step_split(torch, ztrainer, steps: int = 3) -> dict:
    """Host-clock ms (synchronised) of one scorer train step on a demo
    training frame, and of its in-graph grouping alone (FPS and ball query
    of SA1 and SA2, as the step runs them)."""
    from ossid_code_torch.ops.pointcloud import ball_query, farthest_point_sample, gather_points

    point_x, labels, valid = ztrainer.make_training_batch(ztrainer.bop.targets[0])
    n = point_x.shape[1]

    def grouping():
        xyz = point_x[..., :3]
        idx = farthest_point_sample(xyz, min(512, n))
        c1 = gather_points(xyz, idx)
        ball_query(c1, xyz, 0.2, min(64, n))
        idx2 = farthest_point_sample(c1, min(128, n))
        ball_query(gather_points(c1, idx2), c1, 0.4, 64)

    out = {"hypotheses": int(point_x.shape[0]), "points": int(n)}
    for name, fn in (("train_step_ms", lambda: ztrainer.model.train_step(point_x, labels, valid, seed=0)),
                     ("grouping_ms", grouping)):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        out[name] = (time.perf_counter() - t0) * 1e3 / steps
    out["grouping_share"] = out["grouping_ms"] / out["train_step_ms"]
    return out


def run_demo(torch, conv, sa):
    """The demo through its entry point, every launch counter at 0 just
    before, read at the end of each stage; then, in its world, the bf16
    scorer against the float32 one (bf16_scorer_picks) and the scorer
    step's grouping share (scorer_step_split). Returns (summary, launches
    by stage, wall s of the demo, the bf16 picks, the step split, the loop's
    speculation counts)."""
    import tempfile

    from ossid_code_torch.scripts import demo_e2e
    from ossid_code_torch.utils.rpc_stats import STATS

    by_stage, seen, kept = {}, {}, {}

    def on_stage(name, **objects):
        now = read_launches()
        by_stage[name] = {k: v - seen.get(k, 0) for k, v in now.items()}
        seen.update(now)
        if "ztrainer" in objects:
            kept["ztrainer"] = objects["ztrainer"]

    with tempfile.TemporaryDirectory(prefix="ossid_demo_") as root:
        STATS.reset()
        read_launches = zero_launches(conv, sa)
        t0 = time.perf_counter()
        out = demo_e2e.main(DEMO_ARGV + ["--root", root], on_stage=on_stage)
        wall_s = time.perf_counter() - t0
        spec = speculation(STATS)
        picks = bf16_scorer_picks(torch, kept["ztrainer"])
        return out, by_stage, wall_s, picks, scorer_step_split(torch, kept["ztrainer"]), spec


# phase 9: the online-learning CLI on a synthetic world named ycbv (so the
# YCB-V branches run: two scorers by object parity, host ICP, its grid and
# pickle names), 480x640, 2 textured objects, at the CLI's network defaults
CLI_FRAMES = 8              # x 2 objects = 16 targets
CLI_BLANK_IM = 1            # this frame's RGB is one grey: SIFT finds nothing there
CLI_VIEWS = 10              # template views an object: T = 10
CLI_FINETUNE_INTERVAL = 8   # the gating profile's 32, cut so 16 targets give 2 events
# SIFT on the card against the CPU (ops/sift.py): the pyramid and the
# refinement are elementwise float32 chains in a fixed order, so positions
# agree; orientation histograms and descriptor norms are sums in another
# order, so a histogram peak at its 0.8 threshold may flip and a descriptor
# element may round to the next integer. Held: this share of the CPU's
# keypoints has a card keypoint within 0.01 px in the same octave (and of
# those, this share the same angle within 0.01 degree), and descriptors at
# the same keypoint differ by at most SIFT_DESC_TOL of 255
SIFT_MATCH_SHARE = 0.98
SIFT_DESC_TOL = 2.0


def compare_sift_runs(a: tuple, b: tuple, tol_px: float = 0.01, tol_deg: float = 0.01) -> dict:
    """Two SIFT runs on one image (the card's and the CPU's), each
    (Keypoints, (N, 128) descriptors): how many of a's keypoints have a
    keypoint of b within `tol_px` in the same octave, how many of those also
    its angle within `tol_deg`, and the largest descriptor difference (0-255
    scale) over the latter."""
    from scipy.spatial import cKDTree

    (ka, da), (kb, db) = a, b
    da, db = (np.asarray(d.cpu() if hasattr(d, "cpu") else d) for d in (da, db))
    out = {"n_a": ka.count, "n_b": kb.count, "matched": 0, "same_angle": 0, "max_desc_diff": 0.0}
    if not ka.count or not kb.count:
        return out
    tree = cKDTree(kb.pt)
    for i, near in enumerate(tree.query_ball_point(ka.pt, tol_px)):
        near = [j for j in near if (kb.octave[j] & 255) == (ka.octave[i] & 255)]
        if not near:
            continue
        out["matched"] += 1
        dang = [abs((kb.angle[j] - ka.angle[i] + 180.0) % 360.0 - 180.0) for j in near]
        j = near[int(np.argmin(dang))]
        if min(dang) <= tol_deg:
            out["same_angle"] += 1
            out["max_desc_diff"] = max(out["max_desc_diff"], float(np.abs(da[i] - db[j]).max()))
    return out


def textured_wedges() -> dict:
    """Two textured wedges: SIFT finds features on them (phases 9, 10 and 12)."""
    from ossid_code_torch.render.mesh import make_wedge_mesh, texture_mesh

    return {1: texture_mesh(make_wedge_mesh(85, 62, 45, taper=0.55, shear=0.35), amp=0.3, subdiv=3, seed=1),
            2: texture_mesh(make_wedge_mesh(70, 48, 55, taper=0.4, shear=-0.25), amp=0.3, subdiv=3, seed=2)}


def cli_world(root):
    """The CLI's inputs under `root`: the BOP dataset `ycbv` (CLI_FRAMES
    frames of 480x640, 2 textured wedges, frame CLI_BLANK_IM blanked), its
    template grid and precomputed scorer pickle under the JAX names in the
    data root, a model-shift JSON, two scorer checkpoints of different seeds
    and a DTOID checkpoint whose segmentation head predicts nothing (zero
    weights, bias -6: the loop's <= 25-pixel fallback then makes SIFT's
    region the whole frame)."""
    from ossid_code_torch.core.checkpoint import save_checkpoint
    from ossid_code_torch.core.config import default_config
    from ossid_code_torch.data.bop import BopDataset, BopDatasetArgs
    from ossid_code_torch.data.dtoid_bop import BOP_OBJECT_ID_OFFSETS
    from ossid_code_torch.data.synthetic import make_synthetic_bop, make_template_grid, make_zephyr_results_pkl
    from ossid_code_torch.models.dtoid.module import DtoidModel
    from ossid_code_torch.models.zephyr.module import ZephyrModel
    from ossid_code_torch.utils.png import read_png, write_png

    w = {k: os.path.join(root, k) for k in ("bop", "data", "ckpts", "results", "bop_results")}
    objects = textured_wedges()
    make_synthetic_bop(w["bop"], dataset_name="ycbv", n_frames=CLI_FRAMES, img_h=480, img_w=640, objects=objects)
    rgb = os.path.join(w["bop"], "ycbv", "test", "000000", "rgb", f"{CLI_BLANK_IM:06d}.png")
    write_png(rgb, np.full_like(read_png(rgb), 128))
    make_template_grid(os.path.join(w["data"], "templates_YCBV_BOP"), objects, n_views=CLI_VIEWS,
                       obj_id_offset=BOP_OBJECT_ID_OFFSETS["ycbv"])
    bop = BopDataset(BopDatasetArgs(bop_root=w["bop"], dataset_name="ycbv"))
    make_zephyr_results_pkl(os.path.join(w["data"], "test_ycbv_boptest_zephyr_result_unseen.pkl"), bop)
    os.makedirs(w["ckpts"])
    w["shifts"] = os.path.join(root, "shifts.json")
    with open(w["shifts"], "w") as f:
        json.dump({"1": [0.002, -0.003, 0.001], "2": [-0.004, 0.0, 0.002]}, f)
    dtoid = DtoidModel(default_config(), seed=1, device="cpu")
    perturb_heads(dtoid.net, 2)
    seg = dtoid.net.correlation_model.seg_final
    import torch

    with torch.no_grad():
        seg.weight.zero_()
        seg.bias.fill_(-6.0)
    w["dtoid"] = os.path.join(w["ckpts"], "dtoid_empty_seg.ckpt")
    save_checkpoint(w["dtoid"], dtoid.state_dict())
    for parity, seed in (("even", 10), ("odd", 11)):
        w[parity] = os.path.join(w["ckpts"], f"scorer_{parity}.ckpt")
        save_checkpoint(w[parity], ZephyrModel(num_points=NUM_POINTS, seed=seed, device="cpu").state_dict())
    return w, bop


def cli_argv(w, detector="dtoid", *extra):
    """Phase 9's CLI arguments on the world `w`, the detector's weights from
    w[detector]."""
    return ["--dataset_name", "ycbv", "--exp_name", "chip", *extra, "--always_dtoid_mask",
            "--use_dtoid_segmask", "--use_oracle_gt", "--finetune_interval", str(CLI_FINETUNE_INTERVAL),
            "--refine_device", "--refine_top", str(REFINE_TOP), "--hypo_backend", "ppf",
            "--dtoid_weights_path", w[detector], "--zephyr_ckpt_path_even", w["even"],
            "--zephyr_ckpt_path_odd", w["odd"], "--model_shift_path", w["shifts"]]


def run_cli(torch, conv, sa, w, argv):
    """The CLI's main in-process on the world with `argv` (phase 9: PPF +
    SIFT, two scorers, host ICP, device ICP of the top 24, finetune), every
    launch counter at 0 just before and read just after; the scorer calls
    and the hypotheses of each frame are recorded on the way. Returns
    (summary, launches, calls [(scorer, obj_id)], hypotheses a frame, wall s
    of main, of the loop)."""
    import ossid_code_torch.scripts.online_learning as cli
    from ossid_code_torch.loop.online_learning import OnlineLearningLoop
    from ossid_code_torch.models.zephyr.module import ZephyrModel
    from ossid_code_torch.utils.rpc_stats import STATS

    env = {"OSSID_ROOT": os.path.dirname(w["bop"]), "BOP_DATASETS_ROOT": w["bop"], "OSSID_DATA_ROOT": w["data"],
           "OSSID_CKPT_ROOT": w["ckpts"], "OSSID_RESULT_ROOT": w["results"], "BOP_RESULTS_FOLDER": w["bop_results"],
           "BOP_TOOLKIT_PATH": os.path.join(w["ckpts"], "no_toolkit")}
    calls, hypos, loop_wall, loop_rows = [], [], [], []
    score, gen, run = (ZephyrModel.score_hypotheses_async, OnlineLearningLoop._generate_hypotheses,
                       OnlineLearningLoop.run)

    def counted_score(self, data, obj_id=None):
        calls.append((self, obj_id))
        return score(self, data, obj_id=obj_id)

    def recorded_gen(self, obj_id, *a):
        poses = gen(self, obj_id, *a)
        hypos.append((obj_id, poses, a[-1]["time_sift"]))
        return poses

    def timed_run(self, *a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run(self, *a, **k)
        torch.cuda.synchronize()
        loop_wall.append(time.perf_counter() - t0)
        loop_rows.append(out)
        return out

    saved_env = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    ZephyrModel.score_hypotheses_async = counted_score
    OnlineLearningLoop._generate_hypotheses = recorded_gen
    OnlineLearningLoop.run = timed_run
    try:
        torch.cuda.synchronize()
        STATS.reset()
        read_launches = zero_launches(conv, sa)
        t0 = time.perf_counter()
        out = cli.main(cli.build_parser().parse_args(argv))
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = read_launches()
        spec = speculation(STATS)
    finally:
        ZephyrModel.score_hypotheses_async, OnlineLearningLoop._generate_hypotheses = score, gen
        OnlineLearningLoop.run = run
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    rows = loop_rows[0]
    if "--use_maskrcnn" in argv:
        # the class-conditional detector does not speculate: held at 0 with
        # the other launch counts
        launches["speculations"] = sum(spec.values())
    elif not out["loop"].pipeline_scoring:
        if any(spec.values()):
            fail(f"the CLI's synchronous loop speculated: {spec}")
        launches["redispatches"] = 0
    else:
        launches["redispatches"] = hold_speculation(spec, len(rows), sum(r["finetune"] for r in rows),
                                                    "the CLI's loop")
    return out, launches, calls, hypos, wall_s, loop_wall[0]


def check_cli(out, launches, calls, hypos, bop):
    """Phase 9's checks; returns the rows, the CSV's rows and counts."""
    import pickle

    from ossid_code_torch.eval.bop_csv import read_results_bop
    from ossid_code_torch.loop.online_learning import SIFT_FALLBACK_POSES

    loop = out["loop"]
    with open(out["results_path"], "rb") as f:
        saved = pickle.load(f)
    rows = saved["test_results"]
    if len(rows) != len(bop.targets) or set(saved) != {"test_results", "main_args", "finetune_logs",
                                                        "final_state_dict"}:
        fail(f"CLI results pickle: {len(rows)} rows for {len(bop.targets)} targets, keys {sorted(saved)}")
    even, odd = loop.zephyr_model_even, loop.zephyr_model_odd
    if even is None or odd is None or even is odd:
        fail("the CLI did not build two scorers for ycbv")
    by_scorer = {"even": sorted({o for m, o in calls if m is even}), "odd": sorted({o for m, o in calls if m is odd})}
    if (any(o % 2 for o in by_scorer["even"]) or any(o % 2 == 0 for o in by_scorer["odd"])
            or len(calls) != sum(r["n_hypos"] > 0 for r in rows) or not by_scorer["even"] or not by_scorer["odd"]):
        fail(f"scorer calls by parity: {by_scorer}, {len(calls)} calls")
    if len(hypos) != len(rows):
        fail(f"{len(hypos)} hypothesis generations for {len(rows)} rows")
    blank, joined = 0, 0
    for r, (oid, poses, t_sift) in zip(rows, hypos):
        if r["obj_id"] != oid or r["time_sift"] != t_sift or r["n_hypos"] != len(poses):
            fail(f"row {r['obj_id'], r['im_id']} does not match its hypotheses")
        if r["im_id"] == CLI_BLANK_IM:
            blank += 1
            if t_sift is not None or not np.array_equal(poses[:SIFT_FALLBACK_POSES],
                                                        np.stack([np.eye(4)] * SIFT_FALLBACK_POSES)):
                fail(f"blanked frame, obj {oid}: time_sift {t_sift}, expected SIFT's fallback")
        elif t_sift is not None and t_sift > 0 and r["n_hypos"] > 0:
            joined += 1
    if blank != 2 or joined < 1:
        fail(f"SIFT: {blank} blanked targets took the fallback, joined PPF on {joined} textured targets")
    csv_rows = read_results_bop(out["csv_path"])
    for c, r in zip(csv_rows, rows):
        t_mm = np.asarray(r["pred_pose"], np.float64)[:3, 3] * 1000.0
        if ((c["obj_id"], c["scene_id"], c["im_id"]) != (r["obj_id"], r["scene_id"], r["im_id"])
                or c["score"] != r["pred_score"] or not np.array_equal(c["pose"][:3, :3], r["pred_pose"][:3, :3])
                or not np.array_equal(c["pose"][:3, 3], t_mm)):
            fail(f"the CSV's row {c['obj_id'], c['im_id']} differs from the results' pick")
    if len(csv_rows) != len(rows):
        fail(f"the CSV has {len(csv_rows)} rows for {len(rows)}")
    if not all(np.isfinite(out[k]) for k in ("AR", "AR_vsd", "AR_mssd", "AR_mspd", "mAP")):
        fail(f"CLI AR / mAP not finite: {out}")
    n_steps = sum(len(ep) for logs in saved["finetune_logs"] for ep in logs)
    if not saved["finetune_logs"] or n_steps < 1:
        fail("the CLI ran no finetune event")
    expected = dict.fromkeys(launches, 0)
    stale = launches["redispatches"]
    expected.update({"dw_corr3x3": 2 * (len(rows) + stale) + 2 * n_steps, "dw_corr3x3_dx": 2 * n_steps,
                     "dw_corr3x3_dk": 2 * n_steps, "sa_mlp_max": 2 * len(calls), "redispatches": stale})
    if launches != expected:
        fail(f"CLI launches {launches} differ from the schedule's {expected}")
    return rows, {"scorer_objects": by_scorer, "score_calls": len(calls), "sift_fallback_targets": blank,
                  "sift_joined_targets": joined, "finetune_events": len(saved["finetune_logs"]),
                  "train_steps": n_steps, "csv_rows": len(csv_rows)}


def sift_card_vs_cpu(torch, w, loop):
    """The port's SIFT on the card against the CPU on the world's frames
    (whole frame, 500 features) and template views (their masks, 200); its
    time a textured frame on the card (the blanked frame's apart), and one
    call on a textured frame under the profiler."""
    from ossid_code_torch.ops import sift
    from ossid_code_torch.utils.png import read_png

    images = []
    rgb_dir = os.path.join(w["bop"], "ycbv", "test", "000000", "rgb")
    for name in sorted(os.listdir(rgb_dir)):
        gray = sift.rgb_to_gray(torch.from_numpy(read_png(os.path.join(rgb_dir, name))[..., :3]))
        images.append((gray, torch.ones(gray.shape, dtype=torch.bool), 500))
    td = loop.test_loader.dataset.template_dataset
    for oid in td.obj_ids:
        for vid in td.view_ids:
            img, _, mask = td.getTemplate(oid, vid)
            images.append((sift.rgb_to_gray(torch.from_numpy((img * 255).astype(np.uint8))),
                           torch.from_numpy(mask[..., 0] > 0), 200))
    dev = torch.device("cuda")
    total = {"n_cpu": 0, "n_card": 0, "matched": 0, "same_angle": 0, "max_desc_diff": 0.0}
    frame_ms, blank_ms = [], []
    sift.detect_and_compute(images[0][0].to(dev), images[0][1].to(dev), 500)  # warm-up
    for i, (gray, mask, nf) in enumerate(images):
        g, m = gray.to(dev), mask.to(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        card = sift.detect_and_compute(g, m, nf)
        torch.cuda.synchronize()
        if i < CLI_FRAMES:
            (blank_ms if i == CLI_BLANK_IM else frame_ms).append((time.perf_counter() - t0) * 1e3)
        c = compare_sift_runs(sift.detect_and_compute(gray, mask, nf), card)
        total["n_cpu"] += c["n_a"]
        total["n_card"] += c["n_b"]
        total["matched"] += c["matched"]
        total["same_angle"] += c["same_angle"]
        total["max_desc_diff"] = max(total["max_desc_diff"], c["max_desc_diff"])
    total["images"] = len(images)
    if (total["n_cpu"] < 100 or total["matched"] < SIFT_MATCH_SHARE * total["n_cpu"]
            or total["same_angle"] < SIFT_MATCH_SHARE * total["matched"]
            or total["max_desc_diff"] > SIFT_DESC_TOL):
        fail(f"SIFT on the card against the CPU: {total} (limits: share {SIFT_MATCH_SHARE}, "
             f"descriptor {SIFT_DESC_TOL})")
    textured = 0 if CLI_BLANK_IM else 1
    g, m = images[textured][0].to(dev), images[textured][1].to(dev)
    profile = profile_call(torch, lambda: sift.detect_and_compute(g, m, 500))
    return total, frame_ms, blank_ms, profile


# phase 10: the class-conditional detector (--use_maskrcnn) through the CLI,
# card against the CPU and the demo, and the offline training CLI
MASKRCNN_STEP_BATCH = 2      # card against CPU (phase 7's batch)
# The stem's first BatchNorm scale. Every consumer of the stem's output is a
# BatchNorm in training mode, so the loss changes with that scale only
# through BatchNorm's eps: its gradient (largest about 4e-5 of the network's)
# is a sum of terms that nearly cancel, and float32 keeps few of its bits.
# It is held to its own limit: card against CPU in the step, and card and CPU
# float32 against a float64 CPU gradient at two seeds (maskrcnn_against_float64).
# On an H100 at seeds 5 and 7 they read at most 0.311 (card against CPU; the
# card against float64 0.098, the CPU's float32 0.289; PERF.md, PR 8): the
# limit is twice that, rounded up. A zero or doubled gradient reads 1.0.
MASKRCNN_STEM_SCALE = "early.0.weight"
MASKRCNN_STEM_SCALE_TOL = 0.63
MASKRCNN_SECOND_SEEDS = (7, 8, 22)   # weights, output convs, batch
MASKRCNN_TIMES = 10          # detects timed, host clock
TRAIN_EPOCHS = 2
# detect: 7 training frames of the 8 (every fifth validates), one a step so
# that the validation frame fills a batch; dtoid_bop: 16 targets, 4 a step
TRAIN_BATCH = {"detect": 1, "dtoid_bop": 4}
# the demo at the reduced quality protocol's world with the class-conditional
# detector, which pretrains on the test objects (--hard implies
# --same_pretrain); half of phase 8's scorer epochs. PERF.md's criterion: the
# pretrained detector's segmentation IoU exceeds the untrained one's
MASKRCNN_DEMO_ARGV = ["--use_maskrcnn", "--hard", "--n_objects", "2", "--frames", "24", "--epochs", "20",
                      "--zephyr_epochs", "3"]


def perturb_maskrcnn(net, seed):
    """Random weights for the class-conditional detector's zero-initialised
    output convs (segmentation bias 0), as perturb_heads does for DTOID."""
    import torch

    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for conv, std in ((net.classification.output, 0.05), (net.regression.output, 0.01),
                          (net.seg_final, 0.1)):
            conv.weight.copy_(torch.randn(conv.weight.shape, generator=g) * std)
        net.seg_final.bias.zero_()


def maskrcnn_batch(rng, b, n_classes):
    """A train batch of the class-conditional detector at full width: one
    box a row, per-class masks, and a row whose last class is unlabelled."""
    ann = np.zeros((b, 1, 5), np.float32)
    masks = np.zeros((b, 480, 640, n_classes), np.float32)
    for i in range(b):
        x1, y1 = rng.uniform(0, 500), rng.uniform(0, 340)
        w, h = rng.uniform(60, 140, 2)
        c = int(rng.integers(0, n_classes))
        ann[i, 0] = [x1, y1, x1 + w, y1 + h, c]
        masks[i, int(y1):int(y1 + h), int(x1):int(x1 + w), c] = 1.0
    cls_valid = np.ones((b, n_classes), np.float32)
    cls_valid[-1, -1] = 0.0
    return {"img": rng.uniform(0, 1, (b, 480, 640, 3)).astype(np.float32), "bbox_gt": ann, "masks": masks,
            "cls_valid": cls_valid}


def compare_maskrcnn_frame(det, det_cpu):
    """The class-conditional detector's frame, card against CPU. Limits as
    phase 4's: the top score within 1e-3 and at least 98% of the detections
    matched (score within 1e-3, box within 0.05 px); the segmentation's
    probabilities within 1e-3 and its 0.5 threshold on all but 1e-3 of the
    pixels; seg_IoU within 1e-3."""
    out = {"detections": len(det["final_score"][0]), "detections_cpu": len(det_cpu["final_score"][0])}
    s, b = det["final_score"][0], det["final_bbox"][0]
    cs, cb = det_cpu["final_score"][0], det_cpu["final_bbox"][0]
    matched = sum(any(np.abs(cb[j] - bb).max() <= 0.05 for j in np.nonzero(np.abs(cs - ss) <= 1e-3)[0])
                  for ss, bb in zip(s, b))
    out["detections_matched"] = matched / max(len(s), 1)
    out["top_score_abs_err"] = abs(float(s[0] - cs[0]))
    out["seg_max_abs_err"] = float(np.abs(det["segmentation"] - det_cpu["segmentation"]).max())
    out["seg_mismatch"] = float(((det["segmentation"] > 0.5) != (det_cpu["segmentation"] > 0.5)).mean())
    out["seg_iou"], out["seg_iou_cpu"] = det["seg_IoU"], det_cpu["seg_IoU"]
    if (out["detections_matched"] < 0.98 or out["top_score_abs_err"] > 1e-3 or out["seg_max_abs_err"] > 1e-3
            or out["seg_mismatch"] > 1e-3 or abs(out["seg_iou"] - out["seg_iou_cpu"]) > 1e-3):
        fail(f"class-conditional detector card against CPU: {out}")
    return out


def maskrcnn_pair(cfg, seed, head_seed):
    """The class-conditional detector on the card (weights from `seed`,
    output convs perturbed from `head_seed`) and on the CPU with its weights."""
    from ossid_code_torch.models.maskrcnn import MaskRCNN

    gpu = MaskRCNN(cfg, seed=seed, device="cuda")
    perturb_maskrcnn(gpu.net, head_seed)
    cpu = MaskRCNN(cfg, seed=seed, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    return gpu, cpu


def maskrcnn_gradients(model, batch, dtype=None):
    """{leaf: gradient, float64 on the CPU} of one training forward and
    backward of the class-conditional detector on `batch` from its current
    weights, on a copy of its network (no step; the model is left as it
    was), in `dtype` (float32 where None)."""
    import copy

    import torch

    from ossid_code_torch.models.maskrcnn import maskrcnn_losses

    dtype = dtype or torch.float32
    net = copy.deepcopy(model.net).to(dtype).train()
    t = {k: torch.from_numpy(np.asarray(v)).to(model.device, dtype) for k, v in batch.items()}
    cls, reg, seg = net(t["img"])
    loss, _ = maskrcnn_losses(cls, reg, seg, model.anchors.to(dtype), t["bbox_gt"], t["masks"], t.get("cls_valid"))
    loss.backward()
    return {n: p.grad.detach().double().cpu() for n, p in net.named_parameters()}


def maskrcnn_against_float64(torch, gpu, cpu, batch):
    """The detector's float32 gradients on the card and on the CPU against a
    float64 CPU gradient of the same weights and batch, leaf by leaf (the
    stem scale to MASKRCNN_STEM_SCALE_TOL, every other leaf above rounding
    level to STEP_GRAD_TOL), and card against CPU at the same limits.
    Returns the readings."""
    g32, c32 = maskrcnn_gradients(gpu, batch), maskrcnn_gradients(cpu, batch)
    c64 = maskrcnn_gradients(cpu, batch, torch.float64)
    tols = {MASKRCNN_STEM_SCALE: MASKRCNN_STEM_SCALE_TOL}
    out = {}
    for key, what, got, ref in (("card_vs_float64", "the card's float32 and the CPU's float64", g32, c64),
                                ("cpu_vs_float64", "the CPU's float32 and float64", c32, c64),
                                ("card_vs_cpu", "card and CPU", g32, c32)):
        errs, _ = grad_errors(got, ref)
        hold_grads(errs, tols, what)
        rest = [e for n, e in errs.items() if n not in tols]
        out[key] = {"stem_scale": errs.get(MASKRCNN_STEM_SCALE), "others_max": max(rest),
                    "others_median": float(np.median(rest))}
    return out


def maskrcnn_card_vs_cpu(torch, cfg):
    """Phase 10b: one frame and one train step of the class-conditional
    detector (480x640, DenseNet-121, cfg's classes) on the card and on the
    CPU from the same weights, and before the step, at that seed and at
    MASKRCNN_SECOND_SEEDS, both devices' float32 gradients against a
    float64 CPU gradient; then the card's detect and train-step times (host
    clock after a sync) and one traced call of each."""
    rng = np.random.default_rng(21)
    gpu, cpu = maskrcnn_pair(cfg, 5, 6)
    frame = rng.integers(0, 256, (480, 640, 3), dtype=np.uint8)
    gt = np.zeros((480, 640), np.float32)
    gt[150:330, 200:420] = 1.0
    data = {"img": frame, "obj_id": 2, "mask": gt}
    out = {"frame": compare_maskrcnn_frame(gpu.forward_test_time(data), cpu.forward_test_time(data))}
    batch = maskrcnn_batch(rng, MASKRCNN_STEP_BATCH, gpu.n_classes)
    seed, head_seed, batch_seed = MASKRCNN_SECOND_SEEDS
    gpu2, cpu2 = maskrcnn_pair(cfg, seed, head_seed)
    out["float64"] = [maskrcnn_against_float64(torch, gpu, cpu, batch), maskrcnn_against_float64(
        torch, gpu2, cpu2, maskrcnn_batch(np.random.default_rng(batch_seed), MASKRCNN_STEP_BATCH, gpu.n_classes))]
    del gpu2, cpu2
    out["step"] = compare_step(torch, gpu, cpu, batch, leaf_tols={MASKRCNN_STEM_SCALE: MASKRCNN_STEM_SCALE_TOL})
    detect_ms = []
    for i in range(MASKRCNN_TIMES + 1):
        d = dict(data, img=rng.integers(0, 256, (480, 640, 3), dtype=np.uint8), obj_id=1 + i % 2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gpu.forward_test_time(d)
        detect_ms.append((time.perf_counter() - t0) * 1e3)
    out["detect_ms"] = detect_ms[1:]
    batch8 = maskrcnn_batch(rng, FINETUNE_BATCH, gpu.n_classes)
    step_ms = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gpu.train_step(batch8)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    out["train_step_ms"] = step_ms[1:]
    out["profile_detect"] = profile_call(torch, lambda: gpu.forward_test_time(data))
    out["profile_train_step"] = profile_call(torch, lambda: gpu.train_step(batch8))
    return out


def maskrcnn_checkpoint(w, cfg):
    """The class-conditional detector's weights for the CLI (cfg's classes,
    perturbed heads) as w['maskrcnn']."""
    from ossid_code_torch.core.checkpoint import save_checkpoint
    from ossid_code_torch.models.maskrcnn import MaskRCNN

    m = MaskRCNN(cfg, seed=3, device="cpu")
    perturb_maskrcnn(m.net, 4)
    w["maskrcnn"] = os.path.join(w["ckpts"], "maskrcnn.ckpt")
    save_checkpoint(w["maskrcnn"], m.state_dict())


def check_maskrcnn_cli(out, launches, calls, bop):
    """Phase 10a's checks: a row a target with the class-conditional
    detector and no replay buffer, each scorer its parity of object, the
    CSV's rows, finite AR and mAP, the finetune events, and the launches:
    none of the dw-corr kernels (the detector has no correlation) and 2 of
    kernel 2 a score call."""
    import pickle

    from ossid_code_torch.eval.bop_csv import read_results_bop
    from ossid_code_torch.models.maskrcnn import MaskRCNN

    loop = out["loop"]
    with open(out["results_path"], "rb") as f:
        saved = pickle.load(f)
    rows = saved["test_results"]
    if not isinstance(loop.model, MaskRCNN) or loop.replay is not None or len(rows) != len(bop.targets):
        fail(f"--use_maskrcnn CLI: model {type(loop.model).__name__}, {len(rows)} rows for {len(bop.targets)}")
    even, odd = loop.zephyr_model_even, loop.zephyr_model_odd
    if any((m is even) != (o % 2 == 0) for m, o in calls) or len(calls) != sum(r["n_hypos"] > 0 for r in rows):
        fail(f"--use_maskrcnn CLI: {len(calls)} score calls, or a scorer called off its parity")
    if len(read_results_bop(out["csv_path"])) != len(rows):
        fail("--use_maskrcnn CLI: the CSV's rows differ from the results'")
    if not all(np.isfinite(out[k]) for k in ("AR", "AR_vsd", "AR_mssd", "AR_mspd", "mAP")):
        fail(f"--use_maskrcnn CLI AR / mAP not finite: {out}")
    n_steps = sum(len(ep) for logs in saved["finetune_logs"] for ep in logs)
    if len(saved["finetune_logs"]) != len(rows) // CLI_FINETUNE_INTERVAL or n_steps < 1:
        fail(f"--use_maskrcnn CLI: {len(saved['finetune_logs'])} finetune events")
    expected = dict.fromkeys(launches, 0)
    expected["sa_mlp_max"] = 2 * len(calls)
    if launches != expected:
        fail(f"--use_maskrcnn CLI launches {launches} differ from the schedule's {expected}")
    return rows, {"score_calls": len(calls), "finetune_events": len(saved["finetune_logs"]), "train_steps": n_steps}


def train_argv(w, family):
    """Phase 10c's train CLI arguments for `family` on the world `w`."""
    return [f"dataset={family}", f"dataset.bop_root={w['bop']}", "dataset.test_dataset_name=ycbv",
            f"dataset.grid_root={os.path.join(w['data'], 'templates_YCBV_BOP')}",
            f"train.batch_size={TRAIN_BATCH[family]}", f"model.max_epochs={TRAIN_EPOCHS}", f"exp_name=chip_{family}"]


def run_train_cli(torch, conv, sa, family, argv, results, batch):
    """`python -m ossid_code_torch.scripts.train argv` in-process (experiment
    chip_<family>, under `results`), every launch counter at 0 just before
    and read just after; each epoch and each train step timed (host clock,
    synchronised), the steps and validation batches counted, the card's peak
    memory read, and after the run one train step of the trained model on
    the run's last batch traced.
    Checks the run's files, its metric rows and the launches: none but for
    DTOID, which launches 2 of kernel 1 a step, a validation batch and a
    batch log_figures draws, 2 of its dx and of kernel 3 a step. Then holds the kernels against their
    plain versions at every shape the run launched them on
    (recording_dw_calls, hold_dw_calls)."""
    import json as json_

    from ossid_code_torch.models.dtoid.module import DtoidModel
    from ossid_code_torch.models.fewshot_seg import FewshotSegModel
    from ossid_code_torch.models.maskrcnn import MaskRCNN
    from ossid_code_torch.models.matcher import SiftMatcher
    from ossid_code_torch.scripts import train
    from ossid_code_torch.train import offline

    epochs, valid_batches, step_ms = [], [], []
    last = {}
    saved = {}
    for model_cls in (DtoidModel, MaskRCNN, FewshotSegModel, SiftMatcher):
        saved[model_cls] = model_cls.train_step

        def timed_step(self, *a, _f=model_cls.train_step, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = _f(self, *a, **k)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            last.update(model=self, args=a, kwargs=k, step=_f)
            return out

        model_cls.train_step = timed_step
    fig_batches = []
    log_figures = offline.OfflineTrainer.log_figures

    def counted_figures(self, loader, *a, **k):
        counted = CountedLoader(loader)
        out = log_figures(self, counted, *a, **k)
        fig_batches.append(counted.n)
        return out

    offline.OfflineTrainer.log_figures = counted_figures
    for cls in (offline.OfflineTrainer, offline.GenericTrainer):
        saved[cls] = (cls.train_epoch, cls.validate)

        def timed_epoch(self, loader, *a, _f=cls.train_epoch, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = _f(self, loader, *a, **k)
            torch.cuda.synchronize()
            epochs.append(((time.perf_counter() - t0) * 1e3, len(loader)))
            return out

        def counted_validate(self, loader, *a, _f=cls.validate, **k):
            valid_batches.append(len(loader))
            return _f(self, loader, *a, **k)

        cls.train_epoch, cls.validate = timed_epoch, counted_validate
    saved_env = os.environ.get("OSSID_RESULT_ROOT")
    os.environ["OSSID_RESULT_ROOT"] = results
    try:
        with recording_dw_calls(conv) as dw_calls:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            read_launches = zero_launches(conv, sa)
            t0 = time.perf_counter()
            rc = train.main(argv)
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
            launches = read_launches()
            peak_gib = torch.cuda.max_memory_allocated() / 2**30
    finally:
        offline.OfflineTrainer.log_figures = log_figures
        for cls, fns in saved.items():
            if isinstance(fns, tuple):
                cls.train_epoch, cls.validate = fns
            else:
                cls.train_step = fns
        if saved_env is None:
            os.environ.pop("OSSID_RESULT_ROOT", None)
        else:
            os.environ["OSSID_RESULT_ROOT"] = saved_env
    exp = os.path.join(results, "train", f"chip_{family}")
    with open(os.path.join(exp, "metrics_v0.jsonl")) as f:
        rows = [json_.loads(line) for line in f if line.strip()]
    missing = [n for n in ("config_v0.yaml", "last.ckpt", "best.ckpt") if not os.path.exists(os.path.join(exp, n))]
    if rc != 0 or missing or len(rows) != TRAIN_EPOCHS or not all(np.isfinite(r["loss"]) for r in rows) \
            or rows[0]["loss"] == rows[-1]["loss"]:
        fail(f"train CLI {family}: rc {rc}, missing {missing}, metric rows {rows}")
    steps, n_valid, n_fig = sum(n for _, n in epochs), sum(valid_batches), sum(fig_batches)
    expected = dict.fromkeys(launches, 0)
    if family == "dtoid_bop":
        expected.update(dw_corr3x3=2 * (steps + n_valid + n_fig), dw_corr3x3_dx=2 * steps,
                        dw_corr3x3_dk=2 * steps)
    if launches != expected or steps < 1:
        fail(f"train CLI {family}: launches {launches} differ from the schedule's {expected} ({steps} steps, "
             f"{n_valid} validation batches, {n_fig} figure batches)")
    profile = profile_call(torch, lambda: last["step"](last["model"], *last["args"], **last["kwargs"]))
    return {"wall_s": wall_s, "steps": steps, "valid_batches": n_valid, "figure_batches": n_fig, "batch": batch,
            "kernels_held": hold_dw_calls(torch, conv, dw_calls),
            "epoch_ms": [ms for ms, _ in epochs], "epoch_ms_per_step": [ms / n for ms, n in epochs if n],
            "step_ms": step_ms, "step_ms_median": float(np.median(step_ms)), "peak_gib": peak_gib,
            "losses": [r["loss"] for r in rows],
            "monitor": {k: v for k, v in rows[-1].items() if k not in ("step", "loss") and k.startswith("val")},
            "launches": launches, "profile_step": {k: v for k, v in profile.items() if k != "host_top_ops_self_ms"}}


def run_maskrcnn_demo(torch, conv, sa):
    """Phase 10d: the demo with the class-conditional detector, every launch
    counter at 0 just before and read just after. Checks a finite summary,
    a finetune, PERF.md's criterion (the pretrained detector's segmentation
    IoU above the untrained one's) and the launches: none of the dw-corr
    kernels, 2 of kernel 2 a score call (calibration, bootstrap, loop)."""
    import tempfile

    from ossid_code_torch.scripts import demo_e2e

    with tempfile.TemporaryDirectory(prefix="ossid_demo_maskrcnn_") as root:
        read_launches = zero_launches(conv, sa)
        t0 = time.perf_counter()
        out = demo_e2e.main(MASKRCNN_DEMO_ARGV + ["--root", root])
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = read_launches()
    counts = out["counts"]
    expected = dict.fromkeys(launches, 0)
    expected["sa_mlp_max"] = 2 * (counts["calibration_scored"] + counts["bootstrap_scored"] + counts["loop_scored"])
    summary = {k: v for k, v in out.items() if k not in ("stage_s", "counts")}
    if not all(np.isfinite(v) for v in summary.values()) or out["n_finetunes"] < 1:
        fail(f"--use_maskrcnn demo summary {summary}: expected finite values and a finetune")
    if out["dtoid_iou_pretrained"] <= out["dtoid_iou_untrained"]:
        fail(f"--use_maskrcnn demo: pretrained IoU {out['dtoid_iou_pretrained']} not above the untrained "
             f"{out['dtoid_iou_untrained']}")
    if launches != expected:
        fail(f"--use_maskrcnn demo launches {launches} differ from the schedule's {expected}")
    return out, launches, wall_s


def phase10(torch, conv, sa, cfg):
    """Phase 10 (cfg: the serving configuration, 480x640): the CLI with
    --use_maskrcnn on phase 9's world, the train CLI for dataset=detect and
    dataset=dtoid_bop on the same world, the class-conditional detector card
    against CPU with its times, and the demo with --use_maskrcnn. Prints
    what it measured; returns the launches of the CLI, of the demo and of
    each train run."""
    import tempfile

    from ossid_code_torch.models.maskrcnn import MaskRCNN

    torch.set_num_threads(min(8, os.cpu_count() or 1))
    with tempfile.TemporaryDirectory(prefix="ossid_cli_maskrcnn_") as root:
        t0 = time.perf_counter()
        mw, m_bop = cli_world(root)
        maskrcnn_checkpoint(mw, cfg)
        mworld_s = time.perf_counter() - t0
        # warm-up: the detector's first call on the card loads its kernels
        MaskRCNN(cfg, device="cuda").forward_test_time({"img": np.zeros((480, 640, 3), np.uint8), "obj_id": 1})
        mcli_out, mcli_launches, mcalls, _, mcli_wall, mcli_loop_s = run_cli(
            torch, conv, sa, mw, cli_argv(mw, "maskrcnn", "--use_maskrcnn"))
        mcli_rows, mcli_counts = check_maskrcnn_cli(mcli_out, mcli_launches, mcalls, m_bop)
        train_runs = {family: run_train_cli(torch, conv, sa, family, train_argv(mw, family), mw["results"],
                                            TRAIN_BATCH[family]) for family in TRAIN_BATCH}
    print(f"--use_maskrcnn CLI {len(mcli_rows)} targets 480x640 (the phase 9 world, {cfg.dataset.n_classes} classes, "
          f"PPF, two scorers, host ICP, device ICP top {REFINE_TOP}, finetune every {CLI_FINETUNE_INTERVAL} at batch "
          f"{FINETUNE_BATCH}): world {mworld_s:.1f} s, main {mcli_wall:.1f} s, loop {mcli_loop_s:.1f} s = "
          f"{len(mcli_rows) / mcli_loop_s:.2f} frames/s; stage means (ms): "
          + json.dumps({k: float(np.mean([r[f"time_{k}"] for r in mcli_rows if r[f"time_{k}"] is not None]) * 1e3)
                        for k in ("dtoid", "mask", "ppf", "zephyr", "icp", "label", "finetune", "iter")})
          + f"; checks {json.dumps(mcli_counts)}; launches {json.dumps(mcli_launches)}")
    print(f"--use_maskrcnn CLI summary: "
          f"{json.dumps({k: v for k, v in mcli_out.items() if k not in ('loop', 'results_path', 'csv_path')})}")
    for family, r in train_runs.items():
        print(f"train CLI dataset={family} ({TRAIN_EPOCHS} epochs at batch {r['batch']} on the phase 9 world): "
              f"{json.dumps(r)}")
    t0 = time.perf_counter()
    m_cmp = maskrcnn_card_vs_cpu(torch, cfg)
    print(f"class-conditional detector card against CPU, 480x640 ({time.perf_counter() - t0:.1f} s): frame "
          f"{json.dumps(m_cmp['frame'])}; train step (batch {MASKRCNN_STEP_BATCH}) {json.dumps(m_cmp['step'])}; "
          f"float32 gradients against the CPU's float64 (relative L2; seeds 5 and {MASKRCNN_SECOND_SEEDS[0]}) "
          f"{json.dumps(m_cmp['float64'])}")
    print(f"class-conditional detector on the card: detect 480x640, host clock ms {json.dumps(m_cmp['detect_ms'])}, "
          f"median {float(np.median(m_cmp['detect_ms']))}; train step batch {FINETUNE_BATCH}, host clock ms "
          f"{json.dumps(m_cmp['train_step_ms'])}, median {float(np.median(m_cmp['train_step_ms']))}")
    print(f"profile maskrcnn detect: {json.dumps(m_cmp['profile_detect'])}")
    print(f"profile maskrcnn train step (batch {FINETUNE_BATCH}): {json.dumps(m_cmp['profile_train_step'])}")
    mdemo, mdemo_launches, mdemo_wall = run_maskrcnn_demo(torch, conv, sa)
    print(f"demo {' '.join(MASKRCNN_DEMO_ARGV)}: {mdemo_wall:.1f} s; summary "
          f"{json.dumps({k: v for k, v in mdemo.items() if k not in ('stage_s', 'counts')})}; stages (s) "
          f"{json.dumps(mdemo['stage_s'])}; counts {json.dumps(mdemo['counts'])}; "
          f"launches {json.dumps(mdemo_launches)}")
    return mcli_launches, mdemo_launches, train_runs


# phase 12: the train CLI's legacy families and the DTOID wrapper, at the
# presets' full widths on a synthetic world built here
LEGACY_FRAMES = 10           # x 2 textured objects at 480x640 (object 2 seen, 1 unseen on a ycbv-named world)
LEGACY_VIEWS = 16            # template grid views an object: 128x128 (the presets'), and DTOID's 124x124
LEGACY_BATCH = 4
FSS_CLASSES, FSS_IMAGES, FSS_SIZE = 4, 5, 224
JPEG_DECODES = 10
WRAPPER_CALLS = 5            # DTOIDWrapper calls timed, host clock
LEGACY_STEP_BATCH = 2        # card against CPU at full width
# the matcher card against CPU, tests/test_torch_legacy_models.py's limits:
# the log assignment within MATCHER_Z_TOL (absolute; JAX against the port
# read 1.9e-6 at magnitudes up to 5) and gradients within MATCHER_GRAD_TOL
MATCHER_Z_TOL = 2e-5
MATCHER_GRAD_TOL = 0.03


def fss_world(root: str) -> str:
    """An FSS-1000 layout of FSS_CLASSES classes x FSS_IMAGES images of
    FSS_SIZE^2 (<root>/<class>/{i.jpg, i.png}: baseline JPEGs from
    utils/jpeg.py, PNG masks), each a textured ellipse on a textured
    background, the class setting the ellipse's colour."""
    from ossid_code_torch.utils.jpeg import write_jpeg
    from ossid_code_torch.utils.png import write_png

    rng = np.random.default_rng(12)
    yy, xx = np.mgrid[0:FSS_SIZE, 0:FSS_SIZE]
    for c in range(FSS_CLASSES):
        d = os.path.join(root, f"class{c}")
        os.makedirs(d)
        colour = rng.uniform(40, 215, 3)
        for i in range(1, FSS_IMAGES + 1):
            cy, cx = rng.uniform(60, FSS_SIZE - 60, 2)
            ry, rx = rng.uniform(25, 55, 2)
            mask = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1.0
            img = rng.uniform(0, 255, (FSS_SIZE, FSS_SIZE, 3))
            img[mask] = colour + rng.normal(0, 20, (int(mask.sum()), 3))
            write_jpeg(os.path.join(d, f"{i}.jpg"), np.clip(img, 0, 255).astype(np.uint8), quality=90)
            write_png(os.path.join(d, f"{i}.png"), (mask * 255).astype(np.uint8))
    return root


def legacy_argv(w, family):
    """The train CLI's arguments for a legacy family (the presets' widths)."""
    common = [f"dataset.bop_root={w['bop']}", f"dataset.grid_root={w['grid']}", f"train.batch_size={LEGACY_BATCH}",
              f"model.max_epochs={TRAIN_EPOCHS}", f"exp_name=chip_{family}"]
    return {"fewshot_bop": ["dataset=fewshot_bop", "dataset.test_dataset_name=ycbv"],
            "fss_1000": ["dataset=fss_1000", f"dataset.dataset_root={w['fss']}"],
            "ycbv_sift": ["dataset=ycbv_sift", "dataset.test_dataset_name=ycbv"],
            "superglue": ["dataset=ycbv_sift", "model=superglue", "dataset.test_dataset_name=ycbv"]}[family] + common


def legacy_card_vs_cpu(torch, w):
    """Phase 12's card-against-CPU checks at full width: one first step of
    the few-shot model (480x640 queries, width 64, 128x128 supports, its
    zero seg_final perturbed so gradients reach the trunks; compare_step's
    limits, the conv biases before a BatchNorm by ZERO_GRAD_TOL), and of
    the matcher (n_kpts 128, dim 128, 2 layers, 30 Sinkhorn
    iterations): its log assignment within MATCHER_Z_TOL, one step's
    gradients within MATCHER_GRAD_TOL."""
    from ossid_code_torch.models.fewshot_seg import FewshotSegModel
    from ossid_code_torch.models.matcher import SiftMatcher
    from ossid_code_torch.scripts.train import build_config

    rng = np.random.default_rng(31)
    out = {}
    cfg = build_config(legacy_argv(w, "fewshot_bop"))
    pair = [FewshotSegModel(cfg, seed=3, device=d) for d in ("cuda", "cpu")]
    with torch.no_grad():
        g = torch.Generator().manual_seed(4)
        pair[0].net.seg_final.weight.copy_(torch.randn(pair[0].net.seg_final.weight.shape, generator=g) * 0.3)
        pair[0].net.seg_final.bias.zero_()
    pair[1].load_state_dict({k: v.cpu() for k, v in pair[0].state_dict().items()})
    b, (h, wd), s = LEGACY_STEP_BATCH, pair[0].img_size, pair[0].support_size[0]
    batch = {"img": rng.uniform(0, 1, (b, h, wd, 3)).astype(np.float32),
             "mask": (rng.uniform(size=(b, h, wd, 1)) > 0.7).astype(np.float32),
             "simg": rng.uniform(0, 1, (b, 1, s, s, 3)).astype(np.float32),
             "smask": (rng.uniform(size=(b, 1, s, s, 1)) > 0.5).astype(np.float32)}
    # every conv but seg_final feeds a training-mode BatchNorm
    zero = [f"{n}.bias" for n, m in pair[1].net.named_modules()
            if isinstance(m, torch.nn.Conv2d) and n != "seg_final"]
    out["fewshot_step"] = compare_step(torch, *pair, batch, zero_leaves=zero)
    cfg = build_config(legacy_argv(w, "ycbv_sift"))
    pair = [SiftMatcher(cfg, seed=3, device=d) for d in ("cuda", "cpu")]
    pair[1].load_state_dict({k: v.cpu() for k, v in pair[0].state_dict().items()})
    n = pair[0].n_obs
    M = np.zeros((b, n + 1, n + 1), np.float32)
    for i in range(b):
        M[i, np.arange(n // 2), rng.permutation(n)[:n // 2]] = 1.0
        M[i, :n, -1] = 1.0 - M[i, :n, :-1].sum(1)
        M[i, -1, :n] = 1.0 - M[i, :-1, :n].sum(0)
    mb = {"obs_desc": rng.uniform(0, 160, (b, n, 128)).astype(np.float32),
          "obs_uv": rng.uniform(0, 640, (b, n, 2)).astype(np.float32),
          "model_desc": rng.uniform(0, 160, (b, n, 128)).astype(np.float32),
          "model_pts": rng.normal(0, 0.05, (b, n, 3)).astype(np.float32), "matches": M}
    with torch.no_grad():
        z = [m.forward(m._feed(mb)).cpu().numpy() for m in pair]
    out["matcher_z_max_abs_err"] = float(np.abs(z[0] - z[1]).max())
    out["matcher_z_max_abs"] = float(np.abs(z[1]).max())
    if out["matcher_z_max_abs_err"] > MATCHER_Z_TOL:
        fail(f"matcher log assignment card against CPU differs by {out['matcher_z_max_abs_err']:.3g} "
             f"(tol {MATCHER_Z_TOL})")
    out["matcher_step"] = compare_step(torch, *pair, mb, grad_tol=MATCHER_GRAD_TOL)
    return out


def run_wrapper(torch, conv, sa, w):
    """Phase 12d: DTOIDWrapper (480x640, DenseNet-121 12/24/16, n_local
    N_TEMPLATES of the 124x124 grid's LEGACY_VIEWS views) on the world's frames from
    a checkpoint, every launch counter at 0 just before the calls and read
    just after: 2 of kernel 1 a call and nothing else; the first frame
    against the CPU plain path (compare_detections); the host clock of a
    call and one traced call."""
    import glob

    from ossid_code_torch.models.dtoid.wrapper import DTOIDWrapper
    from ossid_code_torch.utils.png import read_png

    frames = [read_png(p) for p in sorted(glob.glob(os.path.join(w["bop"], "ycbv", "test", "*", "rgb", "*.png")))]
    wrapper = DTOIDWrapper(w["dtoid"], w["grid124"], [1, 2], n_local=N_TEMPLATES)
    if len(wrapper.getTemplates(1)[0]) != N_TEMPLATES:
        fail(f"DTOIDWrapper took {len(wrapper.getTemplates(1)[0])} templates, expected {N_TEMPLATES}")
    wrapper(frames[0], 1)  # warm-up: cuDNN plans
    torch.cuda.synchronize()
    read_launches = zero_launches(conv, sa)
    ms, dets = [], []
    for i in range(WRAPPER_CALLS):
        t0 = time.perf_counter()
        dets.append(wrapper(frames[i % len(frames)], 1 + i % 2))
        ms.append((time.perf_counter() - t0) * 1e3)
    launches = read_launches()
    expected = dict.fromkeys(launches, 0)
    expected["dw_corr3x3"] = 2 * WRAPPER_CALLS
    if launches != expected:
        fail(f"DTOIDWrapper launches {launches} differ from 2 of kernel 1 a call ({expected})")
    for det in dets:
        if not np.isfinite(det["pred_scores"]).all() or not det["valid"].any():
            fail("DTOIDWrapper returned no finite detection")
    cpu = DTOIDWrapper(w["dtoid"], w["grid124"], [1, 2], n_local=N_TEMPLATES, device="cpu")
    cmp = compare_detections(dets[0], cpu(frames[0], 1))
    profile = profile_call(torch, lambda: wrapper(frames[0], 1))
    return {"calls": WRAPPER_CALLS, "host_ms": ms, "host_ms_median": float(np.median(ms)), "card_vs_cpu": cmp,
            "launches": launches, "profile": {k: v for k, v in profile.items() if k != "host_top_ops_self_ms"}}


def phase12(torch, conv, sa):
    """Phase 12: the train CLI's legacy families at the presets' widths on a
    synthetic world built here, (a) dataset=fewshot_bop, (b) dataset=fss_1000
    with one JPEG decode timed, (c) dataset=ycbv_sift and model=superglue,
    each through run_train_cli (files, finite losses, the monitored metric,
    no kernel launched; the matcher's loss falls), the two models card
    against CPU, and (d) DTOIDWrapper. Prints what it measured; returns the
    launches of each run."""
    import tempfile

    from ossid_code_torch.core.checkpoint import save_checkpoint
    from ossid_code_torch.core.config import default_config
    from ossid_code_torch.data.synthetic import make_synthetic_bop, make_template_grid
    from ossid_code_torch.models.dtoid.module import DtoidModel
    from ossid_code_torch.utils.jpeg import read_jpeg

    torch.set_num_threads(min(8, os.cpu_count() or 1))
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="ossid_legacy_") as root:
        t0 = time.perf_counter()
        w = {k: os.path.join(root, k) for k in ("bop", "grid", "grid124", "fss", "results")}
        objects = textured_wedges()
        make_synthetic_bop(w["bop"], dataset_name="ycbv", n_frames=LEGACY_FRAMES, img_h=480, img_w=640,
                           objects=objects)
        make_template_grid(w["grid"], objects, n_views=LEGACY_VIEWS, size=128)
        make_template_grid(w["grid124"], objects, n_views=LEGACY_VIEWS)
        fss_world(w["fss"])
        dtoid = DtoidModel(default_config(), seed=1, device="cpu")
        perturb_heads(dtoid.net, 2)
        w["dtoid"] = os.path.join(root, "dtoid.ckpt")
        save_checkpoint(w["dtoid"], dtoid.state_dict())
        world_s = time.perf_counter() - t0
        jpeg = os.path.join(w["fss"], "class0", "1.jpg")
        jpeg_ms = []
        for _ in range(JPEG_DECODES):
            t0 = time.perf_counter()
            read_jpeg(jpeg)
            jpeg_ms.append((time.perf_counter() - t0) * 1e3)
        runs = {}
        for family in ("fewshot_bop", "fss_1000", "ycbv_sift", "superglue"):
            runs[family] = r = run_train_cli(torch, conv, sa, family, legacy_argv(w, family), w["results"],
                                             LEGACY_BATCH)
            if family in ("ycbv_sift", "superglue") and not r["losses"][-1] < r["losses"][0]:
                fail(f"train CLI {family}: the matcher's loss did not fall: {r['losses']}")
            want = "val_match_recall" if family in ("ycbv_sift", "superglue") else "valunseen_seg_IoU"
            if want not in r["monitor"]:
                fail(f"train CLI {family}: {want} is not in the metrics stream {r['monitor']}")
        t0 = time.perf_counter()
        card_cpu = legacy_card_vs_cpu(torch, w)
        card_cpu_s = time.perf_counter() - t0
        wrapper = run_wrapper(torch, conv, sa, w)
    print(f"phase 12 world: {LEGACY_FRAMES} frames 480x640 x 2 textured objects, {LEGACY_VIEWS}-view grids, "
          f"FSS-1000 {FSS_CLASSES} classes x {FSS_IMAGES} images of {FSS_SIZE}x{FSS_SIZE} in {world_s:.1f} s; "
          f"one {FSS_SIZE}x{FSS_SIZE} JPEG decode (utils/jpeg.py, host), ms {json.dumps(jpeg_ms)}, median "
          f"{float(np.median(jpeg_ms))}")
    for family, r in runs.items():
        print(f"train CLI {family} ({TRAIN_EPOCHS} epochs at batch {LEGACY_BATCH}): {json.dumps(r)}")
    print(f"legacy models card against CPU at full width ({card_cpu_s:.1f} s): {json.dumps(card_cpu)}")
    print(f"DTOIDWrapper 480x640, DenseNet-121, n_local {N_TEMPLATES}: {json.dumps(wrapper)}")
    print(f"phase 12 in {time.perf_counter() - t_phase:.1f} s")
    return {**{f"train_{f}": r["launches"] for f, r in runs.items()}, "dtoid_wrapper": wrapper["launches"]}


class CountedLoader:
    """A loader that counts the batches its consumer took."""

    def __init__(self, loader):
        self.loader, self.n = loader, 0

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        for batch in self.loader:
            self.n += 1
            yield batch


# phase 13: the BlenderProc render family at full width, and kernel 1 at
# configuration 1's template count
RENDER_OBJECTS = 6        # the reference's split: 4 train, 1 valid-unseen, 1 test object
RENDER_SCENES = 6         # 480x640; DTOID trains on the first 4 and validates on the last 2
RENDER_TRAIN_SCENES = 4
RENDER_VIEWS = 10         # 128x128 template renders an object, cropped to 124x124
RENDER_BATCH = 4
RENDER_STEP_BATCH = 2     # card against CPU (phase 7's batch)
RENDER_LOADS = 3          # load_hdf5 calls timed a scene, host clock
T_PRETRAINED = 160        # --use_pretrained_dtoid's n_local_test (scripts/online_learning.py)


def render_world(root):
    """The phase's world through data/synthetic.py::make_render_world, every
    array utils/hdf5.py wrote recorded: (scenes dir, grid dir, {path:
    {name: array}})."""
    from ossid_code_torch.data.synthetic import make_render_world, sampled_objects
    from ossid_code_torch.utils import hdf5

    written = {}
    write = hdf5.write

    def recording(path, datasets):
        written[path] = {k: np.array(v, copy=True) for k, v in datasets.items()}
        write(path, datasets)

    hdf5.write = recording
    try:
        scenes, grid = make_render_world(root, n_scenes=RENDER_SCENES, n_grid_views=RENDER_VIEWS,
                                         objects=sampled_objects(RENDER_OBJECTS), img_h=480, img_w=640)
    finally:
        hdf5.write = write
    return scenes, grid, written


def read_back(written) -> dict:
    """Every file read back by utils/hdf5.py equal to what was written,
    dtypes included; then load_hdf5 timed on the scenes."""
    from ossid_code_torch.data.hdf5_render import load_hdf5
    from ossid_code_torch.utils import hdf5

    for path, arrays in written.items():
        with hdf5.File(path) as f:
            if sorted(f.keys()) != sorted(arrays):
                fail(f"{path}: read back the datasets {sorted(f.keys())}, wrote {sorted(arrays)}")
            for name, want in arrays.items():
                got = f[name]
                if got.dtype != want.dtype or got.shape != want.shape or not np.array_equal(got, want):
                    fail(f"{path}:{name} read back {got.dtype} {got.shape}, wrote {want.dtype} {want.shape}"
                         f" (or other values)")
    scenes = sorted(p for p in written if os.path.basename(p).startswith("scene_"))
    load_ms = []
    for path in scenes * RENDER_LOADS:
        t0 = time.perf_counter()
        load_hdf5(path)
        load_ms.append((time.perf_counter() - t0) * 1e3)
    return {"files": len(written), "scenes": len(scenes),
            "scene_mb": float(np.mean([os.path.getsize(p) for p in scenes]) / 1e6),
            "scene_bytes_by_field": {k: int(v.nbytes) for k, v in written[scenes[0]].items()},
            "load_hdf5_ms": load_ms, "load_hdf5_ms_median": float(np.median(load_ms))}


def render_dtoid(torch, conv, sa, scenes, grid, out_dir):
    """Phase 13b: DTOID trained by OfflineTrainer on render samples
    (RenderGridTemplates, DtoidRenderDataset, NumpyLoader, as the JAX
    package's tests compose them) at the preset's widths, 2 epochs at batch
    RENDER_BATCH, then validate and log_figures, every launch counter at 0
    just before and read just after: kernel 1 twice a step, a validation
    batch and a figure batch, its dx and kernel 3 twice a step. Then one
    step traced, the figures decoded, and one step card against CPU."""
    from ossid_code_torch.conf import load_group
    from ossid_code_torch.core.config import Config, default_config
    from ossid_code_torch.data.dtoid_bop import NumpyLoader
    from ossid_code_torch.data.hdf5_render import DtoidRenderDataset, RenderGridTemplates
    from ossid_code_torch.models.dtoid.module import DtoidModel
    from ossid_code_torch.train.offline import FEED_KEYS, OfflineTrainer
    from ossid_code_torch.utils.png import read_png
    from ossid_code_torch.utils.vis import FIG_H, FIG_W

    dcfg = Config(load_group("dataset", "dtoid"))   # shorter_length 480, heatmap 29, n_local_test 10
    cfg = default_config()                          # 480x640, DenseNet-121 (12, 24, 16)
    paths = sorted(os.path.join(scenes, f) for f in os.listdir(scenes) if f.endswith(".hdf5"))
    templates = RenderGridTemplates(grid)
    train_ds = DtoidRenderDataset("train", paths[:RENDER_TRAIN_SCENES], templates, dcfg, seed=0)
    valid_ds = DtoidRenderDataset("test", paths[RENDER_TRAIN_SCENES:], templates, dcfg, seed=1)
    train_loader = NumpyLoader(train_ds, batch_size=RENDER_BATCH, shuffle=True, seed=0)
    valid_loader = NumpyLoader(valid_ds, batch_size=RENDER_BATCH)
    model = DtoidModel(cfg, seed=5, device="cuda")
    perturb_heads(model.net, 6)
    trainer = OfflineTrainer(model, cfg)
    step_ms, epoch_ms = [], []
    train_step = model.train_step

    def timed_step(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = train_step(*a, **k)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    model.train_step = timed_step
    valid = CountedLoader(valid_loader)
    figures = CountedLoader(valid_loader)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        read_launches = zero_launches(conv, sa)
        t_run = time.perf_counter()
        losses = []
        for _ in range(TRAIN_EPOCHS):
            t0 = time.perf_counter()
            losses.append(trainer.train_epoch(train_loader)["loss"])
            torch.cuda.synchronize()
            epoch_ms.append((time.perf_counter() - t0) * 1e3)
        iou = trainer.validate(valid)
        trainer.log_figures(figures, out_dir, epoch=TRAIN_EPOCHS - 1)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t_run
        launches = read_launches()
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
    finally:
        model.train_step = train_step
    steps = len(step_ms)
    expected = dict.fromkeys(launches, 0)
    expected.update(dw_corr3x3=2 * (steps + valid.n + figures.n), dw_corr3x3_dx=2 * steps, dw_corr3x3_dk=2 * steps)
    if launches != expected or steps != TRAIN_EPOCHS * len(train_loader) or valid.n != len(valid_loader) \
            or figures.n != 1:
        fail(f"DTOID on render samples: launches {launches} differ from the schedule's {expected} ({steps} steps, "
             f"{valid.n} validation batches, {figures.n} figure batches)")
    if not all(np.isfinite(losses)) or losses[0] == losses[-1] or not np.isfinite(iou):
        fail(f"DTOID on render samples: epoch losses {losses}, validation IoU {iou}")
    drawn = sorted(os.listdir(os.path.join(out_dir, "figures")))
    want = [f"epoch{TRAIN_EPOCHS - 1}_{i}.png" for i in range(2)]
    shapes = [read_png(os.path.join(out_dir, "figures", n)).shape for n in drawn]
    if drawn != want or any(sh != (FIG_H, FIG_W, 3) for sh in shapes):
        fail(f"log_figures wrote {drawn} of shapes {shapes}, expected {want} at {(FIG_H, FIG_W, 3)}")
    batch = next(iter(train_loader))
    feed = {k: batch[k] for k in FEED_KEYS}
    profile = profile_call(torch, lambda: model.train_step(feed, optimizer=trainer.optimizer, bf16=False))
    t0 = time.perf_counter()
    m_gpu = DtoidModel(cfg, seed=3, device="cuda")
    perturb_heads(m_gpu.net, 4)
    m_cpu = DtoidModel(cfg, seed=3, device="cpu")
    m_cpu.load_state_dict({k: v.cpu() for k, v in m_gpu.state_dict().items()})
    step_cmp = compare_step(torch, m_gpu, m_cpu, {k: v[:RENDER_STEP_BATCH] for k, v in feed.items()})
    step_cmp["seconds"] = time.perf_counter() - t0
    return {"train_items": len(train_ds), "valid_items": len(valid_ds), "steps": steps, "valid_batches": valid.n,
            "figure_batches": figures.n, "run_s": run_s, "epoch_losses": losses, "valid_seg_IoU": iou,
            "step_ms": step_ms, "step_ms_median": float(np.median(step_ms)),
            "epoch_ms": epoch_ms, "epoch_ms_per_step": [ms / len(train_loader) for ms in epoch_ms],
            "peak_gib": peak_gib, "launches": launches, "figures": drawn,
            "profile_step": {k: v for k, v in profile.items() if k != "host_top_ops_self_ms"},
            "card_vs_cpu_step": step_cmp}


def dtoid_family_cli(torch, conv, sa, scenes, results):
    """Phase 13d: `dataset=dtoid` through the train CLI stops at its first
    batch with KeyError 'limg', as the JAX package's CLI does (few-shot
    episodes fed to the DTOID trainer), having launched no kernel."""
    from ossid_code_torch.scripts import train

    saved_env = os.environ.get("OSSID_RESULT_ROOT")
    os.environ["OSSID_RESULT_ROOT"] = results
    read_launches = zero_launches(conv, sa)
    try:
        train.main(["dataset=dtoid", f"dataset.dataset_root={scenes}", f"train.batch_size={RENDER_BATCH}",
                    "model.max_epochs=1", "exp_name=chip_dtoid"])
    except KeyError as e:
        if e.args != ("limg",):
            raise
    else:
        fail("train CLI dataset=dtoid ran on: the JAX package's CLI stops with KeyError 'limg'")
    finally:
        if saved_env is None:
            os.environ.pop("OSSID_RESULT_ROOT", None)
        else:
            os.environ["OSSID_RESULT_ROOT"] = saved_env
    launches = read_launches()
    if any(launches.values()):
        fail(f"train CLI dataset=dtoid launched {launches} before its KeyError")
    return launches


def dw_corr_t160(torch, F, conv):
    """Kernel 1 at configuration 1's template count (--use_pretrained_dtoid:
    n_local_test 160): the correlation head, x (160, 29, 39, 640) with
    stride 0 over T and a 463 MB float32 output, against its plain version
    (DW_TOL), timed beside its byte bound and cuDNN."""
    g = torch.Generator(device="cuda").manual_seed(15)
    feat = torch.randn(1, 29, 39, 640, device="cuda", generator=g)
    k = torch.randn(T_PRETRAINED, 3, 3, 640, device="cuda", generator=g)
    with torch.inference_mode():
        row = measure_dw_corr(torch, F, conv, [(f"correlation head T={T_PRETRAINED}",
                                                feat.expand(T_PRETRAINED, 29, 39, 640), k)], dw_check(torch, False))[0]
    row["output_mb"] = T_PRETRAINED * 29 * 39 * 640 * 4 / 1e6
    return row


def phase13(torch, F, conv, sa):
    """Phase 13: (a) a render world at full width written by the port's
    writer and read back, load_hdf5 timed; (b) DTOID on render samples
    (render_dtoid); (c) dataset=render model=fewshot_seg through the train
    CLI (run_train_cli: no kernel launched); (d) dataset=dtoid through the
    CLI (dtoid_family_cli); then kernel 1 at T=160 (dw_corr_t160). Prints
    what it measured; returns the launches of each path and the T=160 row."""
    import tempfile

    torch.set_num_threads(min(8, os.cpu_count() or 1))
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="ossid_render_") as root:
        t0 = time.perf_counter()
        scenes, grid, written = render_world(os.path.join(root, "world"))
        world_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        io = read_back(written)
        io["read_back_s"] = time.perf_counter() - t0
        del written
        dtoid = render_dtoid(torch, conv, sa, scenes, grid, os.path.join(root, "dtoid"))
        results = os.path.join(root, "results")
        render = run_train_cli(torch, conv, sa, "render", [
            "dataset=render", "model=fewshot_seg", f"dataset.dataset_root={scenes}",
            f"train.batch_size={RENDER_BATCH}", f"model.max_epochs={TRAIN_EPOCHS}", "exp_name=chip_render"],
            results, RENDER_BATCH)
        dtoid_cli = dtoid_family_cli(torch, conv, sa, scenes, results)
    t160 = dw_corr_t160(torch, F, conv)
    print(f"phase 13 world: {RENDER_SCENES} scenes 480x640 x {RENDER_OBJECTS} objects, {RENDER_VIEWS} 128x128 "
          f"template renders an object, written in {world_s:.1f} s (utils/hdf5.py); read back equal: "
          f"{json.dumps(io)}")
    print(f"phase 13 DTOID on render samples ({TRAIN_EPOCHS} epochs at batch {RENDER_BATCH}, DenseNet-121, "
          f"480x640, T=1 local template in training, validation and figures on the all-templates batches): "
          f"{json.dumps(dtoid)}")
    print(f"train CLI dataset=render model=fewshot_seg ({TRAIN_EPOCHS} epochs at batch {RENDER_BATCH}, 480x640 "
          f"scenes): {json.dumps(render)}")
    print(f"train CLI dataset=dtoid: KeyError 'limg' at the first batch, as in the JAX package; launches "
          f"{json.dumps(dtoid_cli)}")
    print(f"dw_corr3x3 {t160['shape']}: err {t160['max_abs_err']:.3g}, kernel {t160['ms']:.4f} ms, plain "
          f"{t160['plain_ms']:.4f} ms, cuDNN {t160['library_ms']:.4f} ms, bound {t160['bound_ms']:.4f} ms "
          f"({t160['bound_by']}), output {t160['output_mb']:.1f} MB")
    print(f"phase 13 in {time.perf_counter() - t_phase:.1f} s")
    return {"render_dtoid": dtoid["launches"], "train_render": render["launches"], "train_dtoid": dtoid_cli}, t160


FARM_FRAMES = 2          # phase 14b: frames a round, one detect of both
FARM_TIMES = 10          # rounds (and pairs of one-frame detects) timed, host clock
MS_SCENES = 2            # phase 14c: camera streams
MS_FRAMES = 4            # frames a scene, x 2 objects x 2 scenes = 16 targets
MESH_TOL = 1e-5          # 14d: a split forward's scores against the unsplit call


def dw_frames_cases(torch, device, bf16=False):
    """Kernel 1 with the frame indexing at the farm's shapes: the head of a
    round of 2 frames x 10 templates (one launch, cross), the stem of 2
    frames with the taps broadcast (stride 0), and 3 frames x 7 templates
    (T odd: a frame's last block holds one template)."""
    g = torch.Generator(device=device).manual_seed(16)
    r = lambda *shape: torch.randn(*shape, device=device, generator=g)
    cases = [
        (f"farm head F x T = {FARM_FRAMES} x {N_TEMPLATES}", r(FARM_FRAMES, 29, 39, 640),
         r(N_TEMPLATES, 3, 3, 640), True),
        (f"farm stem F = {FARM_FRAMES}, taps stride 0", r(FARM_FRAMES, 240, 320, 64),
         r(1, 3, 3, 64).expand(FARM_FRAMES, 3, 3, 64), False),
        ("F x T = 3 x 7", r(3, 29, 39, 640), r(7, 3, 3, 640), True),
    ]
    return [(label, as_bf16(x), as_bf16(k), cross) for label, x, k, cross in cases] if bf16 else cases


def measure_dw_frames(torch, F, conv, cases, check):
    """measure_dw_corr for the frame-indexed calls: kernel, plain version and
    cuDNN's grouped convolution on the F * T samples made whole."""
    rows = []
    for label, x, k, cross in cases:
        got = conv.dw_corr3x3_cuda(x, k, cross=cross)
        want = conv.depthwise_corr_plain(x, k, 1, cross=cross)
        err = check(f"dw_corr3x3 ({label})", got, want)
        xe, ke = conv._cross(x, k) if cross else (x, k)
        b, h, w, c = got.shape
        xi = xe.permute(0, 3, 1, 2).reshape(1, b * c, h, w).contiguous()
        ki = ke.permute(0, 3, 1, 2).reshape(b * c, 1, 3, 3).contiguous()
        bnd, by = bound_ms(unique_bytes(x) + unique_bytes(k) + got.numel() * got.element_size(),
                           18.0 * got.numel())
        rows.append({
            "shape": f"{label}: x {tuple(x.shape)}, k {tuple(k.shape)} -> {tuple(got.shape)}",
            "max_abs_err": err,
            "ms": cuda_ms(torch, lambda: conv.dw_corr3x3_cuda(x, k, cross=cross)),
            "plain_ms": cuda_ms(torch, lambda: conv.depthwise_corr_plain(x, k, 1, cross=cross)),
            "library_ms": cuda_ms(torch, lambda: F.conv2d(xi, ki, groups=b * c, padding=1)),
            "bound_ms": bnd, "bound_by": by,
        })
    return rows


def farm_round(torch, conv, sa, dtoid, scene, frames):
    """14b: make_farm_detect on a one-device mesh (the F-frame detect) on
    FARM_FRAMES frames, each held against DtoidModel's one-frame detect of
    the same frame (compare_detections' limits, the top pick's template and
    box equal); kernel 1 launched twice a round; the round's host time and
    device busy time beside two one-frame detects'."""
    from ossid_code_torch.loop.multi_stream import make_farm_detect
    from ossid_code_torch.parallel.mesh import make_mesh_2d

    farm = make_farm_detect(dtoid, make_mesh_2d(1, 1))
    imgs = np.stack(frames[:FARM_FRAMES])
    local, glob = dtoid.get_template_features(scene["obj_id"], scene["limg"], scene["lmask"])
    run = lambda: {k: v.cpu().numpy() for k, v in farm(imgs, local, glob).items()}  # noqa: E731
    run()  # warm-up: cuDNN plans at the round's batch
    torch.cuda.synchronize()
    read = zero_launches(conv, sa)
    out = run()
    launches = read()
    if launches != {**dict.fromkeys(launches, 0), "dw_corr3x3": 2}:
        fail(f"a farm round of {FARM_FRAMES} frames launched {launches}, expected kernel 1 twice")
    pack, dtoid._pack_seg = dtoid._pack_seg, False
    try:
        one = lambda: [dtoid.forward_test_time(dict(scene, img=f)) for f in frames[:FARM_FRAMES]]  # noqa: E731
        refs = one()
        cmps = []
        for i, ref in enumerate(refs):
            det = {"pred_scores": out["pred_scores"][i], "pred_bbox": out["pred_bbox"][i],
                   "pred_template_ids": out["pred_template_ids"][i], "valid": out["valid"][i],
                   "heat_map": out["heat_map"][i], "segmentation": (out["seg_u8"][i] > 127).astype(np.float32)}
            ref = dict(ref, segmentation=(ref["segmentation"] > 0.5).astype(np.float32))
            cmp = compare_detections(det, ref)
            if det["pred_template_ids"][0] != ref["pred_template_ids"][0] or \
                    np.abs(det["pred_bbox"][0] - ref["pred_bbox"][0]).max() > 0.05:
                fail(f"farm frame {i}: pick {det['pred_template_ids'][0]} {det['pred_bbox'][0]} against the "
                     f"one-frame detect's {ref['pred_template_ids'][0]} {ref['pred_bbox'][0]}")
            cmp["top_score_abs_err"] = float(abs(det["pred_scores"][0] - ref["pred_scores"][0]))
            cmps.append(cmp)
        timing = {"round_host_ms": host_ms(torch, run, FARM_TIMES),
                  "two_detects_host_ms": host_ms(torch, one, FARM_TIMES),
                  "round_profile": profile_call(torch, run), "two_detects_profile": profile_call(torch, one)}
    finally:
        dtoid._pack_seg = pack
    # a round moves what two detects move, or less: more copies mean the
    # weights went to a copy of the network (a device taken for another)
    if timing["round_profile"]["device_copies"] > timing["two_detects_profile"]["device_copies"]:
        fail(f"a farm round made {timing['round_profile']['device_copies']} device copies, two one-frame detects "
             f"{timing['two_detects_profile']['device_copies']}")
    return {"frames": cmps, "launches": launches, **timing}


def multi_stream_world(root):
    """Phase 6's world with MS_SCENES scenes (camera streams) of MS_FRAMES
    frames at 480x640, 2 objects, 10-view template grids."""
    import pickle

    from ossid_code_torch.core.config import default_config
    from ossid_code_torch.data.bop import BopDataset, BopDatasetArgs
    from ossid_code_torch.data.synthetic import (
        default_objects, make_synthetic_bop, make_template_grid, make_zephyr_results_pkl,
    )

    make_synthetic_bop(root, n_frames=MS_FRAMES, img_h=480, img_w=640, n_scenes=MS_SCENES)
    make_template_grid(os.path.join(root, "grid"), default_objects(), n_views=10)
    cfg = default_config()
    d = cfg.dataset
    d.bop_root, d.test_dataset_name, d.grid_root = root, "synth", os.path.join(root, "grid")
    d.n_local_test, d.load_zephyr_result = N_TEMPLATES, True
    d.zephyr_result_path = os.path.join(root, "zr.pkl")
    bop = BopDataset(BopDatasetArgs(bop_root=root, dataset_name="synth"))
    make_zephyr_results_pkl(d.zephyr_result_path, bop, score=50.0)
    with open(d.zephyr_result_path, "rb") as f:
        return cfg, bop, pickle.load(f)


def multi_stream_pass(torch, conv, sa, dtoid, zephyr, cfg, bop, zr_list):
    """One MultiStreamLoop run on its default mesh (one device, the card):
    (per-stream rows, the loop, its rounds, wall s, launches)."""
    import argparse

    from ossid_code_torch.data.dtoid_bop import get_dataloaders
    from ossid_code_torch.loop.multi_stream import MultiStreamLoop

    args = argparse.Namespace(
        dataset_name="synth", exp_name="chip_smoke_streams", use_dtoid_segmask=False, ignore_dtoid_mask=False,
        always_dtoid_mask=True, use_oracle_gt=True, use_sift_hypos=False, use_maskrcnn=False,
        finetune_interval=FINETUNE_INTERVAL, finetune_warmup=0, finetune_epochs=1, finetune_reset=False,
        finetune_batch_size=FINETUNE_BATCH, non_cum=False, save_each=False, raw_dtoid=False,
        no_finetune=False, fast=True, zephyr_depth_crop=0, yuv_transfer=False)
    train_loader, _, test_loader = get_dataloaders(cfg, zr_list)
    test_loader.dataset.sortTargets()
    train_ds = train_loader.dataset
    train_ds.clearTargets()
    zr = {(r["obj_id"], r["scene_id"], r["im_id"]): dict(r) for r in zr_list}
    train_ds.zephyr_results = dict(zr)
    loop = MultiStreamLoop(args, cfg, dtoid, bop, train_ds, test_loader, zr, zephyr_model=zephyr,
                           hypo_gens=hypo_gens(bop))
    rounds = len(loop._rounds())
    torch.cuda.synchronize()
    read = zero_launches(conv, sa)
    t0 = time.perf_counter()
    per_stream = loop.run(progress=False)
    torch.cuda.synchronize()
    return per_stream, loop, rounds, time.perf_counter() - t0, read()


def multi_stream_run(torch, conv, sa, device):
    """14c: MultiStreamLoop over MS_SCENES streams, twice from the same
    weights (the first pass builds the renderers, the PPF models and cuDNN's
    plans): native PPF with LOOP_HYPOS hypotheses, device ICP of the top
    REFINE_TOP, a finetune at batch FINETUNE_BATCH every FINETUNE_INTERVAL
    buffered targets, oracle labels, always the DTOID mask. Holds in each
    pass a row list a stream covering its targets, a finetune, the weights
    moved, and the launches the schedule implies: kernel 1 twice a round
    and twice a step, its dx and kernel 3 twice a step, kernel 2 twice a
    score call."""
    import tempfile

    from ossid_code_torch.models.dtoid.module import DtoidModel
    from ossid_code_torch.models.zephyr.module import ZephyrModel

    out = {}
    with tempfile.TemporaryDirectory(prefix="ossid_streams_") as root:
        cfg, bop, zr_list = multi_stream_world(root)
        dtoid = DtoidModel(cfg, seed=1, device=device)
        perturb_heads(dtoid.net, 2)
        weights = dtoid.state_dict()
        zephyr = ZephyrModel(num_points=NUM_POINTS, inconst_ratio_th=100.0, seed=0, need_uv=False,
                             refine_top=REFINE_TOP, device=device)
        for name in ("cold", "warm"):
            dtoid.load_state_dict(weights)
            dtoid.reset_optimizer()
            wv0 = dtoid.weights_version
            per_stream, loop, rounds, wall_s, launches = multi_stream_pass(torch, conv, sa, dtoid, zephyr, cfg,
                                                                           bop, zr_list)
            rows = [r for rs in per_stream.values() for r in rs]
            if sorted(per_stream) != sorted({t["scene_id"] for t in bop.targets}):
                fail(f"multi-stream loop: streams {sorted(per_stream)}")
            for sid, rs in per_stream.items():
                want = sorted((t["obj_id"], t["im_id"]) for t in bop.targets if t["scene_id"] == sid)
                if sorted((r["obj_id"], r["im_id"]) for r in rs) != want or any(r["scene_id"] != sid for r in rs):
                    fail(f"multi-stream loop: stream {sid}'s rows do not cover its targets")
            n_steps = sum(len(ep) for logs in loop.finetune_logs for ep in logs)
            n_finetunes = sum(r["finetune"] for r in rows)
            if n_finetunes < 1 or dtoid.weights_version == wv0 or not n_steps:
                fail(f"multi-stream loop: {n_finetunes} finetunes, {n_steps} steps, weights version {wv0} -> "
                     f"{dtoid.weights_version}")
            n_scored = sum(r["n_hypos"] > 0 for r in rows)
            expected = {**dict.fromkeys(launches, 0), "dw_corr3x3": 2 * rounds + 2 * n_steps,
                        "dw_corr3x3_dx": 2 * n_steps, "dw_corr3x3_dk": 2 * n_steps, "sa_mlp_max": 2 * n_scored}
            if launches != expected:
                fail(f"multi-stream loop ({name} pass) launched {launches}, the schedule implies {expected}")
            out[name] = {"streams": len(per_stream), "targets": len(rows), "rounds": rounds,
                         "finetunes": n_finetunes, "steps": n_steps, "scored": n_scored, "wall_s": wall_s,
                         "frames_per_s": len(rows) / wall_s, "mean_hypos": float(np.mean([r["n_hypos"] for r in rows])),
                         "add01d": float(np.mean([r["pred_add01d"] for r in rows])), "launches": launches,
                         "stage_ms": {k: float(np.mean([r[f"time_{k}"] or 0.0 for r in rows]) * 1e3)
                                      for k in ("dtoid", "mask", "ppf", "zephyr", "label", "finetune", "iter",
                                                "complete")}}
    return out


def mesh_forwards(torch, dtoid, zephyr, scene, frames, poses):
    """14d: the template-parallel, hypothesis-parallel and 2-D farm forwards
    on the meshes [cuda:0] and [cuda:0, cuda:0] (the second runs the split
    and gather code on the one card), each against the unsplit call: the
    scores within MESH_TOL, the refined first REFINE_TOP poses equal."""
    from ossid_code_torch.models.zephyr.module import ZephyrModel
    from ossid_code_torch.parallel import mesh as pm

    local, glob = dtoid.get_template_features(scene["obj_id"], scene["limg"], scene["lmask"])
    images = torch.from_numpy(np.stack(frames[:FARM_FRAMES]).astype(np.float32) / 255.0).cuda()
    zr = ZephyrModel(num_points=NUM_POINTS, inconst_ratio_th=100.0, seed=0, need_uv=False, refine_top=REFINE_TOP,
                     device="cuda")
    zr.load_state_dict(zephyr.state_dict())
    prep = zr.prepare_object(scene["obj_id"], scene["model_points"], scene["model_colors"], scene["model_normals"])
    frame = [torch.from_numpy(frames[1]).cuda(), torch.from_numpy(scene["depth"].astype(np.int32)).cuda(),
             torch.zeros(2, dtype=torch.int32, device="cuda"), torch.from_numpy(scene["cam_K"]).cuda()]
    pz = torch.from_numpy(np.asarray(poses, np.float32)).cuda()
    valid = torch.ones(len(poses), dtype=torch.bool, device="cuda")
    with torch.inference_mode():
        unsplit = [dtoid.net.forward_all_templates(images[i:i + 1], local, glob) for i in range(FARM_FRAMES)]
        unsplit_scores = zr._score(*frame, *prep, pz, valid)
    out = {}
    for name, devs in (("[cuda:0]", ["cuda:0"]), ("[cuda:0, cuda:0]", ["cuda:0", "cuda:0"])):
        tp = pm.make_template_parallel_forward(dtoid, pm.make_mesh(len(devs), devices=devs))(images[:1], local, glob)
        farm = pm.make_serving_farm_forward(dtoid, pm.make_mesh_2d(1, len(devs), devices=devs))(images, local, glob)
        hp = pm.make_hypothesis_parallel_scorer(zr, pm.make_mesh(len(devs), devices=devs))(*frame, *prep, pz, valid)
        s_ref, s_got = unsplit_scores[0].cpu().numpy(), hp[0].cpu().numpy()
        if not np.array_equal(np.isfinite(s_ref), np.isfinite(s_got)):
            fail(f"hypothesis-parallel scorer on {name}: pruned hypotheses differ")
        fin = np.isfinite(s_ref)
        errs = {"template_parallel": float((tp[0] - unsplit[0][0]).abs().max()),
                "farm_2d": max(float((farm[0][i] - unsplit[i][0]).abs().max()) for i in range(FARM_FRAMES)),
                "hypothesis_parallel": float(np.abs(s_got[fin] - s_ref[fin]).max())}
        refined_equal = bool(torch.equal(hp[5], unsplit_scores[5]))
        if max(errs.values()) > MESH_TOL or not refined_equal:
            fail(f"mesh {name}: scores against the unsplit calls {errs} (tol {MESH_TOL}), refined poses equal "
                 f"{refined_equal}")
        out[name] = {"scores_max_abs_err": errs, "refined_equal": refined_equal, "hypotheses": len(poses)}
    return out


def dp_step_nccl(torch, cfg, device):
    """14e: one OfflineTrainer step under a one-process NCCL group (world
    size 1: the data-parallel step with its all-reduces) against the
    trainer with no group, from the same weights, batch 2 at 480x640:
    phase 7's limits for the loss, the parameters (where both gradients
    agree in sign) and the BatchNorm running statistics."""
    from ossid_code_torch.models.dtoid.module import DtoidModel
    from ossid_code_torch.parallel.launch import process_group
    from ossid_code_torch.train.offline import OfflineTrainer

    cfg2 = cfg.merged({"train": {"batch_size": 2}})
    a = DtoidModel(cfg2, seed=3, device=device)
    perturb_heads(a.net, 4)
    b = DtoidModel(cfg2, seed=3, device=device)
    b.load_state_dict(a.state_dict())
    before = {n: p.detach().double().clone() for n, p in a.net.named_parameters()}
    batch = finetune_batch(np.random.default_rng(6), 2)
    t0 = time.perf_counter()
    loss_a = OfflineTrainer(a, cfg2, n_devices=1).train_epoch([batch])["loss"]
    with process_group("nccl"):
        trainer = OfflineTrainer(b, cfg2, n_devices=None)  # None: the group's size
        if not trainer.dp:
            fail("OfflineTrainer under a process group did not take the data-parallel step")
        loss_b = trainer.train_epoch([batch])["loss"]
    out = {"loss_no_group": loss_a, "loss_nccl_group": loss_b, "loss_rel_err": abs(loss_a - loss_b) / abs(loss_a)}
    wd = float(cfg2.model.weight_decay)
    worst = 0.0
    params_b = dict(b.net.named_parameters())
    for n, p in a.net.named_parameters():
        ga, gb = p.grad.double(), params_b[n].grad.double()
        held = (ga + wd * before[n]).abs() > 2.0 * (ga - gb).abs().max()
        d = (p.detach().double() - params_b[n].detach().double()).abs()[held]
        worst = max(worst, float(d.max()) if d.numel() else 0.0)
    sa_, sb = a.state_dict(), b.state_dict()
    stat = max(float((sa_[n] - sb[n]).abs().max()) / max(float(sa_[n].abs().max()), 1e-30)
               for n, buf in a.net.named_buffers() if buf.dtype.is_floating_point)
    out.update(param_max_abs_err=worst, stat_max_rel_err=stat, seconds=time.perf_counter() - t0)
    if out["loss_rel_err"] > STEP_LOSS_TOL or worst > STEP_PARAM_TOL or stat > STEP_STAT_TOL:
        fail(f"the step under a one-process NCCL group against the trainer with no group: {out}")
    return out


def phase14(torch, F, conv, sa, dtoid, zephyr, scene, frames, poses, cfg):
    """Phase 14, scale-out on the one card: (a) kernel 1 and 1b with the
    frame indexing against their plain versions, timed; (b) the farm's
    F-frame detect; (c) the multi-stream loop; (d) the mesh forwards on
    [cuda:0] and [cuda:0, cuda:0]; (e) the data-parallel step under a
    one-process NCCL group. Prints what it measured; returns the rows of
    (a) and the launches of (b) and (c)."""
    t_phase = time.perf_counter()
    torch.set_num_threads(min(8, os.cpu_count() or 1))
    device = torch.device("cuda")
    with torch.inference_mode():
        rows32 = measure_dw_frames(torch, F, conv, dw_frames_cases(torch, device), dw_check(torch, False))
        rows16 = measure_dw_frames(torch, F, conv, dw_frames_cases(torch, device, bf16=True), dw_check(torch, True))
    for label, rows in (("dw_corr3x3", rows32), ("dw_corr3x3 bf16", rows16)):
        for r in rows:
            print(f"{label} {r['shape']}: err {r['max_abs_err']:.3g}, kernel {r['ms']:.4f} ms, plain "
                  f"{r['plain_ms']:.4f} ms, cuDNN {r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
                  f"({r['bound_by']})")
    farm = farm_round(torch, conv, sa, dtoid, scene, frames)
    print(f"phase 14b farm round of {FARM_FRAMES} frames (make_farm_detect, one-device mesh, 480x640, T="
          f"{N_TEMPLATES}): {json.dumps({k: v for k, v in farm.items() if not k.endswith('profile')})}")
    for key in ("round_profile", "two_detects_profile"):
        print(f"profile {key}: {json.dumps(farm[key])}")
    streams = multi_stream_run(torch, conv, sa, device)
    print(f"phase 14c multi-stream loop ({MS_SCENES} streams x {MS_FRAMES} frames x 2 objects, 480x640, PPF "
          f"{LOOP_HYPOS}, device ICP top {REFINE_TOP}, finetune batch {FINETUNE_BATCH} every "
          f"{FINETUNE_INTERVAL}; a cold and a warm pass from the same weights): {json.dumps(streams)}")
    meshes = mesh_forwards(torch, dtoid, zephyr, scene, frames, poses)
    print(f"phase 14d mesh forwards against the unsplit calls: {json.dumps(meshes)}")
    dp = dp_step_nccl(torch, cfg, device)
    print(f"phase 14e OfflineTrainer step under a one-process NCCL group against no group: {json.dumps(dp)}")
    print(f"phase 14 in {time.perf_counter() - t_phase:.1f} s")
    return rows32, rows16, {"farm_round": farm["launches"], "multi_stream": streams["warm"]["launches"]}


AB_TEMPLATE_SIZES = (10, T_PRETRAINED)   # phase 15b: JAX's ab_templates runs 10, 40, 80, 160
AB_SCORER_HYPOS = 128                    # 15c
TRACE_REPS = 5                           # 15f: detect and score calls in one trace
TRACED_KERNELS = {"dw_corr3x3": "dw_corr3x3_kernel", "sa_mlp_max": "sa_mlp_max_kernel"}  # span: kernel symbol
RANK_BLEND_ARGV = ["--frames", "12", "--targets", "12", "--zephyr_epochs", "2"]  # 15e: JAX's 60 / 72 / 16


def capture_json(fn, *args) -> tuple:
    """fn(*args) with its standard output captured: (its result, the JSON
    objects it printed, one a line)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    return out, [json.loads(ln) for ln in buf.getvalue().splitlines() if ln.startswith("{")]


def flops_card_vs_cpu(torch, roofline, build, what: str) -> dict:
    """One program's FLOP count (scripts/roofline.py::flop_breakdown) on the
    card and on the CPU, from the same seeds: the card's hand-written
    kernels' tally must stand in for the grouped convolution and the matrix
    products that their plain versions run on the CPU. The detect's NMS
    runs (2 K^2 FLOPs a sweep) until its fixed point, which the data decide:
    its sweeps are reported on each side, and everything else must be equal
    (the totals too where the sweeps are)."""
    counts = {}
    for dev in ("cuda", "cpu"):
        fn, args = build(dev)
        counts[dev] = roofline.flop_breakdown(fn, *args)
    card, cpu = counts["cuda"], counts["cpu"]
    if card["hand-written kernels"] <= 0 or cpu["hand-written kernels"] != 0:
        fail(f"15a {what}: the card's count holds no hand-written kernel's work ({card}; CPU {cpu})")
    nms = {}
    if what.startswith("detect"):
        from ossid_code_torch.core.config import default_config

        k2 = 2 * int(default_config().model.get("topk_pre_nms", 1000)) ** 2  # a sweep over the top-K boxes
        nms = {dev: c.get("aten.mm", 0) / k2 for dev, c in counts.items()}
        if any(v != int(v) for v in nms.values()):
            fail(f"15a {what}: matrix products not whole NMS sweeps: {counts}")
    rest = {dev: sum(c.values()) - (c.get("aten.mm", 0) if nms else 0) for dev, c in counts.items()}
    if rest["cuda"] != rest["cpu"]:
        fail(f"15a {what}: the card counts {rest['cuda']} FLOPs, the CPU {rest['cpu']} ({counts})")
    return {"card": card, "cpu": cpu, "card_total": sum(card.values()), "cpu_total": sum(cpu.values()),
            "totals_equal": sum(card.values()) == sum(cpu.values()), "nms_sweeps": nms}


def trace_kernels(torch, conv, sa) -> dict:
    """15f: the CUDA runtime the kernel libraries resolve (kernels/build.py::
    cudart_report), which must be the one the process maps (the phase fails
    naming both); then TRACE_REPS detect (T=10) and score (M=128) calls in
    one trace (utils/profiling.py::trace), held kernel by kernel: one device
    record under the kernel's own name for each launch its wrapper counted,
    and each of them inside an `annotate` span of its name
    (device_summary's kernel_records and records_in_span). Returns the
    launches in the trace."""
    import tempfile

    from ossid_code_torch.core.config import default_config
    from ossid_code_torch.kernels import build
    from ossid_code_torch.models.dtoid.module import DtoidModel
    from ossid_code_torch.models.zephyr.module import ZephyrModel
    from ossid_code_torch.scripts import roofline
    from ossid_code_torch.utils import profiling

    dtoid = DtoidModel(default_config(), seed=0, device="cuda")
    det_fn, det_args = roofline.detect_program(dtoid, np.random.default_rng(1))
    zm = ZephyrModel(num_points=NUM_POINTS, inconst_ratio_th=100.0, seed=0, need_uv=False, device="cuda")
    sc_fn, sc_args = roofline.score_program(zm, roofline.score_inputs(np.random.default_rng(1)), AB_SCORER_HYPOS)
    det_fn(*det_args)
    sc_fn(*sc_args)  # warm: templates, cuDNN plans
    runtime = build.cudart_report()
    print(f"phase 15f CUDA runtime: the process maps {json.dumps(runtime['mapped'])}; the kernel libraries resolve "
          f"{json.dumps(runtime['kernels'])}")
    if not runtime["shared"]:
        fail(f"15f: the kernels do not share the process's CUDA runtime: mapped {runtime['mapped']}, "
             f"the kernel libraries resolve {runtime['kernels']}")
    read = zero_launches(conv, sa)
    with tempfile.TemporaryDirectory(prefix="ossid_trace_") as log_dir:
        with profiling.trace(log_dir) as prof:
            for _ in range(TRACE_REPS):
                det_fn(*det_args)
                sc_fn(*sc_args)
        trace_mb = os.path.getsize(prof.trace_path) / 1e6
    launches = read()
    spans = profiling.device_summary(prof, kernels=TRACED_KERNELS)
    spans["launched"] = {n: launches[n] for n in TRACED_KERNELS}
    lost = {n: {"launched": spans["launched"][n], "records": spans["kernel_records"][n],
                "in_span": spans["records_in_span"][n]} for n in TRACED_KERNELS
            if not spans["launched"][n] == spans["kernel_records"][n] == spans["records_in_span"][n]}
    print(f"phase 15f trace of {TRACE_REPS} detect and score calls (M={AB_SCORER_HYPOS}), {trace_mb:.1f} MB: "
          f"{json.dumps(spans)}")
    if lost or any(v < 2 * TRACE_REPS for v in spans["launched"].values()):
        where = {n: launches_without_record(prof, n, TRACED_KERNELS[n]) for n in lost}
        fail(f"15f trace: kernel records by name against the wrappers' launches (a record a launch, each inside "
             f"a span of its name): {json.dumps(lost or spans['launched'])}; the launches without a record: "
             f"{json.dumps(where)}")
    return launches


def launches_without_record(prof, span: str, symbol: str) -> list:
    """The runtime's launch calls inside `span`s (the profiler's raw records)
    whose kernel `symbol` left no device record: the span's place among
    the trace's spans of that name, the launch's correlation id and its
    start in ms after the trace's first record."""
    from torch.autograd import DeviceType

    raw = prof.profiler.kineto_results.events()
    t0 = min(e.start_ns() for e in raw)
    recorded = {e.correlation_id() for e in raw if e.device_type() == DeviceType.CUDA and symbol in e.name()}
    spans = sorted((e.start_ns(), e.end_ns()) for e in raw if e.device_type() == DeviceType.CPU and e.name() == span)
    out = []
    for e in raw:
        if e.device_type() == DeviceType.CPU and "Launch" in e.name() and e.correlation_id() not in recorded:
            k = next((i for i, (a, b) in enumerate(spans) if a <= e.start_ns() <= b), None)
            if k is not None:
                out.append({"span": k, "of": len(spans), "correlation_id": e.correlation_id(),
                            "ms_after_first_record": (e.start_ns() - t0) / 1e6})
    return out


def phase15(torch, conv, sa, cli_summary, cli_summary_keys):
    """Phase 15, the measuring tools on the card: (a) scripts/roofline.py's
    main at full width, under PyTorch's default TF32 flags (the port's main
    path leaves them), and the FLOP counts of detect T=10 and score M=128
    card against CPU; (b) ab_templates at T = 10 and 160, kernel 1 held at 2
    launches a detect; (c) ab_scorer at M = 128, four-tap and packed, f32
    and bf16, kernel 2 / 2b held at 2 a call; (d) ab_finetune at batch 8,
    bf16 and f32, dx and kernel 3 held at 2 a step; (e) ab_rank_blend at its
    width and a reduced depth; (f) is trace_kernels, which main runs before
    phase 3 (the profiler loses a session's first records once a process
    has opened many sessions); (g)
    summarize_result of phase 9's results pickle (read in phase 9). Every
    launch count is set to 0 before each path and read after it. Returns
    the launches of each path."""
    import tempfile

    from ossid_code_torch.core.config import default_config
    from ossid_code_torch.models.dtoid.module import DtoidModel
    from ossid_code_torch.models.zephyr.module import ZephyrModel
    from ossid_code_torch.scripts import ab_finetune, ab_rank_blend, ab_scorer, ab_templates, roofline
    from ossid_code_torch.utils import profiling

    t_phase = time.perf_counter()
    torch.set_num_threads(min(8, os.cpu_count() or 1))
    launches = {}

    # -- 15a. the roofline
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, False  # PyTorch's defaults
    try:
        read = zero_launches(conv, sa)
        t0 = time.perf_counter()
        rows = roofline.main(["--hypos", "128", "512"])
        torch.cuda.synchronize()
        launches["roofline"] = read()
        roofline_s = time.perf_counter() - t0
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags

    def detect_on(dev):
        return roofline.detect_program(DtoidModel(default_config(), seed=0, device=dev), np.random.default_rng(0))

    def score_on(dev):
        zm = ZephyrModel(num_points=NUM_POINTS, inconst_ratio_th=100.0, seed=0, need_uv=False, device=dev)
        return roofline.score_program(zm, roofline.score_inputs(np.random.default_rng(0)), AB_SCORER_HYPOS)

    t0 = time.perf_counter()
    flops = {"detect t=10 f32": flops_card_vs_cpu(torch, roofline, detect_on, "detect t=10"),
             f"score M={AB_SCORER_HYPOS} f32": flops_card_vs_cpu(torch, roofline, score_on, "score")}
    print(f"phase 15a roofline ({roofline_s:.1f} s, PyTorch's TF32 defaults: cudnn on, matmul off): "
          f"{json.dumps({'roofline': rows})}")
    print(f"phase 15a FLOPs card against CPU ({time.perf_counter() - t0:.1f} s): {json.dumps(flops)}")

    # -- 15b-d. the A/B scripts
    read = zero_launches(conv, sa)
    t0 = time.perf_counter()
    lines, _ = capture_json(ab_templates.main, ["--sizes", *map(str, AB_TEMPLATE_SIZES), "--iters", "4"])
    torch.cuda.synchronize()
    launches["ab_templates"] = read()
    if [ln["dw_corr3x3_launches_per_detect"] for ln in lines] != [2] * len(AB_TEMPLATE_SIZES):
        fail(f"15b ab_templates: kernel 1 launches a detect {lines}, expected 2 at each T")
    print(f"phase 15b ab_templates ({time.perf_counter() - t0:.1f} s): {json.dumps(lines)}")

    read = zero_launches(conv, sa)
    t0 = time.perf_counter()
    score_rows, _ = capture_json(ab_scorer.main, ["--hypos", str(AB_SCORER_HYPOS), "--iters", "6"])
    torch.cuda.synchronize()
    launches["ab_scorer"] = read()
    if any(r["sa_mlp_max_launches"] != 2 for r in score_rows):
        fail(f"15c ab_scorer: kernel 2 / 2b launches a call {score_rows}, expected 2")
    for bf16 in (False, True):
        sums = {r["config"]: r["score_sum"] for r in score_rows if r["bf16"] == bf16}
        if sums["packed"] != sums["baseline"]:
            fail(f"15c ab_scorer: four-tap and packed sampling score differently ({sums}, bf16 {bf16})")
    print(f"phase 15c ab_scorer ({time.perf_counter() - t0:.1f} s): {json.dumps(score_rows)}")

    read = zero_launches(conv, sa)
    t0 = time.perf_counter()
    ft_lines, _ = capture_json(ab_finetune.main, ["--iters", "4"])
    torch.cuda.synchronize()
    launches["ab_finetune"] = read()
    if any((ln["dw_corr3x3_dx_launches"], ln["dw_corr3x3_dk_launches"]) != (2, 2) for ln in ft_lines):
        fail(f"15d ab_finetune: dx / kernel 3 launches a step {ft_lines}, expected 2 each")
    print(f"phase 15d ab_finetune ({time.perf_counter() - t0:.1f} s): {json.dumps(ft_lines)}")

    # -- 15e. ab_rank_blend at its width (240x320), reduced depth
    read = zero_launches(conv, sa)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="ossid_rank_blend_") as root:
        rc, blend_lines = capture_json(ab_rank_blend.main, [*RANK_BLEND_ARGV, "--root", root])
    torch.cuda.synchronize()
    launches["ab_rank_blend"] = read()
    summary = next((d for d in blend_lines if "summary" in d), None)
    if rc != 0 or summary is None or summary["n_frames"] < 1 or launches["ab_rank_blend"]["sa_mlp_max"] < 2:
        fail(f"15e ab_rank_blend: rc {rc}, summary {summary}, launches {launches['ab_rank_blend']}")
    print(f"phase 15e ab_rank_blend {' '.join(RANK_BLEND_ARGV)} ({time.perf_counter() - t0:.1f} s): "
          f"{json.dumps(summary)}")

    # -- 15g. summarize_result of phase 9's results pickle
    if not cli_summary or not all(np.isfinite(cli_summary.get(k, np.nan)) for k in cli_summary_keys):
        fail(f"15g summarize_result of phase 9's pickle: {cli_summary}")
    print(f"phase 15g summarize_result of phase 9's results pickle: {json.dumps(cli_summary)}")
    print(f"phase 15 in {time.perf_counter() - t_phase:.1f} s")
    return launches


# phase 16: the main path at the canonical configurations
LOOP72_FRAMES = 36        # x 2 objects = 72 targets: BASELINE config 3 (bench.py:299-302,374-390)
LOOP72_INTERVAL = 32      # its finetune interval: 2 events in 72 targets
TURNS16 = PIPE_TURNS * 2  # 4 synchronous and 4 pipelined runs, in turns
LMO_FRAMES = 18           # 16c: x 2 objects = 36 targets on a world named lmo (72 cut to keep phase 16 in 300 s)
LMO_VIEWS = T_PRETRAINED  # its template grid: configuration 1's 160 views an object
LMO_ARGV = ["--dataset_name", "lmo", "--always_dtoid_mask", "--finetune_interval", "32", "--finetune_epochs", "1",
            "--n_local_test", str(T_PRETRAINED)]  # README's configurations 1 and 2/3


def lmo_world(root):
    """16c's inputs under `root`: the BOP dataset `lmo` (LMO_FRAMES frames of
    480x640, 2 objects), a template grid of LMO_VIEWS views an object and the
    precomputed scorer pickle under the JAX names in the data root, a DTOID
    checkpoint (seed 1, heads perturbed as phase 6's) and a scorer
    checkpoint (seed 10)."""
    from ossid_code_torch.core.checkpoint import save_checkpoint
    from ossid_code_torch.core.config import default_config
    from ossid_code_torch.data.bop import BopDataset, BopDatasetArgs
    from ossid_code_torch.data.dtoid_bop import BOP_OBJECT_ID_OFFSETS
    from ossid_code_torch.data.synthetic import (
        default_objects, make_synthetic_bop, make_template_grid, make_zephyr_results_pkl,
    )
    from ossid_code_torch.models.dtoid.module import DtoidModel
    from ossid_code_torch.models.zephyr.module import ZephyrModel

    w = {k: os.path.join(root, k) for k in ("bop", "data", "ckpts", "results", "bop_results")}
    make_synthetic_bop(w["bop"], dataset_name="lmo", n_frames=LMO_FRAMES, img_h=480, img_w=640)
    make_template_grid(os.path.join(w["data"], "templates_LMO_DTOID"), default_objects(), n_views=LMO_VIEWS,
                       obj_id_offset=BOP_OBJECT_ID_OFFSETS["lmo"])
    bop = BopDataset(BopDatasetArgs(bop_root=w["bop"], dataset_name="lmo"))
    make_zephyr_results_pkl(os.path.join(w["data"], "lmo_boptest_zephyr_result.pkl"), bop)
    os.makedirs(w["ckpts"])
    dtoid = DtoidModel(default_config(), seed=1, device="cpu")
    perturb_heads(dtoid.net, 2)
    w["dtoid"] = os.path.join(w["ckpts"], "dtoid_seed1.ckpt")
    save_checkpoint(w["dtoid"], dtoid.state_dict())
    w["scorer"] = os.path.join(w["ckpts"], "scorer_seed10.ckpt")
    save_checkpoint(w["scorer"], ZephyrModel(num_points=NUM_POINTS, seed=10, device="cpu").state_dict())
    return w, bop


@contextlib.contextmanager
def synchronous_loops():
    """Within, every OnlineLearningLoop runs its synchronous path (the CLI
    builds the pipelined one)."""
    from ossid_code_torch.loop.online_learning import OnlineLearningLoop

    init = OnlineLearningLoop.__init__

    def sync_init(self, *args, **kwargs):
        init(self, *args, **kwargs)
        self.pipeline_scoring = False

    OnlineLearningLoop.__init__ = sync_init
    try:
        yield
    finally:
        OnlineLearningLoop.__init__ = init


def cli_t160(torch, conv, sa):
    """16c: the CLI (scripts/online_learning.py's main, in process) with
    LMO_ARGV on lmo_world, synchronous then pipelined, cuDNN deterministic:
    a row a target in each, the gates and schedule equal between the two
    (first_divergence), kernel 1 twice a detection (redispatches included)
    and its dx and kernel 3 twice a step, kernel 2 twice a score call, the
    CSV's rows finite, and kernel 1's calls of the first run held against
    the plain version (hold_dw_calls: x (160, 29, 39, 640), stride 0 over
    the templates). Returns what it measured."""
    import pickle
    import tempfile

    from ossid_code_torch.eval.bop_csv import read_results_bop

    t0 = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory(prefix="ossid_lmo_") as root:
        w, bop = lmo_world(root)
        out["world_s"] = time.perf_counter() - t0
        argv = [*LMO_ARGV, "--exp_name", "chip_t160", "--dtoid_weights_path", w["dtoid"],
                "--zephyr_ckpt_path", w["scorer"]]
        det = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        runs = {}
        try:
            for mode in ("sync", "pipelined"):
                torch.cuda.reset_peak_memory_stats()
                with (synchronous_loops() if mode == "sync" else contextlib.nullcontext()), \
                        (recording_dw_calls(conv) if mode == "sync" else contextlib.nullcontext()) as calls:
                    res, launches, score_calls, _, wall_s, loop_s = run_cli(torch, conv, sa, w, argv)
                with open(res["results_path"], "rb") as f:
                    rows = pickle.load(f)["test_results"]
                csv = read_results_bop(res["csv_path"])
                runs[mode] = {"rows": rows, "launches": launches, "score_calls": len(score_calls), "wall_s": wall_s,
                              "loop_s": loop_s, "csv": csv, "calls": calls,
                              "steps": sum(len(ep) for logs in res["loop"].finetune_logs for ep in logs),
                              "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                              "summary": {k: res[k] for k in ("AR", "mAP", "dtoid_mean_iou", "add01d")}}
        finally:
            torch.backends.cudnn.deterministic = det
    for mode, r in runs.items():
        rows, steps, stale = r["rows"], r["steps"], r["launches"]["redispatches"]
        expected = dict.fromkeys(r["launches"], 0)
        expected.update({"dw_corr3x3": 2 * (len(rows) + stale) + 2 * steps, "dw_corr3x3_dx": 2 * steps,
                         "dw_corr3x3_dk": 2 * steps, "sa_mlp_max": 2 * r["score_calls"], "redispatches": stale})
        finite = all(np.isfinite(c["score"]) or c["score"] == -np.inf for c in r["csv"]) and \
            all(np.isfinite(c["pose"]).all() for c in r["csv"])
        if len(rows) != len(bop.targets) or len(r["csv"]) != len(rows) or not finite \
                or r["launches"] != expected:
            fail(f"16c {mode}: {len(rows)} rows for {len(bop.targets)} targets, {len(r['csv'])} CSV rows (finite "
                 f"{finite}), launches {r['launches']} against the schedule's {expected}")
    d = first_divergence(runs["sync"]["rows"], runs["pipelined"]["rows"])
    if d is not None:
        fail(f"16c: the pipelined run's gates or schedule depart from the synchronous run's: {json.dumps(d)}")
    held = hold_dw_calls(torch, conv, runs["sync"]["calls"])
    if not any(str(T_PRETRAINED) in h["shape"] for h in held if h["call"] == "forward"):
        fail(f"16c: kernel 1 never ran at T={T_PRETRAINED}: {held}")
    out.update({mode: {"frames_per_s": len(r["rows"]) / r["loop_s"], "loop_s": r["loop_s"], "main_s": r["wall_s"],
                       "targets": len(r["rows"]), "finetune_events": sum(x["finetune"] for x in r["rows"]),
                       "steps": r["steps"], "peak_memory_gib": r["peak_gib"],
                       "detect_ms_mean": float(np.mean([x["time_dtoid"] for x in r["rows"]]) * 1e3),
                       "launches": r["launches"], "summary": r["summary"]} for mode, r in runs.items()})
    out.update(schedules_equal=True, spread=run_spread(runs["sync"]["rows"], runs["pipelined"]["rows"]),
               kernel1_calls_held=held, phase_s=time.perf_counter() - t0)
    return out


def entry_on_card(torch, conv, sa) -> dict:
    """16d: ossid_code_torch/entry.py on the card: entry()'s forward on its
    example arguments (finite, JAX's shapes, kernel 1 twice: the stem and
    the 4 templates' head) and dryrun_multidevice(2) on [cuda:0, cuda:0]
    (the mesh helpers and a step in two gloo processes on the card)."""
    from ossid_code_torch.entry import dryrun_multidevice, entry

    t0 = time.perf_counter()
    fn, args = entry()
    fn(*args)
    torch.cuda.synchronize()
    read = zero_launches(conv, sa)
    outs = fn(*args)
    torch.cuda.synchronize()
    launches = read()
    shapes = [list(o.shape) for o in outs]
    if shapes[2] != [4, 7, 9, 1] or shapes[3] != [4, 128, 160] or launches["dw_corr3x3"] != 2 or \
            not all(bool(torch.isfinite(o).all()) for o in outs):
        fail(f"16d entry(): outputs {shapes}, launches {launches}")
    out = {"entry_shapes": shapes, "entry_launches": launches, "entry_s": time.perf_counter() - t0}
    t0 = time.perf_counter()
    out["dryrun"] = dryrun_multidevice(2)
    out["dryrun_s"] = time.perf_counter() - t0
    return out


def world72(root) -> dict:
    """16a's and 16b's world under `root`: loop_world at LOOP72_FRAMES
    frames, its float32 and bf16-step configurations, the scorer (device
    ICP of the top REFINE_TOP) and fresh PPF generators a call."""
    from ossid_code_torch.core.config import default_config
    from ossid_code_torch.models.zephyr.module import ZephyrModel

    cfg32 = default_config()
    bop, zr_list = loop_world(root, cfg32, n_frames=LOOP72_FRAMES)
    return {"bop": bop, "zr_list": zr_list, "cfg32": cfg32, "cfg16": cfg32.merged({"model": {"bf16_finetune": True}}),
            "zephyr": ZephyrModel(num_points=NUM_POINTS, inconst_ratio_th=100.0, seed=0, need_uv=False,
                                  refine_top=REFINE_TOP, device="cuda"),
            "make_gens": lambda: hypo_gens(bop)}


def config3_turns(torch, conv, sa, w: dict) -> dict:
    """16a: BASELINE config 3 on world72 (72 targets, a finetune every 32,
    bf16 steps, RGB, cuDNN deterministic) in TURNS16 (phases 6 and 11 ran
    its paths at 16 targets: no warm-up run), held by hold_turns (and
    pipe_turns' launch schedule), the dw-corr calls of the first counted run
    against their plain versions, one pipelined pass traced (trace_pass)."""
    from ossid_code_torch.models.dtoid.module import DtoidModel

    t0 = time.perf_counter()
    dtoid16 = DtoidModel(w["cfg16"], seed=1, device="cuda")
    perturb_heads(dtoid16.net, 2)
    torch.cuda.reset_peak_memory_stats()
    args = (torch, conv, sa, dtoid16, w["zephyr"], w["cfg16"], w["bop"], w["zr_list"], w["make_gens"])
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        runs = pipe_turns(*args, yuv=False, warm_up=False, turns=TURNS16, targets=2 * LOOP72_FRAMES,
                          interval=LOOP72_INTERVAL, where="phase 16a", record_dw=True)
        gens = w["make_gens"]()
        traced = trace_pass(torch, lambda: run_loop(torch, dtoid16, w["zephyr"], w["cfg16"], w["bop"], w["zr_list"],
                                                    gens, interval=LOOP72_INTERVAL))
    finally:
        torch.backends.cudnn.deterministic = det
    a = turns_summary(runs)
    print(f"phase 16a runs ({time.perf_counter() - t0:.1f} s): frames/s {json.dumps(a['frames_per_s'])}; "
          f"first divergence {json.dumps(a['first_divergence'])}; stages {json.dumps(a['divergent_stage'])}; "
          f"spread {json.dumps(a['spread'])}")
    hold_turns(a, "phase 16a")
    a.update(dw_calls_held=hold_dw_calls(torch, conv, runs[0]["dw_calls"]), traced_pass=traced,
             phase_s=time.perf_counter() - t0)
    return a


def default_turns(torch, conv, sa, w: dict) -> dict:
    """16b: the port's default configuration on world72 (float32 steps,
    RGB, cuDNN's normal algorithms) in TURNS16: launches and speculation
    held (pipe_turns), frames/s, schedules and spread reported."""
    from ossid_code_torch.models.dtoid.module import DtoidModel

    t0 = time.perf_counter()
    dtoid32 = DtoidModel(w["cfg32"], seed=1, device="cuda")
    perturb_heads(dtoid32.net, 2)
    torch.cuda.reset_peak_memory_stats()
    b = turns_summary(pipe_turns(torch, conv, sa, dtoid32, w["zephyr"], w["cfg32"], w["bop"], w["zr_list"],
                                 w["make_gens"], yuv=False, warm_up=False, turns=TURNS16, targets=2 * LOOP72_FRAMES,
                                 interval=LOOP72_INTERVAL, where="phase 16b"))
    b["phase_s"] = time.perf_counter() - t0
    return b


def phase16(torch, conv, sa) -> dict:
    """Phase 16, the main path at the canonical configurations: (a)
    BASELINE config 3 at its full length (config3_turns), (b) the same turns
    in the port's default configuration (default_turns; this folds phase
    11b), both on world72; (c) configuration 1's 160 templates through the
    CLI (cli_t160); (d) entry.py on the card (entry_on_card). Returns what
    it measured."""
    import tempfile

    t_phase = time.perf_counter()
    torch.set_num_threads(min(8, os.cpu_count() or 1))
    out = {}
    with tempfile.TemporaryDirectory(prefix="ossid_world72_") as root:
        t0 = time.perf_counter()
        w = world72(root)
        out["world_s"] = time.perf_counter() - t0
        out["16a"] = config3_turns(torch, conv, sa, w)
        out["16b"] = default_turns(torch, conv, sa, w)
    out["16c"] = cli_t160(torch, conv, sa)
    out["16d"] = entry_on_card(torch, conv, sa)
    out["phase_s"] = time.perf_counter() - t_phase
    return out


def report16(p16: dict) -> None:
    """Phase 16's lines."""
    for key, what in (("16a", "BASELINE config 3, 72 targets, finetune every 32, bf16 steps, RGB, cuDNN "
                              "deterministic"),
                      ("16b", "the default configuration (float32 steps, RGB, cuDNN's normal algorithms), "
                              "72 targets, finetune every 32")):
        r = p16[key]
        fps = r["frames_per_s_median"]
        print(f"phase {key}, {what}, in turns {'/'.join(TURNS16)} ({r['phase_s']:.1f} s): frames/s median "
              f"{json.dumps(fps)} (pipelined / sync {fps['pipelined'] / fps['sync']:.3f}), spread (max - min) "
              f"{json.dumps(r['frames_per_s_spread'])}; each run "
              + ", ".join(f"{t['mode']} {t['frames_per_s']:.3f}" for t in r["turns"])
              + "; speculation hit rate " + ", ".join(str(t["spec_hit_rate"]) for t in r["turns"])
              + f"; peak memory {r['peak_memory_gib']:.2f} GiB; schedules equal {r['schedules_equal']}; first "
              f"divergence {json.dumps(r['first_divergence'])}; stage {json.dumps(r['divergent_stage'])}; spread of "
              f"scores and poses (max abs) {json.dumps(r['spread'])}")
        print(f"phase {key} fetches and waits by kind, counts, launches, finetune checksums: {json.dumps(r['turns'])}")
    a = p16["16a"]
    print(f"phase 16a one pipelined pass traced: {json.dumps(a['traced_pass'])}")
    print(f"phase 16a dw-corr calls of the first counted run against their plain versions: "
          f"{json.dumps(a['dw_calls_held'])}")
    c = p16["16c"]
    print(f"phase 16c the CLI {' '.join(LMO_ARGV)} on a world named lmo ({LMO_FRAMES} frames x 2 objects, "
          f"{LMO_VIEWS} views an object; world {c['world_s']:.1f} s, phase {c['phase_s']:.1f} s), cuDNN deterministic: "
          + "; ".join(f"{m}: {json.dumps(c[m])}" for m in ("sync", "pipelined"))
          + f"; schedules equal {c['schedules_equal']}; spread {json.dumps(c['spread'])}")
    print(f"phase 16c kernel 1's calls (and the steps') against their plain versions: "
          f"{json.dumps(c['kernel1_calls_held'])}")
    print(f"phase 16d entry.py on the card: {json.dumps(p16['16d'])}")
    print(f"phase 16 in {p16['phase_s']:.1f} s")


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
    device_name = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; float32 with TF32 off (cuDNN and "
          f"matmul), and the bf16 paths; peaks used for bounds: {HBM_BYTES_PER_S / 1e12} TB/s, "
          f"{FP32_FLOPS / 1e12} TFLOP/s FP32, {TF32_FLOPS / 1e12} TFLOP/s TF32, "
          f"{BF16_FLOPS / 1e12} TFLOP/s BF16")

    stamp("phase 1")
    # -- 1. build -----------------------------------------------------------
    t0 = time.perf_counter()
    logs = build.build()
    for lib in ("ppf", "rasterizer", "icp"):
        build.build_native(lib)
    print(f"built {[s.name for s in build.sources()]} and native/ppf.cpp, native/rasterizer.cpp, native/icp.cpp "
          f"in {time.perf_counter() - t0:.1f} s")
    for src, log in logs.items():
        for kernel, report in ptxas_report(log):
            print(f"  ptxas {src} {kernel}: {report}")

    stamp("phase 2")
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
        dw_edge_err = check_dw_corr_edges(torch, conv, dw_corr_edge_cases(torch, device), dw_check(torch, False))
        sa_edge_err = check_sa_edges(torch, sa, device)
        dw16_edge_err = check_dw_corr_edges(torch, conv, dw_corr_edge_cases(torch, device, bf16=True),
                                            dw_check(torch, True))
        sa16_edge_err = check_sa_edges(torch, sa, device, bf16=True)
        print(f"edge cases agree: dw_corr3x3 max abs err {dw_edge_err:.3g}, "
              f"sa_mlp_max max abs err {sa_edge_err:.3g}; bf16: {dw16_edge_err:.3g}, {sa16_edge_err:.3g}")
        dw_cases = dw_corr_cases(torch, device)
        dw_rows = measure_dw_corr(torch, F, conv, dw_cases, dw_check(torch, False))
        sa_rows = measure_sa(torch, sa, zephyr, prep, 128) + measure_sa(torch, sa, zephyr, prep, 256)
        dw16_rows = measure_dw_corr(torch, F, conv, [(label, as_bf16(x), as_bf16(k)) for label, x, k in dw_cases],
                                    dw_check(torch, True))
        sa16_rows = (measure_sa(torch, sa, zephyr, prep, 128, bf16=True)
                     + measure_sa(torch, sa, zephyr, prep, 256, bf16=True))
    for label, rows in (("dw_corr3x3", dw_rows), ("sa_mlp_max", sa_rows), ("dw_corr3x3 bf16", dw16_rows),
                        ("sa_mlp_max bf16", sa16_rows)):
        for r in rows:
            extra = (f"; 3-pass floor {r['three_pass_floor_ms']:.4f} ms, FP32-pipe bound "
                     f"{r['fp32_pipe_bound_ms']:.4f} ms; weight packing {r['pack_ms']:.4f} ms "
                     f"device, {r['pack_host_ms']:.4f} ms host" if "fp32_pipe_bound_ms" in r else "")
            print(f"{label} {r['shape']}: err {r['max_abs_err']:.3g}, kernel {r['ms']:.4f} ms, "
                  f"plain {r['plain_ms']:.4f} ms, library {r['library_ms']}, "
                  f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}){extra}")

    stamp("phase 3")
    # -- 15f, traced before any other profiling session of the process: the
    # profiler loses a session's first records once a process has opened
    # about 15 (utils/profiling.py::trace)
    stamp("phase 15f")
    trace_launches = trace_kernels(torch, conv, sa)

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

    # -- 3b. the same frames in bf16: bf16_infer and ZephyrModel(bf16=True) on
    # the same weights, the same hypotheses scored --------------------------------
    dtoid16 = DtoidModel(cfg.merged({"model": {"bf16_infer": True}}), seed=0, device=device)
    dtoid16.load_state_dict(dtoid.state_dict())
    zephyr16 = ZephyrModel(num_points=NUM_POINTS, inconst_ratio_th=100.0, seed=0, need_uv=False, bf16=True,
                           device=device)
    zephyr16.load_state_dict(zephyr.state_dict())

    def serve16(img, poses):
        b = dict(scene, img=img)
        t0 = time.perf_counter()
        det16 = dtoid16.forward_test_time(b)
        t1 = time.perf_counter()
        scored16 = zephyr16.score_hypotheses(dict(b, pose_hypos=poses), obj_id=scene["obj_id"])
        return det16, scored16, (t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3

    serve16(frames[0], results[0][1])  # warm-up: the bf16 weight copies, templates, cuDNN plans
    torch.cuda.synchronize()
    counters = (conv.dw_corr3x3_cuda, conv.dw_corr3x3_dx_cuda, conv.dw_corr3x3_dk_cuda, sa.sa_mlp_max_cuda)
    for c in counters:
        c.launches = c.launches_bf16 = c.flops = 0
    served16 = [serve16(img, r[1]) for img, r in zip(frames[1:], results)]
    serve16_launches = {"dw_corr3x3_bf16": conv.dw_corr3x3_cuda.launches_bf16,
                        "sa_mlp_max_bf16": sa.sa_mlp_max_cuda.launches_bf16,
                        "float32 kernels": sum(c.launches for c in counters)}
    for (det16, scored16, _, _), r in zip(served16, results):
        check_frame(det16, scored16, dtoid.img_size)
    if serve16_launches != {"dw_corr3x3_bf16": 2 * N_FRAMES, "sa_mlp_max_bf16": 2 * N_FRAMES, "float32 kernels": 0}:
        fail(f"bf16 serving launched {serve16_launches}, expected 2 of each bf16 kernel per frame and no "
             f"float32 kernel")
    cmp16 = compare_bf16_serving(results, [(d, sc) for d, sc, _, _ in served16])
    print(f"served {N_FRAMES} frames in bf16: detect {[round(r[2], 3) for r in served16]} ms, score "
          f"{[round(r[3], 3) for r in served16]} ms (host clock, results fetched); launches {serve16_launches}; "
          f"against float32: {json.dumps(cmp16)}")
    for label, fn in (("detect bf16", lambda: dtoid16.forward_test_time(batch)),
                      ("score bf16", lambda: zephyr16.score_hypotheses(dict(batch, pose_hypos=poses),
                                                                       obj_id=scene["obj_id"]))):
        print(f"profile {label}: {json.dumps(profile_call(torch, fn))}")

    stamp("phase 4")
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
    zephyr16_cpu = ZephyrModel(num_points=NUM_POINTS, inconst_ratio_th=100.0, seed=0, need_uv=False, bf16=True,
                               device="cpu")
    zephyr16_cpu.load_state_dict(zephyr_cpu.state_dict())
    s16_cpu = zephyr16_cpu.score_hypotheses(dict(batch, pose_hypos=poses), obj_id=scene["obj_id"])["scores"]
    cmp["bf16_score_max_rel_err"] = float(np.abs(served16[0][1]["scores"] - s16_cpu).max() / np.abs(s16_cpu).max())
    if cmp["bf16_score_max_rel_err"] > BF16_SCORE_TOL:
        fail(f"bf16 Zephyr scores GPU vs CPU differ by {cmp['bf16_score_max_rel_err']:.3g} of the largest "
             f"(tol {BF16_SCORE_TOL})")
    print(f"GPU vs CPU plain path on frame 1 ({time.perf_counter() - t0:.1f} s): {json.dumps(cmp)}")

    stamp("phase 5")
    # -- 5. the backward of dw_corr3x3 against its plain version -----------
    bwd_cases = dw_bwd_cases(torch, device)
    bwd_errs = [check_dw_bwd(torch, conv, *case) for case in bwd_cases]
    print(f"dw_corr3x3 backward through autograd agrees: worst relative error "
          f"dx {max(e[0] for e in bwd_errs):.3g} (tol {DX_TOL}), dk {max(e[1] for e in bwd_errs):.3g} "
          f"(tol {DK_TOL})")
    with torch.inference_mode():
        bwd_rows = measure_dw_bwd(torch, conv, bwd_cases[:2])
        bwd_edge_rows = measure_dw_bwd(torch, conv, bwd_cases[2:])
    for r in bwd_rows + bwd_edge_rows:
        print(f"dw_corr3x3 backward {r['shape']}: dk rel err {r['dk_rel_err']:.3g}, bitwise repeatable "
              f"{r['dk_bitwise_repeatable']}, dk {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, cuDNN "
              f"{r['library_ms']:.4f}, bound {r['bound_ms']:.4f} {r['bound_by']}); dx rel err "
              f"{r['dx_rel_err']:.3g}, dx {r['dx_ms']:.4f} ms (plain {r['dx_plain_ms']:.4f}, cuDNN "
              f"{r['dx_library_ms']:.4f}, bound {r['dx_bound_ms']:.4f})")
    bwd_edge_err = max(r["max_abs_err"] for r in bwd_edge_rows)
    # ... and in bf16 (kernels 1b and 3b), within two bf16 steps of the
    # largest magnitude (a broadcast input's gradient sums bf16 per-sample
    # gradients), dk also 1e-4 for its float32 order
    tols16 = (2 * BF16_STEP, 2 * BF16_STEP + 1e-4)
    bwd16_cases = dw_bwd_cases(torch, device, bf16=True)
    bwd16_errs = [check_dw_bwd(torch, conv, *case, tols=tols16) for case in bwd16_cases]
    with torch.inference_mode():
        bwd16_rows = measure_dw_bwd(torch, conv, bwd16_cases[:2], tols16)
        bwd16_edge_rows = measure_dw_bwd(torch, conv, bwd16_cases[2:], tols16)
    print(f"dw_corr3x3 bf16 backward through autograd agrees: worst relative error "
          f"dx {max(e[0] for e in bwd16_errs):.3g}, dk {max(e[1] for e in bwd16_errs):.3g} (tol {tols16})")
    for r in bwd16_rows + bwd16_edge_rows:
        print(f"dw_corr3x3 bf16 backward {r['shape']}: dk rel err {r['dk_rel_err']:.3g}, bitwise repeatable "
              f"{r['dk_bitwise_repeatable']}, dk {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, cuDNN "
              f"{r['library_ms']:.4f}, bound {r['bound_ms']:.4f} {r['bound_by']}); dx rel err "
              f"{r['dx_rel_err']:.3g}, dx {r['dx_ms']:.4f} ms (plain {r['dx_plain_ms']:.4f}, cuDNN "
              f"{r['dx_library_ms']:.4f}, bound {r['dx_bound_ms']:.4f})")
    bwd16_edge_err = max(r["max_abs_err"] for r in bwd16_edge_rows)

    stamp("phase 6")
    # -- 6. the online loop at full width ---------------------------------------
    import tempfile

    torch.set_num_threads(min(8, os.cpu_count() or 1))
    cfg_loop = default_config()
    with tempfile.TemporaryDirectory(prefix="ossid_world_") as root:
        t0 = time.perf_counter()
        bop, zr_list = loop_world(root, cfg_loop)
        gens = hypo_gens(bop)
        print(f"loop world: {LOOP_FRAMES} frames 480x640 x {len(bop.obj_ids)} objects in "
              f"{time.perf_counter() - t0:.1f} s; hypotheses: native PPF")
        dtoid_loop = DtoidModel(cfg_loop, seed=1, device=device)
        perturb_heads(dtoid_loop.net, 2)
        zephyr_loop = ZephyrModel(num_points=NUM_POINTS, inconst_ratio_th=100.0, seed=0,
                                  need_uv=False, refine_top=REFINE_TOP, device=device)
        step_ms, step_spans = time_train_step(torch, dtoid_loop, np.random.default_rng(5))
        dtoid_loop.reset_optimizer()
        # warm-up of the refined score program (solver and cuBLAS handles)
        warm = FakeHypoGen(n_hypos=LOOP_HYPOS, seed=0)
        zephyr_loop.score_hypotheses(dict(scene, img=frames[0], pose_hypos=warm.find_surface_model(
            scene["model_points"] + np.array([0.0, 0.0, 0.9], np.float32))[0]), obj_id="warm-up")
        loop32 = drive_loop(torch, conv, sa, dtoid_loop, zephyr_loop, cfg_loop, bop, zr_list, gens)
        # the gating profile as the bench runs it by default: bf16 finetune
        # steps (BENCH_BF16_FINETUNE=1), the same weights and world
        cfg_loop16 = cfg_loop.merged({"model": {"bf16_finetune": True}})
        dtoid_loop16 = DtoidModel(cfg_loop16, seed=1, device=device)
        perturb_heads(dtoid_loop16.net, 2)
        step16_ms, step16_spans = time_train_step(torch, dtoid_loop16, np.random.default_rng(5))
        dtoid_loop16.reset_optimizer()
        loop16 = drive_loop(torch, conv, sa, dtoid_loop16, zephyr_loop, cfg_loop16, bop, zr_list, gens)
        # -- 11. the pipelined loop against the synchronous one, YUV transport
        stamp("phase 11")
        p11 = phase11(torch, conv, sa, dtoid_loop16, zephyr_loop, cfg_loop16, bop, zr_list, lambda: hypo_gens(bop))
    for label, (rows, wall_s, loop, launches, peak_gib, loop_profile), ms, bf16 in (
            ("loop", loop32, step_ms, False), ("loop, bf16 finetune", loop16, step16_ms, True)):
        n_steps = sum(len(ep) for logs in loop.finetune_logs for ep in logs)
        n_scored = sum(r["n_hypos"] > 0 for r in rows)
        expected = dict.fromkeys(launches, 0)
        # 2 launches a detection: one a target, and again for each
        # speculative detection a finetune made stale
        expected.update({"dw_corr3x3": 2 * (len(rows) + launches["redispatches"]), "sa_mlp_max": 2 * n_scored,
                         "redispatches": launches["redispatches"]})
        step_kernels = ("dw_corr3x3_bf16", "dw_corr3x3_dx_bf16", "dw_corr3x3_dk_bf16") if bf16 else \
            ("dw_corr3x3", "dw_corr3x3_dx", "dw_corr3x3_dk")
        for name in step_kernels:
            expected[name] += 2 * n_steps
        check_loop(rows, 2 * LOOP_FRAMES, launches, expected)
        print(f"{label}: {json.dumps(loop_summary(rows, wall_s, loop, launches, peak_gib, ms))}")
        print(f"profile {label} (a second pass): {json.dumps(loop_profile)}")
    loop_launches = loop32[3]
    loop16_launches = loop16[3]
    print(f"phase 11, the loop with --yuv_transfer in turns {'/'.join(PIPE_TURNS)} after a warm-up run "
          f"({p11['targets']} targets, bf16 steps, {p11['phase_s']:.1f} s): frames/s median "
          f"{json.dumps(p11['frames_per_s_median'])}; each run "
          + ", ".join(f"{t['mode']} {t['frames_per_s']:.3f}" for t in p11["turns"])
          + "; speculation hit rate " + ", ".join(str(t["spec_hit_rate"]) for t in p11["turns"])
          + "; fetches a frame " + ", ".join(f"{t['fetches_per_frame']:.3f}" for t in p11["turns"]))
    print(f"phase 11 spread of scores and poses (max abs): {json.dumps(p11['spread'])}; schedules equal "
          f"{p11['schedules_equal']}")
    print(f"phase 11 fetches and waits by kind, counts, launches: {json.dumps(p11['turns'])}")
    print(f"profile pipelined loop with --yuv_transfer (after the turns): {json.dumps(p11['profile_pipelined'])}")
    print(f"YUV 4:2:0 transport of a 480x640 frame: {json.dumps(p11['transport'])}")
    p11_pipe = next(t["launches"] for t in p11["turns"] if t["mode"] == "pipelined")
    p11_sync = next(t["launches"] for t in p11["turns"] if t["mode"] == "sync")
    batch8 = finetune_batch(np.random.default_rng(7), FINETUNE_BATCH)
    print(f"profile train step (batch {FINETUNE_BATCH}, float feed): "
          f"{json.dumps(profile_call(torch, lambda: dtoid_loop.train_step(batch8)))}")
    print(f"profile train step, bf16 (batch {FINETUNE_BATCH}, float feed): "
          f"{json.dumps(profile_call(torch, lambda: dtoid_loop16.train_step(batch8)))}")

    stamp("phase 7")
    # -- 7. one finetune step, card against the CPU plain path --------------------
    t0 = time.perf_counter()
    dtoid_step = DtoidModel(cfg, seed=3, device=device)
    perturb_heads(dtoid_step.net, 4)
    dtoid_step_cpu = DtoidModel(cfg, seed=3, device="cpu")
    dtoid_step_cpu.load_state_dict({k: v.cpu() for k, v in dtoid_step.state_dict().items()})
    step_cmp = compare_step(torch, dtoid_step, dtoid_step_cpu, finetune_batch(np.random.default_rng(6), 2))
    print(f"finetune step GPU vs CPU plain path, batch 2 at 480x640 "
          f"({time.perf_counter() - t0:.1f} s): {json.dumps(step_cmp)}")

    # -- 7b. one bf16 step against the card's float32 step, same weights --------
    t0 = time.perf_counter()
    m32 = DtoidModel(cfg, seed=3, device=device)
    perturb_heads(m32.net, 4)
    m16 = DtoidModel(cfg.merged({"model": {"bf16_finetune": True}}), seed=3, device=device)
    m16.load_state_dict(m32.state_dict())
    step16_cmp = compare_step_bf16(torch, m16, m32, finetune_batch(np.random.default_rng(6), FINETUNE_BATCH))
    print(f"bf16 finetune step against the float32 step on the card, batch {FINETUNE_BATCH} at 480x640 "
          f"({time.perf_counter() - t0:.1f} s): {json.dumps(step16_cmp)}")
    print(f"train step at batch {FINETUNE_BATCH}, host clock: float32 {step_ms:.1f} ms, bf16 {step16_ms:.1f} ms "
          f"(bf16 {'faster' if step16_ms < step_ms else 'not faster'}); host spans (ms, issue time): "
          f"float32 {json.dumps(step_spans)}, bf16 {json.dumps(step16_spans)}")
    turns = {"float32": [], "bf16": []}
    for i in range(STEP_TURNS):
        for name, m in (("float32", m32), ("bf16", m16))[::1 if i % 2 == 0 else -1]:
            turns[name].append(time_train_step(torch, m, np.random.default_rng(5))[0])
    t32, t16 = (float(np.median(turns[k])) for k in ("float32", "bf16"))
    print(f"train step at batch {FINETUNE_BATCH} in turns on the same weights, host clock, median of "
          f"{STEP_TURNS}: float32 {t32:.1f} ms, bf16 {t16:.1f} ms (bf16 {'faster' if t16 < t32 else 'not faster'}); "
          f"readings {json.dumps(turns)}")

    stamp("phase 8")
    # -- 8. the end-to-end demo at the bench's reduced quality protocol -------
    torch.set_num_threads(min(8, os.cpu_count() or 1))
    demo_dw, demo_bwd, demo_sa = demo_kernels(torch, F, conv, sa, device)
    for r in demo_dw + demo_sa:
        print(f"{'sa_mlp_max' if 'S=' in r['shape'] else 'dw_corr3x3'} at the demo's {r['shape']}: err "
              f"{r['max_abs_err']:.3g}, kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library "
              f"{r['library_ms']}, bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    for r in demo_bwd:
        print(f"dw_corr3x3 backward at the demo's {r['shape']}: dk rel err {r['dk_rel_err']:.3g}, dk {r['ms']:.4f} ms "
              f"(plain {r['plain_ms']:.4f}, cuDNN {r['library_ms']:.4f}, bound {r['bound_ms']:.4f} {r['bound_by']}); "
              f"dx rel err {r['dx_rel_err']:.3g}, dx {r['dx_ms']:.4f} ms (plain {r['dx_plain_ms']:.4f}, cuDNN "
              f"{r['dx_library_ms']:.4f}, bound {r['dx_bound_ms']:.4f})")
    demo, demo_by_stage, demo_wall_s, picks16, zsplit, demo_spec = run_demo(torch, conv, sa)
    counts = demo["counts"]
    demo_stale = hold_speculation(demo_spec, counts["loop_frames"], demo["n_finetunes"], "the demo's loop")
    print(f"demo {' '.join(DEMO_ARGV)}: {demo_wall_s:.1f} s; stages (s) {json.dumps(demo['stage_s'])}; "
          f"counts {json.dumps(counts)}; the loop's redispatched detections {demo_stale}")
    print(f"demo launches by stage: {json.dumps(demo_by_stage)}")
    for stage, got in demo_by_stage.items():
        want = demo_launch_schedule(stage, counts, demo_stale)
        if any(got[k] != v for k, v in want.items()) or any(got[f"{k}_bf16"] for k in want):
            fail(f"demo stage {stage}: launches {got} differ from the schedule's {want}")
    if demo["n_finetunes"] < 1 or not all(np.isfinite(demo[k]) for k in ("AR", "AR_vsd", "AR_mssd", "AR_mspd")):
        fail(f"demo summary {demo}: expected finite ARs and at least one finetune")
    if demo["AR"] < DEMO_AR_FLOOR:
        fail(f"demo AR {demo['AR']} below the JAX bench's floor {DEMO_AR_FLOOR}")
    demo_launches = {k: sum(st[k] for st in demo_by_stage.values()) for k in demo_by_stage["loop"]}
    # the bf16 scorer on the trained weights (run after the counts were read)
    print(f"bf16 scorer on the demo's trained weights against float32, calibration sets: {json.dumps(picks16)}")
    if picks16["frames"] < 1 or \
            abs(picks16["add_correct_bf16"] - picks16["add_correct_f32"]) > BF16_SCORER_ADD_SLACK:
        fail(f"bf16 scorer on trained weights: {picks16['add_correct_bf16']} ADD-correct picks against float32's "
             f"{picks16['add_correct_f32']} over {picks16['frames']} sets (limit {BF16_SCORER_ADD_SLACK} apart)")
    print(f"scorer train step on a demo frame, host clock: {json.dumps(zsplit)}")

    stamp("phase 9")
    # -- 9. the online-learning CLI at full width on a world named ycbv -------
    torch.set_num_threads(min(8, os.cpu_count() or 1))
    with tempfile.TemporaryDirectory(prefix="ossid_cli_") as root:
        t0 = time.perf_counter()
        cli_w, cli_bop = cli_world(root)
        world_s = time.perf_counter() - t0
        cli_out, cli_launches, calls, cli_hypos, cli_wall, cli_loop_s = run_cli(
            torch, conv, sa, cli_w, cli_argv(cli_w, "dtoid", "--use_sift_hypos"))
        cli_rows, cli_counts = check_cli(cli_out, cli_launches, calls, cli_hypos, cli_bop)
        sift_cmp, sift_ms, sift_blank_ms, sift_profile = sift_card_vs_cpu(torch, cli_w, cli_out["loop"])
        from ossid_code_torch.utils.logging import summarize_result

        cli_result_summary = summarize_result(cli_out["results_path"])  # phase 15g
    stage = lambda key: float(np.mean([r[key] for r in cli_rows if r[key] is not None]) * 1e3)  # noqa: E731
    print(f"CLI {len(cli_rows)} targets 480x640 (ycbv-named world, PPF + SIFT, two scorers, host ICP, device ICP "
          f"top {REFINE_TOP}, finetune every {CLI_FINETUNE_INTERVAL}): world {world_s:.1f} s, main {cli_wall:.1f} s, "
          f"loop {cli_loop_s:.1f} s = {len(cli_rows) / cli_loop_s:.2f} frames/s; stage means (ms): "
          + json.dumps({k: stage(f"time_{k}") for k in ("data", "dtoid", "mask", "ppf", "sift", "zephyr", "icp",
                                                        "label", "finetune", "iter", "complete")}))
    print(f"CLI summary: {json.dumps({k: v for k, v in cli_out.items() if k not in ('loop', 'results_path', 'csv_path')})}; "
          f"checks: {json.dumps(cli_counts)}; launches {json.dumps(cli_launches)}")
    print(f"SIFT card against CPU on {sift_cmp['images']} images (frames, templates): {json.dumps(sift_cmp)}; "
          f"SIFT a textured 480x640 frame on the card, ms: {json.dumps(sift_ms)}, median "
          f"{float(np.median(sift_ms))}; the blanked frame, ms: {json.dumps(sift_blank_ms)}")
    print(f"profile SIFT one textured 480x640 frame (500 features): {json.dumps(sift_profile)}")

    stamp("phase 10")
    # -- 10. the class-conditional detector and the train CLI -----------------
    mcli_launches, mdemo_launches, train_runs = phase10(torch, conv, sa, cfg)

    stamp("phase 12")
    # -- 12. the train CLI's legacy families and the DTOID wrapper -------------
    p12 = phase12(torch, conv, sa)

    stamp("phase 13")
    # -- 13. the render family at full width, kernel 1 at T=160 ----------------
    p13, t160 = phase13(torch, F, conv, sa)

    stamp("phase 14")
    # -- 14. scale-out on the one card: the farm, the streams, the mesh ----------
    frames14, frames14_bf16, p14 = phase14(torch, F, conv, sa, dtoid, zephyr, scene, frames, poses, cfg)

    # -- 15. the measuring tools: roofline, the A/B scripts, a trace, the log readers
    stamp("phase 15")
    p15 = phase15(torch, conv, sa, cli_result_summary, ("dtoid_mean_iou", "add01d", "mean_time_dtoid"))
    p15["trace"] = trace_launches

    # -- 16. the main path at the canonical configurations -------------------
    stamp("phase 16")
    p16 = phase16(torch, conv, sa)
    report16(p16)
    p16_launches = {**{f"loop72_{dt}_{m}": next(t["launches"] for t in p16[k]["turns"] if t["mode"] == m)
                       for k, dt in (("16a", "bf16"), ("16b", "f32")) for m in ("sync", "pipelined")},
                    **{f"cli_lmo_t160_{m}": p16["16c"][m]["launches"] for m in ("sync", "pipelined")},
                    "entry": p16["16d"]["entry_launches"]}
    stamp("the kernels' line")

    hbm = f"HBM {HBM_BYTES_PER_S / 1e12} TB/s"
    dw_src, bwd_src = "ossid_code_torch/csrc/dw_corr3x3.cu", "ossid_code_torch/csrc/dw_corr3x3_bwd.cu"
    dw_replaces = "ossid_code_tpu/ops/pallas_kernels.py:49"
    bwd_replaces = ("ossid_code_tpu/ops/conv.py:15 (the gradient JAX takes through XLA's grouped conv; "
                    "no Pallas kernel)")
    # launches: the float32 kernels' in the float32 loop run; the bf16
    # kernels' in the bf16 serving run (1b, 2b) and the bf16-finetune loop
    # run (1b, its dx, 3b), added, with each run's count beside
    by_path10 = lambda name: {"cli_maskrcnn": mcli_launches[name], "demo_maskrcnn": mdemo_launches[name],
                            **{f"train_{f}": r["launches"][name] for f, r in train_runs.items()},
                            **{path: launches[name] for path, launches in p12.items()},
                            **{path: launches[name] for path, launches in p13.items()},
                            **{path: launches[name] for path, launches in p14.items()},
                            **{path: launches[name] for path, launches in p15.items()},
                            **{path: launches[name] for path, launches in p16_launches.items()}}
    by_path11 = lambda name: {"loop_yuv_pipelined": p11_pipe[name], "loop_yuv_sync": p11_sync[name]}
    by_path = lambda name: {"serving_bf16": serve16_launches.get(name, 0), "loop_bf16": loop16_launches[name],
                            "cli": cli_launches[name], **by_path10(name), **by_path11(name)}
    by_path32 = lambda name: {"loop": loop_launches[name], "demo": demo_launches[name], "cli": cli_launches[name],
                              **by_path10(name), **by_path11(name)}
    kernels = [
        dict(summary("dw_corr3x3", dw_src, dw_replaces, loop_launches["dw_corr3x3"], dw_rows, dw_edge_err, hbm),
             dtype="float32", launches_by_path=by_path32("dw_corr3x3"), demo_shapes=demo_dw,
             pretrained_templates=t160, frame_shapes=frames14),
        dict(summary("dw_corr3x3_bwd", bwd_src, bwd_replaces, loop_launches["dw_corr3x3_dk"], bwd_rows,
                     bwd_edge_err, hbm), dtype="float32", dx_launches=loop_launches["dw_corr3x3_dx"],
             launches_by_path=by_path32("dw_corr3x3_dk"), dx_launches_by_path=by_path32("dw_corr3x3_dx"),
             demo_shapes=demo_bwd),
        dict(summary("sa_mlp_max", "ossid_code_torch/csrc/sa_mlp_max.cu", "ossid_code_tpu/ops/sa_fused.py:85",
                     loop_launches["sa_mlp_max"], sa_rows, sa_edge_err,
                     f"TF32 tensor cores {TF32_FLOPS / 1e12} TFLOP/s"), dtype="float32",
             launches_by_path=by_path32("sa_mlp_max"), demo_shapes=demo_sa),
        dict(summary("dw_corr3x3_bf16", dw_src, dw_replaces, sum(by_path("dw_corr3x3_bf16").values()),
                     dw16_rows, dw16_edge_err, hbm), dtype="bfloat16", launches_by_path=by_path("dw_corr3x3_bf16"),
             frame_shapes=frames14_bf16),
        dict(summary("dw_corr3x3_bwd_bf16", bwd_src, bwd_replaces, loop16_launches["dw_corr3x3_dk_bf16"],
                     bwd16_rows, bwd16_edge_err, hbm), dtype="bfloat16",
             dx_launches=loop16_launches["dw_corr3x3_dx_bf16"],
             launches_by_path={"loop_bf16": loop16_launches["dw_corr3x3_dk_bf16"],
                               "cli": cli_launches["dw_corr3x3_dk_bf16"], **by_path10("dw_corr3x3_dk_bf16"),
                               **by_path11("dw_corr3x3_dk_bf16")}),
        dict(summary("sa_mlp_max_bf16", "ossid_code_torch/csrc/sa_mlp_max_bf16.cu",
                     "ossid_code_tpu/ops/sa_fused.py:85", serve16_launches["sa_mlp_max_bf16"], sa16_rows,
                     sa16_edge_err, f"BF16 tensor cores {BF16_FLOPS / 1e12} TFLOP/s"), dtype="bfloat16",
             launches_by_path={"serving_bf16": serve16_launches["sa_mlp_max_bf16"],
                               "loop_bf16": loop16_launches["sa_mlp_max_bf16"],
                               "cli": cli_launches["sa_mlp_max_bf16"], **by_path10("sa_mlp_max_bf16"),
                               **by_path11("sa_mlp_max_bf16")}),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": device_name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
