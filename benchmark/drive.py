"""One cell's session: its world, the program built on it, set-up and the
measured window.

The world is the port's synthetic BOP generator's, written under a
temporary directory from the seed (frames and layout from the seed; the
meshes, template grid and precomputed results fixed). The weights are the
benchmark's (`weights.py`), made on the device from the seed and handed to
the program and to the reference alike. The program is
`ossid_code_torch`'s online loop (`OnlineLearningLoop.run`) over the
harness's stream of targets (`hooks.Stream`).

Set-up runs the traffic's prefix through the loop (a finetune buffer, as a
stream has it past its start) or warms the first targets, and with
`restore_each_pass` keeps a snapshot of everything a pass changes: the
detector's weights and statistics, the optimizer's moments, the finetune
buffer with its labels and replay frames, the dataset's generator state and
the next finetune boundary. The window then runs whole passes from that
snapshot until its seconds have passed; the pass under way at the deadline
completes and counts.
"""

from __future__ import annotations

import argparse
import copy
import gc
import os
import pickle
import threading
import time

import torch

from benchmark import weights
from benchmark.hooks import Hooks, Stream

DATASET = "synth"


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _settle() -> None:
    """Before set-up ends and before each pass: collect, then move every
    object alive into the collector's permanent generation, so that a pass's
    collections scan what that pass made, not what set-up and the earlier
    passes left (the harness keeps every completed target for the check)."""
    gc.collect()
    gc.freeze()


def build_world(root: str, config: dict, traffic: dict, seed: int) -> dict:
    """The cell's BOP world under `root`: `frames` frames of the two default
    objects (their layout from the seed), a template grid of T views an
    object, and the precomputed results the loader reads."""
    from ossid_code_torch.data.bop import BopDataset, BopDatasetArgs
    from ossid_code_torch.data.synthetic import (
        default_objects, make_synthetic_bop, make_template_grid, make_zephyr_results_pkl,
    )

    m = config["model"]
    make_synthetic_bop(root, dataset_name=DATASET, n_frames=int(traffic["frames"]), img_h=int(m["img_h"]),
                       img_w=int(m["img_w"]), seed=int(seed), layout=traffic.get("layout", "spread"),
                       n_scenes=int(traffic.get("scenes", 1)))
    grid = os.path.join(root, "grid")
    make_template_grid(grid, default_objects(), n_views=int(config["dataset"]["n_local_test"]),
                       size=int(m["template_size"]))
    bop = BopDataset(BopDatasetArgs(bop_root=root, dataset_name=DATASET))
    zr_path = os.path.join(root, "zr.pkl")
    make_zephyr_results_pkl(zr_path, bop, score=50.0)
    with open(zr_path, "rb") as f:
        zr_list = pickle.load(f)
    return {"root": root, "dataset_root": os.path.join(root, DATASET), "grid": grid, "bop": bop,
            "zr_list": zr_list, "zr_path": zr_path}


def program_config(config: dict, world: dict, control: str | None):
    """The port's configuration tree with the cell's values; the control
    switches on the port's own bf16 paths (detection and finetune)."""
    from ossid_code_torch.core.config import default_config

    cfg = default_config()
    model = dict(config["model"])
    model["densenet_blocks"] = tuple(model["densenet_blocks"])
    if control == "bf16":
        model.update(bf16_infer=True, bf16_finetune=True)
    cfg = cfg.merged({"model": model, "dataset": dict(config["dataset"])})
    d = cfg.dataset
    d.bop_root, d.test_dataset_name, d.grid_root = world["root"], DATASET, world["grid"]
    d.load_zephyr_result, d.zephyr_result_path = True, world["zr_path"]
    # the readers' caches hold every frame of the world: set-up decodes the
    # passes' frames once, and the window's loop takes them decoded, as
    # from a camera, not from PNG files on each pass
    d.cache_frames = d.proc_cache_frames = 4 * len(world["bop"].targets)
    return cfg


def loop_args(config: dict) -> argparse.Namespace:
    lp = config["loop"]
    return argparse.Namespace(
        dataset_name=DATASET, exp_name="benchmark", use_dtoid_segmask=bool(lp["use_dtoid_segmask"]),
        ignore_dtoid_mask=False, always_dtoid_mask=bool(lp["always_dtoid_mask"]),
        use_oracle_gt=bool(lp["use_oracle_gt"]), use_sift_hypos=False, use_maskrcnn=False,
        finetune_interval=int(lp.get("finetune_interval", 32)), finetune_warmup=0,
        finetune_epochs=int(lp.get("finetune_epochs", 1)), finetune_reset=False,
        finetune_batch_size=int(lp.get("finetune_batch_size", 8)), non_cum=bool(lp.get("non_cum", False)),
        save_each=False, raw_dtoid=False, no_finetune=not lp["finetune"], fast=bool(lp["fast"]),
        zephyr_depth_crop=int(config["scorer"]["depth_crop"]), yuv_transfer=bool(lp["yuv_transfer"]))


class Session:
    def __init__(self, config: dict, traffic: dict, seed: int, device: torch.device, root: str,
                 control: str | None = None, fault: str | None = None):
        self.config, self.traffic, self.seed, self.device = config, traffic, int(seed), device
        self.control, self.fault = control, fault
        t0 = time.perf_counter()
        self.world = build_world(root, config, traffic, self.seed)
        t1 = time.perf_counter()
        self._build()
        self.setup_stages = {"world_s": t1 - t0, "build_s": time.perf_counter() - t1}

    # ------------------------------------------------------------ program
    def _build(self) -> None:
        from ossid_code_torch.data.dtoid_bop import get_dataloaders
        from ossid_code_torch.hypo.ppf import PPFModelMeters
        from ossid_code_torch.loop.online_learning import OnlineLearningLoop
        from ossid_code_torch.models.dtoid.module import DtoidModel
        from ossid_code_torch.models.zephyr.module import ZephyrModel

        cfg, dev, w = program_config(self.config, self.world, self.control), self.device, self.world
        if dev.type == "cuda":
            from ossid_code_torch.kernels import build

            build.build()
        lp = self.config["loop"]
        torch.backends.cudnn.deterministic = bool(lp["cudnn_deterministic"])
        self.cfg = cfg
        self.dtoid = DtoidModel(cfg, seed=0, device=dev)
        weights.dtoid_weights(self.dtoid.net, self.seed)
        sc = self.config["scorer"]
        self.zephyr = ZephyrModel(num_points=int(sc["num_points"]), inconst_ratio_th=float(sc["inconst_ratio_th"]),
                                  seed=0, need_uv=False, refine_top=int(sc["refine_top"]),
                                  bf16=self.control == "bf16", device=dev)
        weights.zephyr_weights(self.zephyr.net, self.seed + 2)
        # the weights both sides start from: inputs, kept for the reference
        self.dtoid_init = {k: v.detach().clone() for k, v in self.dtoid.net.state_dict().items()}
        self.zephyr_init = {k: v.detach().clone() for k, v in self.zephyr.net.state_dict().items()}

        ppf = self.config["ppf"]
        bop = w["bop"]
        gens = {oid: PPFModelMeters(bop.getObjPath(oid), ModelSamplingDist=ppf["ModelSamplingDist"],
                                    scene_sampling_dist=ppf["scene_sampling_dist"], ref_pt_rate=ppf["ref_pt_rate"],
                                    refine_top=int(ppf["refine_top"]), max_poses=int(ppf["max_poses"]))
                for oid in bop.obj_ids}
        train_loader, _, test_loader = get_dataloaders(cfg, w["zr_list"])
        test_loader.dataset.sortTargets()
        self.targets = [dict(t) for t in test_loader.dataset.bop_dataset.targets]
        need = int(self.traffic["prefix_targets"]) + int(self.traffic["pass_targets"])
        if len(self.targets) < need:
            raise ValueError(f"the world has {len(self.targets)} targets; the traffic needs {need}")
        train_ds = train_loader.dataset
        train_ds.clearTargets()
        zr = {(r["obj_id"], r["scene_id"], r["im_id"]): dict(r) for r in w["zr_list"]}
        train_ds.zephyr_results = {k: dict(v) for k, v in zr.items()}
        self.train_ds = train_ds
        self.stream = Stream(test_loader)
        self.loop = OnlineLearningLoop(loop_args(self.config), cfg, self.dtoid, bop, train_ds, self.stream, zr,
                                       zephyr_model=self.zephyr, hypo_gens=gens,
                                       pipeline_scoring=bool(lp["pipelined"]))
        if self.fault:
            # under the hooks, as a fault of the program would be
            from benchmark import faults

            faults.install(self.fault, self)
        self.hooks = Hooks(self.loop, self.dtoid, self.zephyr)

    # ------------------------------------------------------------- set-up
    def prefix_targets(self) -> list:
        return self.targets[:int(self.traffic["prefix_targets"])]

    def pass_targets(self) -> list:
        p = int(self.traffic["prefix_targets"])
        return self.targets[p:p + int(self.traffic["pass_targets"])]

    def prepare(self, capture_steps: int = 0) -> dict:
        """Set-up's run through the loop: the prefix (with the first
        `capture_steps` train steps captured for the check), or the first
        `warmup_targets` of a pass; then the snapshot. Returns the capture."""
        first = self.prefix_targets() or self.pass_targets()[:int(self.traffic["warmup_targets"])]
        capture = self._capture(capture_steps) if capture_steps else None
        t0 = time.perf_counter()
        self.stream.use(first)
        self.loop.run(progress=False)
        self.hooks.on_step = None
        _sync(self.device)
        self.setup_stages["prefix_s"] = time.perf_counter() - t0
        # decode the passes' frames into the readers' caches
        t0 = time.perf_counter()
        self.stream.use(self.pass_targets())
        for i in range(len(self.stream.dataset)):
            self.stream.dataset[i]
        self.setup_stages["decode_s"] = time.perf_counter() - t0
        if capture is not None:
            capture["losses"] = [float(l) for l in capture["losses"]]
            capture["keys"] = [tuple(int(t[k]) for k in ("obj_id", "scene_id", "im_id"))
                               for t in self.train_ds.bop_dataset.targets[:self.config["loop"]["finetune_interval"]]]
        if self.traffic.get("restore_each_pass"):
            self.snapshot = self._snapshot()
        self.hooks.clear()
        _settle()
        return capture

    def _capture(self, n: int) -> dict:
        """The first n train steps of set-up: each step's loss, the
        optimizer's first moments after the first step, and the weights
        after the n-th (read before the next step changes them)."""
        cap = {"losses": [], "mu1": None, "params_n": None}
        opt = self.dtoid.optimizer
        names = [name for name, _ in self.dtoid.net.named_parameters()]
        params = [p for _, p in self.dtoid.net.named_parameters()]

        def on_step(out):
            k = len(cap["losses"])
            if k >= n:
                return
            cap["losses"].append(out["loss"].detach().clone())
            if k == 0:
                cap["mu1"] = {nm: opt.state[p]["mu"].detach().clone() for nm, p in zip(names, params)
                              if p in opt.state}
                cap["b1"] = opt.param_groups[0]["b1"]
            if k == n - 1:
                cap["params_n"] = {nm: p.detach().clone() for nm, p in zip(names, params)}
        self.hooks.on_step = on_step
        return cap

    def _snapshot(self) -> dict:
        opt = self.dtoid.optimizer
        state = {p: {k: (v.detach().clone() if isinstance(v, torch.Tensor) else v) for k, v in st.items()}
                 for p, st in opt.state.items()}
        return {
            "net": {k: v.detach().clone() for k, v in self.dtoid.net.state_dict().items()},
            "opt": state,
            "opt_by_name": {n: state[p] for n, p in self.dtoid.net.named_parameters() if p in state},
            "targets": [dict(t) for t in self.train_ds.bop_dataset.targets],
            "zr": {k: dict(v) for k, v in self.train_ds.zephyr_results.items()},
            "replay": dict(self.loop.replay.entries) if self.loop.replay is not None else None,
            "rng": copy.deepcopy(self.train_ds.rng.bit_generator.state),
            "next_finetune": self.loop.next_finetune_number,
        }

    @torch.no_grad()
    def restore(self) -> None:
        s = self.snapshot
        for k, v in self.dtoid.net.state_dict().items():
            v.copy_(s["net"][k])
        opt = self.dtoid.optimizer
        for p, st in s["opt"].items():
            cur = opt.state[p]
            for k, v in st.items():
                if isinstance(v, torch.Tensor):
                    cur[k].copy_(v)
                else:
                    cur[k] = v
        self.train_ds.bop_dataset.targets = [dict(t) for t in s["targets"]]
        self.train_ds.zephyr_results = {k: dict(v) for k, v in s["zr"].items()}
        if s["replay"] is not None:
            self.loop.replay.entries = dict(s["replay"])
        self.train_ds.rng.bit_generator.state = copy.deepcopy(s["rng"])
        self.loop.next_finetune_number = s["next_finetune"]
        self.dtoid.weights_version += 1
        self.dtoid.clear_cache()

    # ------------------------------------------------------------- window
    def run_pass(self) -> dict:
        _settle()
        if self.traffic.get("restore_each_pass"):
            self.restore()
        self.stream.use(self.pass_targets())
        self.loop.finetune_logs = []
        first_record = len(self.hooks.records)
        wv0 = self.dtoid.weights_version
        steps0 = self.hooks.steps
        read = self._read_weights()
        _sync(self.device)
        t0 = time.perf_counter()
        rows = self.loop.run(progress=False)
        _sync(self.device)
        t1 = time.perf_counter()
        self.hooks.on_step = None
        records = self.hooks.records[first_record:]
        latency = [r["done"] - self.stream.handoff[r["ids"]] for r in records]
        return {"t0": t0, "t1": t1, "seconds": t1 - t0, "targets": len(rows), "latency_s": latency,
                "weights_version": wv0, "finetune_logs": self.loop.finetune_logs,
                "steps": self.hooks.steps - steps0, "events": len(self.loop.finetune_logs),
                "params_k": read.get("params"), "k": read.get("k"),
                "records": (first_record, len(self.hooks.records))}

    def _read_weights(self) -> dict:
        """With a finetune, the weights after the pass's first min(3, its
        first event's steps) train steps, for the check (a device copy of
        the parameters after each of those steps, read by nothing in the
        window)."""
        read: dict = {}
        lp = self.config["loop"]
        if not lp["finetune"]:
            return read
        interval, bs = int(lp["finetune_interval"]), int(lp["finetune_batch_size"])
        first = (int(self.traffic["prefix_targets"]) // interval + 1) * interval
        due = min(3, -(-first // bs))
        named = list(self.dtoid.net.named_parameters())
        count = [0]

        def on_step(out):
            count[0] += 1
            if count[0] <= due:
                read["params"] = {n: p.detach().clone() for n, p in named}
                read["k"] = count[0]
        self.hooks.on_step = on_step
        return read

    def measure(self, seconds: float, traced=None) -> list:
        """Whole passes until `seconds` have passed (the last one completes
        and counts), or with `traced` (a context manager) one pass inside
        it."""
        from ossid_code_torch.utils.rpc_stats import STATS

        STATS.reset()
        self.hooks.reset_counts()
        passes = []
        if traced is not None:
            log = self.hooks.log
            log.on = True
            with traced:
                t0 = time.time_ns()
                passes.append(self.run_pass())
                log.spans.append(("pass", threading.get_native_id(), t0, time.time_ns()))
            log.on = False
        else:
            start = time.perf_counter()
            while not passes or time.perf_counter() - start < seconds:
                if passes:
                    passes[-1]["params_k"] = None  # the check reads the last pass's
                passes.append(self.run_pass())
        self.stats = STATS.snapshot()
        self.spec_hit_rate = STATS.spec_hit_rate()
        return passes

    def release(self) -> None:
        """Free the program's device state (the captures stay)."""
        self.loop.close()
        for name in ("loop", "dtoid", "zephyr", "stream", "train_ds"):
            setattr(self, name, None)
        self.hooks.loop = self.hooks.dtoid = self.hooks.zephyr = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
