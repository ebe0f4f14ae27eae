"""How `correct` is decided: the window's outputs against the plain
reference (`reference/`), run after the window has closed, the peak memory
has been read and the program's state is freed.

The reference runs on the run's device in float32 with TF32 off
(convolutions and matrix products), from the benchmark's own inputs: the
world's files, read again, and the weights the benchmark made from the seed.
It judges the program's outputs as a served model's tokens are judged: the
detections it made and the hypotheses it scored are read only to be held
against what the reference computes from the same inputs.

Numbers (each has a limit in `limits/<workload>.json`; a number that a
limit names and the run does not yield fails the run):
  * detection, on a sample of the window's targets drawn from the seed:
    `det_unpaired` (the share of the program's top 50 detections, pooled
    over the sampled targets, that the reference has no detection of the
    same template and box for: a wrong box or template), `det_p90` (the 90th percentile of the score gaps of the program's top
    50 detections against the reference's detection of the same template
    and box, pooled over the sampled targets: a detection paired with
    another anchor of a coincident box, or across a near tie of the NMS, is
    one gap of some 400 and moves a widest gap or a mean square, not this);
  * scoring, on the same targets: `score_gap` (every hypothesis's score,
    the largest gap over the largest score's magnitude), `pose_mm` /
    `pose_deg` (the picked pose against the reference's refined pose of the
    same hypothesis: a wrong pick reads hundreds of mm);
  * the window's schedule: `schedule_steps` / `schedule_events` (each
    pass's train steps and finetune events against those its traffic
    fixes, the largest difference; exact);
  * with a finetune: set-up's first event followed from the seed's weights
    for three steps: `grad_gap` (the first gradient as the optimizer got it,
    worked out from its first moments after one step: the median leaf's gap
    of norms over the larger of that leaf's reference norm and the median
    leaf's), `update_gap` (the weights' change after three steps, the worst
    leaf, the same way); and the last pass's first event followed from the
    harness's snapshot (the program's state) for three steps:
    `window_loss_gap` (each step's loss, relative) and `window_update_gap`
    (the weights' change over those steps, the median leaf's gap, as
    `grad_gap` takes it). Leaves whose reference gradient is under a thousandth of
    the median leaf's move by round-off alone and are left out.
"""

from __future__ import annotations

import numpy as np
import torch

# detections paired by template and box for `det_p90`
DET_PAIRS = 50
PAIR_PX = 0.5
ZERO_LEAF = 1e-3


class _Cfg(dict):
    """An attribute dict: the configuration as the reference's frozen
    modules read it."""

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e


def _ref_config(config: dict) -> _Cfg:
    model = dict(config["model"])
    model["densenet_blocks"] = tuple(model["densenet_blocks"])
    return _Cfg(model=_Cfg(model), dataset=_Cfg(config["dataset"]))


def _matched_score_gaps(boxes, scores, tids, det, k: int = DET_PAIRS) -> tuple:
    """Score gaps of the program's top-k detections against the reference's
    detection of the same template and box (every corner within PAIR_PX;
    of several, the nearest in score), and how many detections were looked
    at: a near tie that ranks or suppresses another box leaves that
    detection unpaired, not compared."""
    r_boxes, r_scores, r_tids = det["pred_bbox"], det["pred_scores"], det["pred_template_ids"]
    gaps = []
    n = min(k, len(scores))
    for i in range(n):
        same = (r_tids == tids[i]) & (np.abs(r_boxes - boxes[i]).max(axis=1) <= PAIR_PX)
        if same.any():
            # anchors whose boxes coincide (clipped at the border) pair by score
            cand = r_scores[same]
            gaps.append(float(scores[i]) - float(cand[np.argmin(np.abs(cand - scores[i]))]))
    return np.asarray(gaps, np.float64), n


def _sorted_targets(dataset_root: str) -> list:
    import json
    import os

    with open(os.path.join(dataset_root, "test_targets_bop19.json")) as f:
        targets = json.load(f)
    return sorted(((int(t["obj_id"]), int(t["scene_id"]), int(t["im_id"])) for t in targets),
                  key=lambda k: (k[1], k[2], k[0]))


def _leaf_gap(prog: dict, ref: dict, keep: list) -> tuple:
    """The worst leaf's |norm(prog) - norm(ref)| over max(norm(ref), the
    median leaf's norm), over the leaves in `keep`; that leaf, and its
    reference norm over the median's."""
    ref_n = {k: float(ref[k].double().norm()) for k in keep}
    med = float(np.median(list(ref_n.values()))) if ref_n else 0.0
    worst, leaf = 0.0, None
    for k in keep:
        got = float(prog[k].double().norm()) if k in prog else 0.0  # no state: nothing moved
        g = abs(got - ref_n[k]) / max(ref_n[k], med, 1e-30)
        if g > worst:
            worst, leaf = g, k
    return worst, leaf, (ref_n[leaf] / med if leaf is not None and med > 0 else None)


def _median_leaf_gap(prog: dict, ref: dict, keep: list) -> float:
    """The median over the leaves in `keep` of |norm(prog) - norm(ref)| over
    max(norm(ref), the median leaf's norm)."""
    ref_n = {k: float(ref[k].double().norm()) for k in keep}
    med = float(np.median(list(ref_n.values()))) if ref_n else 0.0
    gaps = [abs((float(prog[k].double().norm()) if k in prog else 0.0) - ref_n[k]) / max(ref_n[k], med, 1e-30)
            for k in keep]
    return float(np.median(gaps)) if gaps else 0.0


class Reference:
    def __init__(self, config: dict, world: dict, device: torch.device):
        from benchmark.reference.dtoid_model import DtoidModel
        from benchmark.reference.templates import TemplateDataset
        from benchmark.reference.world import Frames, model_cloud
        from benchmark.reference.zephyr_model import ZephyrModel

        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        self.config, self.device = config, device
        self.frames = Frames(world["dataset_root"])
        self.targets = _sorted_targets(world["dataset_root"])
        obj_ids = sorted({t[0] for t in self.targets})
        self.grid = TemplateDataset(world["grid"], obj_ids)
        self.dtoid = DtoidModel(_ref_config(config), seed=0, device=device)
        sc = config["scorer"]
        self.zephyr = ZephyrModel(num_points=int(sc["num_points"]), inconst_ratio_th=float(sc["inconst_ratio_th"]),
                                  seed=0, need_uv=False, refine_top=int(sc["refine_top"]), device=device)
        self.clouds = {oid: model_cloud(self.frames.obj_path(oid)) for oid in obj_ids}
        self._cache: dict = {}

    def frame(self, ids) -> dict:
        if ids not in self._cache:
            self._cache[ids] = self.frames.read(*ids)
        return self._cache[ids]

    def load_dtoid(self, state: dict, opt_state: dict | None = None) -> None:
        with torch.no_grad():
            self.dtoid.net.load_state_dict({k: v.to(self.device) for k, v in state.items()}, strict=True)
        self.dtoid.clear_cache()
        self.dtoid.reset_optimizer()
        if opt_state:
            opt = self.dtoid.optimizer
            for name, p in self.dtoid.net.named_parameters():
                if name in opt_state:
                    opt.state[p] = {k: (v.detach().clone().to(self.device) if isinstance(v, torch.Tensor) else v)
                                    for k, v in opt_state[name].items()}

    # ------------------------------------------------------- detect, score
    def judge_target(self, rec: dict) -> dict:
        from benchmark.reference.world import depth_crop_window, region_mask, templates

        obj, scene, im = rec["ids"]
        row, fr = rec["row"], self.frame(rec["ids"])
        limg, lmask = templates(self.grid, obj, int(self.config["dataset"]["n_local_test"]))
        det = self.dtoid.forward_test_time({"img": fr["img"], "obj_id": obj, "limg": limg, "lmask": lmask})
        out = {}
        s_p = np.asarray(row["dtoid_score"])
        tids = rec["template_ids"]
        if tids is not None:
            out["det_pairs"] = _matched_score_gaps(np.asarray(row["dtoid_bbox"]), s_p, tids, det)

        hyp = rec["hypotheses"]
        pts, cols, nrms = self.clouds[obj]
        h, w = fr["depth"].shape
        mask = region_mask(np.asarray(row["dtoid_bbox"]), s_p, fr["depth"], (h, w))
        y0, x0, sh, sw = depth_crop_window(mask, (h, w), int(self.config["scorer"]["depth_crop"]))
        crop = fr["depth_mm"][y0:y0 + sh, x0:x0 + sw].astype(np.int32)
        data = {"img": torch.from_numpy(fr["img"]).to(self.device), "depth": torch.from_numpy(crop).to(self.device),
                "depth_origin": np.asarray([y0, x0], np.int32), "cam_K": fr["cam_K"], "model_points": pts,
                "model_colors": cols, "model_normals": nrms, "pose_hypos": hyp}
        ref = self.zephyr.score_hypotheses(data, obj_id=obj)
        p = np.asarray(row["hypo_scores"], np.float64)
        r = np.asarray(ref["scores"], np.float64)
        fin_p, fin_r = np.isfinite(p), np.isfinite(r)
        scale = max(float(np.abs(r[fin_r]).max()) if fin_r.any() else 0.0, 1e-6)
        if len(p) != len(r) or (fin_p != fin_r).any():
            out["score_gap"] = 1.0
        else:
            out["score_gap"] = float(np.abs(p[fin_p] - r[fin_r]).max() / scale) if fin_p.any() else 0.0
        pick = int(np.argmax(p))
        refined = ref.get("refined")
        want = refined[pick] if refined is not None and pick < len(refined) else hyp[pick]
        got = np.asarray(row["pred_pose"], np.float64)
        out["pose_mm"] = float(np.linalg.norm(got[:3, 3] - want[:3, 3]) * 1000.0)
        # the angle between the rotations, 2 asin(|R1 - R2|_F / sqrt(8)): no
        # arccos near 1, which turns round-off into hundredths of a degree
        chord = np.linalg.norm(got[:3, :3] - np.asarray(want[:3, :3], np.float64)) / np.sqrt(8.0)
        out["pose_deg"] = float(np.degrees(2.0 * np.arcsin(min(chord, 1.0))))
        return out

    # ------------------------------------------------------------ finetune
    def _feed(self, keys: list, annot) -> dict:
        frames, bits, anns = [], [], []
        for k in keys:
            fr = self.frame(k)
            frames.append(torch.from_numpy(fr["img"][None]).to(self.device))
            bits.append(np.packbits(fr["mask_visib"].reshape(-1), bitorder="little")[None])
            anns.append(annot.sample(k[0], fr["mat_gt"], fr["mask_visib"]))
        feed = {"img_u8": torch.cat(frames, 0), "mask_bits": np.concatenate(bits, 0)}
        for f in ("limg_u8", "lmask_u8", "gimg_u8", "gmask_u8", "bbox_gt", "heatmap"):
            feed[f] = np.stack([a[f] for a in anns])
        return feed

    def _annotator(self):
        from benchmark.reference.world import Annotator

        d = self.config["dataset"]
        return Annotator(self.grid, d["heatmap_shorter_length"] / float(d["shorter_length"]), d["heatmap_var"],
                         int(d["train_local_template_sample_from"]))

    def follow(self, n_keys: int, before: list, steps: int, capture: bool = False) -> dict:
        """The first `steps` steps of the finetune event over the first
        `n_keys` admitted targets, after the events over `before` buffers
        (whose template draws are made and not followed)."""
        from benchmark.reference.world import event_batches

        bs = int(self.config["loop"]["finetune_batch_size"])
        annot = self._annotator()
        for n in before:
            annot.skip(len(event_batches(n, bs)) * bs)
        keys = self.targets[:n_keys]
        names = [n for n, _ in self.dtoid.net.named_parameters()]
        params = [p for _, p in self.dtoid.net.named_parameters()]
        out = {"losses": []}
        for i, sel in enumerate(event_batches(n_keys, bs)[:steps]):
            out["losses"].append(float(self.dtoid.train_step_u8(self._feed([keys[j] for j in sel], annot))["loss"]))
            if capture and i == 0:
                opt = self.dtoid.optimizer
                out["mu1"] = {n: opt.state[p]["mu"].detach().clone() for n, p in zip(names, params)}
                out["b1"] = opt.param_groups[0]["b1"]
        if capture:
            out["params_n"] = {n: p.detach().clone() for n, p in zip(names, params)}
        return out


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-12)


def expected_schedule(config: dict, traffic: dict) -> tuple:
    """(train steps, finetune events) of one pass, as its traffic fixes
    them: every pass target is admitted (the oracle gate), and each pass
    starts from the snapshot's buffer of `prefix_targets`."""
    from benchmark.reference.world import event_batches

    lp = config["loop"]
    if not lp["finetune"]:
        return 0, 0
    if not traffic.get("restore_each_pass") or lp.get("non_cum"):
        raise ValueError("a pass's schedule is fixed only for cumulative buffers restored before each pass")
    interval, bs = int(lp["finetune_interval"]), int(lp["finetune_batch_size"])
    p0, n = int(traffic["prefix_targets"]), int(traffic["pass_targets"])
    events = range((p0 // interval + 1) * interval, p0 + n + 1, interval)
    return sum(int(lp["finetune_epochs"]) * len(event_batches(b, bs)) for b in events), len(events)


def _first_gradient(mu1: dict, mu0: dict, b1: float) -> dict:
    """The first step's gradient as the optimizer got it, from its first
    moments before (`mu0`; none: zero) and after that step."""
    return {k: (v - b1 * mu0[k].to(v.device) if k in mu0 else v) / (1.0 - b1) for k, v in mu1.items()}


def _moving_leaves(g_ref: dict) -> list:
    """The leaves whose reference gradient is at least ZERO_LEAF of the
    median leaf's: the others move by round-off alone."""
    norms = {k: float(v.double().norm()) for k, v in g_ref.items()}
    med = float(np.median(list(norms.values())))
    return [k for k in g_ref if norms[k] >= ZERO_LEAF * med]


def judge(config: dict, traffic: dict, world: dict, device: torch.device, seed: int, records: list,
          passes: list, init: dict, setup_capture: dict | None, snapshot: dict | None) -> tuple:
    """(the numbers compared, by name, each the worst over what it covers;
    what the check covered)."""
    ref = Reference(config, world, device)
    ref.zephyr.load_state_dict({k: v.to(device) for k, v in init["zephyr"].items()})
    for oid, (pts, cols, nrms) in ref.clouds.items():
        ref.zephyr.prepare_object(oid, pts, cols, nrms)
    numbers: dict = {}

    def worst(name, value):
        if value is not None:
            numbers[name] = max(numbers.get(name, 0.0), float(value))

    steps_due, events_due = expected_schedule(config, traffic)
    if passes:
        numbers["schedule_steps"] = float(max(abs(p["steps"] - steps_due) for p in passes))
        numbers["schedule_events"] = float(max(abs(p["events"] - events_due) for p in passes))
    info = {"schedule_due": [steps_due, events_due], "schedule": [[p["steps"], p["events"]] for p in passes]}

    # the targets the check may take: a pose path, and a detection on
    # weights the reference has (the seed's, or the snapshot's)
    wv_ok = {p["weights_version"] for p in passes}
    eligible = [r for r in records if r["hypotheses"] is not None
                and (not config["loop"]["finetune"] or r["weights_version"] in wv_ok)]
    info["eligible_targets"] = len(eligible)
    rng = np.random.default_rng([seed % (2**32), seed // (2**32), 18])
    n = min(int(traffic.get("check_targets", 8)), len(eligible))
    pick = set(rng.choice(len(eligible), n, replace=False).tolist()) if n else set()
    if eligible:
        pick.add(int(np.argmax([len(r["hypotheses"]) for r in eligible])))
    ref.load_dtoid(snapshot["net"] if snapshot is not None else init["dtoid"])
    info["checked_targets"] = [list(eligible[i]["ids"]) for i in sorted(pick)]
    pairs = []
    for i in sorted(pick):
        for k, v in ref.judge_target(eligible[i]).items():
            if k == "det_pairs":
                pairs.append(v)
            else:
                worst(k, v)
    if pairs:
        gaps = np.abs(np.concatenate([g for g, _ in pairs]))
        looked = sum(n for _, n in pairs)
        info["det_pairs"] = [int(len(gaps)), int(looked)]
        if looked:
            numbers["det_unpaired"] = 1.0 - len(gaps) / looked
        if len(gaps):
            info["det_gap_max"] = float(gaps.max())
            numbers["det_p90"] = float(np.percentile(gaps, 90))

    if config["loop"]["finetune"] and setup_capture is not None:
        interval = int(config["loop"]["finetune_interval"])
        steps = len(setup_capture["losses"])
        ref.load_dtoid(init["dtoid"])
        r = ref.follow(interval, [], steps, capture=True)
        info["setup_losses"] = [setup_capture["losses"], r["losses"]]
        g_p = _first_gradient(setup_capture["mu1"], {}, setup_capture["b1"])
        g_r = _first_gradient(r["mu1"], {}, r["b1"])
        keep = _moving_leaves(g_r)
        numbers["grad_gap"] = _median_leaf_gap(g_p, g_r, keep)
        d_p = {k: setup_capture["params_n"][k] - init["dtoid"][k] for k in keep}
        d_r = {k: r["params_n"][k] - init["dtoid"][k].to(device) for k in keep}
        numbers["update_gap"], *info["update_worst_leaf"] = _leaf_gap(d_p, d_r, keep)
        info["left_out_leaves"] = sorted(set(g_r) - set(keep))

    if (config["loop"]["finetune"] and snapshot is not None and passes and passes[-1]["finetune_logs"]
            and passes[-1]["finetune_logs"][0][0]):
        last = passes[-1]
        prefix = int(traffic["prefix_targets"])
        interval = int(config["loop"]["finetune_interval"])
        first = last["finetune_logs"][0][0]
        steps = min(3, len(first))
        ref.load_dtoid(snapshot["net"], snapshot["opt_by_name"])
        r = ref.follow(prefix + interval, list(range(interval, prefix + 1, interval)), steps, capture=True)
        numbers["window_loss_gap"] = max(_rel(first[i]["train_loss"], r["losses"][i]) for i in range(steps))
        info["window_losses"] = [[first[i]["train_loss"] for i in range(steps)], r["losses"]]
        keep = _moving_leaves(_first_gradient(r["mu1"], {k: v["mu"] for k, v in snapshot["opt_by_name"].items()},
                                              r["b1"]))
        if last.get("params_k") is None or last["k"] != steps:
            # the pass's weights were not read after the steps followed
            numbers["window_update_gap"] = 1.0
        else:
            d_p = {k: last["params_k"][k] - snapshot["net"][k] for k in keep}
            d_r = {k: r["params_n"][k] - snapshot["net"][k].to(device) for k in keep}
            # the median leaf: the worst leaf here is a small bias of the
            # template encoders whose gap swings from seed to seed
            numbers["window_update_gap"] = _median_leaf_gap(d_p, d_r, keep)
            info["window_update_worst_leaf"] = list(_leaf_gap(d_p, d_r, keep))
    return numbers, info
