"""The OSSID online self-supervised learning loop on the card (the port of
ossid_code_tpu/loop/online_learning.py, on its synchronous path).

Each frame, in order: DTOID detection over all templates -> confidence gate
(0.5) -> region mask -> host PPF (or fake) hypotheses in the region, after
SIFT hypotheses with `use_sift_hypos` -> Zephyr scoring by the object's
scorer (one, or two by object-id parity as on YCB-V), with device ICP of the
top hypotheses (`refine_top`) ->
with `use_icp`, host ICP of the picked pose (hypo/icp.py) -> render of the
picked pose -> visible pseudo-mask -> Zephyr gate (20) ->
the frame joins the finetune buffer, and every `finetune_interval` buffered
frames DTOID is finetuned from the device replay buffer (loop/replay.py).

The frame's uint8 image is uploaded to the card once and shared by
detection, scoring and the replay buffer. Every frame completes before the
next one starts, which is the JAX loop's `pipeline_scoring=False` path with
inline fetches and one frame per fetch; the speculative detection, fetch
threads, fetch bundling and the YUV transport of the JAX loop served its
remote TPU link and are not ported. Result rows keep the JAX loop's schema.
`test_dtoid_model` is the detection-only pass (`--raw_dtoid`).
"""

from __future__ import annotations

import os
import pickle
import time

import numpy as np
import torch

from ossid_code_torch.core.checkpoint import save_checkpoint
from ossid_code_torch.data.dtoid_bop import NumpyLoader
from ossid_code_torch.hypo.icp import icp_refinement
from ossid_code_torch.loop.replay import DeviceReplayBuffer
from ossid_code_torch.eval.pose_metrics import (
    add_err, adi_err, object_diameter, pp_err_batch_async, pp_err_fetch,
)
from ossid_code_torch.ops.sift import SiftError
from ossid_code_torch.render.mesh import load_ply
from ossid_code_torch.render.rasterizer import Renderer
from ossid_code_torch.render.visib import estimate_visib_mask_gt
from ossid_code_torch.utils.geometry import K2meta, depth2cloud, expand_box, shift_model_points
from ossid_code_torch.utils.image import resize_linear
from ossid_code_torch.utils.timing import Timer

DTOID_CONFIDENT_THRESHOLD = 0.5  # ref online_learning.py:84
ZEPHYR_CONFIDENT_THRESHOLD = 20  # ref online_learning.py:85

# options of the JAX loop that the port does not take, with the ROADMAP.md
# item that ports them
_NOT_PORTED = {
    "use_maskrcnn": "item 8, the MaskRCNN alternative detector",
    "yuv_transfer": "item 6, the pipelined transport",
}
# identity poses that stand in for SIFT's when SIFT fails on a frame
SIFT_FALLBACK_POSES = 20


def refuse_unported(args) -> None:
    """Raise for an option that the port does not take, naming its item."""
    for flag, item in _NOT_PORTED.items():
        if getattr(args, flag, False):
            raise NotImplementedError(f"--{flag} is not ported: ROADMAP.md §1, {item}")


def model_cloud_from_ply(mesh, n_points: int = 2048, seed: int = 0):
    """Sample a colored, normal-equipped model cloud (meters) from a BOP mesh
    (mm), replacing the reference's precomputed model_cloud_{:02d}.npz files
    (ref online_learning.py:303-311) when they are absent."""
    rng = np.random.default_rng(seed)
    v = mesh.vertices / 1000.0
    faces = mesh.faces
    # sample on faces proportionally to area
    a, b, c = v[faces[:, 0]], v[faces[:, 1]], v[faces[:, 2]]
    areas = 0.5 * np.linalg.norm(np.cross(b - a, c - a), axis=1)
    probs = areas / areas.sum()
    fidx = rng.choice(len(faces), n_points, p=probs)
    r1, r2 = rng.random((2, n_points))
    s1 = np.sqrt(r1)
    w0, w1, w2 = 1 - s1, s1 * (1 - r2), s1 * r2
    pts = w0[:, None] * v[faces[fidx, 0]] + w1[:, None] * v[faces[fidx, 1]] + w2[:, None] * v[faces[fidx, 2]]
    fn = np.cross(b - a, c - a)
    fn /= np.clip(np.linalg.norm(fn, axis=1, keepdims=True), 1e-12, None)
    # orient normals outward: stored vertex normals win when present (the
    # centroid rule mis-orients concave regions of compound shapes)
    if mesh.normals is not None and len(mesh.normals) == len(v):
        vn = (mesh.normals[faces[:, 0]] + mesh.normals[faces[:, 1]]
              + mesh.normals[faces[:, 2]])
        flip = np.einsum("ij,ij->i", fn, vn) < 0
    else:
        centroid = v.mean(axis=0)
        face_centers = (a + b + c) / 3.0
        flip = np.einsum("ij,ij->i", fn, face_centers - centroid) < 0
    fn[flip] *= -1.0
    normals = fn[fidx]
    if mesh.colors is not None:
        cols = (
            w0[:, None] * mesh.colors[faces[fidx, 0]]
            + w1[:, None] * mesh.colors[faces[fidx, 1]]
            + w2[:, None] * mesh.colors[faces[fidx, 2]]
        )
    else:
        cols = np.full((n_points, 3), 0.5)
    return pts.astype(np.float32), cols.astype(np.float32), normals.astype(np.float32)


class OnlineLearningLoop:
    def __init__(self, args, cfg, dtoid_model, bop_dataset, train_dataset, test_loader,
                 zephyr_results: dict, zephyr_model=None, zephyr_model_even=None,
                 zephyr_model_odd=None, hypo_gens: dict | None = None, sift_gens: dict | None = None,
                 use_icp: bool = False, model_shifts: dict | None = None):
        refuse_unported(args)
        self.args = args
        # host ICP (hypo/icp.py) of the picked pose against the frame's depth
        self.use_icp = bool(use_icp)
        self.cfg = cfg
        self.model = dtoid_model
        # share the test dataset's reader when it reads the same data, so
        # each frame's PNGs are decoded once
        reader = getattr(getattr(test_loader, "dataset", None), "bop_dataset", None)
        if (reader is not None and reader.dataset_root == bop_dataset.dataset_root
                and reader.split == bop_dataset.split):
            bop_dataset = reader
        self.bop_dataset = bop_dataset
        self.train_dataset = train_dataset
        self.test_loader = test_loader
        self.zephyr_results = zephyr_results
        self.zephyr_model = zephyr_model
        # YCB-V: two scorers chosen by object-id parity, each trained with
        # the other half of the objects held out (_zephyr_for)
        self.zephyr_model_even = zephyr_model_even
        self.zephyr_model_odd = zephyr_model_odd
        self.hypo_gens = hypo_gens or {}
        self.sift_gens = sift_gens or {}

        # model clouds (points m, colors, normals) sampled from the meshes
        model_clouds = {oid: model_cloud_from_ply(load_ply(bop_dataset.getObjPath(oid)))
                        for oid in bop_dataset.obj_ids}
        if model_shifts:
            # per-object model-frame offsets: YCB-V scorer checkpoints expect
            # clouds in the original YCB frame
            model_clouds = {oid: ((shift_model_points(pc[0], model_shifts[oid]), pc[1], pc[2])
                                  if oid in model_shifts else pc)
                            for oid, pc in model_clouds.items()}
        self.model_clouds = model_clouds
        self.diameters = {oid: object_diameter(pc[0]) for oid, pc in model_clouds.items()}
        for zm in {id(m): m for m in (zephyr_model, zephyr_model_even, zephyr_model_odd)
                   if m is not None}.values():
            # per-object model data and grouping indices go to the card once
            for oid, (pts, cols, nrms) in model_clouds.items():
                zm.prepare_object(oid, pts, cols, nrms)

        self.initial_state_dict = dtoid_model.state_dict()
        self.renderers: dict = {}
        self._pp_pts_dev: dict = {}
        self.next_finetune_number = args.finetune_interval
        self.finetune_logs: list = []
        self.replay = DeviceReplayBuffer()

    # ------------------------------------------------------------ stages
    def _dtoid_mask(self, out, depth):
        """Region mask from the detections (ref online_learning.py:381-408)."""
        if self.args.use_dtoid_segmask:
            seg = out["segmentation"]
            if seg.shape != depth.shape:
                seg = resize_linear(seg.astype(np.float32), (depth.shape[1], depth.shape[0]))
            mask = seg > 0.5
            if mask.sum() <= 25:
                mask = np.ones_like(mask)
            return mask
        mask = np.zeros_like(depth, dtype=bool)
        img_h, img_w = depth.shape
        # boxes are in processed-image coordinates; rescale to the raw frame
        ph, pw = self.proc_hw
        sx, sy = img_w / pw, img_h / ph
        depth_pos = depth > 0
        has_depth_mask = False
        for bbox, score in zip(out["final_bbox"][0], out["final_score"][0]):
            # scores are sorted descending: once below threshold with a
            # non-empty mask, every later box is skipped too (ref :393-405)
            if score < 0.5 and has_depth_mask:
                break
            x1, y1, x2, y2 = bbox
            x1, y1, x2, y2 = expand_box(x1 * sx, y1 * sy, x2 * sx, y2 * sy, img_h, img_w, 1.2)
            region = np.s_[int(y1):int(y2), int(x1):int(x2)]
            mask[region] = True
            if not has_depth_mask:
                has_depth_mask = bool(depth_pos[region].any())
        return mask

    def _generate_hypotheses(self, obj_id, img, depth, dist_mask, cam_K, scene_meta, times):
        """Hypothesis generation (ref online_learning.py:410-449): PPF or
        fake on the host; with `use_sift_hypos`, SIFT's poses go first (its
        keypoints on the image's device). When SIFT itself fails, 20
        identity poses stand in and `time_sift` is None."""
        scene_pc = depth2cloud(depth, np.logical_and(dist_mask, depth > 0), cam_K)
        with Timer() as t:
            poses, _, gen_time = self.hypo_gens[obj_id].find_surface_model(scene_pc)
        times["time_ppf"] = gen_time if gen_time else t.interval
        if not (getattr(self.args, "use_sift_hypos", False) and obj_id in self.sift_gens):
            times["time_sift"] = 0
            return poses
        with Timer() as t:
            try:
                poses_sift = self.sift_gens[obj_id].match(img, depth, dist_mask, scene_meta)
            except SiftError:
                poses_sift = None
        if poses_sift is None:
            poses_sift = np.stack([np.eye(4)] * SIFT_FALLBACK_POSES)
            times["time_sift"] = None
        else:
            times["time_sift"] = t.interval
        return np.concatenate([poses_sift, poses], axis=0)

    def _zephyr_for(self, obj_id):
        """The object's scorer: the parity-selected one of a pair (YCB-V,
        ref online_learning.py:461-464), else the single scorer."""
        if self.zephyr_model_even is not None or self.zephyr_model_odd is not None:
            zm = self.zephyr_model_even if obj_id % 2 == 0 else self.zephyr_model_odd
            if zm is not None:
                return zm
        return self.zephyr_model

    def _depth_crop_window(self, dist_mask, img_hw):
        """Fixed-size square window centred on the detection mask (clamped to
        the image): scoring samples depth only around the object."""
        s = int(self.args.zephyr_depth_crop)
        h, w = img_hw
        ys, xs = np.nonzero(dist_mask)
        if len(ys):
            cy, cx = int(ys.mean()), int(xs.mean())
        else:
            cy, cx = h // 2, w // 2
        y0 = int(np.clip(cy - s // 2, 0, max(h - s, 0)))
        x0 = int(np.clip(cx - s // 2, 0, max(w - s, 0)))
        return y0, x0, min(s, h), min(s, w)

    def _pp_pts(self, obj_id):
        """Device model clouds (full, query-subsampled) for pp_err."""
        if obj_id not in self._pp_pts_dev:
            pts = self.model_clouds[obj_id][0]
            pts_q = pts[np.linspace(0, len(pts) - 1, 1000).round().astype(int)] if len(pts) > 1000 else pts
            dev = self.model.device
            self._pp_pts_dev[obj_id] = (torch.as_tensor(pts, device=dev),
                                        torch.as_tensor(pts_q, device=dev))
        return self._pp_pts_dev[obj_id]

    def _render_pred(self, obj_id, cam_K, pred_pose, img_hw):
        if obj_id not in self.renderers:
            r = Renderer(K2meta(cam_K), img_h=img_hw[0], img_w=img_hw[1])
            r.addObject(obj_id, self.bop_dataset.getObjPath(obj_id), pose=pred_pose,
                        mm2m=True, simplify=self.args.fast)
            self.renderers[obj_id] = r
        r = self.renderers[obj_id]
        r.obj_nodes[obj_id].matrix = pred_pose
        _, pred_depth = r.render(depth_only=True)
        return pred_depth

    def _det_batch(self, batch, bop_data):
        """Detection input. When the processed image has the raw resolution,
        the raw uint8 frame goes to the card once and is shared with scoring
        and the replay buffer."""
        raw = bop_data["img"]
        ph, pw = batch["img"].shape[1:3]
        frame_dev = None
        if raw.shape[:2] == (ph, pw) and raw.dtype == np.uint8:
            frame_dev = torch.from_numpy(np.ascontiguousarray(raw[None])).to(self.model.device)
        return {
            "img": frame_dev if frame_dev is not None else batch["img"][0],
            "obj_id": int(batch["obj_id"][0]),
            "limg": batch["limg"][0],
            "lmask": batch["lmask"][0],
            "mask": batch["mask"][0],
            "_frame_dev": frame_dev,
        }

    # -------------------------------------------------------------- run
    def run(self, progress: bool = True) -> list:
        args = self.args
        test_results = []
        for iteration, batch in enumerate(self.test_loader):
            t_iter0 = time.perf_counter()
            obj_id = int(batch["obj_id"][0])
            scene_id = int(batch["scene_id"][0])
            im_id = int(batch["im_id"][0])

            with Timer() as t_data:
                bop_data = self.bop_dataset.getDataByIds(obj_id, scene_id, im_id)
            depth = bop_data["depth"]
            mat_gt = bop_data["mat_gt"]
            cam_K = np.asarray(bop_data["scene_camera"]["cam_K"])
            is_sym = obj_id in self.bop_dataset.sym_obj_ids
            err_func = add_err if args.fast else (adi_err if is_sym else add_err)
            self.proc_hw = batch["img"].shape[1:3]
            times = {"time_ppf": None, "time_sift": None, "time_zephyr": None,
                     "time_icp": None, "time_finetune": 0,
                     "time_data": t_data.interval, "time_mask": 0.0,
                     "time_pperr": 0.0, "time_label": 0.0, "time_iter": 0.0,
                     "time_det_miss": 0.0, "time_det_spec": 0.0, "time_det_fetch": 0.0}

            # ---- DTOID detection ------------------------------------------
            with Timer() as t:
                det_batch = self._det_batch(batch, bop_data)
                out_dev = self.model.detect_async(det_batch)
                times["time_det_miss"] = time.perf_counter() - t.start
                out = self.model.fetch_detections(out_dev, det_batch)
            times["time_det_fetch"] = t.interval - times["time_det_miss"]
            final_score = out["final_score"][0]
            dtoid_confident = bool(final_score[0] > DTOID_CONFIDENT_THRESHOLD)
            if args.ignore_dtoid_mask:
                use_dtoid_mask = False
            elif args.always_dtoid_mask:
                use_dtoid_mask = True
            else:
                use_dtoid_mask = dtoid_confident
            if iteration < args.finetune_warmup:
                use_dtoid_mask = False

            ctx = {
                "iteration": iteration, "obj_id": obj_id, "scene_id": scene_id, "im_id": im_id,
                "depth": depth, "mat_gt": mat_gt, "cam_K": cam_K,
                "model_points": self.model_clouds[obj_id][0], "err_func": err_func,
                "mask_gt": bop_data["mask_gt"], "mask_gt_visib": bop_data["mask_gt_visib"],
                "times": times, "time_dtoid": t.interval,
                "final_bbox": out["final_bbox"][0], "final_score": final_score,
                "dtoid_iou": out.get("seg_IoU", 0.0), "dtoid_pred_mask": out["segmentation"],
                "dtoid_confident": dtoid_confident, "use_dtoid_mask": use_dtoid_mask,
                "zout": None, "zr": self.zephyr_results.get((obj_id, scene_id, im_id)),
                "pp_err": None, "n_hypos": 0, "img_dev": det_batch["_frame_dev"],
            }
            if not use_dtoid_mask:
                if ctx["zr"] is None:
                    raise RuntimeError(f"no precomputed zephyr result for {(obj_id, scene_id, im_id)}")
            else:
                self._pose_estimate(ctx, bop_data, det_batch, out)
            times["time_iter"] = time.perf_counter() - t_iter0
            self._complete_frame(ctx, test_results, progress)
        return test_results

    def _pose_estimate(self, ctx, bop_data, det_batch, out):
        """Region mask -> hypotheses -> scoring with device ICP, and the
        per-hypothesis pp_err beside it. Fills ctx['zout'] unless hypothesis
        generation found nothing."""
        args, times, obj_id = self.args, ctx["times"], ctx["obj_id"]
        depth, cam_K = ctx["depth"], ctx["cam_K"]
        with Timer() as t_mask:
            dist_mask = self._dtoid_mask(out, depth)
        times["time_mask"] = t_mask.interval
        depth_u16 = (depth * 1000.0).round().clip(0, 65535).astype(np.uint16)
        depth_origin = None
        if int(getattr(args, "zephyr_depth_crop", 0) or 0):
            y0, x0, sh, sw = self._depth_crop_window(dist_mask, depth.shape)
            depth_u16 = np.ascontiguousarray(depth_u16[y0:y0 + sh, x0:x0 + sw])
            depth_origin = np.asarray([y0, x0], np.int32)
        frame = det_batch["_frame_dev"]
        poses = self._generate_hypotheses(obj_id, frame[0] if frame is not None else bop_data["img"], depth,
                                          dist_mask, cam_K, bop_data["scene_meta"], times)
        if len(poses) == 0:
            # no hypotheses: fall back to the precomputed result, else an
            # unconfident identity (ref online_learning.py:367-378)
            return
        pts, cols, nrms = self.model_clouds[obj_id]
        zephyr = self._zephyr_for(obj_id)
        data = {"img": frame[0] if frame is not None else bop_data["img"], "depth": depth_u16,
                "cam_K": cam_K, "model_points": pts, "model_colors": cols,
                "model_normals": nrms, "pose_hypos": poses}
        if depth_origin is not None:
            data["depth_origin"] = depth_origin
        with Timer() as t:
            zhandle = zephyr.score_hypotheses_async(data, obj_id=obj_id)
            with Timer() as t_pp:
                pts_dev, pts_q_dev = self._pp_pts(obj_id)
                pp = pp_err_batch_async(poses, ctx["mat_gt"], pts_dev,
                                        symmetric=ctx["err_func"] is adi_err, pts_q_dev=pts_q_dev)
            ctx["zout"] = zephyr.fetch_scores(zhandle)
            ctx["pp_err"] = pp_err_fetch(pp)
        times["time_pperr"] = t_pp.interval
        times["time_zephyr"] = t.interval - t_pp.interval
        ctx["n_hypos"] = len(poses)
        if self.use_icp:
            with Timer() as t:
                # crop box from the model points projected on the host under
                # the picked pose (the device uv map's row for the pick)
                pose = ctx["zout"]["pred_pose"]
                cam = pts @ pose[:3, :3].T + pose[:3, 3]
                z = np.clip(cam[:, 2], 1e-6, None)
                uv = np.stack([cam_K[0, 0] * cam[:, 0] / z + cam_K[0, 2],
                               cam_K[1, 1] * cam[:, 1] / z + cam_K[1, 2]], axis=1).round().astype(int)
                ctx["zout"]["pred_pose"], _ = icp_refinement(depth, uv, pose, cam_K, pts, icp_max_dist=0.01)
            times["time_icp"] = t.interval

    def _complete_frame(self, ctx, test_results, progress):
        """Pseudo-label render, self-supervision gate, finetune and the result
        row of one frame (ref online_learning.py:470-589)."""
        t_complete0 = time.perf_counter()
        args = self.args
        obj_id, scene_id, im_id = ctx["obj_id"], ctx["scene_id"], ctx["im_id"]
        depth, mat_gt, cam_K = ctx["depth"], ctx["mat_gt"], ctx["cam_K"]
        times, iteration = ctx["times"], ctx["iteration"]
        zout, hypo_scores = ctx["zout"], None
        if zout is None:
            zr = ctx["zr"]
            if zr is None:
                # no hypotheses and no precomputed result: the Zephyr gate
                # never opens for this frame
                pred_pose, pred_score = np.eye(4), float("-inf")
            else:
                pred_pose, pred_score = np.asarray(zr["pred_pose"]), zr["score"]
        else:
            pred_pose, pred_score = zout["pred_pose"], zout["pred_score"]
            hypo_scores = zout["scores"]

        pred_err = ctx["err_func"](pred_pose[:3, :3], pred_pose[:3, 3], mat_gt[:3, :3],
                                   mat_gt[:3, 3], ctx["model_points"])

        # ---- pseudo-label mask ----------------------------------------
        with Timer() as t_label:
            pred_depth = self._render_pred(obj_id, cam_K, pred_pose, depth.shape)
            pred_mask = pred_depth > 0
            gt_mask = np.asarray(ctx["mask_gt"]) > 0
            gt_mask_visib = np.asarray(ctx["mask_gt_visib"]) > 0
            pred_mask_visib = estimate_visib_mask_gt(depth, pred_depth, 15 / 1000.0)
        times["time_label"] = t_label.interval

        # ---- self-supervision gate + finetune -------------------------
        z_th = getattr(args, "zephyr_confident_threshold", ZEPHYR_CONFIDENT_THRESHOLD)
        zephyr_confident = True if args.use_oracle_gt else pred_score > z_th
        finetune = False
        if not args.no_finetune and zephyr_confident:
            self.train_dataset.addTarget(obj_id, scene_id, im_id)
            label_mask = gt_mask_visib if args.use_oracle_gt else pred_mask_visib
            self.train_dataset.updateZephyrMask(obj_id, scene_id, im_id, label_mask, pred_score)
            self.replay.add((obj_id, scene_id, im_id), ctx["img_dev"], label_mask, mat_gt)
            if len(self.train_dataset) == self.next_finetune_number:
                finetune = True
                if args.finetune_reset:
                    self.model.load_state_dict(self.initial_state_dict)
                    self.model.reset_optimizer()
                with Timer() as t:
                    logs = finetune_dtoid(self.model, self.train_dataset,
                                          epochs=args.finetune_epochs,
                                          batch_size=args.finetune_batch_size, replay=self.replay)
                times["time_finetune"] = t.interval
                self.finetune_logs.append(logs)
                if args.save_each:
                    self._save_each_ckpt(iteration)
                if args.non_cum:
                    self.train_dataset.clearTargets()
                    self.next_finetune_number = args.finetune_interval
                else:
                    self.next_finetune_number += args.finetune_interval

        iou = np.logical_and(pred_mask, gt_mask).sum() / max(np.logical_or(pred_mask, gt_mask).sum(), 1)
        iou_visib = np.logical_and(pred_mask_visib, gt_mask_visib).sum() / max(
            np.logical_or(pred_mask_visib, gt_mask_visib).sum(), 1)
        result = {
            "obj_id": obj_id, "scene_id": scene_id, "im_id": im_id,
            "dtoid_confident": ctx["dtoid_confident"],
            "zephyr_confident": bool(zephyr_confident),
            "use_dtoid_mask": bool(ctx["use_dtoid_mask"]),
            "finetune": finetune,
            "dtoid_iou": float(ctx["dtoid_iou"]),
            "dtoid_pred_mask": ctx["dtoid_pred_mask"],
            "dtoid_bbox": ctx["final_bbox"],
            "dtoid_score": ctx["final_score"],
            "pred_pose": pred_pose,
            "pred_score": float(pred_score),
            "pred_err": float(pred_err),
            "pred_add01d": float(pred_err < 0.1 * self.diameters[obj_id]),
            "pred_mask": pred_mask,
            "pred_mask_visib": pred_mask_visib,
            "pred_iou": float(iou),
            "pred_iou_visib": float(iou_visib),
            "n_hypos": int(ctx["n_hypos"]),
            "pp_err": ctx["pp_err"],
            "hypo_scores": hypo_scores,
            "time_dtoid": ctx["time_dtoid"],
            **times,
        }
        result["time_complete"] = time.perf_counter() - t_complete0
        test_results.append(result)
        if progress and iteration % 10 == 0:
            print(f"[{iteration + 1}/{len(self.test_loader)}] obj {obj_id} "
                  f"score {pred_score:.2f} add01d {result['pred_add01d']:.0f} "
                  f"dtoid {ctx['time_dtoid'] * 1000:.0f}ms", flush=True)

    def _save_each_ckpt(self, iteration: int) -> None:
        """--save_each: the weights right after each finetune, as
        <save_root>/<exp_name>/epoch_<iteration>.ckpt (ref
        online_learning.py:535-546), a torch file with the iteration and the
        configuration beside the state_dict, under `args.save_root`."""
        root = getattr(self.args, "save_root", None)
        if not root:
            raise ValueError("--save_each needs args.save_root")
        folder = os.path.join(root, self.args.exp_name)
        os.makedirs(folder, exist_ok=True)
        save_checkpoint(os.path.join(folder, f"epoch_{iteration}.ckpt"), self.model.state_dict(),
                        extra={"iteration": iteration, "conf": self.cfg.to_dict()})

    def save_results(self, path: str, test_results: list) -> None:
        """The JAX CLI's results pickle: rows, arguments, finetune logs and
        the final DTOID weights (numpy, under the port's key names)."""
        with open(path, "wb") as f:
            pickle.dump({
                "test_results": test_results,
                "main_args": vars(self.args),
                "finetune_logs": self.finetune_logs,
                "final_state_dict": {k: v.cpu().numpy() for k, v in self.model.state_dict().items()},
            }, f)


def _collect_loss_logs(loss_per_epoch: list) -> list:
    """[[loss tensor, ...], ...] -> reference-schema logs, fetched from the
    device in one copy."""
    flat = [l for ep in loss_per_epoch for l in ep]
    if flat:
        flat = torch.stack(flat).cpu().tolist()
    it = iter(flat)
    return [[{"train_loss": next(it)} for _ in ep] for ep in loss_per_epoch]


def _finetune_replay(model, train_dataset, replay, epochs: int, batch_size: int):
    """Device-feed finetune pass: frames come from the detection-time uploads
    held by the replay buffer (uint8 + bit-packed pseudo-masks); only
    templates, heat maps and boxes ship from the host. Returns None when the
    buffer cannot serve the pass (an uncovered target, a resolution mismatch,
    a non-u8 frame), and the caller runs the host-loader pass."""
    targets = train_dataset.bop_dataset.targets
    if not replay.covers(targets):
        return None
    img_h, img_w = model.img_size
    keys = [(int(t["obj_id"]), int(t["scene_id"]), int(t["im_id"])) for t in targets]
    if any(replay.bits(k).shape[1] * 8 != img_h * img_w for k in keys):
        return None  # pseudo-labels not at the model's native resolution

    # host frames for buffer misses, checked before any step runs so that a
    # fallback never trains twice
    host_frames: dict = {}
    for k in keys:
        if replay.frame(k) is None:
            raw = np.asarray(train_dataset.bop_dataset.getDataByIds(*k)["img"])
            if raw.shape[:2] != (img_h, img_w) or raw.dtype != np.uint8:
                return None
            host_frames[k] = torch.from_numpy(raw[None]).to(model.device)

    rng = np.random.default_rng(len(keys))
    loss_per_epoch = []
    for _ in range(epochs):
        order = rng.permutation(len(keys))
        epoch_losses = []
        for i0 in range(0, len(order), batch_size):
            sel = order[i0:i0 + batch_size]
            if len(sel) < batch_size:  # pad by repetition to the batch size
                sel = np.resize(sel, batch_size)
            bkeys = [keys[j] for j in sel]
            frames = [replay.frame(k) if replay.frame(k) is not None else host_frames[k]
                      for k in bkeys]
            feed = {"img_u8": torch.cat(frames, 0),
                    "mask_bits": np.concatenate([replay.bits(k) for k in bkeys], axis=0)}
            anns = [train_dataset.replay_annotations(
                        k[0], replay.mat_gt(k), train_dataset.zephyr_results[k]["pred_mask_visib"])
                    for k in bkeys]
            for f in ("limg_u8", "lmask_u8", "gimg_u8", "gmask_u8", "bbox_gt", "heatmap"):
                feed[f] = np.stack([a[f] for a in anns])
            epoch_losses.append(model.train_step_u8(feed)["loss"])
        loss_per_epoch.append(epoch_losses)
    model.clear_cache()  # template features are stale after weight updates
    replay.n_replay_events += 1
    return _collect_loss_logs(loss_per_epoch)


def finetune_dtoid(model, train_dataset, epochs: int = 1, batch_size: int = 8, replay=None) -> list:
    """Online finetuning pass (ref online_learning.py:650-679): one train
    step per batch of the pseudo-labelled buffer, padded to `batch_size`;
    from the replay buffer when it covers the buffer, else from the host
    loader. Returns the per-step losses, fetched once at the end."""
    if replay is not None:
        logs = _finetune_replay(model, train_dataset, replay, epochs, batch_size)
        if logs is not None:
            return logs
    loader = NumpyLoader(train_dataset, batch_size=batch_size, shuffle=True,
                         seed=len(train_dataset), prefetch=2)
    loss_per_epoch = []
    for _ in range(epochs):
        epoch_losses = []
        for batch in loader:
            b = len(batch["img"])
            if b < batch_size:  # pad by repetition to the batch size
                idx = np.resize(np.arange(b), batch_size)
                batch = {k: v[idx] if isinstance(v, np.ndarray) and len(v) == b else v
                         for k, v in batch.items()}
            feed = {k: batch[k] for k in ("img", "limg", "lmask", "gimg", "gmask",
                                          "bbox_gt", "heatmap", "mask")}
            epoch_losses.append(model.train_step(feed)["loss"])
        loss_per_epoch.append(epoch_losses)
    model.clear_cache()
    return _collect_loss_logs(loss_per_epoch)


def test_dtoid_model(model, test_loader, bop_dataset=None):
    """Detection-only evaluation pass (`--raw_dtoid`, ref
    online_learning.py:620-648): one row per target."""
    test_results = []
    for batch in test_loader:
        obj_id = int(batch["obj_id"][0])
        out = model.forward_test_time({
            "img": batch["img"][0], "obj_id": obj_id, "limg": batch["limg"][0],
            "lmask": batch["lmask"][0], "mask": batch["mask"][0]})
        test_results.append({
            "obj_id": obj_id,
            "scene_id": int(batch["scene_id"][0]),
            "im_id": int(batch["im_id"][0]),
            "dtoid_bbox": out["final_bbox"][0],
            "dtoid_score": out["final_score"][0],
            "dtoid_iou": float(out.get("seg_IoU", 0.0)),
            "dtoid_pred_mask": out["segmentation"],
            "gt_bbox": np.asarray(batch["bbox_gt"][0, 0, :4]),
        })
    return test_results
