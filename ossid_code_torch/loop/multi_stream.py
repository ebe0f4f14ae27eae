"""Multi-camera (N-stream) online serving loop on a device mesh (the port of
ossid_code_tpu/loop/multi_stream.py).

N camera streams watch the same object set from different viewpoints
(different BOP scenes). Each round, the N current frames of one (im_id,
obj_id) are detected by one batched program (`make_farm_detect`): on one
card the trunk runs once on the N frames and the heads once on the N x T
frame-template pairs, with kernel 1 twice a round whatever N is; on a 2-D
(dp = frames, tp = templates) mesh each device correlates its templates
with its frames. Then each stream runs hypothesis generation, device
scoring and pseudo-labelling through the loop's own stages. All streams
share the detector weights and one pseudo-label buffer, so every camera's
confident poses finetune the detector that serves all cameras.

Semantics, as the JAX package's code runs them: a round detects every
stream's frame first, then completes the streams in order, sequentially
(no speculation, no deferred completion). A finetune that stream i
triggers therefore changes the weights that stream i+1 trains on in the
same round and the next round's detection; stream i+1's detection in that
round was made before it. (The JAX module's docstring says the finetune is
visible to stream i+1's detection in the same round; its code, which the
tests hold the port to, detects the round first.)
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ossid_code_torch.eval.pose_metrics import add_err, adi_err, pp_err_batch_async
from ossid_code_torch.loop.online_learning import (
    DTOID_CONFIDENT_THRESHOLD, OnlineLearningLoop, _depth_mm,
)
from ossid_code_torch.models.dtoid.network import imagenet_normalize
from ossid_code_torch.parallel.mesh import dtoid_replicas, make_mesh_2d, split_2d, to_tensor
from ossid_code_torch.utils.timing import Timer


def make_farm_detect(dtoid_model, mesh, axes=("dp", "tp"), topk: int = 500):
    """The whole serving path of F frames of one object (trunk, correlation,
    heads, top-k, NMS, the winning template's segmentation decode) on a
    mesh: frames over `axes[0]`, templates over `axes[1]`. On a one-device
    mesh this is `DtoidNetwork.detect_frames`. On more devices each runs the
    trunk on its row's frames and the heads on its templates; per-frame
    top-k and NMS need all of a frame's templates, so the heads' outputs are
    gathered on the row's first device, which picks and decodes the
    winners. The weights (with `bf16_infer`, the bf16 copy) are the model's
    at each call, so a finetune is seen by the next round without a rebuild.

    Returns fn(images_u8 (F, H, W, 3) uint8, local_feats (T, 7, 7, 640),
    global_feat (1, 3, 3, 64)) -> detect_frames' dict of per-frame outputs
    on the mesh's first device (seg as `seg_u8`)."""
    reps = dtoid_replicas(dtoid_model)
    m = dtoid_model.cfg.model
    kw = dict(pre_nms_topk=int(m.get("topk_pre_nms", 1000)), topk=topk, nms_iou=float(m.nms_iou_thresh))

    @torch.inference_mode()
    def detect(images_u8, local_feats, global_feat):
        dtype = torch.bfloat16 if dtoid_model.bf16_infer else torch.float32
        images_u8, local_feats, global_feat = (to_tensor(a) for a in (images_u8, local_feats, global_feat))
        rows, frame_parts, template_parts = split_2d(mesh, axes, images_u8, local_feats)
        if rows.size == 1:
            d = rows[0, 0]
            return reps.net(d).detect_frames(images_u8.to(d), local_feats.to(d), global_feat.to(d),
                                             dtoid_model.anchors.to(d), compute_dtype=dtype, **kw)
        outs = []
        for r, frames in enumerate(frame_parts):
            if not len(frames):
                continue
            head, f = rows[r, 0], frames.shape[0]
            parts = []
            for d, lf in zip(rows[r], template_parts):
                if not len(lf):
                    continue
                image = imagenet_normalize(frames.to(d).to(dtype) / 255.0)
                heads = reps.net(d).heads_frames(image, lf.to(d).to(dtype), global_feat.to(d).to(dtype))
                # (F_r * T_c, ...) -> (F_r, T_c, ...) on the row's first device
                parts.append([h.to(head).reshape(f, -1, *h.shape[1:]) for h in heads])
            heads = [torch.cat(p, 1).flatten(0, 1) for p in zip(*parts)]
            outs.append(reps.net(head).select_frames(*heads, f, dtoid_model.anchors.to(head), **kw))
        first = rows[0, 0]
        return {k: torch.cat([o[k].to(first) for o in outs], 0) for k in outs[0]}

    return detect


class MultiStreamLoop(OnlineLearningLoop):
    """Drives N streams (= N scenes of one BOP world) with farm detection.

    Construction is OnlineLearningLoop's (the same injected components); the
    test loader must cover every stream's targets. `mesh`: a 2-D mesh from
    parallel/mesh.py::make_mesh_2d; by default one device, the card."""

    def __init__(self, *args, mesh=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.mesh = mesh if mesh is not None else make_mesh_2d(1, 1)
        self._farm = make_farm_detect(self.model, self.mesh)

    def _rounds(self):
        """[((im_id, obj_id), [(scene_id, target index), ...]), ...]: every
        scene's target of one (image, object) in one round."""
        ds = self.test_loader.dataset
        groups: dict = {}
        for idx, t in enumerate(ds.bop_dataset.targets):
            groups.setdefault((t["im_id"], t["obj_id"]), []).append((t["scene_id"], idx))
        return [(key, sorted(v)) for key, v in sorted(groups.items())]

    def run(self, progress: bool = True):
        try:
            return self._run_streams(progress)
        finally:
            self.close()

    def _run_streams(self, progress: bool = True) -> dict:
        """{scene_id: [result row, ...]}, each stream's rows in round order."""
        ds = self.test_loader.dataset
        per_stream: dict = {}
        for iteration, ((im_id, obj_id), members) in enumerate(self._rounds()):
            samples = [ds[idx] for _, idx in members]
            imgs = np.stack([np.asarray(s["img"]) for s in samples])
            if imgs.dtype != np.uint8:
                imgs = (np.clip(imgs, 0, 1) * 255.0).round().astype(np.uint8)
            self.proc_hw = imgs.shape[1:3]
            local, glob = self.model.get_template_features(obj_id, samples[0]["limg"], samples[0]["lmask"])
            with Timer() as t_det:
                outs = {k: v.cpu().numpy() for k, v in self._farm(imgs, local, glob).items()}
            for si, (scene_id, _) in enumerate(members):
                out = {k: v[si] for k, v in outs.items()}
                out["segmentation"] = out.pop("seg_u8").astype(np.float32) / 255.0
                out["final_bbox"] = [out["pred_bbox"]]
                out["final_score"] = [out["pred_scores"]]
                self._one_stream_frame(iteration, obj_id, scene_id, im_id, out,
                                       per_stream.setdefault(scene_id, []), progress,
                                       t_det.interval / len(members))
        self._resolve_finetunes()
        return per_stream

    def _one_stream_frame(self, iteration, obj_id, scene_id, im_id, out, results, progress,
                          time_dtoid: float = 0.0):
        """The post-detection half of one stream's frame: region mask,
        hypotheses, device scoring, then completion (render, gate,
        shared-buffer finetune), in order. `time_dtoid`: the stream's share
        of the round's detection."""
        args = self.args
        bop_data = self.bop_dataset.getDataByIds(obj_id, scene_id, im_id)
        depth, mat_gt = bop_data["depth"], bop_data["mat_gt"]
        cam_K = np.asarray(bop_data["scene_camera"]["cam_K"])
        is_sym = obj_id in self.bop_dataset.sym_obj_ids
        err_func = add_err if args.fast else (adi_err if is_sym else add_err)

        times = {"time_ppf": None, "time_sift": None, "time_zephyr": None, "time_icp": None,
                 "time_finetune": 0, "time_data": 0.0, "time_mask": 0.0, "time_pperr": 0.0,
                 "time_label": 0.0, "time_iter": 0.0, "time_det_miss": 0.0, "time_det_spec": 0.0,
                 "time_det_fetch": 0.0}
        t0 = time.perf_counter()
        final_score = out["final_score"][0]
        dtoid_confident = bool(final_score[0] > DTOID_CONFIDENT_THRESHOLD)
        use_dtoid_mask = (False if args.ignore_dtoid_mask
                          else True if args.always_dtoid_mask else dtoid_confident)
        ctx = {
            "iteration": iteration, "obj_id": obj_id, "scene_id": scene_id, "im_id": im_id,
            "depth": depth, "mat_gt": mat_gt, "cam_K": cam_K,
            "model_points": self.model_clouds[obj_id][0], "err_func": err_func,
            "mask_gt": bop_data["mask_gt"], "mask_gt_visib": bop_data["mask_gt_visib"],
            "times": times, "time_dtoid": time_dtoid,
            "final_bbox": out["final_bbox"][0], "final_score": final_score,
            "dtoid_iou": 0.0, "dtoid_pred_mask": out["segmentation"],
            "dtoid_confident": dtoid_confident, "use_dtoid_mask": use_dtoid_mask,
            "zhandle": None, "zr": self.zephyr_results.get((obj_id, scene_id, im_id)),
            "pp_err": None, "n_hypos": 0,
            # the replay buffer keeps metadata: the finetune ships the frame
            # from the host, as the JAX loop's streams do
            "img_dev": None,
        }
        if use_dtoid_mask:
            with Timer() as t_mask:
                dist_mask = self._dtoid_mask(out, depth)
            times["time_mask"] = t_mask.interval
            poses = self._generate_hypotheses(obj_id, bop_data["img"], depth, dist_mask, cam_K,
                                              bop_data["scene_meta"], times)
            if len(poses):
                pts, cols, nrms = self.model_clouds[obj_id]
                data = {"img": bop_data["img"], "depth": _depth_mm(depth), "cam_K": cam_K,
                        "model_points": pts, "model_colors": cols, "model_normals": nrms,
                        "pose_hypos": poses}
                with Timer() as t:
                    ctx["zhandle"] = self._zephyr_for(obj_id).score_hypotheses_async(data, obj_id=obj_id)
                times["time_zephyr"] = t.interval
                ctx["n_hypos"] = len(poses)
                pts_dev, pts_q_dev = self._pp_pts(obj_id)
                ctx["pp_handle"] = pp_err_batch_async(poses, mat_gt, pts_dev, symmetric=err_func is adi_err,
                                                      pts_q_dev=pts_q_dev)
        elif ctx["zr"] is None:
            raise RuntimeError(f"no precomputed zephyr result for {(obj_id, scene_id, im_id)}")
        times["time_iter"] = time.perf_counter() - t0
        self._complete_frame(ctx, results, progress)
