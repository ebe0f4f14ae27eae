"""Offline training of the Zephyr hypothesis scorer (the port's counterpart
of ossid_code_tpu/train/zephyr_offline.py).

For each training frame: generate pose hypotheses (PPF, or GT perturbations
without a generator) plus GT-anchored positives, label each by its ADD(-S)
error against GT (< 0.1 * diameter is positive), assemble the score features
on the device, and take one `ZephyrModel.train_step`. The numpy generator is
consumed in the JAX package's order, so one seed gives the same hypothesis
sets in both packages. `calibrate_align_head` fits the scorer's residual
alignment head post hoc on real PPF sets; `eval_top1` reads the pick rate
there.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.spatial.transform import Rotation

from ossid_code_torch.eval.pose_metrics import add_err, adi_err, object_diameter
from ossid_code_torch.models.zephyr.features import assemble_score_features
from ossid_code_torch.models.zephyr.module import _blur5
from ossid_code_torch.models.zephyr.pointnet2 import alignment_fractions
from ossid_code_torch.utils.geometry import depth2cloud, perturb_trans


def perturb_pose(mat: np.ndarray, n: int, sig_rot: float, sig_t: float, rng) -> np.ndarray:
    """SE(3) perturbations with configurable magnitudes (perturb_trans with
    the reference's fixed sigmas is too coarse for sub-0.1d positives)."""
    axes = rng.normal(size=(n, 3))
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    rots = Rotation.from_rotvec(axes * rng.normal(0, sig_rot, n)[:, None]).as_matrix()
    out = np.repeat(mat[None].copy(), n, axis=0)
    out[:, :3, :3] = np.einsum("ijk,ikl->ijl", rots, out[:, :3, :3])
    out[:, :3, 3] += rng.normal(0, sig_t, (n, 3))
    return out


class ZephyrOfflineTrainer:
    def __init__(self, zephyr_model, bop_dataset, model_clouds: dict,
                 hypo_gens: dict | None = None, n_hypos: int = 64, seed: int = 0):
        self.model = zephyr_model
        self.bop = bop_dataset
        self.model_clouds = model_clouds
        self.hypo_gens = hypo_gens or {}
        self.n_hypos = n_hypos
        self.rng = np.random.default_rng(seed)
        self.diameters = {o: object_diameter(c[0]) for o, c in model_clouds.items()}
        for oid, (pts, cols, nrms) in model_clouds.items():
            self.model.prepare_object(oid, pts, cols, nrms)

    @torch.no_grad()
    def _assemble(self, data: dict, cam_K: np.ndarray, oid, poses: np.ndarray) -> torch.Tensor:
        """The score program's features on the device, from the blurred frame
        (training on raw pixels while scoring blurred ones would shift every
        HSV-difference feature)."""
        dev = self.model.device
        pd, cd, nd, *_ = self.model._objects[oid]
        img = torch.from_numpy(data["img"].astype(np.float32) / 255.0).to(dev)
        point_x, _, _ = assemble_score_features(
            _blur5(img), torch.as_tensor(np.asarray(data["depth"], np.float32), device=dev),
            torch.as_tensor(np.asarray(cam_K, np.float32), device=dev), pd, cd, nd,
            torch.as_tensor(poses, device=dev), return_uv=False)
        return point_x

    def make_training_batch(self, target: dict):
        """One frame -> (point_x (M, N, D) device tensor, labels (M,), valid (M,)).

        Mostly real generator output (surface-aligned wrong poses are the hard
        negatives), topped up with GT perturbations so every frame has
        positives and a graded error range."""
        oid = target["obj_id"]
        data = self.bop.getDataByIds(oid, target["scene_id"], target["im_id"])
        cam_K = np.asarray(data["scene_camera"]["cam_K"], np.float32)
        gt = np.asarray(data["mat_gt"], np.float32)

        n = self.n_hypos
        diam = self.diameters[oid]
        n_near = max(4, n // 8)
        near_t = perturb_pose(gt, n_near // 2, sig_rot=0.05, sig_t=0.02 * diam, rng=self.rng)
        near_m = perturb_pose(gt, n_near - n_near // 2, sig_rot=0.2, sig_t=0.08 * diam, rng=self.rng)
        near = np.concatenate([near_t, near_m])
        near[0] = gt
        if oid in self.hypo_gens:
            mask = np.asarray(data["mask_gt_visib"]) > 0
            cloud = depth2cloud(data["depth"], mask & (data["depth"] > 0), cam_K)
            far, _, _ = self.hypo_gens[oid].find_surface_model(cloud)
            far = far[: n - len(near)]
            if len(far) < n - len(near):
                far = np.concatenate([far, perturb_trans(gt, n - len(near) - len(far), rng=self.rng)])
        else:
            far = perturb_trans(gt, n - len(near), rng=self.rng)
            far[:, :3, 3] += self.rng.normal(0, 0.05, (len(far), 3))
        poses = np.concatenate([near, far]).astype(np.float32)

        pts = self.model_clouds[oid][0]
        err_fn = adi_err if oid in self.bop.sym_obj_ids else add_err
        errs = np.asarray([err_fn(p[:3, :3], p[:3, 3], gt[:3, :3], gt[:3, 3], pts) for p in poses])
        labels = (errs < 0.1 * self.diameters[oid]).astype(np.float32)
        return self._assemble(data, cam_K, oid, poses), labels, np.ones(len(poses), bool)

    def train_epoch(self, max_frames: int | None = None, seed: int = 0) -> float:
        losses = []
        targets = list(self.bop.targets)
        self.rng.shuffle(targets)
        for i, t in enumerate(targets[:max_frames]):
            point_x, labels, valid = self.make_training_batch(t)
            losses.append(self.model.train_step(point_x, labels, valid, seed=seed * 10000 + i))
        return float(np.mean(losses)) if losses else float("nan")

    def _head(self):
        """The alignment head as flax holds it: (kernel (12, 1), bias (1,))
        numpy, or None without align_feats."""
        head = self.model.net.align_head
        if head is None:
            return None
        return head.weight.detach().cpu().numpy().T, head.bias.detach().cpu().numpy()

    def _collect_real_sets(self, targets):
        """Real-PPF hypothesis sets with oracle visible masks: per frame, (raw
        scores without the align head, 12-cell alignment fractions, ADD
        errors, threshold). Shared by align-head calibration and eval_top1."""
        head = self._head()
        rows = []
        for t in targets:
            oid = t["obj_id"]
            if oid not in self.hypo_gens:
                continue
            data = self.bop.getDataByIds(oid, t["scene_id"], t["im_id"])
            gt = np.asarray(data["mat_gt"], np.float32)
            cam_K = np.asarray(data["scene_camera"]["cam_K"], np.float64)
            depth = np.asarray(data["depth"], np.float32)
            mask = np.asarray(data["mask_gt_visib"]) > 0
            cloud = depth2cloud(depth, mask & (depth > 0), cam_K)
            if len(cloud) < 50:
                continue
            poses, _, _ = self.hypo_gens[oid].find_surface_model(cloud)
            if not len(poses):
                rows.append(None)
                continue
            poses = poses.astype(np.float32)
            pts, cols, nrms = self.model_clouds[oid]
            out = self.model.score_hypotheses(
                {"img": data["img"], "depth": depth, "cam_K": cam_K, "model_points": pts,
                 "model_colors": cols, "model_normals": nrms, "pose_hypos": poses}, obj_id=oid)
            stats9 = alignment_fractions(self._assemble(
                dict(data, depth=depth), cam_K.astype(np.float32), oid, poses)).cpu().numpy()
            scores = np.asarray(out["scores"], np.float64)
            if head is not None:
                # strip the current head's contribution -> raw backbone scores
                scores = scores - (stats9 @ head[0][:, 0] + float(head[1][0]))
            err_fn = adi_err if oid in self.bop.sym_obj_ids else add_err
            errs = np.asarray([err_fn(p[:3, :3], p[:3, 3], gt[:3, :3], gt[:3, 3], pts) for p in poses])
            rows.append({"scores": scores, "stats9": stats9, "errs": errs, "th": 0.1 * self.diameters[oid]})
        return rows

    def calibrate_align_head(self, max_frames: int | None = None,
                             weights=(0.0, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0)):
        """Fit the scorer's residual alignment head on real PPF hypothesis
        sets: grid-search the (tolerance cell, weight) that maximises the
        training pick rate of argmax(raw_score + w * stat_cell); the bias keeps
        a hypothesis at the training positives' mean alignment at its raw
        score. Deterministic. Returns {'cell', 'weight', 'pick', 'bias',
        'frames'}, the last the number of hypothesis sets it scored."""
        if not getattr(self.model, "align_feats", False):
            raise ValueError("scorer was built without align_feats")
        rows = [r for r in self._collect_real_sets(list(self.bop.targets)[:max_frames]) if r]
        if not rows:
            return None
        n_cells = rows[0]["stats9"].shape[1]
        best = (0, 0.0, -1.0)
        for cell in range(n_cells):
            for w in weights:
                pick = float(np.mean([r["errs"][int(np.argmax(r["scores"] + w * r["stats9"][:, cell]))] < r["th"]
                                      for r in rows]))
                # prefer smaller weights at equal pick (less gate disruption)
                if pick > best[2] + 1e-9:
                    best = (cell, w, pick)
        cell, w, pick = best
        pos_stats = np.concatenate([
            r["stats9"][r["errs"] < r["th"], cell] for r in rows
        ]) if any((r["errs"] < r["th"]).any() for r in rows) else np.zeros(1)
        mu = float(pos_stats.mean()) if len(pos_stats) else 0.0

        kernel, bias = self._head()
        kernel = np.zeros_like(kernel)
        kernel[cell, 0] = w
        bias = np.zeros_like(bias)
        bias[0] = -w * mu
        sd = self.model.state_dict()
        sd["align_head.weight"] = torch.from_numpy(kernel.T.copy()).to(sd["align_head.weight"])
        sd["align_head.bias"] = torch.from_numpy(bias).to(sd["align_head.bias"])
        self.model.load_state_dict(sd)
        return {"cell": int(cell), "weight": float(w), "pick": pick, "bias": float(bias[0]), "frames": len(rows)}

    def eval_top1(self, max_frames: int | None = None, return_ceiling: bool = False):
        """Fraction of frames whose argmax hypothesis is ADD-correct, on real
        PPF hypothesis sets with oracle visible masks; frames whose generator
        found nothing count as misses. With `return_ceiling`, also the
        fraction of frames whose set holds a correct hypothesis."""
        rows = self._collect_real_sets(list(self.bop.targets)[:max_frames])
        head = self._head()
        correct, winnable = [], []
        for r in rows:
            if r is None:
                correct.append(False)
                winnable.append(False)
                continue
            s = r["scores"]
            if head is not None:
                s = s + (r["stats9"] @ head[0][:, 0] + float(head[1][0]))
            i = int(np.argmax(s))
            correct.append(bool(r["errs"][i] < r["th"]))
            winnable.append(bool(r["errs"].min() < r["th"]))
        pick = float(np.mean(correct)) if correct else 0.0
        if return_ceiling:
            return pick, (float(np.mean(winnable)) if winnable else 0.0)
        return pick
