"""In-repo BOP19 pose-error evaluation: VSD, MSSD, MSPD and the Average
Recall (AR) score (the port's copy of ossid_code_tpu/eval/bop_ar.py).

The reference shells out to bop_toolkit's eval_bop19.py with the C++
bop_renderer (ref utils/bop_utils.py:51-53, SURVEY.md B1/B2). This module
computes the same metrics on the host, with the depth renders of the C++
rasterizer (native/rasterizer.cpp, built at first use; no numpy fallback).

BOP19 definitions implemented:
  * VSD (visible surface discrepancy): visibility delta = 15mm, misalignment
    tolerances tau = {0.05..0.5} of the object diameter, correctness
    thresholds theta = {0.05..0.5}; recall averaged over the (tau, theta) grid;
  * MSSD (maximum symmetry-aware surface distance), thresholds
    theta = {0.05..0.5} * object diameter;
  * MSPD (maximum symmetry-aware projection distance), thresholds
    theta = {5..50} * (image_width / 640) px;
  * AR = mean of the three per-metric average recalls.
"""

from __future__ import annotations

import numpy as np

from ossid_code_torch.eval.pose_metrics import object_diameter
from ossid_code_torch.render.mesh import load_ply
from ossid_code_torch.render.rasterizer import render_depth_native
from ossid_code_torch.render.visib import estimate_visib_mask_est, estimate_visib_mask_gt

VSD_DELTA = 0.015  # m (bop19)
VSD_TAUS = np.arange(0.05, 0.51, 0.05)
THETAS = np.arange(0.05, 0.51, 0.05)
MSPD_THETAS = np.arange(5, 51, 5)


def symmetry_transforms(model_info: dict, max_sym_disc_step: float = 0.01) -> list[np.ndarray]:
    """Discretized symmetry transformations from a models_info entry, matching
    bop_toolkit misc.get_symmetry_transformations exactly (mm -> m):

      * `max_sym_disc_step` is the max fraction of the object diameter that the
        farthest-from-axis vertex travels between consecutive discretized
        rotations, so the step count is ceil(pi / max_sym_disc_step) —
        diameter-independent and uncapped (315 steps at the toolkit's 0.01);
      * discrete and discretized-continuous symmetries are COMPOSED (the
        toolkit returns the product set {cont @ disc})."""
    trans_disc = [np.eye(4)]
    for s in model_info.get("symmetries_discrete", []):
        m = np.asarray(s, np.float64).reshape(4, 4)
        m[:3, 3] /= 1000.0
        trans_disc.append(m)

    trans_cont = []
    for s in model_info.get("symmetries_continuous", []):
        axis = np.asarray(s["axis"], np.float64)
        axis = axis / np.linalg.norm(axis)
        offset = np.asarray(s.get("offset", [0, 0, 0]), np.float64) / 1000.0
        n_steps = int(np.ceil(np.pi / max_sym_disc_step))
        step = 2.0 * np.pi / n_steps
        K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
        for i in range(1, n_steps):
            ang = i * step
            c, si = np.cos(ang), np.sin(ang)
            R = np.eye(3) + si * K + (1 - c) * (K @ K)
            m = np.eye(4)
            m[:3, :3] = R
            m[:3, 3] = offset - R @ offset
            trans_cont.append(m)

    syms = []
    for d in trans_disc:
        syms.append(d)
        for cmat in trans_cont:
            syms.append(cmat @ d)
    return syms


_SYM_CHUNK = 32  # bounds the (chunk, n_vertices, 3) temporary


def mssd(pose_est, pose_gt, model_points, syms) -> float:
    """Max symmetry-aware surface distance (meters), over ALL given model
    points (bop_toolkit pose_error.mssd uses every vertex — max statistics
    over a subsample would systematically underestimate the error)."""
    pts_est = model_points @ pose_est[:3, :3].T + pose_est[:3, 3]
    pg = pose_gt @ np.asarray(syms)  # (S, 4, 4)
    best = np.inf
    for i in range(0, len(pg), _SYM_CHUNK):
        c = pg[i : i + _SYM_CHUNK]
        pts_gt = np.einsum("sij,nj->sni", c[:, :3, :3], model_points) + c[:, None, :3, 3]
        d = np.linalg.norm(pts_est[None] - pts_gt, axis=-1).max(axis=1)
        best = min(best, float(d.min()))
    return best


def mspd(pose_est, pose_gt, model_points, syms, cam_K) -> float:
    """Max symmetry-aware projection distance (pixels), over ALL given model
    points (bop_toolkit pose_error.mspd semantics)."""

    def proj(cam):
        z = np.clip(cam[..., 2], 1e-9, None)
        return np.stack(
            [cam_K[0, 0] * cam[..., 0] / z + cam_K[0, 2],
             cam_K[1, 1] * cam[..., 1] / z + cam_K[1, 2]], -1
        )

    p_est = proj(model_points @ pose_est[:3, :3].T + pose_est[:3, 3])
    pg = pose_gt @ np.asarray(syms)
    best = np.inf
    for i in range(0, len(pg), _SYM_CHUNK):
        c = pg[i : i + _SYM_CHUNK]
        cam = np.einsum("sij,nj->sni", c[:, :3, :3], model_points) + c[:, None, :3, 3]
        d = np.linalg.norm(p_est[None] - proj(cam), axis=-1).max(axis=1)
        best = min(best, float(d.min()))
    return best


def vsd(pose_est, pose_gt, depth_test, cam_K, mesh, diameter, taus=VSD_TAUS,
        delta=VSD_DELTA) -> np.ndarray:
    """Visible surface discrepancy for each tau (array of errors in [0, 1])."""
    h, w = depth_test.shape

    d_est = render_depth_native(mesh.vertices / 1000.0, mesh.faces, cam_K, pose_est, h, w)
    d_gt = render_depth_native(mesh.vertices / 1000.0, mesh.faces, cam_K, pose_gt, h, w)

    # bop_toolkit bop19 visibility semantics (visibility.py): sensor holes
    # count as visible; est visibility adds every est pixel the gt sees
    visib_gt = estimate_visib_mask_gt(depth_test, d_gt, delta)
    visib_est = estimate_visib_mask_est(depth_test, d_est, visib_gt, delta)

    inter = visib_gt & visib_est
    union = visib_gt | visib_est
    n_union = union.sum()
    errs = np.ones(len(taus))
    if n_union == 0:
        return errs
    dist = np.abs(d_gt[inter] - d_est[inter])
    n_outside = n_union - inter.sum()
    for i, tau in enumerate(taus):
        costs = (dist > tau * diameter).sum()
        errs[i] = (costs + n_outside) / n_union
    return errs


class BopEvaluator:
    """AR(VSD, MSSD, MSPD) over a results list against a BopDataset."""

    def __init__(self, bop_dataset, n_model_points: int | None = None):
        """`n_model_points=None` (default) evaluates MSSD/MSPD over ALL mesh
        vertices, as bop_toolkit does; pass an int to subsample for speed
        (max-distance errors are then systematically underestimated)."""
        self.bop = bop_dataset
        self.meshes = {}
        self.points = {}
        self.syms = {}
        self.diameters = {}
        for oid in bop_dataset.obj_ids:
            mesh = load_ply(bop_dataset.getObjPath(oid))
            self.meshes[oid] = mesh
            pts = mesh.vertices / 1000.0
            if n_model_points is not None and len(pts) > n_model_points:
                pts = pts[np.linspace(0, len(pts) - 1, n_model_points).round().astype(int)]
            self.points[oid] = pts
            info = bop_dataset.models_info[oid]
            self.syms[oid] = symmetry_transforms(info)
            self.diameters[oid] = info.get("diameter", object_diameter(pts) * 1000.0) / 1000.0

    def evaluate(self, results, pose_key="pred_pose", verbose=False) -> dict:
        """results: list of dicts with obj_id/scene_id/im_id and a 4x4 pose in
        meters. Returns {'AR', 'AR_vsd', 'AR_mssd', 'AR_mspd', per-error lists}."""
        vsd_recalls = []
        mssd_recalls = []
        mspd_recalls = []
        rows = []
        for r in results:
            oid = r["obj_id"]
            data = self.bop.getDataByIds(oid, r["scene_id"], r["im_id"])
            cam_K = np.asarray(data["scene_camera"]["cam_K"])
            pose_est = np.asarray(r[pose_key], np.float64)
            pose_gt = np.asarray(data["mat_gt"], np.float64)
            diam = self.diameters[oid]
            pts = self.points[oid]
            syms = self.syms[oid]

            e_vsd = vsd(pose_est, pose_gt, data["depth"], cam_K, self.meshes[oid], diam)
            e_mssd = mssd(pose_est, pose_gt, pts, syms)
            e_mspd = mspd(pose_est, pose_gt, pts, syms, cam_K)

            # recalls over threshold grids
            vsd_rec = np.mean([(e < th) for e in e_vsd for th in THETAS])
            mssd_rec = np.mean([e_mssd < th * diam for th in THETAS])
            w = data["depth"].shape[1]
            mspd_rec = np.mean([e_mspd < th * w / 640.0 for th in MSPD_THETAS])
            vsd_recalls.append(vsd_rec)
            mssd_recalls.append(mssd_rec)
            mspd_recalls.append(mspd_rec)
            rows.append({"obj_id": oid, "e_vsd": float(np.mean(e_vsd)),
                         "e_mssd": e_mssd, "e_mspd": e_mspd})
            if verbose:
                print(rows[-1])

        ar_vsd = float(np.mean(vsd_recalls)) if vsd_recalls else 0.0
        ar_mssd = float(np.mean(mssd_recalls)) if mssd_recalls else 0.0
        ar_mspd = float(np.mean(mspd_recalls)) if mspd_recalls else 0.0
        return {
            "AR": (ar_vsd + ar_mssd + ar_mspd) / 3.0,
            "AR_vsd": ar_vsd,
            "AR_mssd": ar_mssd,
            "AR_mspd": ar_mspd,
            "per_image": rows,
        }
