"""SIFT pose hypotheses (the port of ossid_code_tpu/hypo/sift.py).

Each object's template grid views are featurized once, their keypoints
lifted to object-frame 3D points; at test time the keypoints in the masked
scene region are lifted to 3D through the depth and matched to the model's
descriptors, and RANSAC over 3-point rigid (Kabsch) alignments gives ranked
pose hypotheses. Keypoints and descriptors come from the port's own SIFT
(ops/sift.py, on the card unless the caller asks for the CPU); the matcher is
the JAX package's, on the host (scipy's cKDTree, numpy's RANSAC), and gives
its hypotheses bit for bit on the same features (`match_features`). SIFT's
own failures raise `ops.sift.SiftError`.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.spatial import cKDTree

from ossid_code_torch.device import resolve_device
from ossid_code_torch.ops.sift import SiftError, detect_and_compute, rgb_to_gray
from ossid_code_torch.utils.geometry import estimate_rigid_body_transform


def _features(img_u8, mask, max_kpts: int, device=None):
    """SIFT of an (H, W, 3) uint8 RGB image (numpy or tensor) in a mask, on
    `device` (None: the card): (Keypoints, (N, 128) float32 numpy
    descriptors)."""
    img = img_u8 if torch.is_tensor(img_u8) else torch.from_numpy(np.ascontiguousarray(img_u8))
    img = img.to(resolve_device(device))
    m = torch.as_tensor(np.ascontiguousarray(np.asarray(mask) > 0), device=img.device)
    kps, descs = detect_and_compute(rgb_to_gray(img), m, nfeatures=max_kpts)
    return kps, descs.cpu().numpy()


def featurize_scene(img_u8, depth: np.ndarray, mask: np.ndarray, cam_K: np.ndarray,
                    max_kpts: int = 500, device=None):
    """SIFT keypoints and descriptors in the masked region, lifted to 3D;
    SIFT runs on `device` (None: the card).

    Returns (kpts_uv (N, 2), descs (N, 128), points3d (N, 3) camera frame)."""
    kps, descs = _features(img_u8, mask, max_kpts, device)
    if not kps.count:
        raise SiftError("no SIFT features in the masked region")
    uv = np.asarray(kps.pt, np.float64)  # (u, v)
    iu = np.clip(uv[:, 0].round().astype(int), 0, depth.shape[1] - 1)
    iv = np.clip(uv[:, 1].round().astype(int), 0, depth.shape[0] - 1)
    z = depth[iv, iu]
    ok = z > 1e-6
    if not ok.any():
        raise SiftError("no SIFT features with valid depth")
    uv, descs, iu, iv, z = uv[ok], descs[ok], iu[ok], iv[ok], z[ok]
    x = (iu - cam_K[0, 2]) * z / cam_K[0, 0]
    y = (iv - cam_K[1, 2]) * z / cam_K[1, 1]
    pts3d = np.stack([x, y, z], 1)
    return uv, descs.astype(np.float32), pts3d


class SiftFeatureModel:
    """Per-object 3D SIFT feature bank built from a template grid; SIFT
    runs on `device` (None: the card)."""

    def __init__(self, max_kpts_per_view: int = 200, device=None):
        self.max_kpts_per_view = max_kpts_per_view
        self.device = resolve_device(device)
        self.descs: np.ndarray | None = None
        self.points_obj: np.ndarray | None = None
        self._tree: cKDTree | None = None

    def construct_from_templates(self, template_dataset, obj_id: int, view_dist: float | None = None):
        """Featurize every grid view; template xyz maps are camera-frame, so
        object-frame points are R^T (x - t) with the grid view pose (R, t).
        Poses come from the grid's vid2pose.pkl when present, else from
        vid2rot + `view_dist`."""
        poses = template_dataset.get_view_poses(obj_id)
        if poses is None and view_dist is None:
            raise SiftError("grid has no view poses; pass view_dist")
        all_desc, all_pts = [], []
        for vi, vid in enumerate(template_dataset.view_ids):
            img, xyz, mask = template_dataset.getTemplate(obj_id, vid)
            kps, descs = _features((img * 255).astype(np.uint8), mask[..., 0] > 0, self.max_kpts_per_view,
                                   self.device)
            if not kps.count:
                continue
            if poses is not None:
                R, t = poses[vi][:3, :3], poses[vi][:3, 3]
            else:
                R, t = template_dataset.grid_rots[vi], np.array([0.0, 0.0, view_dist])
            for (pu, pv), d in zip(kps.pt, descs):
                u = np.clip(int(round(float(pu))), 0, xyz.shape[1] - 1)
                v = np.clip(int(round(float(pv))), 0, xyz.shape[0] - 1)
                p_cam = xyz[v, u]
                if p_cam[2] <= 1e-6:
                    continue
                all_desc.append(d)
                all_pts.append(R.T @ (p_cam - t))
        if not all_desc:
            raise SiftError(f"no SIFT features on templates of obj {obj_id}")
        self.descs = np.stack(all_desc).astype(np.float32)
        self.points_obj = np.stack(all_pts)
        self._tree = cKDTree(self.descs)
        return self

    def match(self, img_u8, depth, mask, cam_K, n_hypos: int = 20, ransac_iters: int = 200,
              inlier_th: float = 0.01, seed: int = 0):
        """Scene -> ranked pose hypotheses (M, 4, 4), camera frame, meters."""
        uv, descs, scene3d = featurize_scene(img_u8, depth, mask, cam_K, device=self.device)
        return self.match_features(uv, descs, scene3d, n_hypos, ransac_iters, inlier_th, seed)

    def match_features(self, uv, descs, scene3d, n_hypos: int = 20, ransac_iters: int = 200,
                       inlier_th: float = 0.01, seed: int = 0):
        """The matcher half of `match` on given scene features: descriptor
        nearest neighbours, the best half of them (at least 20),
        RANSAC-Kabsch, inlier refinement, ranking by inlier count."""
        rng = np.random.default_rng(seed)
        dist, idx = self._tree.query(descs, k=1)
        # keep the best correspondences by descriptor distance
        order = np.argsort(dist)
        keep = order[: max(20, len(order) // 2)]
        src = self.points_obj[idx[keep]]  # object frame
        dst = scene3d[keep]               # camera frame
        if len(src) < 3:
            raise SiftError("too few SIFT correspondences")

        hypos, scores = [], []
        n = len(src)
        for _ in range(ransac_iters):
            sel = rng.choice(n, 3, replace=False)
            try:
                R, t = estimate_rigid_body_transform(src[sel].T, dst[sel].T)
            except np.linalg.LinAlgError:
                continue
            pred = src @ R.T + t[:, 0]
            inliers = np.linalg.norm(pred - dst, axis=1) < inlier_th
            ninl = int(inliers.sum())
            if ninl >= 3:
                R2, t2 = estimate_rigid_body_transform(src[inliers].T, dst[inliers].T)
                pose = np.eye(4)
                pose[:3, :3] = R2
                pose[:3, 3] = t2[:, 0]
                hypos.append(pose)
                scores.append(ninl)
        if not hypos:
            raise SiftError("SIFT RANSAC found no consistent pose")
        order = np.argsort(scores)[::-1]
        return np.stack(hypos)[order[:n_hypos]]


class SiftHypoGen:
    """Loop-facing adapter with the reference's `match(img, depth, mask,
    meta)` shape; the image may be a tensor on the card."""

    def __init__(self, feature_model: SiftFeatureModel, cam_K: np.ndarray, n_hypos: int = 20):
        self.fm = feature_model
        self.cam_K = cam_K
        self.n_hypos = n_hypos

    def match(self, img, depth, mask, scene_meta=None):
        if not torch.is_tensor(img) and img.dtype != np.uint8:
            img = (np.clip(img, 0, 1) * 255).astype(np.uint8)
        K = self.cam_K
        if scene_meta is not None and "camera_fx" in scene_meta:
            K = np.array([[scene_meta["camera_fx"], 0, scene_meta["camera_cx"]],
                          [0, scene_meta["camera_fy"], scene_meta["camera_cy"]],
                          [0, 0, 1.0]])
        return self.fm.match(img, depth, np.asarray(mask), K, n_hypos=self.n_hypos)
