"""Legacy SIFT-correspondence training data, SuperGlue-style matching (the
port of ossid_code_tpu/data/ycbv_sift.py, without cv2).

Covers ref datasets/ycbv_sift_dataset.py (C16) and datasets/ycbv_object.py
(C17): per-object multi-view SIFT feature grids with 3D keypoint locations,
and per-frame GT correspondence matrices built by projecting model keypoints
under the GT pose and Hungarian-assigning them to detected scene keypoints,
with dustbin rows/cols. FAISS NN search is replaced by scipy cKDTree
(SURVEY.md N7).

SIFT is the port's own (ops/sift.py, OpenCV's algorithm in PyTorch) on
`device` (None: the card): the object grids as cv2's
`SIFT_create(nfeatures=200).detectAndCompute` at scales 1 and 0.5
(`resize_linear` for cv2.resize), the scene through hypo/sift.py's
`featurize_scene`. The Hungarian assignment and the NN index are scipy's.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.optimize import linear_sum_assignment
from scipy.spatial import cKDTree

from ossid_code_torch.device import resolve_device
from ossid_code_torch.hypo.sift import featurize_scene
from ossid_code_torch.ops.sift import detect_and_compute, rgb_to_gray
from ossid_code_torch.utils.image import resize_linear


class YcbvObject:
    """Per-object SIFT feature grid over rendered viewpoints
    (ref datasets/ycbv_object.py:9-88)."""

    def __init__(self, template_dataset, obj_id: int, scales=(1.0, 0.5), max_kpts=200, device=None):
        self.obj_id = obj_id
        dev = resolve_device(device)
        self.template_dataset = template_dataset
        poses = template_dataset.get_view_poses(obj_id)
        if poses is None:
            raise ValueError("template grid has no view poses")
        self.view_poses = poses
        self.view_dirs = np.stack([-p[:3, :3].T @ p[:3, 3] for p in poses])
        self.view_dirs /= np.clip(np.linalg.norm(self.view_dirs, axis=1, keepdims=True), 1e-9, None)

        descs, pts_obj, view_ids = [], [], []
        for vi, vid in enumerate(template_dataset.view_ids):
            img, xyz, mask = template_dataset.getTemplate(obj_id, vid)
            for s in scales:
                im = img if s == 1.0 else resize_linear(
                    img, (int(round(img.shape[1] * s)), int(round(img.shape[0] * s))))
                u8 = torch.from_numpy(np.ascontiguousarray((im * 255).astype(np.uint8))).to(dev)
                kpts, ds = detect_and_compute(rgb_to_gray(u8), nfeatures=max_kpts)
                if not kpts.count:
                    continue
                ds = ds.cpu().numpy()
                R, t = poses[vi][:3, :3], poses[vi][:3, 3]
                for (pu, pv), d in zip(kpts.pt.tolist(), ds):
                    u = int(round(pu / s))
                    v = int(round(pv / s))
                    if not (0 <= v < xyz.shape[0] and 0 <= u < xyz.shape[1]):
                        continue
                    if mask[v, u, 0] < 0.5 or xyz[v, u, 2] <= 1e-6:
                        continue
                    descs.append(d)
                    pts_obj.append(R.T @ (xyz[v, u] - t))
                    view_ids.append(vi)
        if not descs:
            raise ValueError(f"no SIFT features for obj {obj_id}")
        self.descs = np.stack(descs).astype(np.float32)
        self.points_obj = np.stack(pts_obj)
        self.kpt_view_ids = np.asarray(view_ids)

    def kpt_proj_grid_cos(self) -> np.ndarray:
        """(n_kpts, n_views) cosine between each keypoint's source view
        direction and every grid view direction (ref ycbv_object.py:63)."""
        kpt_dirs = self.view_dirs[self.kpt_view_ids]
        return kpt_dirs @ self.view_dirs.T

    def get_most_straight_features(self, view_dir: np.ndarray, n_kpts: int):
        """Keypoints from views most aligned with `view_dir`
        (ref ycbv_object.py:79)."""
        cos = self.view_dirs[self.kpt_view_ids] @ (view_dir / np.linalg.norm(view_dir))
        order = np.argsort(-cos)[:n_kpts]
        return self.descs[order], self.points_obj[order], order


class YcbvSiftDataset:
    """Per-frame SIFT correspondence samples with GT assignment matrices
    (ref datasets/ycbv_sift_dataset.py:59-238)."""

    def __init__(self, bop_dataset, objects: dict[int, YcbvObject], cfg, seed=0, device=None):
        self.device = resolve_device(device)
        self.bop_dataset = bop_dataset
        self.objects = objects
        self.cfg = cfg
        self.rng = np.random.default_rng(seed)
        self.targets = [t for t in bop_dataset.targets if t["obj_id"] in objects]
        self.n_kpts_obs = cfg.get("n_kpts_obs", 128)
        self.n_kpts_model = cfg.get("n_kpts_model", 128)
        self.match_px_th = cfg.get("match_px_th", 4.0)

    def __len__(self):
        return len(self.targets)

    def project_model_points(self, pts_obj, pose, cam_K):
        cam = pts_obj @ pose[:3, :3].T + pose[:3, 3]
        z = np.clip(cam[:, 2], 1e-9, None)
        u = cam_K[0, 0] * cam[:, 0] / z + cam_K[0, 2]
        v = cam_K[1, 1] * cam[:, 1] / z + cam_K[1, 2]
        return np.stack([u, v], 1)

    def assign_matches(self, obs_uv: np.ndarray, model_uv: np.ndarray,
                       n_obs: int, n_model: int) -> np.ndarray:
        """Fixed-shape GT correspondence matrix (n_obs+1, n_model+1) with
        dustbin last row/col, via Hungarian assignment on pixel distance
        (ref :209-211,265). Padding slots match to the dustbin."""
        M = np.zeros((n_obs + 1, n_model + 1), np.float32)
        no, nm = len(obs_uv), len(model_uv)
        if no and nm:
            dist = np.linalg.norm(obs_uv[:, None] - model_uv[None], axis=-1)
            rows, cols = linear_sum_assignment(dist)
            for r, c in zip(rows, cols):
                if dist[r, c] <= self.match_px_th:
                    M[r, c] = 1.0
        M[:n_obs, -1] = 1.0 - M[:n_obs, :-1].sum(1)
        M[-1, :n_model] = 1.0 - M[:-1, :n_model].sum(0)
        return M

    def __getitem__(self, idx):
        t = self.targets[idx]
        data = self.bop_dataset.getDataByIds(t["obj_id"], t["scene_id"], t["im_id"])
        cam_K = np.asarray(data["scene_camera"]["cam_K"])
        mask = np.asarray(data["mask_gt_visib"]) > 0

        uv, descs, pts3d = featurize_scene(
            data["img"], data["depth"], mask, cam_K, max_kpts=self.n_kpts_obs, device=self.device
        )
        uv, descs, pts3d = uv[: self.n_kpts_obs], descs[: self.n_kpts_obs], pts3d[: self.n_kpts_obs]

        obj = self.objects[t["obj_id"]]
        view_dir = -data["mat_gt"][:3, :3].T @ data["mat_gt"][:3, 3]
        m_desc, m_pts, _ = obj.get_most_straight_features(view_dir, self.n_kpts_model)
        m_uv = self.project_model_points(m_pts, data["mat_gt"], cam_K)

        matches = self.assign_matches(uv, m_uv, self.n_kpts_obs, self.n_kpts_model)

        def pad(a, n):
            out = np.zeros((n,) + a.shape[1:], a.dtype)
            out[: len(a)] = a[:n]
            return out

        return {
            "obs_desc": pad(descs, self.n_kpts_obs),
            "obs_uv": pad(uv.astype(np.float32), self.n_kpts_obs),
            "obs_xyz": pad(pts3d.astype(np.float32), self.n_kpts_obs),
            "model_desc": pad(m_desc, self.n_kpts_model),
            "model_pts": pad(m_pts.astype(np.float32), self.n_kpts_model),
            "matches": matches,
            "n_obs": len(uv),
            "obj_id": t["obj_id"],
            "scene_id": t["scene_id"],
            "im_id": t["im_id"],
        }


def get_ycbv_sift_dataloaders(cfg):
    """(train, valid, test) loaders of SIFT-correspondence samples for the
    train CLI (the reference's ycbv_sift config family,
    ref conf/dataset/ycbv_sift.yaml + datasets/ycbv_sift_dataset.py):
    per-object SIFT grids built from the template dataset, frames split 80/20.
    SIFT runs on the config's `device` (None: the card)."""
    from ossid_code_torch.data.bop import BopDataset, BopDatasetArgs
    from ossid_code_torch.data.dtoid_bop import NumpyLoader
    from ossid_code_torch.data.templates import TemplateDataset

    d = cfg.dataset
    device = cfg.get("device")
    bop = BopDataset(BopDatasetArgs(
        bop_root=d.bop_root, dataset_name=d.get("train_dataset_name") or d.test_dataset_name,
        split_name=d.get("split_name", "bop_test"), split=d.get("split", "test"),
    ))
    tmpl = TemplateDataset(d.grid_root, bop.obj_ids,
                           use_provided_template=d.get("use_provided_template", False))
    objects = {}
    for oid in bop.obj_ids:
        try:
            objects[oid] = YcbvObject(tmpl, oid, device=device)
        except ValueError:
            pass  # textureless template grid: no SIFT features for this object
    if not objects:
        raise SystemExit("ycbv_sift: no object produced SIFT features from the template grid")

    full = YcbvSiftDataset(bop, objects, d, device=device)
    train_ds = YcbvSiftDataset(bop, objects, d, seed=0, device=device)
    valid_ds = YcbvSiftDataset(bop, objects, d, seed=1, device=device)
    train_ds.targets = [t for i, t in enumerate(full.targets) if i % 5 != 4]
    valid_ds.targets = [t for i, t in enumerate(full.targets) if i % 5 == 4] or full.targets[:1]
    b = int(cfg.train.batch_size)
    return (
        NumpyLoader(train_ds, batch_size=b, shuffle=True, drop_last=True),
        NumpyLoader(valid_ds, batch_size=b, drop_last=True),
        NumpyLoader(full, batch_size=1),
    )


def create_search_index(descs: np.ndarray) -> cKDTree:
    """NN index over descriptors (role of the reference's FAISS index,
    ref ycbv_sift_dataset.py:293-301)."""
    return cKDTree(np.asarray(descs, np.float32))
