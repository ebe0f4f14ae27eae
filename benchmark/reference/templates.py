"""Template grid loader (host-side, numpy, HWC).

Counterpart of the reference's TemplateDataset
(ref datasets/template_dataset.py:14-117): loads pre-rendered object template
grids in either the framework's own format (vid2rot.pkl +
%06d/%04d_color.png/_xyz.npy/_mask.npy) or the original-DTOID-author format
(hinterstoisser_%02d/%06d_{a,d,m}.png + poses.txt).

Layout difference from the reference: arrays are HWC float32 (NHWC, as in the
rest of the port), not CHW. The port's copy of ossid_code_tpu/data/templates.py,
reading PNGs with utils/png.py.
"""

from __future__ import annotations

import os
import pickle

import numpy as np

from .geometry import mat2quat
from .png import read_png


class TemplateDataset:
    def __init__(
        self,
        grid_root: str,
        obj_ids,
        obj_id_offset: int = 0,
        preload: bool = False,
        use_provided_template: bool = False,
    ):
        self.grid_root = grid_root
        self.obj_ids = list(obj_ids)
        self.obj_id_offset = obj_id_offset
        self.preload = preload
        self.use_provided_template = use_provided_template

        if use_provided_template:
            # DTOID-author template format (ref template_dataset.py:26-39)
            self.obj_id_offset = 0
            pose_file = os.path.join(self.grid_root, "hinterstoisser_01", "poses.txt")
            poses = np.loadtxt(pose_file).reshape(-1, 4, 4)
            self.grid_poses = poses
            self.view_ids = list(range(len(poses)))
            self.grid_rots = poses[:, :3, :3]
            self.grid_quats = mat2quat(self.grid_rots)
            self.template_z_values = poses[:, 2, 3]
        else:
            with open(os.path.join(self.grid_root, "vid2rot.pkl"), "rb") as f:
                self.vid2rot = pickle.load(f)
            self.view_ids = sorted(self.vid2rot.keys())
            self.grid_rots = np.stack([self.vid2rot[k] for k in self.view_ids], 0)
            self.grid_quats = mat2quat(self.grid_rots)
            self.template_z_values = None

        # one convention everywhere: stacked arrays (grid_rots/quats, caches)
        # are indexed by POSITION; filenames are derived from the literal view
        # id at that position. view_id -> position mapped once here.
        self._vid2pos = {int(v): i for i, v in enumerate(self.view_ids)}

        self.template_cache: dict = {}
        # per-view LRU for non-preload mode: the online finetune pass samples
        # nearest-rotation templates repeatedly, and re-reading PNG+npy from
        # disk per sample dominates the single host core (~10 ms/view)
        self._view_cache: dict = {}
        self._view_cache_cap = 1024
        if preload:
            for oid in self.obj_ids:
                self.template_cache[oid] = self.getTemplatesAll(oid)

    def get_view_poses(self, obj_id) -> np.ndarray | None:
        """Full 4x4 view poses if the grid stores them (framework extension:
        per-object vid2pose.pkl; needed to lift template pixels into the
        object frame for SIFT featurization)."""
        if self.use_provided_template:
            return self.grid_poses
        path = os.path.join(
            self.grid_root, f"{int(obj_id) + self.obj_id_offset:06d}", "vid2pose.pkl"
        )
        if not os.path.exists(path):
            return None
        with open(path, "rb") as f:
            vid2pose = pickle.load(f)
        return np.stack([vid2pose[k] for k in self.view_ids], 0)

    def getTemplate(self, obj_id, view_id):
        """Fetch one template by its literal view id (a key of vid2rot)."""
        return self.getTemplateByPos(obj_id, self._vid2pos[int(view_id)])

    def getTemplateByPos(self, obj_id, pos):
        """Fetch one template by POSITION — the index into the stacked
        grid_rots/grid_quats/getTemplatesAll arrays. Callers that argsort
        grid_quats get positions, not view ids; the two only coincide when
        view_ids == range(n) (a non-contiguous vid2rot.pkl would otherwise
        fetch the wrong templates)."""
        pos = int(pos)
        if obj_id in self.template_cache:
            img, xyz, mask = self.template_cache[obj_id]
            return img[pos], xyz[pos], mask[pos]
        key = (int(obj_id), pos)
        hit = self._view_cache.get(key)
        if hit is not None:
            return hit

        view_id = int(self.view_ids[pos])
        obj_id = int(obj_id)
        if self.use_provided_template:
            folder = os.path.join(self.grid_root, f"hinterstoisser_{obj_id:02d}")
            img = read_png(os.path.join(folder, f"{view_id:06d}_a.png"))[..., :3]
            xyz = read_png(os.path.join(folder, f"{view_id:06d}_d.png"))
            if xyz.ndim == 2:
                xyz = np.stack([xyz] * 3, -1)
            mask = (
                read_png(os.path.join(folder, f"{view_id:06d}_m.png")) > 0
            )
            if mask.ndim == 3:
                mask = mask[..., 0]
        else:
            folder = os.path.join(self.grid_root, f"{obj_id + self.obj_id_offset:06d}")
            img = read_png(os.path.join(folder, f"{view_id:04d}_color.png"))
            xyz = np.load(os.path.join(folder, f"{view_id:04d}_xyz.npy"))
            mask = np.load(os.path.join(folder, f"{view_id:04d}_mask.npy"))

        img = img.astype(np.float32) / 255.0
        mask = mask.astype(np.float32)[..., None]
        xyz = xyz.astype(np.float32)
        if len(self._view_cache) >= self._view_cache_cap:
            self._view_cache.pop(next(iter(self._view_cache)))
        self._view_cache[key] = (img, xyz, mask)
        return img, xyz, mask

    def getTemplatesAll(self, obj_id):
        if obj_id in self.template_cache:
            return self.template_cache[obj_id]
        imgs, xyzs, masks = [], [], []
        for pos in range(len(self.view_ids)):
            img, xyz, mask = self.getTemplateByPos(obj_id, pos)
            imgs.append(img)
            xyzs.append(xyz)
            masks.append(mask)
        return np.stack(imgs, 0), np.stack(xyzs, 0), np.stack(masks, 0)
