"""The reference's view of the benchmark's world: its files read again
(frames, depth, visible masks, poses, templates, meshes), and the small host
steps of the loop that turn them into the network's and the scorer's
inputs, frozen from the port's loop and dataset code:

  * `Frames`: a BOP split as the world writes it (scene_camera.json,
    scene_gt.json, rgb / depth / mask_visib PNGs);
  * `templates`: the T local templates a test batch holds (every view of the
    grid, or T of them spaced evenly);
  * `model_cloud`: the scorer's model cloud sampled from the object's mesh;
  * `region_mask` and `depth_crop_window`: the scorer's region from the
    detections and its depth crop around it;
  * `Annotator`: a finetune sample's templates, box and heat map from its
    label mask, and the order in which a finetune event draws them.
"""

from __future__ import annotations

import json
import os

import numpy as np

from .geometry import expand_box, heatmap_gaussian, mat2quat, quat_angular_diff_batch
from .mesh import load_ply
from .png import read_png
from .templates import TemplateDataset


class Frames:
    """The frames of one BOP split (`<root>/<dataset>/<split>/<scene>/...`)."""

    def __init__(self, dataset_root: str, split: str = "test"):
        self.root = dataset_root
        self.split_dir = os.path.join(dataset_root, split)
        self._json: dict = {}

    def _scene_json(self, scene_id: int, name: str):
        key = (scene_id, name)
        if key not in self._json:
            with open(os.path.join(self.split_dir, f"{scene_id:06d}", name)) as f:
                self._json[key] = json.load(f)
        return self._json[key]

    def obj_path(self, obj_id: int) -> str:
        return os.path.join(self.root, "models", f"obj_{obj_id:06d}.ply")

    def read(self, obj_id: int, scene_id: int, im_id: int) -> dict:
        """img (H, W, 3) uint8, depth in metres (float32, as the loop holds
        it), depth_mm (uint16, as the scorer takes it), the object's visible
        mask, mat_gt (4x4, metres) and cam_K."""
        scene_dir = os.path.join(self.split_dir, f"{scene_id:06d}")
        cam = self._scene_json(scene_id, "scene_camera.json")[str(im_id)]
        img = read_png(os.path.join(scene_dir, "rgb", f"{im_id:06d}.png"))
        if img.ndim == 2:
            img = np.stack([img] * 3, -1)
        img = img[..., :3]
        raw = np.asarray(read_png(os.path.join(scene_dir, "depth", f"{im_id:06d}.png"))).astype(np.float32)
        depth = raw * float(cam.get("depth_scale", 1.0)) / 1000.0
        gts = self._scene_json(scene_id, "scene_gt.json")[str(im_id)]
        gi = next(i for i, g in enumerate(gts) if int(g["obj_id"]) == int(obj_id))
        mat_gt = np.eye(4)
        mat_gt[:3, :3] = np.asarray(gts[gi]["cam_R_m2c"], np.float64).reshape(3, 3)
        mat_gt[:3, 3] = np.asarray(gts[gi]["cam_t_m2c"], np.float64) / 1000.0
        visib = read_png(os.path.join(scene_dir, "mask_visib", f"{im_id:06d}_{gi:06d}.png"))
        return {"img": np.ascontiguousarray(img), "depth": depth,
                "depth_mm": (depth * 1000.0).round().clip(0, 65535).astype(np.uint16),
                "mask_visib": np.asarray(visib) > 0, "mat_gt": mat_gt,
                "cam_K": np.asarray(cam["cam_K"], np.float64).reshape(3, 3)}


def templates(grid: TemplateDataset, obj_id: int, n_local: int):
    """The local templates of a test batch: (T, h, w, 3) float [0, 1] images
    and (T, h, w, 1) masks."""
    limg, _, lmask = grid.getTemplatesAll(obj_id)
    if len(limg) > n_local:
        lvids = np.linspace(0, len(limg) - 1, n_local).round().astype(int)
        limg, lmask = limg[lvids], lmask[lvids]
    return limg, lmask


def model_cloud(mesh_path: str, n_points: int = 2048, seed: int = 0):
    """The scorer's model cloud (metres, colours, outward normals) sampled
    from a BOP mesh in millimetres."""
    mesh = load_ply(mesh_path)
    rng = np.random.default_rng(seed)
    v = mesh.vertices / 1000.0
    faces = mesh.faces
    a, b, c = v[faces[:, 0]], v[faces[:, 1]], v[faces[:, 2]]
    areas = 0.5 * np.linalg.norm(np.cross(b - a, c - a), axis=1)
    fidx = rng.choice(len(faces), n_points, p=areas / areas.sum())
    r1, r2 = rng.random((2, n_points))
    s1 = np.sqrt(r1)
    w0, w1, w2 = 1 - s1, s1 * (1 - r2), s1 * r2
    pts = w0[:, None] * v[faces[fidx, 0]] + w1[:, None] * v[faces[fidx, 1]] + w2[:, None] * v[faces[fidx, 2]]
    fn = np.cross(b - a, c - a)
    fn /= np.clip(np.linalg.norm(fn, axis=1, keepdims=True), 1e-12, None)
    if mesh.normals is not None and len(mesh.normals) == len(v):
        vn = mesh.normals[faces[:, 0]] + mesh.normals[faces[:, 1]] + mesh.normals[faces[:, 2]]
        flip = np.einsum("ij,ij->i", fn, vn) < 0
    else:
        flip = np.einsum("ij,ij->i", fn, (a + b + c) / 3.0 - v.mean(axis=0)) < 0
    fn[flip] *= -1.0
    if mesh.colors is not None:
        cols = (w0[:, None] * mesh.colors[faces[fidx, 0]] + w1[:, None] * mesh.colors[faces[fidx, 1]]
                + w2[:, None] * mesh.colors[faces[fidx, 2]])
    else:
        cols = np.full((n_points, 3), 0.5)
    return pts.astype(np.float32), cols.astype(np.float32), fn[fidx].astype(np.float32)


def region_mask(boxes, scores, depth, proc_hw) -> np.ndarray:
    """The scorer's region: the detections' boxes (processed-image
    coordinates) grown by 1.2 about their centres, best first, until the
    scores fall under 0.5 with some depth inside the region."""
    mask = np.zeros_like(depth, dtype=bool)
    img_h, img_w = depth.shape
    sx, sy = img_w / proc_hw[1], img_h / proc_hw[0]
    depth_pos = depth > 0
    has_depth = False
    for (x1, y1, x2, y2), score in zip(boxes, scores):
        if score < 0.5 and has_depth:
            break
        x1, y1, x2, y2 = expand_box(x1 * sx, y1 * sy, x2 * sx, y2 * sy, img_h, img_w, 1.2)
        region = np.s_[int(y1):int(y2), int(x1):int(x2)]
        mask[region] = True
        if not has_depth:
            has_depth = bool(depth_pos[region].any())
    return mask


def depth_crop_window(mask: np.ndarray, img_hw, size: int):
    """(y0, x0, h, w) of the square depth crop centred on the region."""
    h, w = img_hw
    ys, xs = np.nonzero(mask)
    cy, cx = (int(ys.mean()), int(xs.mean())) if len(ys) else (h // 2, w // 2)
    y0 = int(np.clip(cy - size // 2, 0, max(h - size, 0)))
    x0 = int(np.clip(cx - size // 2, 0, max(w - size, 0)))
    return y0, x0, min(size, h), min(size, w)


class Annotator:
    """A finetune sample's non-frame half: a global template drawn at random,
    the local template nearest the pose's rotation, and the box and centre
    heat map of the label mask. Draws from its own generator in the order a
    finetune event makes them."""

    def __init__(self, grid: TemplateDataset, heatmap_scale: float, heatmap_var: float, sample_from: int,
                 seed: int = 42):
        self.grid = grid
        self.heatmap_scale = heatmap_scale
        self.heatmap_var = heatmap_var
        self.sample_from = sample_from
        self.rng = np.random.default_rng(seed)

    def _bbox_heatmap(self, mask_hw: np.ndarray):
        h, w = mask_hw.shape
        ys, xs = mask_hw.nonzero()
        if len(ys) == 0:
            bbox = np.asarray([[-1, -1, -1, -1, -1]], np.float32)
            cx = cy = 0.0
        else:
            x1, x2, y1, y2 = xs.min(), xs.max(), ys.min(), ys.max()
            bbox = np.asarray([[x1, y1, x2, y2, 1]], np.float32)
            cx, cy = (x1 + x2) / 2.0, (y1 + y2) / 2.0
        s = self.heatmap_scale
        heat = heatmap_gaussian(h * s, w * s, cx * s, cy * s, sigma=np.sqrt(self.heatmap_var))
        return bbox, heat.astype(np.float32)[..., None]

    def sample(self, obj_id: int, mat_gt: np.ndarray, mask: np.ndarray) -> dict:
        bbox, heat = self._bbox_heatmap(np.asarray(mask).astype(np.float32))
        gvid = self.rng.choice(self.grid.view_ids)
        gimg, _, gmask = self.grid.getTemplate(obj_id, gvid)
        diff = quat_angular_diff_batch(self.grid.grid_quats, mat2quat(mat_gt[:3, :3])[None])
        lpos = self.rng.choice(diff.reshape(-1).argsort()[: self.sample_from])
        limg, _, lmask = self.grid.getTemplateByPos(obj_id, lpos)
        return {"limg_u8": (limg * 255.0).round().astype(np.uint8), "lmask_u8": lmask.astype(np.uint8),
                "gimg_u8": (gimg * 255.0).round().astype(np.uint8), "gmask_u8": gmask.astype(np.uint8),
                "bbox_gt": bbox, "heatmap": heat}

    def skip(self, n: int) -> None:
        """Make the draws of `n` samples without building them (a finetune
        event the reference does not follow)."""
        for _ in range(n):
            self.rng.choice(self.grid.view_ids)
            self.rng.choice(np.arange(min(self.sample_from, len(self.grid.view_ids))))


def event_batches(n_keys: int, batch_size: int) -> list:
    """A finetune event's batches over a buffer of `n_keys` targets (indices
    in admission order): one epoch in the permutation seeded by the buffer's
    size, the last batch padded by repetition."""
    order = np.random.default_rng(n_keys).permutation(n_keys)
    out = []
    for i0 in range(0, n_keys, batch_size):
        sel = order[i0:i0 + batch_size]
        if len(sel) < batch_size:
            sel = np.resize(sel, batch_size)
        out.append([int(j) for j in sel])
    return out
