"""BlenderProc-format HDF5 render IO and the few-shot / DTOID render
datasets (the port's copy of ossid_code_tpu/data/hdf5_render.py; files are
read by utils/hdf5.py, cv2's resizes are utils/image.py's).

Covers the reference's offline-pretraining data path (SURVEY.md C13/C14):
  * `load_hdf5` parses a BlenderProc scene (colors/depth/segmap/segcolormap/
    campose/object_states/normals) and computes per-object obj->cam transforms
    with the Blender->OpenCV camera flip (ref datasets/render_dataset.py:191-249;
    the reference's `cam2world[:3, 2] *= -2` at :213 is a scaling bug, and
    this applies the correct -1 flip, as the JAX package does);
  * `process_render_grid` crops an object-centred template from a
    single-object render (ref :251-330);
  * `RenderDataset` serves few-shot query/support episodes;
  * `DtoidRenderDataset` serves DTOID pretraining samples (query image + GT
    mask/bbox/heatmap + global/local templates, the closest-rotation local
    template at train time, ref datasets/dtoid_dataset.py:200-222).
Every random draw is made in the JAX package's order, so items agree for
the same seed.
"""

from __future__ import annotations

import glob
import json
import os

import numpy as np
from scipy.ndimage import binary_erosion
from scipy.spatial.transform import Rotation

from ossid_code_torch.data.dtoid_bop import NumpyLoader
from ossid_code_torch.utils import hdf5
from ossid_code_torch.utils.augmentation import augment_depth_map
from ossid_code_torch.utils.geometry import (
    depth2xyz, heatmap_gaussian, mat2quat, quat_angular_diff_batch, robust_crop,
)
from ossid_code_torch.utils.image import normalize_image, process_data, resize_linear


def load_hdf5(path: str) -> dict:
    """One BlenderProc scene: its arrays, its JSON fields parsed (stored as
    uint8 arrays or as |S scalars), the OpenCV cam2world and each object's
    obj2world / obj2cam."""
    with hdf5.File(path) as f:
        campose = json.loads(np.array(f["campose"]).tobytes())
        segmap = f["segmap"]
        colors = f["colors"]
        depth = f["depth"]
        segcolormap = json.loads(np.array(f["segcolormap"]).tobytes())
        object_states = json.loads(np.array(f["object_states"]).tobytes())
        normals = f["normals"] if "normals" in f else None

    if normals is not None:
        normals = (normals - 0.5) * 2.0

    cam2world = np.asarray(campose[0]["cam2world_matrix"], np.float64)
    # Blender camera: right +x, up +y, backward +z -> OpenCV: right +x,
    # down +y, forward +z
    cam2world = cam2world.copy()
    cam2world[:3, 1] *= -1
    cam2world[:3, 2] *= -1
    world2cam = np.linalg.inv(cam2world)

    objects = []
    for obj in object_states:
        if not obj["name"].startswith("obj"):
            continue
        t = np.asarray(obj["location"], np.float64)
        rot = Rotation.from_euler("XYZ", obj["rotation_euler"], degrees=False).as_matrix()
        obj2world = np.eye(4)
        obj2world[:3, :3] = rot
        obj2world[:3, 3] = t
        obj2cam = world2cam @ obj2world
        obj_id = int(obj["name"].split("_")[-1].split(".")[0])
        objects.append({"obj_id": obj_id, "obj2world": obj2world, "obj2cam": obj2cam})

    return {
        "campose": campose,
        "segmap": segmap,
        "colors": colors,
        "depth": depth,
        "segcolormap": segcolormap,
        "object_states": object_states,
        "objects": objects,
        "cam2world": cam2world,
        "normals": normals,
    }


def object_mask_from_segmap(segmap: np.ndarray, segcolormap: list, obj_id: int) -> np.ndarray | None:
    for inst in segcolormap:
        if int(inst["category_id"]) != obj_id:
            continue
        inst_id = int(inst["idx"])
        cch = int(inst["channel_class"])
        ich = int(inst["channel_instance"])
        return np.logical_and(segmap[:, :, cch] == obj_id, segmap[:, :, ich] == inst_id)
    return None


def process_render_grid(path: str, output_size=(128, 128)) -> dict:
    """Object-centred crop of a single-object render (templates)."""
    data = load_hdf5(path)
    cam_K = np.asarray(data["campose"][0]["cam_K"], np.float64).reshape(3, 3)
    image = data["colors"]
    depth = data["depth"]
    if len(data["objects"]) != 1:
        raise ValueError(f"{path}: a template render holds {len(data['objects'])} objects, expected 1")
    obj = data["objects"][0]
    mask = object_mask_from_segmap(data["segmap"], data["segcolormap"], obj["obj_id"])

    xyz = depth2xyz(depth, cam_K)
    eroded = binary_erosion(mask)
    pix = np.stack((eroded if eroded.any() else mask).nonzero(), axis=1)
    mask = eroded if eroded.any() else mask

    y1, x1 = pix.min(0)
    y2, x2 = pix.max(0)
    cy, cx = (y1 + y2) // 2, (x1 + x2) // 2
    r = int(max(y2 - y1, x2 - x1, 10) // 2 * 1.1)
    image = robust_crop(image, cy - r, cy + r, cx - r, cx + r)
    xyz = robust_crop(xyz, cy - r, cy + r, cx - r, cx + r)
    maskc = robust_crop(mask.astype(np.float64), cy - r, cy + r, cx - r, cx + r)

    image = (image * maskc[:, :, None]).astype(np.uint8)
    xyz = xyz * maskc[:, :, None]
    image = resize_linear(image, output_size)
    xyz = resize_linear(xyz, output_size)
    maskc = resize_linear(maskc, output_size)
    return {
        "image": image,
        "xyz": xyz.astype(np.float32),
        "mask": maskc.astype(np.float32),
        "obj2cam": obj["obj2cam"],
        "obj_id": obj["obj_id"],
    }


class RenderGridTemplates:
    """Per-object template grid backed by single-object render HDF5 files
    (<render_folder>/<obj_id>/*.hdf5), with rotation metadata for
    closest-rotation selection."""

    def __init__(self, render_folder: str, template_size: int = 124):
        self.render_folder = render_folder
        self.template_size = template_size
        self._cache: dict = {}

    def paths(self, obj_id) -> list[str]:
        return sorted(glob.glob(os.path.join(self.render_folder, str(int(obj_id)), "*.hdf5")))

    def get_all(self, obj_id):
        if obj_id in self._cache:
            return self._cache[obj_id]
        imgs, xyzs, masks, quats = [], [], [], []
        for p in self.paths(obj_id):
            g = process_render_grid(p, output_size=(self.template_size, self.template_size))
            imgs.append(normalize_image(g["image"]))
            xyzs.append(g["xyz"])
            masks.append(g["mask"][..., None])
            quats.append(mat2quat(g["obj2cam"][:3, :3]))
        out = (np.stack(imgs), np.stack(xyzs), np.stack(masks), np.stack(quats))
        self._cache[obj_id] = out
        return out


class DtoidRenderDataset:
    """DTOID offline-pretraining samples from multi-object BlenderProc scenes
    (role of ref datasets/dtoid_dataset.py)."""

    def __init__(self, dataset_mode, scene_paths, templates: RenderGridTemplates, cfg, seed=0):
        self.dataset_mode = dataset_mode
        self.cfg = cfg
        self.templates = templates
        self.rng = np.random.default_rng(seed)
        self.heatmap_scale = cfg.heatmap_shorter_length / float(cfg.shorter_length)

        # flatten (scene_path, obj_id) pairs
        self.datapoints = []
        for p in scene_paths:
            data = load_hdf5(p)
            for obj in data["objects"]:
                if self.templates.paths(obj["obj_id"]):
                    self.datapoints.append((p, obj["obj_id"]))

    def __len__(self):
        return len(self.datapoints)

    def __getitem__(self, idx):
        path, obj_id = self.datapoints[idx]
        data = load_hdf5(path)
        cam_K = np.asarray(data["campose"][0]["cam_K"], np.float64).reshape(3, 3)
        mask = object_mask_from_segmap(data["segmap"], data["segcolormap"], obj_id)
        depth = data["depth"]
        if self.cfg.get("augment_depth", False) and data["normals"] is not None:
            depth = augment_depth_map(depth, data["normals"], rng=self.rng)

        proc = process_data(
            data["colors"].astype(np.uint8), mask.astype(np.float32), depth, cam_K,
            keep_aspect_ratio=self.cfg.keep_aspect_ratio,
            shorter_length=self.cfg.shorter_length,
            compute_xyz=False,
        )
        h, w = proc["mask"].shape[:2]
        ys, xs = proc["mask"][..., 0].nonzero()
        if len(ys):
            x1, x2, y1, y2 = xs.min(), xs.max(), ys.min(), ys.max()
            bbox_gt = np.asarray([[x1, y1, x2, y2, 1]], np.float32)
            cx, cy = (x1 + x2) / 2.0, (y1 + y2) / 2.0
        else:
            bbox_gt = np.asarray([[-1, -1, -1, -1, -1]], np.float32)
            cx = cy = 0.0
        heatmap = heatmap_gaussian(
            h * self.heatmap_scale, w * self.heatmap_scale,
            cx * self.heatmap_scale, cy * self.heatmap_scale,
            sigma=np.sqrt(self.cfg.heatmap_var),
        ).astype(np.float32)[..., None]

        timgs, txyzs, tmasks, tquats = self.templates.get_all(obj_id)
        gv = self.rng.integers(len(timgs))
        gt_quat = mat2quat(
            next(o for o in data["objects"] if o["obj_id"] == obj_id)["obj2cam"][:3, :3]
        )
        if self.dataset_mode == "train":
            diff = quat_angular_diff_batch(tquats, gt_quat[None]).reshape(-1)
            order = diff.argsort()
            lv = self.rng.choice(order[: max(1, self.cfg.get("train_local_template_sample_from", 1))])
            limg, lxyz, lmask = timgs[lv], txyzs[lv], tmasks[lv]
        else:
            n = min(len(timgs), self.cfg.get("n_local_test", 10))
            sel = np.linspace(0, len(timgs) - 1, n).round().astype(int)
            limg, lxyz, lmask = timgs[sel], txyzs[sel], tmasks[sel]

        return {
            "img": proc["img"], "mask": proc["mask"],
            "gimg": timgs[gv], "gxyz": txyzs[gv], "gmask": tmasks[gv],
            "limg": limg, "lxyz": lxyz, "lmask": lmask,
            "bbox_gt": bbox_gt, "heatmap": heatmap,
            "obj_id": int(obj_id),
        }


def _process_render(data: dict, obj_id: int, cfg, **kw) -> dict:
    """process_data of one scene's colours, depth and the object's mask (an
    empty mask where the scene lacks the object), with its XYZ."""
    mask = object_mask_from_segmap(data["segmap"], data["segcolormap"], obj_id)
    return process_data(
        data["colors"].astype(np.uint8),
        (mask if mask is not None else np.zeros(data["depth"].shape, bool)).astype(np.float32),
        data["depth"], np.asarray(data["campose"][0]["cam_K"], np.float64).reshape(3, 3),
        keep_aspect_ratio=cfg.keep_aspect_ratio, shorter_length=cfg.shorter_length, compute_xyz=True, **kw)


class RenderDataset:
    """Few-shot query/support episodes over BlenderProc scenes
    (role of ref datasets/render_dataset.py:84-188)."""

    def __init__(self, dataset_mode, obj2paths: dict, cfg, seed=0):
        self.dataset_mode = dataset_mode
        self.obj2paths = obj2paths
        self.cfg = cfg
        self.rng = np.random.default_rng(seed)
        self.datapoints = [
            (obj_id, p) for obj_id, paths in obj2paths.items() for p in paths
        ]

    def __len__(self):
        return len(self.datapoints)

    def __getitem__(self, idx):
        obj_id, path = self.datapoints[idx]
        proc = _process_render(load_hdf5(path), int(obj_id), self.cfg, crop=self.cfg.get("crop", False))
        # support views: k other renders of the same object
        k = self.cfg.get("k_support", 1)
        others = [p for p in self.obj2paths[obj_id] if p != path] or [path]
        sel = self.rng.choice(len(others), size=min(k, len(others)), replace=False)
        supports = [_process_render(load_hdf5(others[int(si)]), int(obj_id), self.cfg) for si in sel]
        return {
            "img": proc["img"], "mask": proc["mask"], "xyz": proc["xyz"],
            "simg": np.stack([s["img"] for s in supports]),
            "smask": np.stack([s["mask"] for s in supports]),
            "sxyz": np.stack([s["xyz"] for s in supports]),
            "obj_id": int(obj_id),
        }


def get_render_dataloaders(cfg, loader_cls=None):
    """Split objects/images like the reference (ref render_dataset.py:19-82):
    4/6 train objects, 1/6 valid-unseen, 1/6 test; train images 3/4 train,
    1/4 valid-seen."""
    loader_cls = loader_cls or NumpyLoader
    root = cfg.dataset.dataset_root
    with open(os.path.join(root, "object2files.json")) as f:
        obj2fnames = json.load(f)
    object_ids = list(obj2fnames.keys())
    obj2paths = {
        oid: [os.path.join(root, f"{fn}.hdf5") for fn in fns]
        for oid, fns in obj2fnames.items()
    }

    n = len(object_ids)
    train_ids = object_ids[: n // 6 * 4]
    valid_ids = object_ids[n // 6 * 4 : n // 6 * 5]
    test_ids = object_ids[n // 6 * 5 :]

    train_set, valseen_set, valunseen_set, test_set = {}, {}, {}, {}
    for oid in train_ids:
        paths = obj2paths[oid]
        train_set[oid] = paths[: len(paths) // 4 * 3]
        valseen_set[oid] = paths[len(paths) // 4 * 3 :]
    for oid in valid_ids:
        valunseen_set[oid] = obj2paths[oid]
    for oid in test_ids:
        test_set[oid] = obj2paths[oid]

    d = cfg.dataset
    batch = cfg.train.batch_size
    train_loader = loader_cls(RenderDataset("train", train_set, d), batch_size=batch, shuffle=True)
    valseen_loader = loader_cls(RenderDataset("valid", valseen_set, d), batch_size=batch)
    valunseen_loader = loader_cls(RenderDataset("valid", valunseen_set, d), batch_size=batch)
    test_loader = loader_cls(RenderDataset("test", test_set, d), batch_size=batch)
    return train_loader, [valunseen_loader, valseen_loader], test_loader
