"""BOP disk-format reader (host-side, numpy; the port's copy of
ossid_code_tpu/data/bop.py, reading PNGs with utils/png.py).

Replaces `zephyr.utils.bop_dataset.BopDataset` (SURVEY.md Z4), whose interface
the reference uses everywhere (ref scripts/online_learning.py:231-244,296-334;
datasets/dtoid_bop_dataset.py:52,257). Reads the standard BOP layout:

  <bop_root>/<dataset>/
    camera.json                      (or camera_*.json)
    test_targets_bop19.json          (targets for split_name='bop_test')
    models/models_info.json, obj_%06d.ply
    <split>/<scene:06d>/
      scene_camera.json, scene_gt.json, scene_gt_info.json
      rgb/%06d.png  depth/%06d.png  mask/%06d_%06d.png  mask_visib/%06d_%06d.png

Depth pngs are converted to meters via scene_camera depth_scale (mm * scale).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass

import numpy as np

from ossid_code_torch.utils.png import read_png


@dataclass
class BopDatasetArgs:
    bop_root: str
    dataset_name: str
    split_name: str = "bop_test"
    split: str = "test"
    split_type: str | None = None
    model_type: str | None = None
    ppf_results_file: str | None = None
    skip: int = 1
    # decoded-frame LRU capacity: size it to the finetune buffer so the online
    # loop's finetune pass re-uses the stream's decodes instead of re-decoding
    # every buffered PNG on the single host core (~30 ms each)
    cache_frames: int = 4


class BopDataset:
    def __init__(self, args):
        self.bop_root = args.bop_root
        self.dataset_name = args.dataset_name
        self.split_name = getattr(args, "split_name", "bop_test")
        self.split = getattr(args, "split", "test")
        self.skip = getattr(args, "skip", 1) or 1

        self.dataset_root = os.path.join(self.bop_root, self.dataset_name)
        self.split_dir = os.path.join(self.dataset_root, self.split)
        self.model_dir = os.path.join(self.dataset_root, "models")
        self.model_tpath = os.path.join(self.model_dir, "obj_{obj_id:06d}.ply")

        with open(os.path.join(self.model_dir, "models_info.json")) as f:
            self.models_info = {int(k): v for k, v in json.load(f).items()}
        self.obj_ids = sorted(self.models_info.keys())
        self.sym_obj_ids = [
            oid
            for oid, info in self.models_info.items()
            if "symmetries_discrete" in info or "symmetries_continuous" in info
        ]

        cam_path = os.path.join(self.dataset_root, "camera.json")
        if not os.path.exists(cam_path):
            cands = [p for p in os.listdir(self.dataset_root) if p.startswith("camera")]
            cam_path = os.path.join(self.dataset_root, sorted(cands)[0])
        with open(cam_path) as f:
            cam = json.load(f)
        self.dataset_camera = dict(cam)
        self.dataset_camera["K"] = np.array(
            [[cam["fx"], 0, cam["cx"]], [0, cam["fy"], cam["cy"]], [0, 0, 1]]
        )

        self.targets = self._load_targets()
        if self.skip > 1:
            self.targets = self.targets[:: self.skip]

        self._scene_cache: dict = {}
        # tiny LRU over full frames: the online loop touches the same
        # (obj, scene, im) through both its dataset and its raw reader, and
        # PNG decode is ~30ms/frame on one host core. The loop's IO prefetch
        # thread inserts concurrently, so all cache access is lock-guarded.
        import threading

        self._data_cache: dict = {}
        self._data_cache_cap = int(getattr(args, "cache_frames", 4) or 4)
        self._data_cache_lock = threading.Lock()

    # ------------------------------------------------------------ targets
    def _load_targets(self):
        if self.split_name == "bop_test":
            tpath = os.path.join(self.dataset_root, "test_targets_bop19.json")
            with open(tpath) as f:
                raw = json.load(f)
            return [
                {
                    "obj_id": int(t["obj_id"]),
                    "scene_id": int(t["scene_id"]),
                    "im_id": int(t["im_id"]),
                    "inst_count": int(t.get("inst_count", 1)),
                }
                for t in raw
            ]
        # enumerate every GT instance of every frame in the split
        targets = []
        for scene_id in self._scene_ids():
            gt = self._scene_json(scene_id, "scene_gt.json")
            for im_id, instances in sorted((int(k), v) for k, v in gt.items()):
                counts: dict[int, int] = {}
                for inst in instances:
                    counts[int(inst["obj_id"])] = counts.get(int(inst["obj_id"]), 0) + 1
                for obj_id, cnt in sorted(counts.items()):
                    targets.append(
                        {"obj_id": obj_id, "scene_id": scene_id, "im_id": im_id, "inst_count": cnt}
                    )
        return targets

    def _scene_ids(self):
        return sorted(
            int(d) for d in os.listdir(self.split_dir)
            if os.path.isdir(os.path.join(self.split_dir, d)) and d.isdigit()
        )

    def _scene_json(self, scene_id: int, name: str):
        key = (scene_id, name)
        if key not in self._scene_cache:
            with open(os.path.join(self.split_dir, f"{scene_id:06d}", name)) as f:
                self._scene_cache[key] = json.load(f)
        return self._scene_cache[key]

    # ------------------------------------------------------------- access
    def __len__(self):
        return len(self.targets)

    def __getitem__(self, idx):
        t = self.targets[idx]
        return self.getDataByIds(t["obj_id"], t["scene_id"], t["im_id"])

    def getObjPath(self, obj_id: int) -> str:
        return self.model_tpath.format(obj_id=obj_id)

    def _gt_index(self, scene_id: int, im_id: int, obj_id: int) -> int:
        gt = self._scene_json(scene_id, "scene_gt.json")[str(im_id)]
        for gi, inst in enumerate(gt):
            if int(inst["obj_id"]) == int(obj_id):
                return gi
        raise KeyError(f"obj {obj_id} not in scene {scene_id} im {im_id}")

    def getDataByIds(self, obj_id: int, scene_id: int, im_id: int) -> dict:
        key = (int(obj_id), int(scene_id), int(im_id))
        with self._data_cache_lock:
            if key in self._data_cache:
                return self._data_cache[key]
        data = self._read_data(obj_id, scene_id, im_id)
        with self._data_cache_lock:
            if len(self._data_cache) >= self._data_cache_cap:
                self._data_cache.pop(next(iter(self._data_cache)), None)
            self._data_cache[key] = data
        return data

    def _read_data(self, obj_id: int, scene_id: int, im_id: int) -> dict:
        scene_dir = os.path.join(self.split_dir, f"{scene_id:06d}")
        cam = self._scene_json(scene_id, "scene_camera.json")[str(im_id)]
        img = read_png(os.path.join(scene_dir, "rgb", f"{im_id:06d}.png"))
        if img.ndim == 2:
            img = np.stack([img] * 3, -1)
        img = img[..., :3]
        depth_raw = read_png(os.path.join(scene_dir, "depth", f"{im_id:06d}.png"))
        depth_raw = np.asarray(depth_raw).astype(np.float32)
        depth = depth_raw * float(cam.get("depth_scale", 1.0)) / 1000.0  # -> meters

        gi = self._gt_index(scene_id, im_id, obj_id)
        gt = self._scene_json(scene_id, "scene_gt.json")[str(im_id)][gi]
        mat_gt = np.eye(4)
        mat_gt[:3, :3] = np.asarray(gt["cam_R_m2c"], np.float64).reshape(3, 3)
        mat_gt[:3, 3] = np.asarray(gt["cam_t_m2c"], np.float64) / 1000.0  # mm -> m

        mask = read_png(os.path.join(scene_dir, "mask", f"{im_id:06d}_{gi:06d}.png"))
        mask_visib = read_png(os.path.join(scene_dir, "mask_visib", f"{im_id:06d}_{gi:06d}.png"))

        cam_K = np.asarray(cam["cam_K"], np.float64).reshape(3, 3)
        scene_meta = {
            "camera_fx": cam_K[0, 0],
            "camera_fy": cam_K[1, 1],
            "camera_cx": cam_K[0, 2],
            "camera_cy": cam_K[1, 2],
            "camera_scale": 1.0,
        }
        return {
            "obj_id": int(obj_id),
            "scene_id": int(scene_id),
            "im_id": int(im_id),
            "img": img,
            "depth": depth,
            "scene_camera": {"cam_K": cam_K, **{k: v for k, v in cam.items() if k != "cam_K"}},
            "scene_meta": scene_meta,
            "mat_gt": mat_gt,
            "mask_gt": mask,
            "mask_gt_visib": mask_visib,
        }
