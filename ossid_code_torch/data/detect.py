"""Per-frame multi-object detection data for the class-conditional detector
(the port of ossid_code_tpu/data/detect.py).

Each sample is one frame of a BOP split with a box, a label and a mask for
every annotated object, class index obj_id - 1. Labels come from the scorer's
pseudo-labels (`pred_mask_visib` of a results pickle) where one exists for
the target, else from the ground truth; `confidences` holds the pseudo-label
score (1.0 for ground truth) of each class. Masks that are not at the
processed frame's size are resized nearest-neighbour as cv2 does
(utils/image.py::resize_nearest).
"""

from __future__ import annotations

import pickle

import numpy as np

from ossid_code_torch.utils.image import process_data, resize_nearest


def get_detect_dataloaders(cfg):
    """(train, valid, test) loaders of the train CLI's `dataset=detect`:
    frames split 80/20 by index (every fifth frame validates; at least one
    does), the test loader over all frames."""
    from ossid_code_torch.data.bop import BopDataset, BopDatasetArgs
    from ossid_code_torch.data.dtoid_bop import NumpyLoader

    d = cfg.dataset
    bop = BopDataset(BopDatasetArgs(
        bop_root=d.bop_root, dataset_name=d.get("train_dataset_name") or d.test_dataset_name,
        split_name=d.get("split_name", "bop_test"), split=d.get("split", "test"),
    ))
    zephyr_results = None
    if d.get("load_zephyr_result") and d.get("zephyr_result_path"):
        with open(d.zephyr_result_path, "rb") as f:
            zephyr_results = {(r["obj_id"], r["scene_id"], r["im_id"]): r for r in pickle.load(f)}

    full = DetectDataset(bop, d, zephyr_results)
    train_ds = DetectDataset(bop, d, zephyr_results)
    valid_ds = DetectDataset(bop, d, zephyr_results)
    train_ds.frames = [f for i, f in enumerate(full.frames) if i % 5 != 4]
    valid_ds.frames = [f for i, f in enumerate(full.frames) if i % 5 == 4] or full.frames[:1]
    b = int(cfg.train.batch_size)
    return (NumpyLoader(train_ds, batch_size=b, shuffle=True, drop_last=True),
            NumpyLoader(valid_ds, batch_size=b, drop_last=True),
            NumpyLoader(full, batch_size=1))


class DetectDataset:
    """Frames of `bop_dataset`, grouped by (scene_id, im_id) in sorted order."""

    def __init__(self, bop_dataset, cfg, zephyr_results: dict | None = None):
        self.bop_dataset = bop_dataset
        self.cfg = cfg
        self.zephyr_results = zephyr_results
        self.n_classes = int(cfg.n_classes)
        frames: dict = {}
        for t in bop_dataset.targets:
            frames.setdefault((t["scene_id"], t["im_id"]), []).append(t["obj_id"])
        self.frames = sorted(frames.items())

    def __len__(self):
        return len(self.frames)

    def __getitem__(self, idx):
        """'img' (H, W, 3) in [0, 1], 'bbox_gt' (max_objects, 5) with -1 rows
        as padding, 'masks' (H, W, n_classes), 'labels' (max_objects,) object
        ids (0 as padding), 'confidences' (n_classes,), 'scene_id', 'im_id'."""
        (scene_id, im_id), obj_ids = self.frames[idx]
        boxes, labels = [], []
        proc = masks_by_class = None
        confidences = np.zeros(self.n_classes, np.float32)
        for obj_id in obj_ids:
            data = self.bop_dataset.getDataByIds(obj_id, scene_id, im_id)
            if proc is None:
                proc = process_data(data["img"], np.zeros(data["depth"].shape, np.float32), data["depth"],
                                    np.asarray(data["scene_camera"]["cam_K"]),
                                    keep_aspect_ratio=self.cfg.keep_aspect_ratio,
                                    shorter_length=self.cfg.shorter_length, compute_xyz=False)
                h, w = proc["mask"].shape[:2]
                masks_by_class = np.zeros((h, w, self.n_classes), np.float32)
            zr = None if self.zephyr_results is None else self.zephyr_results.get((obj_id, scene_id, im_id))
            if zr is not None:
                mask = np.asarray(zr["pred_mask_visib"]).astype(np.float32)
                confidences[obj_id - 1] = zr.get("score", 0.0)
            else:
                mask = np.asarray(data["mask_gt_visib"]).astype(np.float32) / 255.0
                confidences[obj_id - 1] = 1.0
            if mask.shape != (h, w):
                mask = resize_nearest(mask, (w, h))
            ys, xs = (mask > 0.5).nonzero()
            if len(ys) == 0:
                continue
            boxes.append([xs.min(), ys.min(), xs.max(), ys.max(), obj_id - 1])
            labels.append(obj_id)
            masks_by_class[..., obj_id - 1] = np.maximum(masks_by_class[..., obj_id - 1],
                                                         (mask > 0.5).astype(np.float32))

        max_obj = self.cfg.get("max_objects", 8)
        bbox_gt = -np.ones((max_obj, 5), np.float32)
        for i, b in enumerate(boxes[:max_obj]):
            bbox_gt[i] = b
        labels = labels[:max_obj]
        return {
            "img": proc["img"],
            "bbox_gt": bbox_gt,
            "masks": masks_by_class,
            "labels": np.asarray(labels + [0] * (max_obj - len(labels))),
            "confidences": confidences,
            "scene_id": scene_id,
            "im_id": im_id,
        }
