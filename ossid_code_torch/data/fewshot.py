"""Legacy few-shot episode datasets (the port of ossid_code_tpu/data/fewshot.py,
without imageio and cv2: JPEGs through utils/jpeg.py, PNGs through
utils/png.py, the resizes of utils/image.py).

  * FewshotBopDataset — query/support episodes per object over a BOP split,
    with the reference's seen/unseen object splits (even/odd object ids on
    YCB-V, LM-vs-LMO containment) and visib_fract filtering
    (ref datasets/fewshot_bop_dataset.py:104-115,245-391);
  * FSS1000Dataset — 1000-class few-shot segmentation episodes over the
    standard FSS-1000 directory layout (ref datasets/fss1000dataset.py:42-115).

Episodes come out index by index as the JAX package's: the same
`np.random.default_rng(seed)` draws in the same order, and the port's
NumpyLoader. FSS images are resized as cv2's INTER_LINEAR within 1 LSB
(`resize_linear`), masks as INTER_NEAREST exactly.
"""

from __future__ import annotations

import glob
import os

import numpy as np

from ossid_code_torch.data.templates import TemplateDataset
from ossid_code_torch.utils.image import normalize_image, process_data, resize_linear, resize_nearest
from ossid_code_torch.utils.jpeg import read_jpeg
from ossid_code_torch.utils.png import read_png


def split_seen_unseen_objects(dataset_name: str, obj_ids):
    """Reference split rules (ref fewshot_bop_dataset.py:108-115): on YCB-V,
    even object ids are seen / odd unseen; else all objects in both."""
    if dataset_name == "ycbv":
        seen = [o for o in obj_ids if o % 2 == 0]
        unseen = [o for o in obj_ids if o % 2 == 1]
    else:
        seen = list(obj_ids)
        unseen = list(obj_ids)
    return seen, unseen


class FewshotBopDataset:
    """Episodes of (query frame, k support templates) for one object."""

    def __init__(self, dataset_mode, obj_ids, bop_dataset, cfg, seed=0):
        self.dataset_mode = dataset_mode
        self.obj_ids = list(obj_ids)
        self.bop_dataset = bop_dataset
        self.cfg = cfg
        self.rng = np.random.default_rng(seed)

        min_visib = cfg.get("min_visib_fract", 0.0)
        self.targets = []
        for t in bop_dataset.targets:
            if t["obj_id"] not in self.obj_ids:
                continue
            if min_visib > 0:
                try:
                    info = bop_dataset.getMetaDataByIds(t["obj_id"], t["scene_id"], t["im_id"])
                    if info.get("visib_fract", 1.0) < min_visib:
                        continue
                except (KeyError, FileNotFoundError):
                    pass
            self.targets.append(t)

        self.template_dataset = TemplateDataset(
            cfg.grid_root, self.obj_ids,
            use_provided_template=cfg.get("use_provided_template", False),
        )

    def __len__(self):
        return len(self.targets)

    def __getitem__(self, idx):
        t = self.targets[idx]
        data = self.bop_dataset.getDataByIds(t["obj_id"], t["scene_id"], t["im_id"])
        mask = np.asarray(data["mask_gt_visib"]).astype(np.float32) / 255.0
        proc = process_data(
            data["img"], mask, data["depth"],
            np.asarray(data["scene_camera"]["cam_K"]),
            keep_aspect_ratio=self.cfg.keep_aspect_ratio,
            shorter_length=self.cfg.shorter_length,
            compute_xyz=False,
        )
        k = self.cfg.get("k_support", 1)
        vids = self.rng.choice(self.template_dataset.view_ids, size=k, replace=False)
        supports = [self.template_dataset.getTemplate(t["obj_id"], v) for v in vids]
        return {
            "img": proc["img"],
            "mask": proc["mask"],
            "simg": np.stack([s[0] for s in supports]),
            "sxyz": np.stack([s[1] for s in supports]),
            "smask": np.stack([s[2] for s in supports]),
            "obj_id": int(t["obj_id"]),
            "scene_id": int(t["scene_id"]),
            "im_id": int(t["im_id"]),
        }


def get_fewshot_dataloaders(cfg):
    """(train, valid, test) loaders of few-shot BOP episodes for the train CLI
    (ref datasets/__init__.py:7-9 dispatches fewshot_bop to
    fewshot_bop_dataset.getDataloaders): train on seen objects, validate and
    test on unseen ones (ref fewshot_bop_dataset.py:108-115)."""
    from ossid_code_torch.data.bop import BopDataset, BopDatasetArgs
    from ossid_code_torch.data.dtoid_bop import NumpyLoader

    d = cfg.dataset
    name = d.get("train_dataset_name") or d.test_dataset_name
    bop = BopDataset(BopDatasetArgs(
        bop_root=d.bop_root, dataset_name=name,
        split_name=d.get("split_name", "bop_test"), split=d.get("split", "test"),
    ))
    seen, unseen = split_seen_unseen_objects(name, bop.obj_ids)
    train_ds = FewshotBopDataset("train", seen, bop, d, seed=0)
    valid_ds = FewshotBopDataset("valid", unseen, bop, d, seed=1)
    test_ds = FewshotBopDataset("test", unseen, bop, d, seed=2)
    b = int(cfg.train.batch_size)
    return (
        NumpyLoader(train_ds, batch_size=b, shuffle=True, drop_last=True),
        NumpyLoader(valid_ds, batch_size=b, drop_last=True),
        NumpyLoader(test_ds, batch_size=1),
    )


def get_fss1000_dataloaders(cfg):
    """(train, valid, test) loaders over an FSS-1000 checkout
    (ref datasets/fss1000dataset.py): classes split 80/20 train/valid."""
    from ossid_code_torch.data.dtoid_bop import NumpyLoader

    d = cfg.dataset
    root = d.get("dataset_root")
    if not root or not os.path.isdir(root):
        raise SystemExit(
            "dataset=fss_1000 needs dataset.dataset_root pointing at an "
            "FSS-1000 checkout (<root>/<class>/{i.jpg,i.png})"
        )
    classes = sorted(c for c in os.listdir(root) if os.path.isdir(os.path.join(root, c)))
    n_train = max(int(0.8 * len(classes)), 1)
    kw = dict(k_shot=int(d.get("k_shot", 1)), image_size=int(d.get("image_size", 224)))
    train_ds = FSS1000Dataset(root, classes[:n_train], seed=0, **kw)
    valid_ds = FSS1000Dataset(root, classes[n_train:] or classes[:1], seed=1, **kw)
    b = int(cfg.train.batch_size)
    return (
        NumpyLoader(train_ds, batch_size=b, shuffle=True, drop_last=True),
        NumpyLoader(valid_ds, batch_size=b, drop_last=True),
        NumpyLoader(valid_ds, batch_size=1),
    )


class FSS1000Dataset:
    """FSS-1000 few-shot segmentation episodes: <root>/<class>/{i.jpg, i.png}."""

    def __init__(self, root: str, classes=None, k_shot: int = 1, image_size: int = 224, seed=0):
        self.root = root
        self.k_shot = k_shot
        self.image_size = image_size
        self.rng = np.random.default_rng(seed)
        self.classes = classes or sorted(
            d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d))
        )
        self.samples = []
        for c in self.classes:
            imgs = sorted(glob.glob(os.path.join(root, c, "*.jpg")))
            for p in imgs:
                self.samples.append((c, p))

    def __len__(self):
        return len(self.samples)

    def _load(self, img_path):
        img = read_jpeg(img_path)[..., :3]
        mask = read_png(img_path[:-4] + ".png")
        if mask.ndim == 3:
            mask = mask[..., 0]
        mask = (mask > 127).astype(np.float32)
        s = self.image_size
        img = resize_linear(img, (s, s))
        mask = resize_nearest(mask, (s, s))
        return normalize_image(img), mask[..., None]

    def __getitem__(self, idx):
        cls, qpath = self.samples[idx]
        img, mask = self._load(qpath)
        pool = [p for c, p in self.samples if c == cls and p != qpath] or [qpath]
        sel = self.rng.choice(len(pool), size=min(self.k_shot, len(pool)), replace=False)
        sup = [self._load(pool[int(i)]) for i in sel]
        return {
            "img": img, "mask": mask,
            "simg": np.stack([s[0] for s in sup]),
            "smask": np.stack([s[1] for s in sup]),
            "class_name": cls,
        }
