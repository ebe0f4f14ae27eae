"""DtoidBopDataset: the online-loop train/test dataset.

Counterpart of ref datasets/dtoid_bop_dataset.py:171-339 — serves (query
image, GT-or-pseudo mask, bbox, Gaussian heatmap, global + local templates)
from a BOP dataset, with the mutable-target API the online loop drives:
`clearTargets` / `addTarget` / `updateZephyrMask` (pseudo-label injection) /
`sortTargets`.

Host-side numpy with HWC layout (the port's copy of
ossid_code_tpu/data/dtoid_bop.py, without cv2); batches are plain dicts of stacked numpy
arrays produced by `NumpyLoader` (replacing the torch DataLoader + collate_fn
of ref datasets/utils.py:35-46).
"""

from __future__ import annotations

import copy

import numpy as np

from ossid_code_torch.utils.geometry import (
    meta2K,
    quat_angular_diff_batch,
    heatmap_gaussian,
    mat2quat,
)
from ossid_code_torch.utils.image import process_data, resize_nearest
from ossid_code_torch.data.templates import TemplateDataset
from ossid_code_torch.data.bop import BopDataset, BopDatasetArgs

# BOP object-id offsets for shared template-grid directories
# (ref utils/constants.py BOP_OBJECT_ID_OFFSETS)
BOP_OBJECT_ID_OFFSETS = {
    "hb": 100, "icbin": 200, "icmi": 300, "itodd": 400, "lm": 500, "lmo": 500,
    "ruapc": 700, "tless": 800, "tudl": 900, "tyol": 1000, "ycbv": 1100,
    "synth": 0,
}


class DtoidBopDataset:
    def __init__(self, dataset_mode, obj_ids, bop_dataset, cfg, zephyr_results=None, seed=42):
        self.dataset_mode = dataset_mode
        self.obj_ids = list(obj_ids)
        # shallow copy with an independent target list: targets are mutated by
        # the online loop, but the frame/scene caches stay shared so the same
        # PNG is never decoded twice per frame (the reference deep-copies,
        # ref dtoid_bop_dataset.py:176)
        self.bop_dataset = copy.copy(bop_dataset)
        self.bop_dataset.targets = [dict(t) for t in bop_dataset.targets]
        self.dataset_name = self.bop_dataset.dataset_name
        self.cfg = cfg
        self.heatmap_scale = cfg.heatmap_shorter_length / float(cfg.shorter_length)
        self.rng = np.random.default_rng(seed)

        self.template_dataset = TemplateDataset(
            cfg.grid_root,
            self.obj_ids,
            preload=dataset_mode == "test",
            obj_id_offset=BOP_OBJECT_ID_OFFSETS.get(self.dataset_name, 0),
            use_provided_template=cfg.use_provided_template,
        )

        # processed-frame LRU (resize/normalize output, pre-pseudo-label):
        # the finetune pass revisits the same buffered frames every interval,
        # and process_data costs ~15-25 ms/frame on the single host core
        self._proc_cache: dict = {}
        self._proc_cache_cap = int(cfg.get("proc_cache_frames", 48) or 0)

        if zephyr_results is not None:
            self.zephyr_results = {
                (zr["obj_id"], zr["scene_id"], zr["im_id"]): zr for zr in zephyr_results
            }
            self.bop_dataset.targets = [
                {"obj_id": zr["obj_id"], "scene_id": zr["scene_id"],
                 "im_id": zr["im_id"], "inst_count": 1}
                for zr in zephyr_results
            ]
        else:
            self.zephyr_results = None

    # ----- mutable-target API (ref dtoid_bop_dataset.py:206-235) -----------
    def clearTargets(self):
        self.bop_dataset.targets = []

    def sortTargets(self, reverse: bool = False):
        self.bop_dataset.targets.sort(
            reverse=reverse, key=lambda x: (x["scene_id"], x["im_id"], x["obj_id"])
        )

    def addTarget(self, obj_id, scene_id, im_id, mask=None, score=None):
        self.bop_dataset.targets.append(
            {"obj_id": obj_id, "scene_id": scene_id, "im_id": im_id, "inst_count": 1}
        )

    def updateZephyrMask(self, obj_id, scene_id, im_id, mask, score):
        if self.zephyr_results is None:
            self.zephyr_results = {}
        key = (obj_id, scene_id, im_id)
        entry = self.zephyr_results.setdefault(
            key, {"obj_id": obj_id, "scene_id": scene_id, "im_id": im_id}
        )
        entry["pred_mask_visib"] = mask
        entry["score"] = score

    def __len__(self):
        return len(self.bop_dataset)

    # -------------------------------------------------- sample construction
    def _bbox_heatmap(self, mask_hw: np.ndarray):
        """Annotation bbox + Gaussian center heatmap from a (pseudo-)label
        mask at processed resolution (ref dtoid_bop_dataset.py:276-289)."""
        h, w = mask_hw.shape
        ys, xs = mask_hw.nonzero()
        if len(ys) == 0:
            # degenerate pseudo-label; mark invalid with a padding annotation
            bbox_gt = np.asarray([[-1, -1, -1, -1, -1]], np.float32)
            cx = cy = 0.0
        else:
            x1, x2 = xs.min(), xs.max()
            y1, y2 = ys.min(), ys.max()
            bbox_gt = np.asarray([[x1, y1, x2, y2, 1]], np.float32)
            cx, cy = (x1 + x2) / 2.0, (y1 + y2) / 2.0
        heatmap = heatmap_gaussian(
            h * self.heatmap_scale, w * self.heatmap_scale,
            cx * self.heatmap_scale, cy * self.heatmap_scale,
            sigma=np.sqrt(self.cfg.heatmap_var),
        ).astype(np.float32)[..., None]
        return bbox_gt, heatmap

    def _sample_local_template(self, obj_id, mat_gt):
        """Local template nearest the GT rotation, sampled among top-k
        (ref dtoid_bop_dataset.py:294-304). argsort yields POSITIONS into
        grid_quats, not literal view ids."""
        gt_quat = mat2quat(mat_gt[:3, :3])
        diff = quat_angular_diff_batch(self.template_dataset.grid_quats, gt_quat[None])
        order = diff.reshape(-1).argsort()
        lpos = self.rng.choice(order[: self.cfg.train_local_template_sample_from])
        return self.template_dataset.getTemplateByPos(obj_id, lpos)

    def replay_annotations(self, obj_id, mat_gt, mask) -> dict:
        """The small (non-frame) half of one finetune sample, for the
        device-resident replay path (loop/replay.py): uint8 templates +
        bbox/heatmap from the stored pseudo-label. Bit-exact vs __getitem__'s
        f32 arrays: template images are u8 PNG decodes /255 (u8 round-trip is
        lossless) and the masks are 0/1. Draw order (global view first, then
        local position) matches __getitem__ so a given rng state samples the
        same templates either way."""
        m = np.asarray(mask)
        if m.ndim == 3:
            m = m[..., 0]
        bbox_gt, heatmap = self._bbox_heatmap(m.astype(np.float32))
        gvid = self.rng.choice(self.template_dataset.view_ids)
        gimg, _, gmask = self.template_dataset.getTemplate(obj_id, gvid)
        limg, _, lmask = self._sample_local_template(obj_id, mat_gt)
        return {
            "limg_u8": (limg * 255.0).round().astype(np.uint8),
            "lmask_u8": lmask.astype(np.uint8),
            "gimg_u8": (gimg * 255.0).round().astype(np.uint8),
            "gmask_u8": gmask.astype(np.uint8),
            "bbox_gt": bbox_gt,
            "heatmap": heatmap,
        }

    # ------------------------------------------------------------- loading
    def __getitem__(self, idx):
        bop_data = self.bop_dataset[idx]
        obj_id = bop_data["obj_id"]
        scene_id = bop_data["scene_id"]
        im_id = bop_data["im_id"]

        pkey = (int(obj_id), int(scene_id), int(im_id))
        cached = self._proc_cache.get(pkey)
        if cached is None:
            img = np.asarray(bop_data["img"])
            mask = np.asarray(bop_data["mask_gt_visib"]).astype(np.float32) / 255.0
            depth = np.asarray(bop_data["depth"])
            cam_K = meta2K(bop_data["scene_meta"])

            data = process_data(
                img, mask, depth, cam_K,
                keep_aspect_ratio=self.cfg.keep_aspect_ratio,
                shorter_length=self.cfg.shorter_length,
                compute_xyz=bool(self.cfg.get("need_xyz", False)),
            )
            cached = (data["img"], data["mask"], data["xyz"])
            if self._proc_cache_cap:
                if len(self._proc_cache) >= self._proc_cache_cap:
                    self._proc_cache.pop(next(iter(self._proc_cache)))
                self._proc_cache[pkey] = cached
        img_p, mask_p, xyz_p = cached
        h, w = mask_p.shape[:2]

        zr = None
        if self.zephyr_results is not None:
            # pseudo-label mask from pose verification (ref :268-271)
            zr = self.zephyr_results[(obj_id, scene_id, im_id)]
            zmask = np.asarray(zr["pred_mask_visib"]).astype(np.float32)
            if zmask.shape != (h, w):
                zmask = resize_nearest(zmask, (w, h))
            mask_p = zmask[..., None]

        bbox_gt, heatmap = self._bbox_heatmap(mask_p[..., 0])

        # global template: random view (ref :291-292)
        gvid = self.rng.choice(self.template_dataset.view_ids)
        gimg, gxyz, gmask = self.template_dataset.getTemplate(obj_id, gvid)

        if self.dataset_mode == "train":
            limg, lxyz, lmask = self._sample_local_template(obj_id, bop_data["mat_gt"])
        elif self.dataset_mode in ("test", "valid"):
            limg, lxyz, lmask = self.template_dataset.getTemplatesAll(obj_id)
            if len(limg) > self.cfg.n_local_test:
                lvids = np.linspace(0, len(limg) - 1, self.cfg.n_local_test).round().astype(int)
                limg, lxyz, lmask = limg[lvids], lxyz[lvids], lmask[lvids]
        else:
            raise ValueError(f"unknown dataset_mode {self.dataset_mode}")

        out = {
            "img": img_p, "xyz": xyz_p, "mask": mask_p,
            "gimg": gimg, "gxyz": gxyz, "gmask": gmask,
            "limg": limg, "lxyz": lxyz, "lmask": lmask,
            "bbox_gt": bbox_gt, "heatmap": heatmap,
            "obj_id": int(obj_id), "scene_id": int(scene_id), "im_id": int(im_id),
        }
        if zr is not None and "score" in zr:
            out["zephyr_score"] = zr["score"]
        if self.template_dataset.use_provided_template and self.dataset_mode == "test":
            out["template_z_values"] = self.template_dataset.template_z_values
        return out


def collate(batch: list[dict]) -> dict:
    out = {}
    for k in batch[0]:
        vals = [b[k] for b in batch]
        if vals[0] is None:
            out[k] = None
        elif isinstance(vals[0], np.ndarray):
            out[k] = np.stack(vals, 0)
        else:
            out[k] = np.asarray(vals)
    return out


class NumpyLoader:
    """Minimal batching iterator over a map-style dataset.

    With prefetch > 0, a background thread stays `prefetch` batches ahead —
    PNG decode and preprocessing overlap the consumer's device time (this
    replaces the reference's torch DataLoader worker processes,
    ref dtoid_bop_dataset.py:144).

    ttt_sampling repeats the SAME index batch_size times per batch —
    test-time-training batches (ref datasets/utils.py TTTBatchSampler:64-86)."""

    def __init__(self, dataset, batch_size=1, shuffle=False, drop_last=False, seed=0,
                 prefetch: int = 0, ttt_sampling: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.ttt_sampling = ttt_sampling
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        n = len(self.dataset)
        if self.ttt_sampling:
            return n
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _chunks(self):
        idxs = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(idxs)
        if self.ttt_sampling:
            for i in idxs:
                yield np.full(self.batch_size, i)
            return
        for start in range(0, len(idxs), self.batch_size):
            chunk = idxs[start : start + self.batch_size]
            if self.drop_last and len(chunk) < self.batch_size:
                return
            yield chunk

    def __iter__(self):
        if self.prefetch <= 0:
            for chunk in self._chunks():
                yield collate([self.dataset[int(i)] for i in chunk])
            return

        import queue
        import threading

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        _END = object()

        def worker():
            try:
                for chunk in self._chunks():
                    q.put(collate([self.dataset[int(i)] for i in chunk]))
            except BaseException as e:  # surface loader errors to the consumer
                q.put(e)
            q.put(_END)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is _END:
                return
            if isinstance(item, BaseException):
                raise item
            yield item


def sort_target_by_image(targets):
    """Group target object ids per (scene, image) (ref datasets/utils.py:88)."""
    out: dict = {}
    for t in targets:
        out.setdefault((t["scene_id"], t["im_id"]), []).append(t["obj_id"])
    return out


def load_process_zephyr_results(cfg, zephyr_results):
    """Filter/sort/split precomputed zephyr results (ref datasets/utils.py:6-33)."""
    if cfg.zephyr_filter_key is not None and cfg.zephyr_filter_threshold is not None:
        zephyr_results = [
            r for r in zephyr_results if r[cfg.zephyr_filter_key] > cfg.zephyr_filter_threshold
        ]
    zephyr_results = sorted(zephyr_results, key=lambda x: (x["scene_id"], x["im_id"]))
    if cfg.zephyr_results_percent < 1:
        zephyr_results = zephyr_results[: round(cfg.zephyr_results_percent * len(zephyr_results))]
    train = [r for i, r in enumerate(zephyr_results) if i % 5 != 4]
    valid = [r for i, r in enumerate(zephyr_results) if i % 5 == 4]
    return train, valid


def get_dataloaders(cfg, zephyr_results=None):
    """Build (train_loader, valid_loader, test_loader) over a BOP test split
    (ref datasets/dtoid_bop_dataset.py:21-169; only the train==test dataset
    path used by the online loop is supported here)."""
    d = cfg.dataset
    args = BopDatasetArgs(
        bop_root=d.bop_root, dataset_name=d.test_dataset_name,
        split_name=d.get("split_name", "bop_test"), split=d.get("split", "test"),
        cache_frames=int(d.get("cache_frames", 4) or 4),
    )
    test_bop = BopDataset(args)
    objects = test_bop.obj_ids

    if zephyr_results is None and d.load_zephyr_result and d.zephyr_result_path:
        import pickle

        with open(d.zephyr_result_path, "rb") as f:
            zephyr_results = pickle.load(f)

    if zephyr_results is not None:
        zr_train, zr_valid = load_process_zephyr_results(d, zephyr_results)
    else:
        zr_train, zr_valid = None, None

    train_ds = DtoidBopDataset("train", objects, test_bop, d, zr_train)
    valid_ds = DtoidBopDataset("valid", objects, test_bop, d, zr_valid)
    test_ds = DtoidBopDataset("test", objects, test_bop, d)

    train_loader = NumpyLoader(
        train_ds, batch_size=cfg.train.batch_size, shuffle=True, drop_last=True,
        ttt_sampling=bool(d.get("ttt_sampling", False)),
    )
    valid_loader = NumpyLoader(valid_ds, batch_size=1)
    test_loader = NumpyLoader(test_ds, batch_size=1, prefetch=1)
    return train_loader, valid_loader, test_loader
