"""DtoidModel: the host-side DTOID wrapper (counterpart of
ossid_code_tpu/models/dtoid/module.py).

It holds the network, the anchor grid, the finetune optimizer and a
per-object template-feature cache that stays on the device. `detect_async`
launches the whole serving path for one frame (CUDA launches return before
the device finishes); `fetch_detections` copies the results to the host and
builds the reference-schema dict. `train_step` / `train_step_u8` run one
finetune step (forward in train mode, `dtoid_losses`, backward, the
optax-rule optimizer of core/optim.py).

The JAX package's two bf16 switches, read the same way (`cfg.model.get(...,
False)`):
  * `bf16_finetune`: the mixed-precision step (JAX `train_step_mp`). The
    network runs on bf16 casts of the float32 parameters (gradients flow
    back through the casts into the float32 masters), on bf16 inputs, with
    the running statistics updated in float32 by flax's bf16 rule
    (models/batchnorm.py); the losses run on float32 upcasts of the outputs
    and the optimizer in float32.
  * `bf16_infer`: detection in bf16 on a cast of the weights that is kept
    on the device and refreshed when `weights_version` changes (JAX
    `_infer_vars`); template features are computed and cached in float32
    from the float32 weights and cast for each detect.
"""

from __future__ import annotations

import copy
from typing import Any

import numpy as np
import torch

from ossid_code_torch.core.optim import make_optimizer
from ossid_code_torch.device import resolve_device
from ossid_code_torch.models.dtoid.anchors import generate_anchor_grid
from ossid_code_torch.models.dtoid.losses import dtoid_losses
from ossid_code_torch.models.dtoid.network import DtoidNetwork, imagenet_normalize


class DtoidModel:
    """Network weights + template cache; runs on `device` (None -> cuda)."""

    def __init__(self, cfg, seed: int = 42, device: str | torch.device | None = None):
        self.device = resolve_device(device)
        self.cfg = cfg
        m = cfg.model
        self.img_size = (int(m.img_h), int(m.img_w))
        self.feat_size = (int(m.img_h) // 16 - 1, int(m.img_w) // 16 - 1)
        self.pre_nms_topk = int(m.get("topk_pre_nms", 1000))
        self.nms_iou = float(m.nms_iou_thresh)
        self._pack_seg = str(m.get("seg_transfer", "packed")) == "packed"

        self.bf16_finetune = bool(m.get("bf16_finetune", False))
        self.bf16_infer = bool(m.get("bf16_infer", False))
        self.net = DtoidNetwork(self.img_size, tuple(m.get("densenet_blocks", (12, 24, 16))))
        self.net.reset_parameters(torch.Generator().manual_seed(seed))
        self.net.to(device=self.device, memory_format=torch.channels_last).eval()
        self.anchors = torch.from_numpy(generate_anchor_grid(*self.feat_size)).to(self.device)
        self.optimizer = make_optimizer(self.net.parameters(), m.learning_rate, m.weight_decay)

        # per-object template features, device-resident
        self.template_feature_cache: dict[Any, tuple] = {}
        # bumped on every weight change
        self.weights_version = 0
        self._bf16_cache = None  # (weights_version, bf16 copy of the network)

    # ------------------------------------------------------------- weights
    def state_dict(self) -> dict:
        """A copy of the weights and BatchNorm statistics (the training step
        updates the live tensors in place)."""
        return {k: v.detach().clone() for k, v in self.net.state_dict().items()}

    def load_state_dict(self, sd: dict) -> None:
        self.net.load_state_dict(sd, strict=True)
        self.weights_version += 1
        self.clear_cache()

    # ------------------------------------------------------------ training
    def reset_optimizer(self) -> None:
        """Fresh optimizer state (ref online_learning.py:520-528)."""
        m = self.cfg.model
        self.optimizer = make_optimizer(self.net.parameters(), m.learning_rate, m.weight_decay)

    def _on_device(self, batch: dict) -> dict:
        return {k: (v if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v))).to(self.device)
                for k, v in batch.items()}

    def train_step(self, batch: dict) -> dict:
        """One finetune step on a batch of float [0, 1] images: 'img'
        (B, H, W, 3), 'limg', 'lmask', 'gimg', 'gmask' (B, h, w, 3 | 1),
        'bbox_gt' (B, G, 5), 'heatmap' (B, fh, fw, 1), 'mask' (B, H, W, 1).
        With `bf16_finetune` the forward and backward run in bf16 (module
        doc); the parameters, statistics and optimizer state stay float32.
        Returns the loss terms as device scalars (no host sync)."""
        b = {k: t.to(torch.float32) for k, t in self._on_device(batch).items()}
        m = self.cfg.model
        images = [b[k] for k in ("img", "limg", "lmask", "gimg", "gmask")]
        self.net.train()
        try:
            if self.bf16_finetune:
                casts = {n: p.to(torch.bfloat16) for n, p in self.net.named_parameters()}
                out = torch.func.functional_call(self.net, casts, tuple(t.to(torch.bfloat16) for t in images))
                out = {k: v.float() for k, v in out.items()}
            else:
                out = self.net(*images)
            loss, metrics = dtoid_losses(out, b, self.anchors, lam_seg=m.lam_seg,
                                         lam_center=m.lam_center, lam_cls=m.lam_cls,
                                         lam_reg=m.lam_reg)
            self.optimizer.zero_grad(set_to_none=True)
            loss.backward()
            self.optimizer.step()
        finally:
            self.net.eval()
        self.weights_version += 1
        return {k: v.detach() for k, v in metrics.items()}

    def train_step_u8(self, batch: dict) -> dict:
        """train_step over compact inputs, expanded on the device: 'img_u8'
        (B, H, W, 3) uint8, 'mask_bits' (B, H*W/8) uint8 of little-endian
        bit-packed mask, 'limg_u8' / 'gimg_u8' uint8 templates, 'lmask_u8' /
        'gmask_u8' 0/1 uint8, 'bbox_gt', 'heatmap'. u8 / 255 is what the host
        path's process_data gives at native resolution; the bf16 step casts
        that float32 feed."""
        dev = self._on_device(batch)
        img_h, img_w = self.img_size
        img = dev["img_u8"].to(torch.float32) / 255.0
        shifts = torch.arange(8, dtype=torch.uint8, device=self.device)
        bits = (dev["mask_bits"][..., None] >> shifts) & 1
        return self.train_step({
            "img": img,
            "limg": dev["limg_u8"].to(torch.float32) / 255.0,
            "lmask": dev["lmask_u8"].to(torch.float32),
            "gimg": dev["gimg_u8"].to(torch.float32) / 255.0,
            "gmask": dev["gmask_u8"].to(torch.float32),
            "bbox_gt": dev["bbox_gt"],
            "heatmap": dev["heatmap"],
            "mask": bits.to(torch.float32).reshape(img.shape[0], img_h, img_w, 1),
        })

    # ----------------------------------------------------------- inference
    def clear_cache(self) -> None:
        self.template_feature_cache = {}

    def _tensor(self, a, dtype=torch.float32) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=dtype).to(self.device)

    @torch.inference_mode()
    def get_template_features(self, obj_id, limg: np.ndarray, lmask: np.ndarray):
        """Cache-or-compute the device template features of one object.
        limg (T, h, w, 3) float [0,1]; lmask (T, h, w) or (T, h, w, 1).
        The global feature comes from the first template."""
        if obj_id not in self.template_feature_cache:
            lmask = np.asarray(lmask)
            if lmask.ndim == 3:
                lmask = lmask[..., None]
            t4 = torch.cat([imagenet_normalize(self._tensor(limg)), self._tensor(lmask)], -1)
            local = self.net.compute_template_local(t4)
            glob = self.net.compute_template_global(t4[0:1])
            self.template_feature_cache[obj_id] = (local, glob)
        return self.template_feature_cache[obj_id]

    @torch.inference_mode()
    def detect_async(self, batch: dict, topk: int = 500) -> dict:
        """Launch detection for one frame without waiting; returns the dict of
        device tensors (see DtoidNetwork.detect)."""
        img = batch["img"]
        if isinstance(img, torch.Tensor):
            img = img.to(self.device)
        else:
            img = np.asarray(img)
            if img.dtype != np.uint8:
                img = (np.clip(img, 0.0, 1.0) * 255.0).round().astype(np.uint8)
            img = torch.from_numpy(np.ascontiguousarray(img)).to(self.device)
        if img.ndim == 3:
            img = img[None]
        if img.shape[0] != 1 or img.dtype != torch.uint8:
            raise ValueError(f"detect takes one uint8 frame, got {tuple(img.shape)} {img.dtype}")

        obj_id = batch["obj_id"]
        if hasattr(obj_id, "__len__"):
            obj_id = int(np.asarray(obj_id).reshape(-1)[0])
        local, glob = self.get_template_features(obj_id, batch["limg"], batch["lmask"])
        dtype = torch.bfloat16 if self.bf16_infer else torch.float32
        return self._infer_net().detect(img, local, glob, self.anchors,
                                        pre_nms_topk=self.pre_nms_topk, topk=topk,
                                        nms_iou=self.nms_iou, pack_seg=self._pack_seg,
                                        compute_dtype=dtype)

    def _infer_net(self) -> DtoidNetwork:
        """The network in the inference dtype: the float32 network itself, or
        with `bf16_infer` a bf16 copy on the device, recast from the float32
        weights and statistics when `weights_version` has changed."""
        if not self.bf16_infer:
            return self.net
        # plain tensors, not inference tensors: the copy is refreshed in place
        with torch.inference_mode(False), torch.no_grad():
            if self._bf16_cache is None:
                net16 = copy.deepcopy(self.net).to(torch.bfloat16).eval().requires_grad_(False)
                self._bf16_cache = (self.weights_version, net16)
            elif self._bf16_cache[0] != self.weights_version:
                net16 = self._bf16_cache[1]
                for dst, src in zip(net16.state_dict().values(), self.net.state_dict().values()):
                    dst.copy_(src)
                self._bf16_cache = (self.weights_version, net16)
        return self._bf16_cache[1]

    def fetch_detections(self, out_dev: dict, batch: dict | None = None,
                         fetched: dict | None = None) -> dict:
        """Copy a detect_async result to the host and build the
        reference-schema output dict; `fetched` injects host arrays that were
        already copied."""
        out = (dict(fetched) if fetched is not None
               else {k: v.cpu().numpy() for k, v in out_dev.items()})
        if "seg_packed" in out:
            packed = out.pop("seg_packed")
            bits = np.unpackbits(packed[..., None], axis=-1, bitorder="little")
            out["segmentation"] = bits.reshape(packed.shape[0], -1).astype(np.float32)
        else:
            out["segmentation"] = out.pop("seg_u8").astype(np.float32) / 255.0

        result = {
            "pred_bbox": out["pred_bbox"],
            "pred_scores": out["pred_scores"],
            "pred_template_ids": out["pred_template_ids"],
            "valid": out["valid"],
            "segmentation": out["segmentation"],
            "heat_map": out["heat_map"],
            # reference-compatible aliases (ref models/dtoid/__init__.py:152-160)
            "final_bbox": [out["pred_bbox"]],
            "final_score": [out["pred_scores"]],
        }
        if batch is not None and batch.get("mask") is not None:
            gt = np.asarray(batch["mask"]).squeeze() > 0.5
            pred = out["segmentation"] > 0.5
            union = np.logical_or(pred, gt).sum()
            iou = float(np.logical_and(pred, gt).sum() / union) if union > 0 else 1.0
            result["seg_IoU"] = iou
            result["seg_IoU_50"] = float(iou > 0.5)
        return result

    def forward_test_time(self, batch: dict, topk: int = 500) -> dict:
        """Zero-shot detection on one frame (ref models/dtoid/__init__.py:61-171).

        batch: 'img' (H, W, 3) or (1, H, W, 3), float [0,1] or uint8; 'obj_id';
        'limg' (T, h, w, 3); 'lmask' (T, h, w[, 1]); optional 'mask' GT for
        seg_IoU; optional 'template_z_values' for z-filtering."""
        out = self.fetch_detections(self.detect_async(batch, topk=topk), batch)
        if self.cfg.model.get("filter_z") and batch.get("template_z_values") is not None:
            out = self._filter_z(out, np.asarray(batch["template_z_values"]).reshape(-1))
        return out

    def _filter_z(self, out: dict, template_z_values: np.ndarray) -> dict:
        """Reject detections whose implied object distance is implausible: the
        124px template at distance |z_t| scales to the box's max dimension,
        implying z = 124 / max_dim * -z_t; keep 0.4 m < z < 2 m."""
        boxes = out["pred_bbox"]
        tids = out["pred_template_ids"].astype(int)
        zt = template_z_values[tids]
        max_dim = np.maximum(boxes[:, 2] - boxes[:, 0], boxes[:, 3] - boxes[:, 1])
        pred_z = (124.0 / np.clip(max_dim, 1e-6, None)) * -zt
        cond = (pred_z > 0.4) & (pred_z < 2.0) & out["valid"]
        ids = np.nonzero(cond)[0]
        if len(ids) == 0:
            ids = np.asarray([0])
        for k in ("pred_bbox", "pred_scores", "pred_template_ids", "valid"):
            out[k] = out[k][ids]
        out["final_bbox"] = [out["pred_bbox"]]
        out["final_score"] = [out["pred_scores"]]
        return out
