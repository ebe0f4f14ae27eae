"""The class-conditional instance detector behind `--use_maskrcnn` (the port
of ossid_code_tpu/models/maskrcnn.py).

The JAX package replaced the reference's two-stage Mask R-CNN by a
single-stage detector with the same serving interface: the DenseNet-121
trunk (blocks 12/24/16, fixed) shared with DTOID, a 1x1 neck to 512
channels, RetinaNet-style class and box heads over `n_classes`, and a
per-class segmentation decoder. This module is that network in PyTorch,
under the flax module names (`stem`, `early`, `late`, `neck`, `neck_bn`,
`classification`, `regression`, `s1`..`s3`, `ns1`..`ns3`, `seg_final`), so
`maskrcnn_from_jax` carries the JAX weights with strict=True.

`MaskRCNN` is the host wrapper with the JAX interface: target-class
inference (`forward_test_time`; the target's column is taken before top-k
1000, then NMS 0.5 to top-k 100, all on the device), the train step
(`detection_loss` with `class_valid`, BCE on the clipped sigmoid weighted
by `cls_valid`, loss = cls + reg + 20 seg; optax's add_decayed_weights +
amsgrad rule from core/optim.py), `eval_metric`, and weights. It runs on the
card unless `device="cpu"`. There is no CUDA kernel of the port on this
path: the network has no depthwise correlation.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ossid_code_torch.core.optim import make_optimizer
from ossid_code_torch.device import resolve_device
from ossid_code_torch.models.backbones import densenet
from ossid_code_torch.models.batchnorm import BatchNorm2d
from ossid_code_torch.models.dtoid.anchors import generate_anchor_grid
from ossid_code_torch.models.dtoid.losses import detection_loss
from ossid_code_torch.models.dtoid.network import (
    ClassificationHead, RegressionHead, clip_boxes, decode_boxes, imagenet_normalize, lecun_init_,
)
from ossid_code_torch.ops.nms import nms_topk, topk_stable
from ossid_code_torch.ops.resize import resize_nearest, upsample_nearest

SEG_PRIOR_BIAS = -4.595  # seg_final's bias: a prior of 0.01, as the JAX package sets it
PRE_NMS_TOPK = 1000
NMS_IOU = 0.5
SEG_WEIGHT = 20.0


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class MaskRCNNNetwork(nn.Module):
    """image (B, H, W, 3) in [0, 1] -> cls (B, N, C) probabilities, reg
    (B, N, 4), seg logits (B, H, W, C); N = (H/16-1)(W/16-1) x 24 anchors."""

    def __init__(self, n_classes: int, img_size=(480, 640)):
        super().__init__()
        self.n_classes = int(n_classes)
        self.img_size = tuple(img_size)
        self.stem = densenet.stem()
        self.early = densenet.early()
        self.late = densenet.late((12, 24, 16))
        self.neck = nn.Conv2d(self.late.out_channels, 512, 1)
        self.neck_bn = BatchNorm2d(512)
        self.classification = ClassificationHead(num_classes=self.n_classes)
        self.regression = RegressionHead()
        for i, (cin, cout) in enumerate(((512, 256), (256, 128), (128, 64)), 1):
            self.add_module(f"s{i}", nn.Conv2d(cin, cout, 3, padding=1))
            self.add_module(f"ns{i}", BatchNorm2d(cout))
        self.seg_final = nn.Conv2d(64, self.n_classes, 3, padding=1)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's initialisation: lecun kernels, zero output convs with the
        heads' prior biases, and seg_final's zero kernel and bias -4.595."""
        lecun_init_(self, generator)
        self.classification.reset_output()
        self.regression.reset_output()
        nn.init.zeros_(self.seg_final.weight)
        nn.init.constant_(self.seg_final.bias, SEG_PRIOR_BIAS)

    def trunk(self, image: torch.Tensor):
        """image NHWC [0, 1] -> (neck (B, 512, h, w), decoder features
        (B, 64, H, W)), NCHW in channels_last."""
        x = _nchw(imagenet_normalize(image)).contiguous(memory_format=torch.channels_last)
        neck = self.neck_bn(F.elu(self.neck(self.late(self.early(self.stem(x))))))
        s = neck
        for i in (1, 2, 3):
            s = getattr(self, f"ns{i}")(F.elu(getattr(self, f"s{i}")(s)))
            s = upsample_nearest(_nhwc(s), 2) if i < 3 else resize_nearest(_nhwc(s), self.img_size)
            s = _nchw(s)
        return neck, s

    def forward(self, image: torch.Tensor):
        neck, s = self.trunk(image)
        return self.classification(neck), self.regression(neck), _nhwc(self.seg_final(s))

    def infer(self, image_u8: torch.Tensor, anchors: torch.Tensor, target_cls: int, topk: int = 100):
        """Target-class inference for one uint8 frame (1, H, W, 3): the
        target's scores are selected before top-k and NMS (ranking by the
        anchor's best class, or NMS across classes, drops the target where
        another class scores a little higher), and only the target's
        segmentation channel is decoded. Returns (scores (topk,), boxes
        (topk, 4), valid (topk,), seg probabilities (H, W)), on the device."""
        img_h, img_w = self.img_size
        neck, s = self.trunk(image_u8.float() / 255.0)
        cls, reg = self.classification(neck), self.regression(neck)
        boxes = clip_boxes(decode_boxes(anchors, reg[0]), img_h, img_w)
        target_score = cls[0, :, target_cls]
        top_scores, top_idx = topk_stable(target_score, min(PRE_NMS_TOPK, target_score.shape[0]))
        scores, sel_boxes, _, valid = nms_topk(boxes[top_idx], top_scores, NMS_IOU, topk)
        t = slice(target_cls, target_cls + 1)
        seg = F.conv2d(s, self.seg_final.weight[t], self.seg_final.bias[t], padding=1)
        return scores, sel_boxes, valid, torch.sigmoid(seg[0, 0])


def maskrcnn_losses(cls, reg, seg_logits, anchors, bbox_gt, masks, cls_valid=None):
    """The JAX train step's loss: detection_loss with `cls_valid` (B, C), and
    the per-class mask BCE on the sigmoid clipped to [1e-7, 1 - 1e-7],
    weighted by `cls_valid` and divided by the weight's sum (at least 1).
    Returns (loss, metrics)."""
    if cls_valid is None:
        cls_valid = torch.ones((seg_logits.shape[0], seg_logits.shape[-1]), dtype=seg_logits.dtype,
                               device=seg_logits.device)
    loss_cls, loss_reg = detection_loss(cls, reg, anchors, bbox_gt, class_valid=cls_valid)
    p = torch.sigmoid(seg_logits).clamp(1e-7, 1.0 - 1e-7)
    bce = -(masks * torch.log(p) + (1.0 - masks) * torch.log(1.0 - p))
    w = cls_valid[:, None, None, :]
    loss_seg = (w * bce).sum() / (w * torch.ones_like(bce)).sum().clamp(min=1.0)
    loss = loss_cls + loss_reg + SEG_WEIGHT * loss_seg
    return loss, {"loss": loss, "loss_classifier": loss_cls, "loss_box_reg": loss_reg, "loss_mask": loss_seg}


class MaskRCNN:
    """Host wrapper with the JAX MaskRCNN's interface; runs on `device`
    (None -> cuda). Classes are 0-based: class c is object id c + 1."""

    train_feed_keys = ("img", "bbox_gt", "masks", "cls_valid")

    def __init__(self, cfg, seed: int = 0, device: str | torch.device | None = None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.n_classes = int(cfg.dataset.n_classes)
        self.img_size = (int(cfg.dataset.img_h), int(cfg.dataset.img_w))
        self.feat_size = (self.img_size[0] // 16 - 1, self.img_size[1] // 16 - 1)
        self.net = MaskRCNNNetwork(self.n_classes, self.img_size)
        self.net.reset_parameters(torch.Generator().manual_seed(seed))
        self.net.to(device=self.device, memory_format=torch.channels_last).eval()
        self.anchors = torch.from_numpy(generate_anchor_grid(*self.feat_size)).to(self.device)
        self.reset_optimizer()
        self.weights_version = 0

    # ------------------------------------------------------------- weights
    def state_dict(self) -> dict:
        return {k: v.detach().clone() for k, v in self.net.state_dict().items()}

    def load_state_dict(self, sd: dict) -> None:
        self.net.load_state_dict(sd, strict=True)
        self.weights_version += 1

    def clear_cache(self) -> None:
        """No template cache (the interface of DtoidModel)."""

    def reset_optimizer(self) -> None:
        m = self.cfg.model
        self.optimizer = make_optimizer(self.net.parameters(), m.get("learning_rate", 1e-4),
                                        m.get("weight_decay", 1e-6))

    # ------------------------------------------------------------ training
    def _float(self, a) -> torch.Tensor:
        t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a))
        return t.to(self.device, torch.float32)

    def train_step(self, batch: dict) -> dict:
        """One step on 'img' (B, H, W, 3) in [0, 1], 'bbox_gt' (B, G, 5) with
        0-based classes, 'masks' (B, H, W, C) and optional 'cls_valid'
        (B, C); other keys are ignored. Returns the loss terms as device
        scalars (no host sync)."""
        b = {k: self._float(batch[k]) for k in self.train_feed_keys if k in batch}
        self.net.train()
        try:
            cls, reg, seg_logits = self.net(b["img"])
            loss, metrics = maskrcnn_losses(cls, reg, seg_logits, self.anchors, b["bbox_gt"], b["masks"],
                                            b.get("cls_valid"))
            self.optimizer.zero_grad(set_to_none=True)
            loss.backward()
            self.optimizer.step()
        finally:
            self.net.eval()
        self.weights_version += 1
        return {k: v.detach() for k, v in metrics.items()}

    @torch.inference_mode()
    def eval_metric(self, batch: dict) -> list:
        """Per-sample segmentation IoU, averaged over the classes present in
        the GT (1.0 where none is): the monitored metric of dataset=detect."""
        pred = (self.net(self._float(batch["img"]))[2] > 0.0).cpu().numpy()
        gt = np.asarray(batch["masks"]) > 0.5
        out = []
        for p, g in zip(pred, gt):
            present = g.any(axis=(0, 1))
            if not present.any():
                out.append(1.0)
                continue
            inter = np.logical_and(p, g)[..., present].sum(axis=(0, 1))
            union = np.logical_or(p, g)[..., present].sum(axis=(0, 1))
            out.append(float(np.mean(inter / np.clip(union, 1, None))))
        return out

    # ----------------------------------------------------------- inference
    def _frame(self, img) -> torch.Tensor:
        """A frame as the card's uint8 (1, H, W, 3): a tensor (uint8, or float
        in [0, 1]) or an array, with or without the batch axis."""
        if not isinstance(img, torch.Tensor):
            img = np.asarray(img)
            if img.dtype != np.uint8:
                img = (np.clip(img, 0.0, 1.0) * 255.0).round().astype(np.uint8)
            img = torch.from_numpy(np.ascontiguousarray(img))
        img = img.to(self.device)
        if img.dtype != torch.uint8:
            img = (img.clamp(0.0, 1.0) * 255.0).round().to(torch.uint8)
        return img[None] if img.ndim == 3 else img

    @torch.inference_mode()
    def forward_test_time(self, data: dict, topk: int = 100) -> dict:
        """Detections of the class of `data['obj_id']` (class obj_id - 1) in
        data['img'], in the reference's output schema; with no detection, one
        full-frame box at score 0 and an empty mask. With data['mask'], the
        segmentation's IoU with it (seg_IoU, seg_IoU_50)."""
        target = int(np.asarray(data["obj_id"]).reshape(-1)[0])
        out = self.net.infer(self._frame(data["img"]), self.anchors, target - 1, topk=topk)
        scores, boxes, valid, seg = (t.cpu().numpy() for t in out)
        h, w = self.img_size
        if not valid.any():
            return {"final_bbox": [np.asarray([[0, 0, w, h]], np.float32)],
                    "final_score": [np.zeros(1, np.float32)],
                    "segmentation": np.zeros((h, w), np.float32), "seg_IoU": 0.0, "seg_IoU_50": 0.0}
        res = {"final_bbox": [boxes[valid]], "final_score": [scores[valid]], "segmentation": seg}
        if data.get("mask") is not None:
            gt = np.asarray(data["mask"]).squeeze() > 0.5
            pred = seg > 0.5
            union = np.logical_or(pred, gt).sum()
            iou = float(np.logical_and(pred, gt).sum() / union) if union else 1.0
            res["seg_IoU"] = iou
            res["seg_IoU_50"] = float(iou > 0.5)
        return res

