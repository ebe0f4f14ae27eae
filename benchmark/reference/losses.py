"""DTOID training losses (counterpart of ossid_code_tpu/models/dtoid/losses.py).

RetinaNet-style detection loss (focal classification with alpha 0.25, gamma
2; IoU assignment: positive >= 0.5, negative < 0.4, ignored in between;
smooth-L1 box regression with beta 1/9 on the positives, targets divided by
(0.1, 0.1, 0.2, 0.2)), plus the L1 centre-heat-map and BCE segmentation
terms. Annotations arrive padded: (B, G, 5) with column 4 the class index and
-1 on padding rows; a sample without any valid row has every anchor negative.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .nms import batched_iou

ALPHA = 0.25
GAMMA = 2.0
REG_STD = (0.1, 0.1, 0.2, 0.2)


def detection_loss(classifications: torch.Tensor, regressions: torch.Tensor, anchors: torch.Tensor,
                   annotations: torch.Tensor, class_valid: torch.Tensor | None = None):
    """classifications (B, N, C) probabilities; regressions (B, N, 4); anchors
    (N, 4); annotations (B, G, 5). Returns (cls_loss, reg_loss), batch means.
    class_valid (B, C), optional: classes marked 0 add no classification
    loss (rows annotated for one class only)."""
    cls = classifications.clamp(1e-4, 1.0 - 1e-4)
    b, n, num_classes = cls.shape
    if class_valid is None:
        class_valid = torch.ones((b, num_classes), dtype=cls.dtype, device=cls.device)

    anchor_w = anchors[:, 2] - anchors[:, 0]
    anchor_h = anchors[:, 3] - anchors[:, 1]
    anchor_cx = anchors[:, 0] + 0.5 * anchor_w
    anchor_cy = anchors[:, 1] + 0.5 * anchor_h

    gt_valid = annotations[:, :, 4] != -1  # (B, G)
    iou = torch.stack([batched_iou(anchors, annotations[i, :, :4]) for i in range(b)])  # (B, N, G)
    iou = torch.where(gt_valid[:, None, :], iou, torch.full_like(iou, -1.0))
    iou_max, iou_arg = iou.max(dim=2)
    iou_max = iou_max.clamp(min=0.0)
    assigned = torch.gather(annotations, 1, iou_arg[..., None].expand(b, n, 5))  # (B, N, 5)
    positive = iou_max >= 0.5
    negative = iou_max < 0.4
    num_pos = positive.sum(1).to(cls.dtype)

    cls_idx = assigned[..., 4].to(torch.int64).clamp(0, num_classes - 1)
    targets = torch.where(positive[..., None], F.one_hot(cls_idx, num_classes).to(cls.dtype),
                          torch.zeros_like(cls))
    care = (positive | negative)[..., None]
    is_pos = targets == 1.0
    alpha_factor = torch.where(is_pos, torch.full_like(cls, ALPHA), torch.full_like(cls, 1.0 - ALPHA))
    focal_weight = alpha_factor * torch.where(is_pos, 1.0 - cls, cls) ** GAMMA
    bce = -(targets * torch.log(cls) + (1.0 - targets) * torch.log(1.0 - cls))
    cls_loss = torch.where(care, focal_weight * bce, torch.zeros_like(cls))
    cls_loss = torch.where(class_valid[:, None, :] > 0, cls_loss, torch.zeros_like(cls))
    cls_loss = cls_loss.sum((1, 2)) / num_pos.clamp(min=1.0)

    gt_w = (assigned[..., 2] - assigned[..., 0]).clamp(min=1.0)
    gt_h = (assigned[..., 3] - assigned[..., 1]).clamp(min=1.0)
    gt_cx = assigned[..., 0] + 0.5 * (assigned[..., 2] - assigned[..., 0])
    gt_cy = assigned[..., 1] + 0.5 * (assigned[..., 3] - assigned[..., 1])
    safe_w = anchor_w.clamp(min=1e-6)
    safe_h = anchor_h.clamp(min=1e-6)
    t = torch.stack([(gt_cx - anchor_cx) / safe_w, (gt_cy - anchor_cy) / safe_h,
                     torch.log(gt_w / safe_w), torch.log(gt_h / safe_h)], -1)
    t = t / torch.tensor(REG_STD, dtype=t.dtype, device=t.device)
    diff = (t - regressions).abs()
    smooth = torch.where(diff <= 1.0 / 9.0, 0.5 * 9.0 * diff ** 2, diff - 0.5 / 9.0)
    reg_loss = torch.where(positive[..., None], smooth, torch.zeros_like(smooth)).sum((1, 2))
    reg_loss = reg_loss / (num_pos * 4.0).clamp(min=1.0)
    return cls_loss.mean(), reg_loss.mean()


def dtoid_losses(out: dict, batch: dict, anchors: torch.Tensor, lam_seg: float = 20.0,
                 lam_center: float = 20.0, lam_cls: float = 1.0, lam_reg: float = 1.0):
    """The four DTOID losses combined. batch: 'bbox_gt' (B, G, 5), 'heatmap'
    (B, fh, fw, 1), 'mask' (B, H, W, 1). Seg logits at half resolution
    (model.seg_loss_half) are held to the exact 2x2 mean of the mask (soft
    targets at edges). Returns (loss, metrics dict)."""
    loss_cls, loss_reg = detection_loss(out["classifications"], out["regressions"], anchors,
                                        batch["bbox_gt"])
    loss_center = (batch["heatmap"] - out["heat_map"]).abs().mean()
    seg_probs = torch.sigmoid(out["seg_logits"]).clamp(1e-7, 1.0 - 1e-7)
    mask = batch["mask"]
    if mask.shape[1:3] != seg_probs.shape[1:3]:
        b, h, w, c = mask.shape
        sh, sw = seg_probs.shape[1:3]
        mask = mask.reshape(b, sh, h // sh, sw, w // sw, c).mean((2, 4))
    loss_seg = -(mask * torch.log(seg_probs) + (1.0 - mask) * torch.log(1.0 - seg_probs)).mean()
    loss = lam_seg * loss_seg + lam_center * loss_center + lam_cls * loss_cls + lam_reg * loss_reg
    return loss, {
        "loss": loss,
        "loss_seg": lam_seg * loss_seg,
        "loss_center": lam_center * loss_center,
        "loss_cls": lam_cls * loss_cls,
        "loss_reg": lam_reg * loss_reg,
    }
