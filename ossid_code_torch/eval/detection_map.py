"""Detection mAP (VOC-style), in-repo (the port's copy of
ossid_code_tpu/eval/detection_map.py).

Per-image top-1 boxes per object are scored against GT boxes at IoU 0.5
with VOC-2010-style all-point-interpolated AP (what the reference's
Cartucho/mAP run computes); the reference's 11-point variant is kept beside
it.
"""

from __future__ import annotations

import numpy as np


def box_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(N, 4) x (M, 4) -> (N, M) IoU; boxes (x1, y1, x2, y2)."""
    area_a = np.clip(a[:, 2] - a[:, 0], 0, None) * np.clip(a[:, 3] - a[:, 1], 0, None)
    area_b = np.clip(b[:, 2] - b[:, 0], 0, None) * np.clip(b[:, 3] - b[:, 1], 0, None)
    iw = np.minimum(a[:, None, 2], b[None, :, 2]) - np.maximum(a[:, None, 0], b[None, :, 0])
    ih = np.minimum(a[:, None, 3], b[None, :, 3]) - np.maximum(a[:, None, 1], b[None, :, 1])
    inter = np.clip(iw, 0, None) * np.clip(ih, 0, None)
    return inter / np.clip(area_a[:, None] + area_b[None, :] - inter, 1e-9, None)


def _ap_all_point(recall: np.ndarray, precision: np.ndarray) -> float:
    """VOC2010+ all-point interpolation (what Cartucho/mAP uses)."""
    mrec = np.concatenate([[0.0], recall, [1.0]])
    mpre = np.concatenate([[0.0], precision, [0.0]])
    for i in range(len(mpre) - 2, -1, -1):
        mpre[i] = max(mpre[i], mpre[i + 1])
    idx = np.where(mrec[1:] != mrec[:-1])[0] + 1
    return float(np.sum((mrec[idx] - mrec[idx - 1]) * mpre[idx]))


def _ap_11_point(recall: np.ndarray, precision: np.ndarray) -> float:
    """VOC2007 11-point interpolation (ref utils/detection_metrics.py:131-145)."""
    ap = 0.0
    for t in np.linspace(0, 1, 11):
        mask = recall >= t
        ap += (precision[mask].max() if mask.any() else 0.0) / 11.0
    return float(ap)


def voc_map(detections, groundtruths, iou_threshold=0.5, method="all_point"):
    """detections: list of (image_key, class_id, score, box4);
    groundtruths: list of (image_key, class_id, box4).

    Returns (per_class_AP: dict, mAP: float). Classes with zero GT are skipped
    (matching Cartucho/mAP)."""
    ap_fn = _ap_all_point if method == "all_point" else _ap_11_point
    classes = sorted({g[1] for g in groundtruths})
    aps = {}
    for cls in classes:
        gts: dict = {}
        for key, c, box in groundtruths:
            if c == cls:
                gts.setdefault(key, []).append(np.asarray(box, np.float64))
        npos = sum(len(v) for v in gts.values())
        dets = sorted([d for d in detections if d[1] == cls], key=lambda d: -d[2])
        tp = np.zeros(len(dets))
        fp = np.zeros(len(dets))
        matched: dict = {k: np.zeros(len(v), bool) for k, v in gts.items()}
        for di, (key, _, _, box) in enumerate(dets):
            if key not in gts:
                fp[di] = 1
                continue
            ious = box_iou(np.asarray(box, np.float64)[None], np.stack(gts[key]))[0]
            best = int(np.argmax(ious))
            if ious[best] >= iou_threshold and not matched[key][best]:
                tp[di] = 1
                matched[key][best] = True
            else:
                fp[di] = 1
        if npos == 0:
            continue
        ctp, cfp = np.cumsum(tp), np.cumsum(fp)
        recall = ctp / npos
        precision = ctp / np.clip(ctp + cfp, 1e-9, None)
        aps[cls] = ap_fn(recall, precision)
    mAP = float(np.mean(list(aps.values()))) if aps else 0.0
    return aps, mAP


def eval_detection_results(test_results, gt_boxes, iou_threshold=0.5):
    """The reference's finetune-results detection eval (ref
    utils/detection.py:137-187): one top-1 predicted box per (obj, image) from
    the loop's result rows vs GT boxes.

    test_results: iterable of dicts with obj_id/scene_id/im_id, 'dtoid_bbox'
    (K, 4) sorted by score, 'dtoid_score' (K,).
    gt_boxes: dict (obj_id, scene_id, im_id) -> (x1, y1, x2, y2).
    """
    detections, groundtruths = [], []
    for r in test_results:
        key = (r["scene_id"], r["im_id"])
        if len(r["dtoid_bbox"]):
            detections.append((key, r["obj_id"], float(r["dtoid_score"][0]),
                               np.asarray(r["dtoid_bbox"][0])))
    for (obj_id, scene_id, im_id), box in gt_boxes.items():
        groundtruths.append(((scene_id, im_id), obj_id, np.asarray(box)))
    return voc_map(detections, groundtruths, iou_threshold)
