"""Correspondence-matching metrics, numpy (the port's copy of
ossid_code_tpu/utils/metrics.py; ref utils/metrics.py:4-67).

Operate on score matrices (B, N0+1, N1+1) whose last row/col are dustbins, and
GT assignment matrices of the same shape (legacy SIFT-matching training)."""

from __future__ import annotations

import numpy as np


def match_precision(scores: np.ndarray, gt: np.ndarray) -> float:
    """Fraction of predicted (argmax) matches that are correct, ignoring
    dustbin predictions."""
    pred = scores[:, :-1, :-1].argmax(-1)
    gt_idx = gt[:, :-1, :].argmax(-1)  # N1 = dustbin column index
    n1 = scores.shape[2] - 1
    pred_valid = scores[:, :-1, :].argmax(-1) != n1
    correct = (pred == gt_idx) & pred_valid & (gt_idx != n1)
    denom = max(pred_valid.sum(), 1)
    return float(correct.sum() / denom)


def match_recall(scores: np.ndarray, gt: np.ndarray) -> float:
    """Fraction of GT matches recovered by the argmax prediction."""
    n1 = scores.shape[2] - 1
    gt_idx = gt[:, :-1, :].argmax(-1)
    has_gt = gt_idx != n1
    pred = scores[:, :-1, :].argmax(-1)
    correct = (pred == gt_idx) & has_gt
    denom = max(has_gt.sum(), 1)
    return float(correct.sum() / denom)


def obs_seg_iou(pred_mask: np.ndarray, gt_mask: np.ndarray) -> float:
    """Foreground IoU between binary masks."""
    pred = np.asarray(pred_mask) > 0.5
    gt = np.asarray(gt_mask) > 0.5
    union = np.logical_or(pred, gt).sum()
    if union == 0:
        return 1.0
    return float(np.logical_and(pred, gt).sum() / union)
