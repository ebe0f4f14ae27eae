"""RetinaNet-style anchor enumeration for DTOID's single-level head (copy of
ossid_code_tpu/models/dtoid/anchors.py).

Reference formulas (ref models/dtoid/anchors.py:45-132) with DTOID's
parameters: one pyramid level (stride 16), base size 30, ratios (0.5, 1, 2),
scales 1..8 -> 24 anchors per cell. Anchors are static for a fixed feature-map
shape, so they are computed once on the host in numpy.

Anchor ordering is (row, col, anchor), matching how the heads' NHWC output is
reshaped to (B, H*W*A, C).
"""

from __future__ import annotations

import numpy as np

STRIDE = 16
BASE_SIZE = 30
RATIOS = np.array([0.5, 1.0, 2.0])
SCALES = np.array([1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 7.0, 8.0])
NUM_ANCHORS = len(RATIOS) * len(SCALES)  # 24


def base_anchors() -> np.ndarray:
    """(24, 4) anchor windows centered at the origin, (x1, y1, x2, y2).

    Enumeration order is ratio-major / scale-minor (ref anchors.py:57-76).
    """
    num = NUM_ANCHORS
    anchors = np.zeros((num, 4))
    # width/height start as base_size * scale, tiled per ratio
    anchors[:, 2:] = BASE_SIZE * np.tile(SCALES, (2, len(RATIOS))).T
    areas = anchors[:, 2] * anchors[:, 3]
    anchors[:, 2] = np.sqrt(areas / np.repeat(RATIOS, len(SCALES)))
    anchors[:, 3] = anchors[:, 2] * np.repeat(RATIOS, len(SCALES))
    anchors[:, 0::2] -= np.tile(anchors[:, 2] * 0.5, (2, 1)).T
    anchors[:, 1::2] -= np.tile(anchors[:, 3] * 0.5, (2, 1)).T
    return anchors


def generate_anchor_grid(feat_h: int, feat_w: int) -> np.ndarray:
    """All anchors for an (feat_h, feat_w) feature map: (feat_h*feat_w*24, 4)
    float32, cell centers at (i + 0.5) * stride (ref anchors.py:111-130)."""
    base = base_anchors()
    shift_x = (np.arange(feat_w) + 0.5) * STRIDE
    shift_y = (np.arange(feat_h) + 0.5) * STRIDE
    sx, sy = np.meshgrid(shift_x, shift_y)  # (H, W)
    shifts = np.stack([sx.ravel(), sy.ravel(), sx.ravel(), sy.ravel()], axis=1)
    all_anchors = base[None, :, :] + shifts[:, None, :]
    return all_anchors.reshape(-1, 4).astype(np.float32)
