"""Depth-map corruption augmentation, numpy (the port's copy of
ossid_code_tpu/utils/augmentation.py; ref utils/augmentation.py:5-25):
drop depth at grazing incidence angles (sensor-like failures) plus random
rectangular dropouts."""

from __future__ import annotations

import numpy as np


def augment_depth_map(depth: np.ndarray, normals: np.ndarray, n_rectangles: int = 5,
                      rng=None) -> np.ndarray:
    """depth (H, W); normals (H, W, 3) camera-frame unit normals.

    Zeroes depth where the view-angle cosine |n_z| falls below a random
    threshold, then zeroes up to `n_rectangles` random boxes.
    """
    rng = rng or np.random.default_rng()
    depth = depth.copy()
    h, w = depth.shape

    cos_th = rng.uniform(0.1, 0.5)
    grazing = np.abs(normals[..., 2]) < cos_th
    depth[grazing] = 0.0

    for _ in range(rng.integers(0, n_rectangles + 1)):
        rh = int(rng.uniform(0.02, 0.1) * h)
        rw = int(rng.uniform(0.02, 0.1) * w)
        y = rng.integers(0, max(h - rh, 1))
        x = rng.integers(0, max(w - rw, 1))
        depth[y : y + rh, x : x + rw] = 0.0
    return depth
