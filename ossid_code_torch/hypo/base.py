"""Pose-hypothesis generation interface (copy of ossid_code_tpu/hypo/base.py).

Hypothesis generation stays on the host; the scoring of the hypotheses runs
on the device (models/zephyr). Call contract (ref
scripts/online_learning.py:416-419): given a masked scene point cloud, return
(poses (M, 4, 4) in METERS, scores (M,), elapsed_seconds).
"""

from __future__ import annotations

import abc

import numpy as np


class HypothesisGenerator(abc.ABC):
    @abc.abstractmethod
    def find_surface_model(self, scene_pc_m: np.ndarray, **kwargs):
        """scene_pc_m: (N, 3) scene points in meters (camera frame).

        Returns (poses (M, 4, 4) object->camera in meters, scores (M,),
        elapsed_seconds). M may vary per call."""
