"""Deterministic fake hypothesis generator (copy of ossid_code_tpu/hypo/fake.py).

Produces the anchor pose (optionally) plus perturbations around it, standing
in for PPF/SIFT so the serving path runs without native code or datasets.
"""

from __future__ import annotations

import time

import numpy as np

from ossid_code_torch.hypo.base import HypothesisGenerator
from ossid_code_torch.utils.geometry import perturb_trans


class FakeHypoGen(HypothesisGenerator):
    def __init__(self, n_hypos: int = 100, noise_rot: float = 0.15, noise_t: float = 0.02,
                 include_anchor: bool = True, seed: int = 0):
        self.n_hypos = n_hypos
        self.noise_rot = noise_rot
        self.noise_t = noise_t
        self.include_anchor = include_anchor
        self.rng = np.random.default_rng(seed)
        self.anchor_pose: np.ndarray | None = None

    def set_anchor(self, pose: np.ndarray):
        """Seed pose to perturb around (tests pass the GT here)."""
        self.anchor_pose = np.asarray(pose, np.float64)

    def find_surface_model(self, scene_pc_m: np.ndarray, **kwargs):
        t0 = time.perf_counter()
        if self.anchor_pose is not None:
            anchor = self.anchor_pose
        else:
            # center of the masked cloud, identity rotation
            anchor = np.eye(4)
            if len(scene_pc_m):
                anchor[:3, 3] = np.asarray(scene_pc_m).mean(axis=0)
        # perturb_trans draws at its own fixed sigmas (0.2 rad, 1 cm), as the
        # JAX package's generator does; noise_rot / noise_t are kept for its API
        poses = perturb_trans(anchor, self.n_hypos, rng=self.rng)
        if self.include_anchor:
            poses[0] = anchor
        scores = np.linspace(1.0, 0.1, len(poses))
        return poses, scores, time.perf_counter() - t0
