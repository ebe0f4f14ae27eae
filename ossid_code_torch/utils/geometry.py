"""Host geometry helpers (numpy copies from ossid_code_tpu/utils/geometry.py)."""

from __future__ import annotations

import numpy as np


def rotvec_to_matrix(rotvec: np.ndarray) -> np.ndarray:
    """Rodrigues' formula: rotation vectors (..., 3) -> matrices (..., 3, 3)."""
    rotvec = np.asarray(rotvec, np.float64)
    theta = np.linalg.norm(rotvec, axis=-1)[..., None, None]
    small = theta < 1e-12
    axis = rotvec / np.where(small[..., 0], 1.0, theta[..., 0])
    x, y, z = axis[..., 0], axis[..., 1], axis[..., 2]
    zero = np.zeros_like(x)
    kmat = np.stack([np.stack([zero, -z, y], -1),
                     np.stack([z, zero, -x], -1),
                     np.stack([-y, x, zero], -1)], -2)
    eye = np.broadcast_to(np.eye(3), kmat.shape)
    rot = eye + np.sin(theta) * kmat + (1.0 - np.cos(theta)) * (kmat @ kmat)
    return np.where(small, eye, rot)


def perturb_trans(mat: np.ndarray, n_perturb: int = 500,
                  rng: np.random.Generator | None = None) -> np.ndarray:
    """Sample small SE(3) perturbations of a pose (ref utils/__init__.py:82-98):
    rotation angle ~ N(0, 0.2 rad) about a random axis, translation ~ N(0, 1 cm).
    Draws the same random numbers in the same order as the JAX package's copy."""
    rng = rng or np.random.default_rng()
    rot_mag = rng.normal(0, 0.2, n_perturb)
    rot_axis = rng.normal(0, 1.0, (n_perturb, 3))
    rot_axis /= np.linalg.norm(rot_axis, ord=2, axis=1, keepdims=True)
    rot = rotvec_to_matrix(rot_axis * rot_mag[:, None])
    dt = rng.normal(0, 0.01, (n_perturb, 3))
    out = np.repeat(mat[None].copy(), n_perturb, axis=0)
    out[:, :3, :3] = np.einsum("ijk,ikl->ijl", rot, out[:, :3, :3])
    out[:, :3, 3] += dt
    return out
