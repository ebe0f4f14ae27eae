"""Host geometry helpers (the port's copy of ossid_code_tpu/utils/geometry.py;
`perturb_trans` builds its rotations with Rodrigues' formula in numpy).
"""

from __future__ import annotations

import numpy as np
from scipy.spatial.transform import Rotation as _R


# ---------------------------------------------------------------------------
# Intrinsics
# ---------------------------------------------------------------------------

def meta2K(meta_data: dict) -> np.ndarray:
    """Camera meta dict -> 3x3 intrinsics (ref utils/__init__.py:132)."""
    return np.asarray(
        [
            [float(meta_data["camera_fx"]), 0.0, float(meta_data["camera_cx"])],
            [0.0, float(meta_data["camera_fy"]), float(meta_data["camera_cy"])],
            [0.0, 0.0, 1.0],
        ]
    )


def K2meta(cam_K: np.ndarray) -> dict:
    """3x3 intrinsics -> camera meta dict (ref utils/__init__.py:148)."""
    return {
        "camera_fx": float(cam_K[0, 0]),
        "camera_fy": float(cam_K[1, 1]),
        "camera_cx": float(cam_K[0, 2]),
        "camera_cy": float(cam_K[1, 2]),
        "camera_scale": 1.0,
    }


# ---------------------------------------------------------------------------
# Depth <-> 3D
# ---------------------------------------------------------------------------

def depth2xyz(depth: np.ndarray, cam_K: np.ndarray) -> np.ndarray:
    """Dense unprojection: (H, W) depth -> (H, W, 3) XYZ map.

    Matches ref utils/__init__.py:241-255: pixel column index u drives x,
    row index v drives y.
    """
    h, w = depth.shape
    u = np.arange(w, dtype=np.float64)[None, :].repeat(h, axis=0)
    v = np.arange(h, dtype=np.float64)[:, None].repeat(w, axis=1)
    z = depth.astype(np.float64)
    x = (u - cam_K[0, 2]) * z / cam_K[0, 0]
    y = (v - cam_K[1, 2]) * z / cam_K[1, 1]
    return np.stack([x, y, z], axis=2).astype(np.float32)


def depth2cloud(depth: np.ndarray, mask: np.ndarray, cam_K: np.ndarray) -> np.ndarray:
    """Masked unprojection -> (N, 3) point cloud (interface of zephyr.utils.depth2cloud,
    call site ref scripts/online_learning.py:416). Unprojects only the masked
    pixels (the dense map costs ~10ms/frame at VGA on one host core)."""
    vs, us = np.nonzero(np.asarray(mask, bool))
    z = depth[vs, us].astype(np.float64)
    x = (us - cam_K[0, 2]) * z / cam_K[0, 0]
    y = (vs - cam_K[1, 2]) * z / cam_K[1, 1]
    return np.stack([x, y, z], axis=1).astype(np.float32)


# ---------------------------------------------------------------------------
# Rotations
# ---------------------------------------------------------------------------

def proj_cloud(pts: np.ndarray, cam_K: np.ndarray) -> np.ndarray:
    """Project (N, 3) camera-frame points to pixel coordinates: (N, 2) of
    (row, col) = (v, u), the reference's (px, py) order at
    utils/__init__.py:269-287, where px is the row."""
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    col = cam_K[0, 0] * x / z + cam_K[0, 2]
    row = cam_K[1, 1] * y / z + cam_K[1, 2]
    return np.stack([row, col], axis=1)


def project_points_uv(poses: np.ndarray, model_points: np.ndarray, cam_K: np.ndarray) -> np.ndarray:
    """Model points under M pose hypotheses: poses (M, 4, 4), model_points
    (N, 3) -> integer (M, N, 2) of (u, v) pixels (u the column), the
    interface of zephyr.utils.projectPointsUv (call site ref
    utils/zephyr_utils.py:58)."""
    R = poses[:, :3, :3]
    t = poses[:, :3, 3]
    cam = np.einsum("mij,nj->mni", R, model_points) + t[:, None, :]
    z = np.clip(cam[..., 2], 1e-9, None)
    u = cam_K[0, 0] * cam[..., 0] / z + cam_K[0, 2]
    v = cam_K[1, 1] * cam[..., 1] / z + cam_K[1, 2]
    return np.stack([u, v], axis=-1).round().astype(np.int64)


def depth_im_to_dist_im(depth: np.ndarray, cam_K: np.ndarray) -> np.ndarray:
    """Z-depth image -> per-pixel ray distance image, dist = depth *
    ||[(u-cx)/fx, (v-cy)/fy, 1]|| (the role of bop_toolkit_lib.misc.
    depth_im_to_dist_im_fast; call site ref scripts/online_learning.py:427)."""
    h, w = depth.shape
    u = np.arange(w, dtype=np.float32)[None, :]
    v = np.arange(h, dtype=np.float32)[:, None]
    xs = (u - cam_K[0, 2]) / cam_K[0, 0]
    ys = (v - cam_K[1, 2]) / cam_K[1, 1]
    return np.asarray(depth, np.float32) * np.sqrt(xs * xs + ys * ys + 1.0)


def mat2quat(R: np.ndarray) -> np.ndarray:
    """Rotation matrix (..., 3, 3) -> quaternion (..., 4) scalar-last."""
    single = R.ndim == 2
    q = _R.from_matrix(R.reshape(-1, 3, 3)).as_quat()
    return q[0] if single else q.reshape(R.shape[:-2] + (4,))


def quat2mat(q: np.ndarray) -> np.ndarray:
    """Quaternion (..., 4) scalar-last -> rotation matrix (..., 3, 3)."""
    single = q.ndim == 1
    m = _R.from_quat(q.reshape(-1, 4)).as_matrix()
    return m[0] if single else m.reshape(q.shape[:-1] + (3, 3))


def quat_angular_diff_batch(Q1: np.ndarray, Q2: np.ndarray) -> np.ndarray:
    """(M, 4) x (N, 4) -> (M, N) angular differences in radians
    (ref utils/__init__.py:327-334)."""
    product = np.abs(np.einsum("md,nd->mn", Q1, Q2))
    product = np.minimum(product, 1.0 - 1e-7)
    return 2.0 * np.arccos(product)


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


# ---------------------------------------------------------------------------
# Boxes / masks / heatmaps
# ---------------------------------------------------------------------------

def expand_box(x1, y1, x2, y2, img_h, img_w, expand_ratio):
    """Scale a box about its center, clipped to the image
    (ref utils/__init__.py:11-16)."""
    cx, cy = (x1 + x2) / 2.0, (y1 + y2) / 2.0
    w, h = x2 - x1, y2 - y1
    x1n = max(0, cx - w / 2 * expand_ratio)
    x2n = min(img_w - 1, cx + w / 2 * expand_ratio)
    y1n = max(0, cy - h / 2 * expand_ratio)
    y2n = min(img_h - 1, cy + h / 2 * expand_ratio)
    return x1n, y1n, x2n, y2n


def robust_crop(image: np.ndarray, x1: int, x2: int, y1: int, y2: int) -> np.ndarray:
    """Crop rows [x1, x2) and columns [y1, y2) (rows first, as the
    reference names them), zero-padded outside the image
    (ref utils/__init__.py:340-352)."""
    if not (x2 > x1 and y2 > y1):
        raise ValueError(f"robust_crop: empty crop rows [{x1}, {x2}) columns [{y1}, {y2})")
    from_h, from_w = image.shape[:2]
    to_h, to_w = x2 - x1, y2 - y1
    crop = np.zeros((to_h, to_w, *image.shape[2:]), dtype=image.dtype)
    fx1, fy1 = max(0, x1), max(0, y1)
    fx2, fy2 = min(from_h, x2), min(from_w, y2)
    tx1, ty1 = max(0, -x1), max(0, -y1)
    tx2, ty2 = min(to_h, from_h - x1), min(to_w, from_w - y1)
    crop[tx1:tx2, ty1:ty2] = image[fx1:fx2, fy1:fy2]
    return crop


def heatmap_gaussian(img_h, img_w, cx, cy, sigma, normalize=False) -> np.ndarray:
    """Unnormalized isotropic Gaussian centered at (cx, cy)
    (ref utils/__init__.py:354-366)."""
    img_h, img_w = int(round(img_h)), int(round(img_w))
    x, y = np.meshgrid(np.arange(img_w), np.arange(img_h))
    dst2 = (x - cx) ** 2 + (y - cy) ** 2
    gauss = np.exp(-dst2 / (2.0 * sigma**2))
    if normalize:
        gauss = gauss / gauss.sum()
    return gauss


def estimate_rigid_body_transform(P: np.ndarray, Q: np.ndarray):
    """Kabsch/Umeyama: find (R, t) with Q ~= R @ P + t.

    P, Q: (3, N) corresponding points (ref utils/__init__.py:107-130).
    """
    d, _ = P.shape
    p_cen = P.mean(axis=1, keepdims=True)
    q_cen = Q.mean(axis=1, keepdims=True)
    S = (P - p_cen) @ (Q - q_cen).T
    u, _, vh = np.linalg.svd(S)
    V, U = vh.T, u
    middle = np.eye(d)
    middle[-1, -1] = np.linalg.det(V @ U.T)
    R = V @ middle @ U.T
    t = q_cen - R @ p_cen
    return R, t


def mask_to_bbox(mask: np.ndarray):
    """Tight (x1, y1, x2, y2) box of the nonzero region of a 2D mask; None if
    empty."""
    ys, xs = np.nonzero(mask)
    if ys.size == 0:
        return None
    return float(xs.min()), float(ys.min()), float(xs.max()), float(ys.max())


def load_model_shifts(path: str) -> dict:
    """{obj_id: (3,) meters}: per-object model-frame offsets from a JSON file
    {"1": [x, y, z], ...}. YCB-V scorer checkpoints were trained on model
    clouds in the original YCB frame, whose origin differs per object from
    the BOP models' (the role of zephyr's modelPointsShiftYcbv2Bop)."""
    import json

    with open(path) as f:
        raw = json.load(f)
    return {int(k): np.asarray(v, np.float32).reshape(3) for k, v in raw.items()}


def shift_model_points(points: np.ndarray, shift: np.ndarray) -> np.ndarray:
    """A constant object-frame offset added to a model cloud (meters)."""
    return np.asarray(points, np.float32) + np.asarray(shift, np.float32).reshape(1, 3)
