"""Homography / 3D-rigid-warp augmentation sampling on the host (the port of
ossid_code_tpu/utils/homographies.py, without cv2).

The reference's SuperPoint-style augmentation stack (ref
utils/homographies.py): `sample_homography` draws a random valid
perspective/scale/rotate/translate homography over normalized corners;
`sample_trans_3d` draws a random SE(3) transform of scene anchor points and
returns both the induced image homography and the (R, t); `sample_warp`
produces matched keypoint pairs for correspondence training. Warping on
tensors lives in ops/warp.py.

cv2's three calls are written here in numpy, to cv2's results:
`get_perspective_transform` builds cv2.getPerspectiveTransform's 8x8 system
(its products of two float32 coordinates rounded to float32) and solves it
by cv2's LU (partial pivoting, the eliminated rows updated in float64 without
fused multiply-adds, the back substitution divided by the pivot);
`warp_keypoints` is cv2.perspectiveTransform's homogeneous divide; the SIFT
branch of `sample_warp` runs the port's SIFT (ops/sift.py, on `device`) and
takes its keypoints in the order of cv2's `detect`, so the weighted
`rng.choice` by response draws what cv2's would where the keypoints agree.
"""

from __future__ import annotations

import numpy as np

from ossid_code_torch.utils.geometry import estimate_rigid_body_transform

FLT_EPSILON = 1.1920928955078125e-07


def proj_cloud(pts: np.ndarray, cam_K: np.ndarray) -> np.ndarray:
    """Project (N, 3) camera-frame points to pixel (row, col) = (v, u)
    (the JAX package's utils/geometry.py::proj_cloud)."""
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    col = cam_K[0, 0] * x / z + cam_K[0, 2]
    row = cam_K[1, 1] * y / z + cam_K[1, 2]
    return np.stack([row, col], axis=1)


def get_perspective_transform(src, dst) -> np.ndarray:
    """cv2.getPerspectiveTransform(src, dst) for (4, 2) float32 point sets:
    the (3, 3) float64 homography with H[2, 2] = 1."""
    src = np.asarray(src, np.float32)
    dst = np.asarray(dst, np.float32)
    a = [[0.0] * 8 for _ in range(8)]
    b = [0.0] * 8
    for i in range(4):
        sx, sy = src[i]
        dx, dy = dst[i]
        a[i][0] = a[i + 4][3] = float(sx)
        a[i][1] = a[i + 4][4] = float(sy)
        a[i][2] = a[i + 4][5] = 1.0
        a[i][6], a[i][7] = -float(sx * dx), -float(sy * dx)
        a[i + 4][6], a[i + 4][7] = -float(sx * dy), -float(sy * dy)
        b[i], b[i + 4] = float(dx), float(dy)
    for i in range(8):
        k = i
        for j in range(i + 1, 8):
            if abs(a[j][i]) > abs(a[k][i]):
                k = j
        if abs(a[k][i]) < np.finfo(np.float64).eps * 100:
            raise np.linalg.LinAlgError("degenerate point sets: no perspective transform")
        if k != i:
            a[i], a[k] = a[k], a[i]
            b[i], b[k] = b[k], b[i]
        d = -1.0 / a[i][i]
        for j in range(i + 1, 8):
            alpha = a[j][i] * d
            for c in range(i + 1, 8):
                a[j][c] += alpha * a[i][c]
            b[j] += alpha * b[i]
    for i in range(7, -1, -1):
        s = b[i]
        for c in range(i + 1, 8):
            s -= a[i][c] * b[c]
        b[i] = s / a[i][i]
    return np.asarray(b + [1.0], np.float64).reshape(3, 3)


def rand_rot_mat(Z_max=90.0, X_max=30.0, Y_max=30.0, rng=None) -> np.ndarray:
    """Random Euler rotation (ref utils/__init__.py:100-105)."""
    from scipy.spatial.transform import Rotation

    rng = rng or np.random.default_rng()
    angles = [rng.uniform(-Z_max, Z_max), rng.uniform(-X_max, X_max), rng.uniform(-Y_max, Y_max)]
    return Rotation.from_euler("ZXY", angles, degrees=True).as_matrix()


def sample_homography(
    image_shape,
    perspective=True, scaling=True, rotation=True, translation=True,
    n_scales=5, n_angles=25, scaling_amplitude=0.1,
    perspective_amplitude_x=0.1, perspective_amplitude_y=0.1,
    patch_ratio=0.5, max_angle=np.pi / 2,
    allow_artifacts=True, translation_overflow=0.1,
    rng=None,
):
    """Random valid homography over an image of `image_shape` (h, w)
    (ref utils/homographies.py:173-309)."""
    rng = rng or np.random.default_rng()

    pts1 = np.array([[0.0, 0.0], [0.0, 1.0], [1.0, 1.0], [1.0, 0.0]])
    margin = (1 - patch_ratio) * 0.5
    pts2 = margin + patch_ratio * pts1

    def t_perspective(points):
        t_min, t_max = -points.min(axis=0), 1.0 - points.max(axis=0)
        t_max[1] = min(abs(t_min[1]), abs(t_max[1]))
        t_min[1] = -t_max[1]
        if not allow_artifacts:
            lo = np.maximum(np.array([-perspective_amplitude_x, -perspective_amplitude_y]), t_min)
            hi = np.minimum(np.array([perspective_amplitude_x, perspective_amplitude_y]), t_max)
        else:
            lo = np.array([-perspective_amplitude_x, -perspective_amplitude_y])
            hi = np.array([perspective_amplitude_x, perspective_amplitude_y])
        persp = rng.uniform(lo[1], hi[1])
        left = rng.uniform(lo[0], hi[0])
        right = rng.uniform(lo[0], hi[0])
        return points + np.array(
            [[left, persp], [left, -persp], [right, persp], [right, -persp]]
        )

    def t_scale(points):
        scales = rng.uniform(-scaling_amplitude, scaling_amplitude, n_scales) + 1.0
        center = points.mean(axis=0)
        scaled = (points - center)[None] * scales[:, None, None] + center
        if allow_artifacts:
            valid = np.arange(n_scales)
        else:
            valid = [i for i in range(n_scales)
                     if scaled[i].max() < 1.0 and scaled[i].min() >= 0.0] or [0]
        return scaled[rng.choice(valid)]

    def t_translation(points):
        t_min, t_max = -points.min(axis=0), 1.0 - points.max(axis=0)
        if allow_artifacts:
            t_min -= translation_overflow
            t_max += translation_overflow
        return points + np.array(
            [rng.uniform(t_min[0], t_max[0]), rng.uniform(t_min[1], t_max[1])]
        )

    def t_rotation(points):
        angles = rng.uniform(-max_angle, max_angle, n_angles)
        angles = np.append(angles, 0.0)
        center = points.mean(axis=0)
        rot = np.stack(
            [np.cos(angles), -np.sin(angles), np.sin(angles), np.cos(angles)], axis=1
        ).reshape(-1, 2, 2)
        rotated = np.matmul((points - center)[None], rot) + center
        if allow_artifacts:
            valid = np.arange(n_angles)
        else:
            valid = [i for i in range(len(angles))
                     if rotated[i].max() < 1.0 and rotated[i].min() >= 0.0] or [len(angles) - 1]
        return rotated[rng.choice(valid)]

    fns = []
    if perspective:
        fns.append(t_perspective)
    if scaling:
        fns.append(t_scale)
    if translation:
        fns.append(t_translation)
    if rotation:
        fns.append(t_rotation)
    for i in rng.permutation(len(fns)):
        pts2 = fns[i](pts2)

    shape = np.asarray(image_shape)[::-1]  # (w, h)
    pts1 = (pts1 * shape).astype(np.float32)
    pts2 = (pts2 * shape).astype(np.float32)
    return get_perspective_transform(pts1, pts2)


def sample_trans_3d(xyz: np.ndarray, cam_K: np.ndarray, rng=None):
    """Random SE(3) warp of scene anchor points -> (homography, R, t)
    (ref utils/homographies.py:103-158)."""
    rng = rng or np.random.default_rng()
    x_span = xyz[:, :, 0].max() - xyz[:, :, 0].min()
    y_span = xyz[:, :, 1].max() - xyz[:, :, 1].min()

    denom = max((xyz[:, :, -1] != 0).sum(), 1)
    mean = xyz.sum((0, 1)) / denom
    pts1 = np.stack(
        [
            mean,
            mean + np.asarray([0.0, 0.42, 0.2]),
            mean + np.asarray([0.41, 0.0, 0.1]),
            mean + np.asarray([0.43, 0.44, -0.15]),
        ]
    )
    pts1_proj = proj_cloud(pts1, cam_K)

    while True:
        pts2 = pts1.copy()
        rot_mat = rand_rot_mat(X_max=40, Y_max=40, rng=rng)
        center = mean.reshape(-1, 1)
        pts2 = (rot_mat @ (pts2.T - center) + center).T
        trans = np.asarray(
            [
                (rng.random() - 0.5) * y_span * 0.2,
                (rng.random() - 0.5) * x_span * 0.2,
                rng.random() * mean[2],
            ]
        )
        pts2 = pts2 + trans
        try:
            TR, Tt = estimate_rigid_body_transform(pts1.T, pts2.T)
        except np.linalg.LinAlgError:
            continue
        break

    pts2_proj = proj_cloud(pts2, cam_K)
    H = get_perspective_transform(
        pts1_proj.astype(np.float32)[:, ::-1], pts2_proj.astype(np.float32)[:, ::-1]
    )
    return H, TR.astype(np.float32), Tt.astype(np.float32)


def warp_keypoints(keypoints: np.ndarray, homography: np.ndarray, return_type=np.int64):
    """Warp (N, 2) keypoints in (row, col) order (ref utils/homographies.py:311-324)."""
    if len(keypoints) == 0:
        return keypoints
    m = np.asarray(homography, np.float64).reshape(-1)
    x = keypoints[:, 1].astype(np.float64)
    y = keypoints[:, 0].astype(np.float64)
    w = x * m[6] + y * m[7] + m[8]
    ok = np.abs(w) > FLT_EPSILON
    w = 1.0 / np.where(ok, w, 1.0)
    u = np.where(ok, (x * m[0] + y * m[1] + m[2]) * w, 0.0)
    v = np.where(ok, (x * m[3] + y * m[4] + m[5]) * w, 0.0)
    return np.stack([v, u], axis=1).astype(return_type)


def filter_points(points: np.ndarray, shape) -> np.ndarray:
    """Drop points outside an image of `shape` (h, w)."""
    if len(points) == 0:
        return points
    keep = (
        (points[:, 0] >= 0) & (points[:, 0] < shape[0])
        & (points[:, 1] >= 0) & (points[:, 1] < shape[1])
    )
    return points[keep]


def filter_points_return_indices(points: np.ndarray, shape) -> np.ndarray:
    keep = (
        (points[:, 0] >= 0) & (points[:, 0] < shape[0])
        & (points[:, 1] >= 0) & (points[:, 1] < shape[1])
    )
    return np.nonzero(keep)[0]


def _sift_keypoints(img, device):
    """The port's SIFT keypoints of an (H, W, 3) uint8 RGB image in the order
    of cv2's `SIFT_create().detect`: by x, then y, size (descending), angle,
    response (descending) and packed octave (descending). Returns their
    (x, y) points and responses."""
    import torch

    from ossid_code_torch.device import resolve_device
    from ossid_code_torch.ops.sift import detect_and_compute, rgb_to_gray

    t = torch.from_numpy(np.ascontiguousarray(img)).to(resolve_device(device))
    kps, _ = detect_and_compute(rgb_to_gray(t))
    order = np.lexsort((-kps.octave.astype(np.int64), -kps.response, kps.angle, -kps.size,
                        kps.pt[:, 1], kps.pt[:, 0]))
    return kps.pt[order], kps.response[order]


def sample_warp(img, xyz, cam_K, n_kpts=128, down_factor=8, random_kpt=True,
                warp_3d=True, rng=None, device=None):
    """Sample a warp + matched keypoint pairs for correspondence supervision
    (ref utils/homographies.py:50-101). Returns (kpts, kpts_warp, H, TR, Tt)
    with keypoints in (row, col), already divided by down_factor. The SIFT
    branch (`random_kpt=False`) runs SIFT on `device` (None: the card)."""
    rng = rng or np.random.default_rng()
    h, w = img.shape[:2]

    if random_kpt:
        kpts = np.stack(
            [rng.integers(h, size=n_kpts // 2), rng.integers(w, size=n_kpts // 2)], axis=1
        )
    else:
        pts, resp = _sift_keypoints(img, device)
        if len(pts) > n_kpts:
            resp = resp.astype(np.float64)
            sel = rng.choice(len(pts), size=n_kpts, replace=False, p=resp / resp.sum())
            pts = pts[sel]
        if len(pts) > 0:
            kpts = pts[:, ::-1].astype(int)
            kpts = filter_points(kpts, (h, w))
        else:
            kpts = np.stack([rng.integers(h, size=n_kpts), rng.integers(w, size=n_kpts)], axis=1)

    if warp_3d:
        H, TR, Tt = sample_trans_3d(xyz, cam_K, rng=rng)
    else:
        H = sample_homography((h, w), rng=rng)
        TR, Tt = np.eye(3, dtype=np.float32), np.zeros((3, 1), np.float32)

    kpts_warp = warp_keypoints(kpts, H)
    idx3 = filter_points_return_indices(kpts_warp, (h, w))

    kpts = kpts // down_factor
    kpts_warp = kpts_warp // down_factor
    _, idx1 = np.unique(kpts, return_index=True, axis=0)
    _, idx2 = np.unique(kpts_warp, return_index=True, axis=0)
    idx = np.intersect1d(np.intersect1d(idx1, idx2, assume_unique=True), idx3, assume_unique=True)

    return kpts[idx], kpts_warp[idx], H.astype(np.float32), TR, Tt
