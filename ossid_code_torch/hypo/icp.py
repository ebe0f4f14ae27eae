"""Depth-based ICP pose refinement on the host (the port's copy of
ossid_code_tpu/hypo/icp.py).

Point-to-point ICP between the model cloud at the predicted pose and the
scene cloud unprojected from depth around the predicted object region, with
a correspondence distance cap (`icp_max_dist`, the reference uses 0.01 m on
YCB-V, ref scripts/online_learning.py:473-480). The solver is the
repository's C++ source `native/icp.cpp`, compiled at first use by
kernels/build.py::native_library; a missing compiler or a failed build
raises. When the C++ solver reports a failed refinement (fewer than 10
correspondences), `icp_refinement` runs `icp_point_cloud`, as the JAX
package does.
"""

from __future__ import annotations

import ctypes

import numpy as np
from scipy.spatial import cKDTree

from ossid_code_torch.kernels.build import native_library
from ossid_code_torch.utils.geometry import depth2cloud, estimate_rigid_body_transform

_DOUBLE_P = ctypes.POINTER(ctypes.c_double)
_SIGNATURES = {
    "icp_refine": ([_DOUBLE_P, ctypes.c_int, _DOUBLE_P, ctypes.c_int, _DOUBLE_P,
                    ctypes.c_double, ctypes.c_double, ctypes.c_int], ctypes.c_double),
}


def icp_refine_native(pose, model_points, scene_points, icp_max_dist=0.01,
                      coarse_start=0.04, max_iter=20):
    """C++ ICP (native/icp.cpp); returns (refined_pose, rms), or None when
    the refinement failed."""
    lib = native_library("icp", _SIGNATURES)
    mp = np.ascontiguousarray(model_points, np.float64)
    sp = np.ascontiguousarray(scene_points, np.float64)
    p = np.ascontiguousarray(pose, np.float64).copy()
    err = lib.icp_refine(mp.ctypes.data_as(_DOUBLE_P), len(mp), sp.ctypes.data_as(_DOUBLE_P), len(sp),
                         p.ctypes.data_as(_DOUBLE_P), ctypes.c_double(icp_max_dist),
                         ctypes.c_double(coarse_start), max_iter)
    if err < 0:
        return None
    return p, float(err)


def icp_point_cloud(
    pose: np.ndarray,
    model_points: np.ndarray,
    scene_tree: "cKDTree",
    scene_points: np.ndarray,
    icp_max_dist: float = 0.01,
    max_iter: int = 20,
    tol: float = 1e-7,
    coarse_start: float | None = 0.04,
):
    """Point-to-point ICP of a model cloud (object frame) against a scene
    cloud, starting from `pose`. Returns (refined_pose, rms, inlier_fraction).
    Scene -> model correspondences (every scene point observes the surface,
    so partial visibility does not bias them); the correspondence cap anneals
    from `coarse_start` down to `icp_max_dist`."""
    cur = np.asarray(pose, np.float64).copy()
    model = np.asarray(model_points, np.float64)
    prev_err = np.inf
    err, frac = np.inf, 0.0
    start = max(coarse_start or icp_max_dist, icp_max_dist)
    for it in range(max_iter):
        cap = max(icp_max_dist, start * (0.7 ** it))
        tm = model @ cur[:3, :3].T + cur[:3, 3]
        tree = cKDTree(tm)
        dist, idx = tree.query(scene_points, distance_upper_bound=cap)
        ok = np.isfinite(dist)
        frac = ok.mean()
        if ok.sum() < 10:
            return pose, np.inf, 0.0
        err = float(np.sqrt((dist[ok] ** 2).mean()))
        R, t = estimate_rigid_body_transform(tm[idx[ok]].T, scene_points[ok].T)
        delta = np.eye(4)
        delta[:3, :3] = R
        delta[:3, 3] = t[:, 0]
        cur = delta @ cur
        if abs(prev_err - err) < tol:
            break
        prev_err = err
    return cur, err, float(frac)


def icp_refinement(
    depth: np.ndarray,
    uv: np.ndarray,
    pose: np.ndarray,
    cam_K: np.ndarray,
    model_points: np.ndarray,
    icp_max_dist: float = 0.01,
    max_iter: int = 30,
    tol: float = 1e-6,
):
    """Refine `pose` (4, 4, meters) against the observed depth.

    uv: (N, 2) integer pixel coords (u=col, v=row) of the model points under
    `pose`, which crop the scene region (the reference passes
    `uv_original[pred_idx]`). Returns (refined_pose, final_rms_error); the
    input pose when there are too few scene points."""
    h, w = depth.shape
    uv = np.asarray(uv)
    u1, v1 = uv.min(axis=0)
    u2, v2 = uv.max(axis=0)
    pad = max(10, int(0.2 * max(u2 - u1, v2 - v1)))
    u1, v1 = max(0, int(u1) - pad), max(0, int(v1) - pad)
    u2, v2 = min(w, int(u2) + pad), min(h, int(v2) + pad)
    if u2 <= u1 or v2 <= v1:
        return pose, np.inf

    region = np.zeros_like(depth, dtype=bool)
    region[v1:v2, u1:u2] = True
    region &= depth > 0
    scene = depth2cloud(depth, region, cam_K).astype(np.float64)
    if len(scene) < 30:
        return pose, np.inf
    if len(scene) > 2000:
        scene = scene[np.linspace(0, len(scene) - 1, 2000).round().astype(int)]

    model = np.asarray(model_points, np.float64)
    if len(model) > 500:
        model = model[np.linspace(0, len(model) - 1, 500).round().astype(int)]

    out = icp_refine_native(pose, model, scene, icp_max_dist=icp_max_dist,
                            coarse_start=icp_max_dist * 3, max_iter=max_iter)
    if out is not None:
        return out
    cur, err, _ = icp_point_cloud(pose, model, cKDTree(scene), scene, icp_max_dist=icp_max_dist,
                                  max_iter=max_iter, coarse_start=icp_max_dist * 3, tol=tol)
    return cur, err
