"""PPF surface matching — ctypes wrapper over native/ppf.cpp (the port's copy
of ossid_code_tpu/hypo/ppf.py; the library is compiled from the repository's
source at first use by kernels/build.py::native_library).

Interface-compatible replacement for the commercial Halcon wrapper the
reference uses (`zephyr.utils.halcon_wrapper.PPFModel`, SURVEY.md N1):
  PPFModel(model_path, ModelSamplingDist=0.025)
  find_surface_model(scene_pc_mm, ...) -> (poses_mm (M,4,4), scores, seconds)

Note on units: the reference feeds the wrapper MILLIMETERS and converts the
returned translations to meters (ref scripts/online_learning.py:416-419);
this wrapper keeps that convention.
"""

from __future__ import annotations

import ctypes
import time

import numpy as np

from ossid_code_torch.hypo.base import HypothesisGenerator
from ossid_code_torch.kernels.build import native_library

_SIGNATURES = {
    "ppf_create": ([ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
                    ctypes.c_int, ctypes.c_double, ctypes.c_double], ctypes.c_void_p),
    "ppf_destroy": ([ctypes.c_void_p], None),
    "ppf_match": ([ctypes.c_void_p, ctypes.POINTER(ctypes.c_double), ctypes.c_int,
                   ctypes.c_double, ctypes.c_double, ctypes.c_int,
                   ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double)], ctypes.c_int),
}


def _as_double_ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


class PPFModel(HypothesisGenerator):
    """Train a PPF model from a mesh file or point cloud; match in scenes."""

    def __init__(self, model_path_or_points, normals=None,
                 ModelSamplingDist: float = 0.025, angle_step_deg: float = 12.0,
                 scene_sampling_dist: float = 0.03, ref_pt_rate: float = 0.4,
                 max_poses: int = 100):
        self.scene_sampling_dist = scene_sampling_dist
        self.ref_pt_rate = ref_pt_rate
        self.max_poses = int(max_poses)
        lib = native_library("ppf", _SIGNATURES)
        if isinstance(model_path_or_points, str):
            from ossid_code_torch.render.mesh import load_ply
            from ossid_code_torch.loop.online_learning import model_cloud_from_ply

            mesh = load_ply(model_path_or_points)
            pts_m, _, nrm = model_cloud_from_ply(mesh, n_points=4096)
            points = pts_m * 1000.0  # model file is mm; cloud sampler returns m
            normals = nrm
            self.model_points_m = pts_m
        else:
            points = np.asarray(model_path_or_points, np.float64)
            normals = None if normals is None else np.asarray(normals, np.float64)
            self.model_points_m = points / 1000.0

        points = np.ascontiguousarray(points, np.float64)
        nptr = None
        if normals is not None:
            normals = np.ascontiguousarray(normals, np.float64)
            nptr = _as_double_ptr(normals)
        self._handle = lib.ppf_create(
            _as_double_ptr(points), nptr, len(points),
            ctypes.c_double(ModelSamplingDist), ctypes.c_double(angle_step_deg),
        )
        self._lib = lib

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.ppf_destroy(self._handle)
            self._handle = None

    def find_surface_model(self, scene_pc, DensePoseRefinement="false",
                           SceneSamplingDist: float | None = None,
                           RefPtRate: float | None = None,
                           max_poses: int | None = None, **kwargs):
        """scene_pc: (N, 3) in the SAME unit the model was trained in (the
        reference convention is mm). Returns (poses (M,4,4), scores, seconds)."""
        t0 = time.perf_counter()
        if SceneSamplingDist is None:
            SceneSamplingDist = self.scene_sampling_dist
        if RefPtRate is None:
            RefPtRate = self.ref_pt_rate
        if max_poses is None:
            max_poses = self.max_poses
        scene = np.ascontiguousarray(np.asarray(scene_pc, np.float64))
        out_poses = np.zeros((max_poses, 4, 4), np.float64)
        out_scores = np.zeros((max_poses,), np.float64)
        n = self._lib.ppf_match(
            self._handle, _as_double_ptr(scene), len(scene),
            ctypes.c_double(SceneSamplingDist), ctypes.c_double(RefPtRate),
            max_poses, _as_double_ptr(out_poses), _as_double_ptr(out_scores),
        )
        dt = time.perf_counter() - t0
        if n == 0:
            # fail closed: the reference's Halcon path returns an empty pose
            # list and the loop falls back to precomputed results
            # (ref online_learning.py:367-378). Returning identity here would
            # let a miscalibrated scorer pseudo-label garbage.
            return np.zeros((0, 4, 4)), np.zeros((0,)), dt
        return out_poses[:n], out_scores[:n], dt


class PPFModelMeters(PPFModel):
    """Convenience wrapper trained/matched in meters (used by the loop to
    skip the reference's mm round trip).

    refine_top > 0 runs point-to-point host ICP (hypo/icp.py) of the top-N
    hypotheses against the (subsampled) scene cloud, the equivalent of
    Halcon's DensePoseRefinement (the reference's LM-O hypotheses arrive
    pre-refined, which is why its loop skips ICP there, ref
    scripts/online_learning.py:172)."""

    def __init__(self, *args, refine_top: int = 10, refine_max_dist: float = 0.01,
                 model_points_m: np.ndarray | None = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.refine_top = refine_top
        self.refine_max_dist = refine_max_dist
        self._refine_model_pts = model_points_m if model_points_m is not None else self.model_points_m

    def find_surface_model(self, scene_pc_m, **kwargs):
        t0 = time.perf_counter()
        poses, scores, _ = super().find_surface_model(np.asarray(scene_pc_m) * 1000.0, **kwargs)
        poses = poses.copy()
        poses[:, :3, 3] /= 1000.0

        if self.refine_top > 0 and self._refine_model_pts is not None and len(scene_pc_m) > 50:
            from scipy.spatial import cKDTree

            from ossid_code_torch.hypo.icp import icp_point_cloud, icp_refine_native

            scene = np.asarray(scene_pc_m, np.float64)
            if len(scene) > 1200:
                scene = scene[np.linspace(0, len(scene) - 1, 1200).round().astype(int)]
            mp = self._refine_model_pts
            if len(mp) > 400:
                mp = mp[np.linspace(0, len(mp) - 1, 400).round().astype(int)]
            tree = None
            for i in range(min(self.refine_top, len(poses))):
                out = icp_refine_native(poses[i], mp, scene, icp_max_dist=self.refine_max_dist, max_iter=12)
                if out is not None:
                    poses[i] = out[0]
                    continue
                # the C++ solver found too few correspondences
                if tree is None:
                    tree = cKDTree(scene)
                refined, err, _ = icp_point_cloud(poses[i], mp, tree, scene,
                                                  icp_max_dist=self.refine_max_dist, max_iter=12)
                if np.isfinite(err):
                    poses[i] = refined
        return poses, scores, time.perf_counter() - t0
