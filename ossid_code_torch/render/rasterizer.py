"""Software z-buffer triangle rasterizer.

Replaces the reference's pyrender/OpenGL offscreen renderer
(`zephyr.utils.renderer.Renderer`, SURVEY.md Z8/N5), which the online loop
uses once per frame to render the predicted pose into a depth map for
pseudo-label visible-mask estimation (ref scripts/online_learning.py:485-500).

Two renderers: native C++ (native/rasterizer.cpp via ctypes, compiled by
kernels/build.py::native_library) for the loop's depth-only renders, and a
numpy one that also interpolates vertex colors, for the synthetic data
generator. A depth-only render never falls back to the numpy one.
"""

from __future__ import annotations

import ctypes

import numpy as np

from ossid_code_torch.kernels.build import native_library
from ossid_code_torch.render.mesh import load_ply

_RASTER_SIGNATURES = {"rasterize_depth": ([
    ctypes.POINTER(ctypes.c_double), ctypes.c_int,
    ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
    ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
    ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_float),
], None)}


def render_depth_native(vertices, faces, cam_K, pose, h, w):
    """C++ z-buffer depth render (native/rasterizer.cpp, built at first use)."""
    lib = native_library("rasterizer", _RASTER_SIGNATURES)
    verts = np.ascontiguousarray(vertices, np.float64)
    faces_i = np.ascontiguousarray(faces, np.int32)
    K = np.ascontiguousarray(cam_K, np.float64)
    P = np.ascontiguousarray(pose, np.float64)
    out = np.empty((h, w), np.float32)
    lib.rasterize_depth(
        verts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), len(verts),
        faces_i.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(faces_i),
        K.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        P.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        h, w, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return out


def render_depth(
    vertices: np.ndarray,
    faces: np.ndarray,
    cam_K: np.ndarray,
    pose: np.ndarray,
    h: int,
    w: int,
    colors: np.ndarray | None = None,
):
    """Render mesh depth (and optionally flat-interpolated vertex colors).

    vertices (N, 3) meters (object frame); pose (4, 4) object->camera.
    Returns depth (h, w) float32 meters with 0 = empty, and color (h, w, 3)
    float32 (zeros where empty) if colors given.
    """
    cam = vertices @ pose[:3, :3].T + pose[:3, 3]
    z = cam[:, 2]
    zsafe = np.where(z > 1e-9, z, 1e-9)
    u = cam_K[0, 0] * cam[:, 0] / zsafe + cam_K[0, 2]
    v = cam_K[1, 1] * cam[:, 1] / zsafe + cam_K[1, 2]

    depth = np.full((h, w), np.inf, np.float32)
    color = np.zeros((h, w, 3), np.float32) if colors is not None else None
    cidx = np.full((h, w), -1, np.int64)

    for fi, (a, b, c) in enumerate(faces):
        if z[a] <= 1e-6 or z[b] <= 1e-6 or z[c] <= 1e-6:
            continue
        xs = np.array([u[a], u[b], u[c]])
        ys = np.array([v[a], v[b], v[c]])
        x0, x1 = int(np.floor(xs.min())), int(np.ceil(xs.max()))
        y0, y1 = int(np.floor(ys.min())), int(np.ceil(ys.max()))
        x0, x1 = max(x0, 0), min(x1, w - 1)
        y0, y1 = max(y0, 0), min(y1, h - 1)
        if x1 < x0 or y1 < y0:
            continue
        gx, gy = np.meshgrid(np.arange(x0, x1 + 1), np.arange(y0, y1 + 1))
        d = (xs[1] - xs[0]) * (ys[2] - ys[0]) - (xs[2] - xs[0]) * (ys[1] - ys[0])
        if abs(d) < 1e-12:
            continue
        l1 = ((gx - xs[0]) * (ys[2] - ys[0]) - (gy - ys[0]) * (xs[2] - xs[0])) / d
        l2 = -((gx - xs[0]) * (ys[1] - ys[0]) - (gy - ys[0]) * (xs[1] - xs[0])) / d
        l0 = 1.0 - l1 - l2
        inside = (l0 >= -1e-9) & (l1 >= -1e-9) & (l2 >= -1e-9)
        if not inside.any():
            continue
        # perspective-correct depth: interpolate 1/z
        invz = l0 * (1.0 / z[a]) + l1 * (1.0 / z[b]) + l2 * (1.0 / z[c])
        zpix = 1.0 / np.clip(invz, 1e-9, None)
        yy, xx = gy[inside], gx[inside]
        zz = zpix[inside].astype(np.float32)
        closer = zz < depth[yy, xx]
        depth[yy[closer], xx[closer]] = zz[closer]
        if colors is not None:
            cw = np.stack([l0[inside][closer], l1[inside][closer], l2[inside][closer]], 1)
            col = cw @ colors[[a, b, c]]
            color[yy[closer], xx[closer]] = col
        cidx[yy[closer], xx[closer]] = fi

    depth[~np.isfinite(depth)] = 0.0
    if colors is not None:
        return depth, color
    return depth


def decimate_vertex_clustering(
    vertices: np.ndarray,
    faces: np.ndarray,
    target_faces: int = 5000,
    colors: np.ndarray | None = None,
):
    """Vertex-clustering mesh decimation: snap vertices to a uniform grid,
    collapse each cluster to its centroid, drop degenerate and duplicate
    faces. Unlike uniform face subsampling (ADVICE r1, medium) this preserves
    the surface — no holes — so the rendered depth stays a valid pseudo-label
    mask source (the reference relies on pyrender rendering the full mesh,
    ref scripts/online_learning.py:485-500).

    Returns (vertices, faces[, colors]) with roughly <= target_faces faces
    (binary search on the cell size; the input is returned unchanged when it
    is already small enough)."""
    faces = np.asarray(faces)
    vertices = np.asarray(vertices, np.float64)
    if len(faces) <= target_faces:
        return (vertices, faces) if colors is None else (vertices, faces, colors)

    lo = vertices.min(0)
    diag = float(np.linalg.norm(vertices.max(0) - lo))

    def cluster(cell):
        key = np.floor((vertices - lo) / cell).astype(np.int64)
        _, inv = np.unique(key, axis=0, return_inverse=True)
        inv = inv.reshape(-1)
        n = int(inv.max()) + 1
        counts = np.bincount(inv, minlength=n).astype(np.float64)
        cents = np.stack(
            [np.bincount(inv, weights=vertices[:, k], minlength=n) for k in range(3)], 1
        ) / counts[:, None]
        f2 = inv[faces]
        keep = (f2[:, 0] != f2[:, 1]) & (f2[:, 1] != f2[:, 2]) & (f2[:, 0] != f2[:, 2])
        f2 = f2[keep]
        if len(f2):
            _, uidx = np.unique(np.sort(f2, 1), axis=0, return_index=True)
            f2 = f2[np.sort(uidx)]
        cols2 = None
        if colors is not None:
            cols2 = np.stack(
                [np.bincount(inv, weights=np.asarray(colors, np.float64)[:, k], minlength=n)
                 for k in range(colors.shape[1])], 1,
            ) / counts[:, None]
        return cents, f2, cols2

    # face count decreases monotonically with cell size: bisect for the finest
    # grid that meets the target
    c_lo, c_hi = diag / 2048.0, diag / 2.0
    best = None
    for _ in range(14):
        cell = np.sqrt(c_lo * c_hi)
        v2, f2, cols2 = cluster(cell)
        if len(f2) > target_faces:
            c_lo = cell
        else:
            best = (v2, f2, cols2)
            c_hi = cell
    if best is None:  # even the finest probe was above target; take coarsest
        best = cluster(c_hi)
    v2, f2, cols2 = best
    v2 = v2.astype(vertices.dtype, copy=False)
    return (v2, f2) if colors is None else (v2, f2, cols2)


class Renderer:
    """Interface-compatible with the reference's renderer usage
    (ref scripts/online_learning.py:485-493): addObject once, then update
    `obj_nodes[obj_id].matrix` and call render(depth_only=True)."""

    class _Node:
        def __init__(self, matrix):
            self.matrix = matrix

    def __init__(self, meta_data: dict, img_h: int = 480, img_w: int = 640):
        self.cam_K = np.array(
            [
                [meta_data["camera_fx"], 0, meta_data["camera_cx"]],
                [0, meta_data["camera_fy"], meta_data["camera_cy"]],
                [0, 0, 1.0],
            ]
        )
        self.img_h, self.img_w = img_h, img_w
        self.meshes: dict = {}
        self.obj_nodes: dict = {}

    def addObject(self, obj_id, model_path: str, pose=None, mm2m: bool = False, simplify: bool = False):
        mesh = load_ply(model_path)
        if mm2m:
            mesh.vertices = mesh.vertices / 1000.0
        # 12k-face budget: on a >=100k-face mesh the decimated pseudo-label
        # masks stay within IoU >= 0.97 of full-mesh renders (5k gave 0.948 —
        # below the 0.95 fidelity floor; tests/test_decimation_fidelity.py)
        # at +0.6 ms/render
        if simplify and len(mesh.faces) > 12000:
            if mesh.colors is not None:
                mesh.vertices, mesh.faces, mesh.colors = decimate_vertex_clustering(
                    mesh.vertices, mesh.faces, 12000, colors=mesh.colors
                )
            else:
                mesh.vertices, mesh.faces = decimate_vertex_clustering(
                    mesh.vertices, mesh.faces, 12000
                )
        self.meshes[obj_id] = mesh
        self.obj_nodes[obj_id] = Renderer._Node(np.eye(4) if pose is None else np.asarray(pose))

    def render(self, depth_only: bool = False):
        depth = np.full((self.img_h, self.img_w), np.inf, np.float32)
        color = np.zeros((self.img_h, self.img_w, 3), np.float32)
        for obj_id, mesh in self.meshes.items():
            pose = self.obj_nodes[obj_id].matrix
            if depth_only:
                d = render_depth_native(
                    mesh.vertices, mesh.faces, self.cam_K, pose, self.img_h, self.img_w
                )
                closer = (d > 0) & (d < depth)
                depth[closer] = d[closer]
                continue
            if mesh.colors is not None and not depth_only:
                d, c = render_depth(
                    mesh.vertices, mesh.faces, self.cam_K, pose, self.img_h, self.img_w,
                    colors=mesh.colors,
                )
            else:
                d = render_depth(mesh.vertices, mesh.faces, self.cam_K, pose, self.img_h, self.img_w)
                c = None
            closer = (d > 0) & (d < depth)
            depth[closer] = d[closer]
            if c is not None:
                color[closer] = c[closer]
        depth[~np.isfinite(depth)] = 0.0
        return color, depth
