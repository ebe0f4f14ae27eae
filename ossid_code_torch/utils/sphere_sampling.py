"""Icosahedron-subdivision viewpoint sampling for template grids, numpy (the
port's copy of ossid_code_tpu/utils/sphere_sampling.py;
ref utils/sphere_sampling.py:5-83 — the viewpoint design behind the
pre-rendered template datasets)."""

from __future__ import annotations

import numpy as np

from ossid_code_torch.render.mesh import make_icosphere


def get_triangles(subdiv: int = 0):
    """Vertices + faces of a unit icosphere after `subdiv` subdivisions."""
    mesh = make_icosphere(1.0, subdiv=subdiv)
    return mesh.vertices, mesh.faces


def sample_points(subdiv: int = 1, hemisphere: bool = False) -> np.ndarray:
    """Quasi-uniform unit view directions; optionally upper hemisphere only."""
    verts, _ = get_triangles(subdiv)
    if hemisphere:
        verts = verts[verts[:, 2] >= -1e-9]
    return verts


def view_rotations(directions: np.ndarray) -> np.ndarray:
    """Object->camera rotations for cameras looking at the origin from each
    direction (z toward the object)."""
    rots = []
    for d in directions:
        z = d / np.linalg.norm(d)
        up = np.array([0.0, 0.0, 1.0]) if abs(z[2]) < 0.95 else np.array([0.0, 1.0, 0.0])
        x = np.cross(up, z)
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        rots.append(np.stack([x, y, z], axis=0))
    return np.stack(rots)
