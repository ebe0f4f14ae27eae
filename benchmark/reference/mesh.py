"""Minimal triangle-mesh IO and primitives (numpy only — trimesh/plyfile are
not in this environment).

Reads/writes the PLY flavor used by BOP model files (`obj_%06d.ply`: ascii or
binary_little_endian, vertex x/y/z[/nx/ny/nz][/red/green/blue], triangular
faces), which the reference consumes through pyrender/Halcon/bop_renderer
(SURVEY.md N1/N5, Z8).
"""

from __future__ import annotations

import struct

import numpy as np


class Mesh:
    def __init__(self, vertices, faces, colors=None, normals=None):
        self.vertices = np.asarray(vertices, np.float64)
        self.faces = np.asarray(faces, np.int64)
        self.colors = None if colors is None else np.asarray(colors)
        self.normals = None if normals is None else np.asarray(normals)


def load_ply(path: str) -> Mesh:
    with open(path, "rb") as f:
        line = f.readline().strip()
        assert line == b"ply", f"not a PLY file: {path}"
        fmt = None
        elements = []  # (name, count, [(prop_type, prop_name) | ('list', idx_t, cnt_t, name)])
        cur_props = None
        while True:
            line = f.readline().strip()
            if not line or line == b"end_header":
                break
            parts = line.decode().split()
            if parts[0] == "format":
                fmt = parts[1]
            elif parts[0] == "element":
                cur_props = []
                elements.append((parts[1], int(parts[2]), cur_props))
            elif parts[0] == "property":
                if parts[1] == "list":
                    cur_props.append(("list", parts[2], parts[3], parts[4]))
                else:
                    cur_props.append((parts[1], parts[2]))

        type_map = {
            "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
            "uchar": "u1", "uint8": "u1", "char": "i1", "int8": "i1",
            "ushort": "u2", "uint16": "u2", "short": "i2", "int16": "i2",
            "uint": "u4", "uint32": "u4", "int": "i4", "int32": "i4",
        }

        verts = faces = colors = normals = None
        for name, count, props in elements:
            if name == "vertex":
                if fmt == "ascii":
                    rows = [f.readline().split() for _ in range(count)]
                    arr = np.asarray(rows, np.float64)
                else:
                    dt = np.dtype([(p[1], "<" + type_map[p[0]]) for p in props])
                    arr_s = np.frombuffer(f.read(dt.itemsize * count), dtype=dt)
                    arr = np.stack([arr_s[p[1]].astype(np.float64) for p in props], 1)
                names = [p[1] for p in props]
                ix = [names.index(c) for c in ("x", "y", "z")]
                verts = arr[:, ix]
                if "nx" in names:
                    normals = arr[:, [names.index(c) for c in ("nx", "ny", "nz")]]
                if "red" in names:
                    colors = arr[:, [names.index(c) for c in ("red", "green", "blue")]] / 255.0
            elif name == "face":
                if fmt == "ascii":
                    rows = [f.readline().split() for _ in range(count)]
                    faces = np.asarray([r[1:4] for r in rows], np.int64)
                else:
                    lst = props[0]
                    cnt_t = np.dtype("<" + type_map[lst[1]])
                    idx_t = np.dtype("<" + type_map[lst[2]])
                    out = np.empty((count, 3), np.int64)
                    buf = f.read()
                    off = 0
                    for i in range(count):
                        n = int(np.frombuffer(buf, cnt_t, 1, off)[0])
                        off += cnt_t.itemsize
                        idx = np.frombuffer(buf, idx_t, n, off)
                        off += idx_t.itemsize * n
                        out[i] = idx[:3]
                    faces = out
    return Mesh(verts, faces, colors=colors, normals=normals)


def save_ply(path: str, mesh: Mesh):
    """ASCII PLY with optional per-vertex color/normals."""
    v = mesh.vertices
    has_c = mesh.colors is not None
    has_n = mesh.normals is not None
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(v)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if has_n:
            f.write("property float nx\nproperty float ny\nproperty float nz\n")
        if has_c:
            f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write(f"element face {len(mesh.faces)}\n")
        f.write("property list uchar int vertex_indices\nend_header\n")
        cols = (np.clip(mesh.colors, 0, 1) * 255).round().astype(int) if has_c else None
        for i in range(len(v)):
            row = list(v[i])
            if has_n:
                row += list(mesh.normals[i])
            f.write(" ".join(f"{x:.6f}" for x in row))
            if has_c:
                f.write(" " + " ".join(str(c) for c in cols[i]))
            f.write("\n")
        for face in mesh.faces:
            f.write("3 " + " ".join(str(int(i)) for i in face) + "\n")


def make_box_mesh(sx, sy, sz, color=(0.8, 0.2, 0.2)) -> Mesh:
    """Axis-aligned box centered at the origin (dimensions in the caller's unit)."""
    hx, hy, hz = sx / 2, sy / 2, sz / 2
    corners = np.array(
        [[sgn_x * hx, sgn_y * hy, sgn_z * hz]
         for sgn_x in (-1, 1) for sgn_y in (-1, 1) for sgn_z in (-1, 1)],
        np.float64,
    )
    # 12 triangles, outward winding not required by the z-buffer renderer
    quads = [
        (0, 1, 3, 2), (4, 6, 7, 5),  # x- , x+
        (0, 4, 5, 1), (2, 3, 7, 6),  # y- , y+
        (0, 2, 6, 4), (1, 5, 7, 3),  # z- , z+
    ]
    faces = []
    for a, b, c, d in quads:
        faces += [(a, b, c), (a, c, d)]
    colors = np.tile(np.asarray(color, np.float64), (8, 1))
    # vary the corner colors slightly so rendered templates have gradients
    colors += (corners / np.abs(corners).max() * 0.08)
    colors = np.clip(colors, 0, 1)
    normals = corners / np.linalg.norm(corners, axis=1, keepdims=True)
    return Mesh(corners, np.asarray(faces), colors=colors, normals=normals)


def subdivide_mesh(mesh: Mesh, n: int = 1) -> Mesh:
    """Midpoint subdivision (flat): each triangle -> 4; colors/normals averaged."""
    verts = [np.asarray(v) for v in mesh.vertices]
    colors = None if mesh.colors is None else [np.asarray(c) for c in mesh.colors]
    normals = None if mesh.normals is None else [np.asarray(x) for x in mesh.normals]
    faces = mesh.faces
    for _ in range(n):
        cache: dict = {}

        def midpoint(i, j):
            key = (min(i, j), max(i, j))
            if key not in cache:
                verts.append((verts[i] + verts[j]) / 2.0)
                if colors is not None:
                    colors.append((colors[i] + colors[j]) / 2.0)
                if normals is not None:
                    nrm = normals[i] + normals[j]
                    normals.append(nrm / max(np.linalg.norm(nrm), 1e-12))
                cache[key] = len(verts) - 1
            return cache[key]

        new_faces = []
        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [(a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca)]
        faces = np.asarray(new_faces)
    return Mesh(
        np.stack(verts), faces,
        colors=None if colors is None else np.stack(colors),
        normals=None if normals is None else np.stack(normals),
    )


def make_wedge_mesh(sx, sy, sz, taper=0.55, shear=0.35, color=(0.8, 0.5, 0.2)) -> Mesh:
    """Sheared tapered box (asymmetric hexahedron): the top face is scaled by
    `taper` and shifted by `shear * sx` along +x, killing every rotational
    symmetry — a pose on this shape is fully determined by its visible
    geometry (a plain box or sphere is not, which makes depth-only hypothesis
    generation provably unable to recover ADD-correct orientations)."""
    hx, hy, hz = sx / 2, sy / 2, sz / 2
    bottom = np.array(
        [[-hx, -hy, -hz], [hx, -hy, -hz], [hx, hy, -hz], [-hx, hy, -hz]], np.float64
    )
    top = bottom.copy()
    top[:, :2] *= taper
    top[:, 0] += shear * sx
    top[:, 2] = hz
    corners = np.concatenate([bottom, top])
    quads = [
        (0, 1, 2, 3), (4, 7, 6, 5),  # bottom, top
        (0, 4, 5, 1), (1, 5, 6, 2), (2, 6, 7, 3), (3, 7, 4, 0),  # sides
    ]
    faces = []
    for a, b, c, d in quads:
        faces += [(a, b, c), (a, c, d)]
    colors = np.tile(np.asarray(color, np.float64), (8, 1))
    colors += corners / np.abs(corners).max() * 0.12
    colors = np.clip(colors, 0, 1)
    normals = corners / np.linalg.norm(corners, axis=1, keepdims=True)
    return Mesh(corners, np.asarray(faces), colors=colors, normals=normals)


def make_icosphere(radius, subdiv=1, color=(0.2, 0.6, 0.8)) -> Mesh:
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array(
        [
            [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
            [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
            [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
        ],
        np.float64,
    )
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ]
    )
    for _ in range(subdiv):
        new_faces = []
        verts = list(map(np.asarray, verts))
        cache = {}

        def midpoint(i, j):
            key = (min(i, j), max(i, j))
            if key not in cache:
                m = verts[i] + verts[j]
                m /= np.linalg.norm(m)
                verts.append(m)
                cache[key] = len(verts) - 1
            return cache[key]

        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [(a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca)]
        faces = np.asarray(new_faces)
        verts = np.stack(verts)
    verts = verts * radius
    colors = np.tile(np.asarray(color, np.float64), (len(verts), 1))
    colors += verts / radius * 0.1
    colors = np.clip(colors, 0, 1)
    normals = verts / np.linalg.norm(verts, axis=1, keepdims=True)
    return Mesh(verts, faces, colors=colors, normals=normals)


def concat_meshes(meshes) -> Mesh:
    """Union of meshes into one (vertex/face concatenation; colors default to
    gray where absent). Used to compose asymmetric compound shapes (L/T
    brackets, stepped blocks) for the hard synthetic world. Piece-local
    vertex normals are preserved when every piece has them — downstream
    model-cloud sampling orients face normals by them, which stays correct in
    the concave regions where a global-centroid rule flips the sign."""
    verts, faces, colors, normals = [], [], [], []
    have_n = all(m.normals is not None for m in meshes)
    off = 0
    for m in meshes:
        verts.append(m.vertices)
        faces.append(m.faces + off)
        colors.append(m.colors if m.colors is not None
                      else np.full((len(m.vertices), 3), 0.5))
        if have_n:
            normals.append(m.normals)
        off += len(m.vertices)
    return Mesh(np.concatenate(verts), np.concatenate(faces),
                colors=np.concatenate(colors),
                normals=np.concatenate(normals) if have_n else None)


def translate_mesh(mesh: Mesh, offset) -> Mesh:
    return Mesh(mesh.vertices + np.asarray(offset, np.float64), mesh.faces,
                colors=mesh.colors, normals=mesh.normals)


def texture_mesh(mesh: Mesh, amp: float = 0.25, subdiv: int = 2, seed: int = 0) -> Mesh:
    """Subdivide and jitter per-vertex colors: high-frequency texture so both
    SIFT featurization and appearance-based detection have something to grip."""
    m = subdivide_mesh(mesh, subdiv)
    rng = np.random.default_rng(seed)
    cols = m.colors if m.colors is not None else np.full((len(m.vertices), 3), 0.5)
    m.colors = np.clip(cols + rng.uniform(-amp, amp, cols.shape), 0, 1)
    return m
