"""Synthetic mini BOP dataset + template grids (test fixture / hermetic e2e).

The reference has no test suite and can only be exercised against the real
LM-O/YCB-V downloads (SURVEY.md §4). This module fills that gap: it writes a
miniature, fully BOP-format-compliant dataset (rgb/depth/masks/scene_gt/
targets/models) rendered with the in-repo rasterizer, plus DTOID-style
template grids (vid2rot.pkl + %04d_color.png/_xyz.npy/_mask.npy, the format of
ref datasets/template_dataset.py:41-96) and a precomputed "zephyr results"
pickle like the one the online loop preloads (ref
scripts/online_learning.py:246-248). The whole online loop then runs
hermetically with no real datasets.

The port's copy of ossid_code_tpu/data/synthetic.py: PNGs are written by
utils/png.py and BlenderProc HDF5 scenes by utils/hdf5.py, so the files
hold the JAX writer's pixels and arrays, laid out or compressed
differently.
"""

from __future__ import annotations

import json
import os
import pickle

import numpy as np
from scipy.spatial.transform import Rotation

from ossid_code_torch.render.mesh import (
    Mesh, concat_meshes, make_box_mesh, make_icosphere, make_wedge_mesh,
    save_ply, texture_mesh, translate_mesh,
)
from ossid_code_torch.render.rasterizer import render_depth
from ossid_code_torch.render.visib import estimate_visib_mask_gt
from ossid_code_torch.utils import hdf5
from ossid_code_torch.utils.png import write_png


def default_objects() -> dict[int, Mesh]:
    """Two ASYMMETRIC objects with mm-scale vertices (BOP model convention).

    Asymmetric on purpose: plain boxes/spheres admit rigid self-symmetries, so
    depth-only hypothesis generation cannot contain an ADD-correct orientation
    and every pose metric saturates at chance — real BOP objects (and these)
    are geometrically identifiable."""
    return {
        1: make_wedge_mesh(85, 62, 45, taper=0.55, shear=0.35, color=(0.85, 0.3, 0.2)),
        2: make_wedge_mesh(70, 48, 55, taper=0.4, shear=-0.25, color=(0.2, 0.45, 0.85)),
    }


def hard_objects() -> dict[int, Mesh]:
    """Six distinct, asymmetric, TEXTURED objects for the LM-O-difficulty
    hermetic world (VERDICT r2 next-step 4): varied wedges plus compound
    L / T / stepped shapes. All are rotationally asymmetric (poses fully
    determined by visible geometry) and carry high-frequency vertex-color
    texture so appearance features discriminate between them."""
    l_bracket = concat_meshes([
        make_box_mesh(85, 32, 26, color=(0.2, 0.7, 0.3)),
        translate_mesh(make_box_mesh(30, 32, 52, color=(0.3, 0.6, 0.2)),
                       (-27.5, 0, 39)),
    ])
    t_block = concat_meshes([
        make_box_mesh(92, 30, 24, color=(0.7, 0.6, 0.15)),
        translate_mesh(make_box_mesh(28, 62, 24, color=(0.65, 0.5, 0.2)),
                       (18, 16, 24)),
    ])
    steps = concat_meshes([
        make_box_mesh(72, 52, 22, color=(0.55, 0.25, 0.6)),
        translate_mesh(make_box_mesh(44, 34, 22, color=(0.45, 0.3, 0.7)),
                       (-14, -9, 22)),
    ])
    raw = {
        1: make_wedge_mesh(85, 62, 45, taper=0.55, shear=0.35, color=(0.85, 0.3, 0.2)),
        2: make_wedge_mesh(70, 48, 55, taper=0.4, shear=-0.25, color=(0.2, 0.45, 0.85)),
        3: l_bracket,
        4: t_block,
        5: make_wedge_mesh(95, 42, 32, taper=0.7, shear=0.2, color=(0.25, 0.65, 0.65)),
        6: steps,
    }
    return {oid: texture_mesh(m, amp=0.22, subdiv=2, seed=oid) for oid, m in raw.items()}


def pretrain_objects() -> dict[int, Mesh]:
    """Six textured asymmetric shapes DISJOINT from hard_objects(): the
    offline-pretraining world for the reference-faithful demo protocol.
    The reference pretrains DTOID on ShapeNet renders and meets the BOP test
    objects for the first time in the online stream (SURVEY §2 C13, ref
    readme.md); pretraining on the test objects instead makes online
    self-supervision unable to improve the detector by construction."""
    cross = concat_meshes([
        make_box_mesh(90, 26, 22, color=(0.8, 0.45, 0.2)),
        translate_mesh(make_box_mesh(26, 70, 22, color=(0.75, 0.5, 0.25)), (12, 8, 0)),
    ])
    z_bracket = concat_meshes([
        make_box_mesh(70, 28, 20, color=(0.3, 0.4, 0.8)),
        translate_mesh(make_box_mesh(28, 28, 46, color=(0.35, 0.45, 0.75)), (21, 0, 33)),
        translate_mesh(make_box_mesh(46, 28, 20, color=(0.4, 0.5, 0.7)), (30, 0, 56)),
    ])
    u_channel = concat_meshes([
        make_box_mesh(80, 44, 18, color=(0.7, 0.3, 0.55)),
        translate_mesh(make_box_mesh(18, 44, 40, color=(0.65, 0.35, 0.5)), (-31, 0, 29)),
        translate_mesh(make_box_mesh(18, 44, 28, color=(0.6, 0.3, 0.6)), (31, 0, 23)),
    ])
    raw = {
        1: make_wedge_mesh(78, 55, 40, taper=0.3, shear=0.5, color=(0.9, 0.6, 0.2)),
        2: make_wedge_mesh(60, 65, 35, taper=0.6, shear=-0.4, color=(0.2, 0.7, 0.5)),
        3: cross,
        4: z_bracket,
        5: make_wedge_mesh(100, 36, 48, taper=0.45, shear=-0.15, color=(0.5, 0.2, 0.75)),
        6: u_channel,
    }
    return {oid: texture_mesh(m, amp=0.22, subdiv=2, seed=100 + oid)
            for oid, m in raw.items()}


def sampled_objects(n: int, seed: int = 0) -> dict[int, Mesh]:
    """n procedurally sampled asymmetric textured shapes (obj_ids 1..n).

    Shape-variety generator for larger pretraining worlds: the reference
    pretrains DTOID on thousands of ShapeNet models, and the detector's
    zero-shot transfer to novel stream objects is bounded by pretraining
    variety, not epochs. Families: sheared/tapered wedges and 2-3-box
    compounds (L/T/Z/U/cross) with randomized dimensions and offsets — every
    sample is rotationally asymmetric (wedges carry nonzero taper AND shear;
    compounds are offset off-axis) so poses stay identifiable from depth."""
    rng = np.random.default_rng(seed)

    def wedge():
        s = rng.choice([-1.0, 1.0])
        return make_wedge_mesh(
            rng.uniform(55, 100), rng.uniform(30, 68), rng.uniform(28, 55),
            taper=rng.uniform(0.25, 0.7), shear=s * rng.uniform(0.15, 0.55),
            color=tuple(rng.uniform(0.15, 0.9, 3)),
        )

    def compound(n_parts):
        base_l, base_w, base_h = (rng.uniform(60, 95), rng.uniform(26, 50),
                                  rng.uniform(16, 26))
        parts = [make_box_mesh(base_l, base_w, base_h,
                               color=tuple(rng.uniform(0.15, 0.9, 3)))]
        for _ in range(n_parts - 1):
            l, w, h = rng.uniform(18, 50), rng.uniform(18, 50), rng.uniform(18, 55)
            # off-axis offset breaks every mirror/rotational symmetry
            off = (rng.uniform(-base_l / 2, base_l / 2), rng.uniform(0, base_w / 3),
                   rng.uniform(base_h / 2, base_h / 2 + 30))
            parts.append(translate_mesh(
                make_box_mesh(l, w, h, color=tuple(rng.uniform(0.15, 0.9, 3))), off))
        return concat_meshes(parts)

    out = {}
    for i in range(n):
        fam = i % 3
        m = wedge() if fam == 0 else compound(2 if fam == 1 else 3)
        out[i + 1] = texture_mesh(m, amp=0.22, subdiv=2, seed=1000 + seed * 97 + i)
    return out


def _clutter_meshes(rng) -> list[Mesh]:
    """Unannotated distractor geometry (clutter is never a target)."""
    return [
        make_icosphere(28, subdiv=1, color=(0.6, 0.6, 0.6)),
        make_box_mesh(55, 40, 30, color=(0.5, 0.4, 0.35)),
        make_box_mesh(35, 35, 65, color=(0.35, 0.5, 0.45)),
    ]


def _look_at_rotation(direction: np.ndarray) -> np.ndarray:
    """Rotation R (cam axes in world) for a camera at -direction looking at origin."""
    z = direction / np.linalg.norm(direction)
    up = np.array([0.0, 0.0, 1.0]) if abs(z[2]) < 0.95 else np.array([0.0, 1.0, 0.0])
    x = np.cross(up, z)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    return np.stack([x, y, z], axis=0)  # world->cam


def make_synthetic_bop(
    root: str,
    dataset_name: str = "synth",
    n_frames: int = 8,
    img_h: int = 240,
    img_w: int = 320,
    objects: dict[int, Mesh] | None = None,
    seed: int = 0,
    layout: str = "spread",
    n_clutter: int = 0,
    n_scenes: int = 1,
    max_per_frame: int | None = None,
) -> str:
    """Write a BOP dataset under <root>/<dataset_name>; returns its path.

    layout="spread" keeps objects separated in x (the easy fixture);
    layout="cluttered" packs them into two depth rows with overlapping image
    positions so back-row objects are partially occluded (LM-O-like, ≥30%
    occlusion on a subset of frames). n_clutter adds unannotated distractor
    meshes that occlude and add scene structure but are never targets.
    n_scenes > 1 writes several scenes (independent layouts) — one per camera
    stream in the multi-stream serving demos. max_per_frame places a random
    subset of the object set in each frame (targets list only the placed
    objects) so large pretraining-variety object sets (sampled_objects) stay
    inside the camera frustum."""
    rng = np.random.default_rng(seed)
    objects = objects or default_objects()
    ds = os.path.join(root, dataset_name)
    os.makedirs(os.path.join(ds, "models"), exist_ok=True)

    f = 1.2 * max(img_h, img_w)
    K = np.array([[f, 0, img_w / 2], [0, f, img_h / 2], [0, 0, 1.0]])
    with open(os.path.join(ds, "camera.json"), "w") as fp:
        json.dump(
            {"fx": K[0, 0], "fy": K[1, 1], "cx": K[0, 2], "cy": K[1, 2],
             "width": img_w, "height": img_h, "depth_scale": 1.0},
            fp,
        )

    models_info = {}
    for oid, mesh in objects.items():
        save_ply(os.path.join(ds, "models", f"obj_{oid:06d}.ply"), mesh)
        ext = mesh.vertices.max(0) - mesh.vertices.min(0)
        diam = float(np.linalg.norm(mesh.vertices.max(0) - mesh.vertices.min(0)))
        models_info[str(oid)] = {
            "diameter": diam,
            "min_x": float(mesh.vertices[:, 0].min()), "size_x": float(ext[0]),
            "min_y": float(mesh.vertices[:, 1].min()), "size_y": float(ext[1]),
            "min_z": float(mesh.vertices[:, 2].min()), "size_z": float(ext[2]),
        }
    with open(os.path.join(ds, "models", "models_info.json"), "w") as fp:
        json.dump(models_info, fp)

    clutter = _clutter_meshes(rng) if n_clutter else []
    targets = []
    for scene_id in range(n_scenes):
        scene_dir = os.path.join(ds, "test", f"{scene_id:06d}")
        for sub in ("rgb", "depth", "mask", "mask_visib"):
            os.makedirs(os.path.join(scene_dir, sub), exist_ok=True)
        _write_scene(
            scene_dir, scene_id, objects, clutter, n_frames, img_h, img_w, K,
            layout, n_clutter, rng, targets, max_per_frame=max_per_frame,
        )
    with open(os.path.join(ds, "test_targets_bop19.json"), "w") as fp:
        json.dump(targets, fp)
    return ds


def _write_scene(scene_dir, scene_id, objects, clutter, n_frames, img_h, img_w,
                 K, layout, n_clutter, rng, targets, max_per_frame=None):
    scene_camera, scene_gt, scene_gt_info = {}, {}, {}
    for im_id in range(n_frames):
        frame_objects = objects
        if max_per_frame is not None and len(objects) > max_per_frame:
            pick = rng.permutation(sorted(objects))[:max_per_frame]
            frame_objects = {int(oid): objects[int(oid)] for oid in pick}
        obj_poses = {}
        n_obj = len(frame_objects)
        if layout == "cluttered":
            # two depth rows with overlapping image-space positions: the back
            # row peeks out between (and behind) front-row objects
            order = [int(o) for o in rng.permutation(list(frame_objects))]
            for slot, oid in enumerate(order):
                front = slot % 2 == 0
                n_row = (n_obj + 1) // 2 if front else n_obj // 2
                col = slot // 2 - (n_row - 1) / 2
                R = Rotation.random(random_state=int(rng.integers(1 << 30))).as_matrix()
                t = np.array([
                    col * 0.105 + rng.uniform(-0.02, 0.02) + (0 if front else 0.05),
                    rng.uniform(-0.035, 0.035),
                    rng.uniform(0.44, 0.5) if front else rng.uniform(0.54, 0.66),
                ])
                pose = np.eye(4)
                pose[:3, :3] = R
                pose[:3, 3] = t
                obj_poses[oid] = pose
        else:
            # place every object at a random pose; keep them separated in x
            for slot, oid in enumerate(frame_objects):
                R = Rotation.random(random_state=int(rng.integers(1 << 30))).as_matrix()
                t = np.array(
                    [
                        (slot - (n_obj - 1) / 2) * 0.12 + rng.uniform(-0.01, 0.01),
                        rng.uniform(-0.03, 0.03),
                        rng.uniform(0.45, 0.6),
                    ]
                )
                pose = np.eye(4)
                pose[:3, :3] = R
                pose[:3, 3] = t
                obj_poses[oid] = pose

        # render each object separately (mm -> m vertices)
        renders = {}
        for oid, mesh in frame_objects.items():
            d, c = render_depth(
                mesh.vertices / 1000.0, mesh.faces, K, obj_poses[oid], img_h, img_w,
                colors=mesh.colors,
            )
            renders[oid] = (d, c)

        # composite with z-buffer + gray background at 2 m
        depth = np.full((img_h, img_w), 2.0, np.float32)
        color = np.full((img_h, img_w, 3), 0.45, np.float32)
        noise = rng.normal(0, 0.02, (img_h, img_w, 3)).astype(np.float32)
        color = np.clip(color + noise, 0, 1)
        for oid, (d, c) in renders.items():
            closer = (d > 0) & (d < depth)
            depth[closer] = d[closer]
            color[closer] = c[closer]
        # unannotated clutter occludes targets and clutters PPF's scene cloud
        for ci in range(n_clutter):
            cm = clutter[ci % len(clutter)]
            cpose = np.eye(4)
            cpose[:3, :3] = Rotation.random(
                random_state=int(rng.integers(1 << 30))).as_matrix()
            cpose[:3, 3] = [rng.uniform(-0.22, 0.22), rng.uniform(-0.1, 0.1),
                            rng.uniform(0.5, 0.75)]
            d, c = render_depth(cm.vertices / 1000.0, cm.faces, K, cpose,
                                img_h, img_w, colors=cm.colors)
            closer = (d > 0) & (d < depth)
            depth[closer] = d[closer]
            color[closer] = c[closer]

        write_png(
            os.path.join(scene_dir, "rgb", f"{im_id:06d}.png"),
            (color * 255).round().astype(np.uint8),
        )
        write_png(
            os.path.join(scene_dir, "depth", f"{im_id:06d}.png"),
            (depth * 1000).round().astype(np.uint16),
        )

        cam_entry = {"cam_K": K.reshape(-1).tolist(), "depth_scale": 1.0}
        scene_camera[str(im_id)] = cam_entry
        gt_list, info_list = [], []
        for gi, (oid, pose) in enumerate(obj_poses.items()):
            d, _ = renders[oid]
            mask_full = (d > 0).astype(np.uint8) * 255
            visib = estimate_visib_mask_gt(depth, d, 0.015).astype(np.uint8) * 255
            write_png(os.path.join(scene_dir, "mask", f"{im_id:06d}_{gi:06d}.png"), mask_full)
            write_png(
                os.path.join(scene_dir, "mask_visib", f"{im_id:06d}_{gi:06d}.png"), visib
            )
            gt_list.append(
                {
                    "obj_id": oid,
                    "cam_R_m2c": pose[:3, :3].reshape(-1).tolist(),
                    "cam_t_m2c": (pose[:3, 3] * 1000.0).tolist(),
                }
            )
            px_count = int((mask_full > 0).sum())
            visib_count = int((visib > 0).sum())
            info_list.append(
                {
                    "px_count_all": px_count,
                    "px_count_visib": visib_count,
                    "visib_fract": visib_count / max(px_count, 1),
                }
            )
            targets.append({"obj_id": oid, "scene_id": scene_id, "im_id": im_id,
                            "inst_count": 1})
        scene_gt[str(im_id)] = gt_list
        scene_gt_info[str(im_id)] = info_list

    for name, obj in (
        ("scene_camera.json", scene_camera),
        ("scene_gt.json", scene_gt),
        ("scene_gt_info.json", scene_gt_info),
    ):
        with open(os.path.join(scene_dir, name), "w") as fp:
            json.dump(obj, fp)


def make_template_grid(
    grid_root: str,
    objects: dict[int, Mesh],
    n_views: int = 16,
    size: int = 124,
    obj_id_offset: int = 0,
    seed: int = 0,
):
    """Render a viewpoint grid per object in the reference's own-template
    format (ref datasets/template_dataset.py:41-96): <grid_root>/vid2rot.pkl +
    <grid_root>/%06d/%04d_color.png,_xyz.npy,_mask.npy."""
    os.makedirs(grid_root, exist_ok=True)
    rng = np.random.default_rng(seed)

    # view directions: repeatable quasi-uniform sphere sampling
    dirs = rng.normal(size=(n_views, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)

    vid2rot = {}
    rots = []
    for vid, d in enumerate(dirs):
        R = _look_at_rotation(d)
        vid2rot[vid] = R
        rots.append(R)
    with open(os.path.join(grid_root, "vid2rot.pkl"), "wb") as fp:
        pickle.dump(vid2rot, fp)
    # full 4x4 per-object view poses are written alongside (vid2pose_<oid>.pkl);
    # the rotation-only vid2rot is the reference's format
    # (ref datasets/template_dataset.py:43-50)

    for oid, mesh in objects.items():
        odir = os.path.join(grid_root, f"{oid + obj_id_offset:06d}")
        os.makedirs(odir, exist_ok=True)
        verts_m = mesh.vertices / 1000.0
        diam = float(np.linalg.norm(verts_m.max(0) - verts_m.min(0)))
        dist = diam * 1.6
        f = size * dist / (1.15 * diam)
        K = np.array([[f, 0, size / 2], [0, f, size / 2], [0, 0, 1.0]])
        vid2pose = {}
        for vid in range(n_views):
            pose = np.eye(4)
            pose[:3, :3] = vid2rot[vid]
            pose[:3, 3] = [0, 0, dist]
            vid2pose[vid] = pose.copy()
            depth, color = render_depth(
                verts_m, mesh.faces, K, pose, size, size, colors=mesh.colors
            )
            mask = (depth > 0).astype(np.float32)
            # xyz map in the camera frame
            u, v = np.meshgrid(np.arange(size), np.arange(size))
            x = (u - K[0, 2]) * depth / K[0, 0]
            y = (v - K[1, 2]) * depth / K[1, 1]
            xyz = np.stack([x, y, depth], -1).astype(np.float32)
            write_png(
                os.path.join(odir, f"{vid:04d}_color.png"),
                (color * 255).round().astype(np.uint8),
            )
            np.save(os.path.join(odir, f"{vid:04d}_xyz.npy"), xyz)
            np.save(os.path.join(odir, f"{vid:04d}_mask.npy"), mask)
        with open(os.path.join(odir, "vid2pose.pkl"), "wb") as fp:
            pickle.dump(vid2pose, fp)
    return grid_root


def make_blenderproc_hdf5(
    path: str,
    objects: dict[int, Mesh],
    obj_poses: dict[int, np.ndarray],
    img_h: int = 128,
    img_w: int = 160,
    noise: float = 0.02,
    seed: int = 0,
):
    """Write one BlenderProc-format HDF5 scene (the format of the reference's
    offline render datasets, ref datasets/render_dataset.py:191-249), rendered
    with the in-repo rasterizer and written by utils/hdf5.py. obj_poses map
    obj_id -> obj->cam (OpenCV)."""
    rng = np.random.default_rng(seed)
    f = 1.2 * max(img_h, img_w)
    K = np.array([[f, 0, img_w / 2], [0, f, img_h / 2], [0, 0, 1.0]])

    depth = np.full((img_h, img_w), 2.0, np.float32)
    color = np.clip(
        np.full((img_h, img_w, 3), 0.4, np.float32) + rng.normal(0, noise, (img_h, img_w, 3)),
        0, 1,
    ).astype(np.float32)
    seg_class = np.zeros((img_h, img_w), np.int32)
    seg_inst = np.zeros((img_h, img_w), np.int32)
    normals_map = np.full((img_h, img_w, 3), 0.5, np.float32)

    for inst_idx, (oid, pose) in enumerate(obj_poses.items(), start=1):
        mesh = objects[oid]
        d, c = render_depth(mesh.vertices / 1000.0, mesh.faces, K, pose, img_h, img_w,
                            colors=mesh.colors)
        closer = (d > 0) & (d < depth)
        depth[closer] = d[closer]
        color[closer] = c[closer]
        seg_class[closer] = oid
        seg_inst[closer] = inst_idx
        normals_map[closer] = [0.5, 0.5, 0.0]  # facing camera (-z), encoded (n+1)/2

    # camera at origin: OpenCV cam == world; store the Blender-convention
    # cam2world (y up, z backward) that load_hdf5 flips back
    cam2world = np.eye(4)
    cam2world[:3, 1] *= -1
    cam2world[:3, 2] *= -1
    campose = [{"cam2world_matrix": cam2world.tolist(), "cam_K": K.reshape(-1).tolist()}]

    segcolormap = [
        {"category_id": int(oid), "idx": i + 1, "channel_class": 0, "channel_instance": 1}
        for i, oid in enumerate(obj_poses)
    ]
    object_states = []
    for oid, pose in obj_poses.items():
        # obj2world == obj2cam (camera at world origin, OpenCV frame)
        euler = Rotation.from_matrix(pose[:3, :3]).as_euler("XYZ", degrees=False)
        object_states.append(
            {"name": f"obj_{oid:06d}", "location": pose[:3, 3].tolist(),
             "rotation_euler": euler.tolist()}
        )

    hdf5.write(path, {
        "colors": (color * 255).astype(np.uint8),
        "depth": depth,
        "segmap": np.stack([seg_class, seg_inst], axis=-1).astype(np.int32),
        "normals": normals_map,
        "campose": np.frombuffer(json.dumps(campose).encode(), np.uint8),
        "segcolormap": np.frombuffer(json.dumps(segcolormap).encode(), np.uint8),
        "object_states": np.frombuffer(json.dumps(object_states).encode(), np.uint8),
    })
    return path


RENDER_ROW = 3   # objects a row in a render-world scene


def make_render_world(root: str, n_scenes: int = 4, n_grid_views: int = 6, seed: int = 0,
                      objects: dict[int, Mesh] | None = None, img_h: int = 128, img_w: int = 160):
    """Synthetic offline-pretraining world: multi-object BlenderProc scenes
    under <root>/scenes + single-object template grids (128x128 renders)
    under <root>/grid/<oid>/ + object2files.json (ref
    scripts/index_render_dataset.py output format).

    The JAX package's function with two more arguments, `objects` (default:
    default_objects()) and the scenes' size: objects stand RENDER_ROW to a
    row, rows 0.12 m apart, so that up to RENDER_ROW objects are placed as
    the JAX package places them and six stay in view."""
    rng = np.random.default_rng(seed)
    objects = default_objects() if objects is None else objects
    scenes_dir = os.path.join(root, "scenes")
    os.makedirs(scenes_dir, exist_ok=True)

    cols = min(len(objects), RENDER_ROW)
    rows = -(-len(objects) // RENDER_ROW)
    obj2files: dict[str, list[str]] = {str(o): [] for o in objects}
    for si in range(n_scenes):
        obj_poses = {}
        for slot, oid in enumerate(objects):
            row, col = divmod(slot, RENDER_ROW)
            pose = np.eye(4)
            pose[:3, :3] = Rotation.random(random_state=int(rng.integers(1 << 30))).as_matrix()
            pose[:3, 3] = [
                (col - (cols - 1) / 2) * 0.12,
                (row - (rows - 1) / 2) * 0.12 + rng.uniform(-0.02, 0.02),
                rng.uniform(0.45, 0.6),
            ]
            obj_poses[oid] = pose
        name = f"scene_{si:04d}"
        make_blenderproc_hdf5(
            os.path.join(scenes_dir, name + ".hdf5"), objects, obj_poses, img_h=img_h, img_w=img_w,
            seed=int(rng.integers(1 << 30)),
        )
        for oid in objects:
            obj2files[str(oid)].append(name)

    grid_dir = os.path.join(root, "grid")
    for oid, mesh in objects.items():
        odir = os.path.join(grid_dir, str(oid))
        os.makedirs(odir, exist_ok=True)
        verts_m = mesh.vertices / 1000.0
        diam = float(np.linalg.norm(verts_m.max(0) - verts_m.min(0)))
        for vi in range(n_grid_views):
            pose = np.eye(4)
            pose[:3, :3] = Rotation.random(random_state=1000 + vi).as_matrix()
            pose[:3, 3] = [0, 0, diam * 1.8]
            make_blenderproc_hdf5(
                os.path.join(odir, f"{vi:04d}.hdf5"), {oid: mesh}, {oid: pose},
                img_h=128, img_w=128, noise=0.0,
            )
    with open(os.path.join(scenes_dir, "object2files.json"), "w") as fp:
        json.dump(obj2files, fp)
    return scenes_dir, grid_dir


def make_zephyr_results_pkl(
    path: str, bop_dataset, noise_t: float = 0.003, score: float = 50.0, seed: int = 0
):
    """Precomputed pose-verification results for every target, GT + noise —
    the stand-in for the zephyr result pickles the reference ships and preloads
    (ref scripts/online_learning.py:246-248,367-378)."""
    rng = np.random.default_rng(seed)
    results = []
    for t in bop_dataset.targets:
        data = bop_dataset.getDataByIds(t["obj_id"], t["scene_id"], t["im_id"])
        pose = data["mat_gt"].copy()
        pose[:3, 3] += rng.normal(0, noise_t, 3)
        results.append(
            {
                "obj_id": t["obj_id"],
                "scene_id": t["scene_id"],
                "im_id": t["im_id"],
                "score": score,
                "pred_pose": pose,
                "pred_mask_visib": np.asarray(data["mask_gt_visib"]) > 0,
            }
        )
    with open(path, "wb") as fp:
        pickle.dump(results, fp)
    return path
