"""The port's device ICP (ops/icp_device.py) against the JAX package's, on
the CPU: the pseudo-random valid-pixel sample (indices exactly equal, ties
included), refined poses on a well-posed scene, Kabsch on degenerate input,
and the scorer's refined score program with a depth crop. Host ICP
(hypo/icp.py, native/icp.cpp) against the JAX package's on frames of the
synthetic world."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ossid_code_torch.ops import icp_device as ticp
from ossid_code_torch.ops.nms import topk_stable

torch.set_num_threads(2)


def _cam_K(h, w):
    return np.array([[572.4, 0, w / 2 + 0.3], [0, 573.6, h / 2 - 0.2], [0, 0, 1]], np.float32)


def test_sample_indices_match_top_k():
    """The 4096 pixels picked at 480x640, valid first in hash order, are
    JAX's exactly (points equal), and the order is lax.top_k's."""
    from ossid_code_tpu.ops.icp_device import sample_valid_points

    rng = np.random.default_rng(0)
    h, w = 480, 640
    depth = rng.uniform(0.5, 1.5, (h, w)).astype(np.float32)
    depth[rng.uniform(size=(h, w)) < 0.4] = 0.0
    k = _cam_K(h, w)
    origin = np.array([7, 11], np.int32)

    n = h * w
    hsh = (np.arange(n, dtype=np.uint64) * 2654435761) & 0xFFFFFFFF
    r = (hsh >> 8).astype(np.float32) / float(1 << 24)
    score = np.where(depth.reshape(-1) > 1e-6, 1.0 + r, r).astype(np.float32)
    _, want_idx = jax.lax.top_k(jnp.asarray(score), 4096)
    got_idx = ticp.valid_point_order(torch.from_numpy(depth.reshape(-1) > 1e-6), 4096)
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))

    want = sample_valid_points(jnp.asarray(depth), jnp.asarray(k), origin=jnp.asarray(origin), k=4096)
    got = ticp.sample_valid_points(torch.from_numpy(depth), torch.from_numpy(k),
                                   origin=torch.from_numpy(origin), k=4096)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def test_sample_order_keeps_ties_as_top_k():
    """Equal scores keep the lower index first, as lax.top_k does (torch.topk
    promises no order among ties): scores with many ties, some all-equal."""
    rng = np.random.default_rng(4)
    score = rng.integers(0, 5, 5000).astype(np.float32)
    _, want = jax.lax.top_k(jnp.asarray(score), 3000)
    np.testing.assert_array_equal(topk_stable(torch.from_numpy(score), 3000)[1].numpy(),
                                  np.asarray(want))


def _box_cloud(rng, n):
    """Points and outward normals on the faces of a 6 x 4 x 3 cm box."""
    half = np.array([0.03, 0.02, 0.015])
    face = rng.integers(0, 6, n)
    axis, sign = face // 2, np.where(face % 2, 1.0, -1.0)
    pts = rng.uniform(-1, 1, (n, 3)) * half
    pts[np.arange(n), axis] = sign * half[axis]
    nrm = np.zeros((n, 3))
    nrm[np.arange(n), axis] = sign
    return pts.astype(np.float32), nrm.astype(np.float32)


def _rot(rng, sigma):
    from ossid_code_torch.utils.geometry import rotvec_to_matrix

    return rotvec_to_matrix(rng.normal(0, sigma, 3))


def _box_scene(rng):
    """A 6 x 4 x 3 cm box at 0.8 m: 384 model points with normals, the true
    pose, and the scene: every model point under the true pose (so each has
    its own match whichever side faces the camera), then decoys 0.5 mm off
    them in rows marked invalid (they win every match unless the mask holds),
    then invalid zero padding to 4096."""
    model, nrm = _box_cloud(rng, 384)
    gt = np.eye(4)
    gt[:3, :3] = _rot(rng, 0.4)
    gt[:3, 3] = (0.02, -0.01, 0.8)
    sel = model @ gt[:3, :3].T + gt[:3, 3]
    n = len(sel)
    scene = np.zeros((4096, 3), np.float32)
    scene[:n] = sel
    scene[n:2 * n] = sel + rng.normal(0, 0.0005, (n, 3))
    return model, nrm, gt, scene, np.arange(4096) < n


def _icp_both(poses, model, nrm, scene, valid):
    from ossid_code_tpu.ops.icp_device import batched_icp

    want = np.asarray(batched_icp(jnp.asarray(poses), jnp.asarray(model), jnp.asarray(scene),
                                  jnp.asarray(valid), max_dist=0.01, iters=16,
                                  model_normals=jnp.asarray(nrm)))
    got = ticp.batched_icp(torch.from_numpy(poses), torch.from_numpy(model), torch.from_numpy(scene),
                           torch.from_numpy(valid), max_dist=0.01, iters=16,
                           model_normals=torch.from_numpy(nrm)).numpy()
    return got, want


def test_batched_icp_matches_jax():
    """Hypotheses within 1 mm and 0.6 degrees of the truth, where each model
    point's nearest scene point is its own: the gate, the back-face test,
    the weighted Kabsch solve and the pose update give JAX's poses (1e-4).
    Where nearest neighbours are nearly equidistant, both packages pick them
    by |p|^2 + |s|^2 - 2 p.s in float32 and their rounding differs, so
    starts several mm off are held to the truth instead (3 mm), as JAX's."""
    rng = np.random.default_rng(1)
    model, nrm, gt, scene, valid = _box_scene(rng)
    poses = np.stack([gt] * 8).astype(np.float32)
    for i in range(1, 8):
        poses[i, :3, :3] = _rot(rng, 0.006) @ gt[:3, :3]
        poses[i, :3, 3] += rng.normal(0, 0.0006, 3)
    got, want = _icp_both(poses, model, nrm, scene, valid)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    far = np.stack([gt] * 8).astype(np.float32)
    for i in range(8):
        far[i, :3, :3] = _rot(rng, 0.05) @ gt[:3, :3]
        far[i, :3, 3] += rng.normal(0, 0.006, 3)
    got, want = _icp_both(far, model, nrm, scene, valid)
    for out in (got, want):
        assert np.abs(out[:, :3, 3] - gt[:3, 3]).max() < 3e-3


def test_kabsch_degenerate_inputs():
    """Too few weighted points: identity, zero and not ok, as in JAX. A
    mirrored cloud: the determinant fix gives a proper rotation, JAX's. All
    points on one line (rank-1 covariance, the rotation about the line is
    not determined): a finite proper rotation that maps P onto Q."""
    from ossid_code_tpu.ops.icp_device import kabsch_batched

    rng = np.random.default_rng(2)
    p = rng.normal(0, 0.05, (3, 40, 3)).astype(np.float32)
    q = p.copy()
    q[1, :, 0] *= -1.0
    line = rng.normal(0, 0.05, (40, 1)) * np.array([[1.0, 2.0, -0.5]])
    p[2] = line
    q[2] = line @ _rot(rng, 0.3).T + 0.01
    w = np.ones((3, 40), np.float32)
    w[0, 3:] = 0.0

    want = kabsch_batched(*map(jnp.asarray, (p, q, w)))
    got = ticp.kabsch_batched(*map(torch.from_numpy, (p, q, w)))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert not bool(got[2][0])
    np.testing.assert_array_equal(got[0][0].numpy(), np.eye(3, dtype=np.float32))
    np.testing.assert_array_equal(got[1][0].numpy(), np.zeros(3, np.float32))
    np.testing.assert_allclose(got[0][1].numpy(), np.asarray(want[0][1]), atol=1e-5)
    np.testing.assert_allclose(got[1][1].numpy(), np.asarray(want[1][1]), atol=1e-6)
    r = got[0][2].numpy()
    assert np.isfinite(r).all()
    np.testing.assert_allclose(r @ r.T, np.eye(3), atol=1e-5)
    assert abs(np.linalg.det(r) - 1.0) < 1e-5
    mapped = p[2] @ r.T + got[1][2].numpy()
    assert np.abs(mapped - q[2]).max() < 1e-4


def test_refined_score_program_with_depth_crop():
    """ZephyrModel(refine_top=8) scoring a depth crop (depth_origin) of a box
    on a table: the hypotheses ICP leaves alone score as in JAX (2e-4). The
    refined ones are proper rotations within 1 cm and 0.05 of JAX's (ICP's
    nearest neighbours on the table plane turn on float32 rounding, see
    test_batched_icp_matches_jax); at least half of them (6 of 8 on an x86
    CPU) agree with JAX's within 1e-4, and those score as in JAX (2e-4)."""
    from ossid_code_tpu.models.zephyr.module import ZephyrModel

    from ossid_code_torch.models.zephyr.jax_import import pointnet2_from_jax
    from ossid_code_torch.models.zephyr.module import ZephyrModel as TZephyrModel

    rng = np.random.default_rng(3)
    h, w = 96, 128
    model, nrm = _box_cloud(rng, 300)
    gt = np.eye(4)
    gt[:3, 3] = (0.0, 0.0, 0.6)
    k = np.array([[150.0, 0, w / 2], [0, 150.0, h / 2], [0, 0, 1]], np.float32)
    yy, xx = np.mgrid[0:h, 0:w]
    depth = np.full((h, w), 0.7)
    front = (np.abs((xx - w / 2) / 150 * 0.585) < 0.03) & (np.abs((yy - h / 2) / 150 * 0.585) < 0.02)
    depth[front] = 0.585
    poses = np.stack([gt] * 12).astype(np.float32)
    for i in range(12):
        poses[i, :3, :3] = _rot(rng, 0.05)
        poses[i, :3, 3] += rng.normal(0, 0.005, 3)
    crop = (depth[20:84, 30:110] * 1000).astype(np.uint16)
    data = {"img": rng.integers(0, 256, (h, w, 3), dtype=np.uint8), "depth": crop,
            "depth_origin": np.array([20, 30], np.int32), "cam_K": k, "model_points": model,
            "model_colors": rng.uniform(0, 1, (300, 3)).astype(np.float32),
            "model_normals": nrm, "pose_hypos": poses}

    jz = ZephyrModel(num_points=128, seed=0, need_uv=False, refine_top=8)
    tz = TZephyrModel(num_points=128, seed=0, need_uv=False, refine_top=8, device="cpu")
    tz.load_state_dict(pointnet2_from_jax(jax.device_get(jz.params), jax.device_get(jz.batch_stats)))
    handle = jz.score_hypotheses_async(data, obj_id=1)
    want = jz.fetch_scores(handle)
    got = tz.fetch_scores(tz.score_hypotheses_async(data, obj_id=1))
    np.testing.assert_allclose(got["scores"][8:], want["scores"][8:], rtol=2e-4, atol=2e-4)
    refined, want_refined = got["refined"], np.asarray(handle["refined_dev"])
    assert refined.shape == (8, 4, 4) and np.isfinite(refined).all()
    for r in refined[:, :3, :3]:
        np.testing.assert_allclose(r @ r.T, np.eye(3), atol=1e-5)
    np.testing.assert_allclose(refined[:, :3, 3], want_refined[:, :3, 3], atol=1e-2)
    np.testing.assert_allclose(refined[:, :3, :3], want_refined[:, :3, :3], atol=5e-2)
    agree = np.abs(refined - want_refined).max(axis=(1, 2)) <= 1e-4
    assert agree.sum() >= 4, agree
    np.testing.assert_allclose(got["scores"][:8][agree], want["scores"][:8][agree], rtol=2e-4, atol=2e-4)


# ------------------------------------------------------------------ host ICP
@pytest.fixture(scope="module")
def synth_world(tmp_path_factory):
    """A synthetic world (2 frames of 120x160, 2 objects) and the JAX
    package's ICP library, built as its own tests build it: without it the
    JAX code would run its Python ICP instead of the C++ one."""
    import subprocess
    from pathlib import Path

    from ossid_code_tpu.data.synthetic import make_synthetic_bop
    from ossid_code_tpu.hypo.icp import _load_icp_lib

    subprocess.run(["make", "-C", str(Path(__file__).resolve().parents[1] / "native"), "-s"], check=True)
    assert _load_icp_lib() is not None
    root = str(tmp_path_factory.mktemp("icpworld"))
    make_synthetic_bop(root, n_frames=2, img_h=120, img_w=160)
    return root


@pytest.mark.parametrize("sigma_t", [0.0, 0.004, 0.012])
def test_host_icp_refinement_matches_jax(synth_world, sigma_t):
    """icp_refinement of the GT pose moved by a small rotation and a shift
    of sigma_t per axis, on every target of the world: the same C++ solver on
    the same inputs, so the refined poses and residuals agree to 1e-9 (and
    the refinement moved the pose)."""
    from ossid_code_tpu.data.bop import BopDataset, BopDatasetArgs
    from ossid_code_tpu.hypo.icp import icp_refinement
    from ossid_code_tpu.loop.online_learning import model_cloud_from_ply
    from ossid_code_tpu.render.mesh import load_ply

    from ossid_code_torch.hypo.icp import icp_refinement as t_icp_refinement

    bop = BopDataset(BopDatasetArgs(bop_root=synth_world, dataset_name="synth"))
    rng = np.random.default_rng(int(sigma_t * 1e4))
    moved = 0
    for t in bop.targets:
        d = bop.getDataByIds(t["obj_id"], t["scene_id"], t["im_id"])
        pts = model_cloud_from_ply(load_ply(bop.getObjPath(t["obj_id"])))[0]
        cam_K = np.asarray(d["scene_camera"]["cam_K"])
        pose = np.asarray(d["mat_gt"], np.float64).copy()
        pose[:3, :3] = _rot(rng, 0.05) @ pose[:3, :3]
        pose[:3, 3] += rng.normal(0, sigma_t, 3)
        cam = pts @ pose[:3, :3].T + pose[:3, 3]
        uv = np.stack([cam_K[0, 0] * cam[:, 0] / cam[:, 2] + cam_K[0, 2],
                       cam_K[1, 1] * cam[:, 1] / cam[:, 2] + cam_K[1, 2]], 1).round().astype(int)
        want = icp_refinement(d["depth"], uv, pose, cam_K, pts, icp_max_dist=0.01)
        got = t_icp_refinement(d["depth"], uv, pose, cam_K, pts, icp_max_dist=0.01)
        np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-9)
        assert abs(got[1] - want[1]) <= 1e-9
        moved += not np.allclose(want[0], pose)
    assert moved == len(bop.targets)
