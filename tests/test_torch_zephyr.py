"""Parity of the PyTorch port's Zephyr scorer with the JAX package's, on the CPU.

Weights go across through `pointnet2_from_jax`, with BatchNorm statistics
and affine terms perturbed (the `_randomize_stats` pattern of
tests/test_zephyr_fused.py) so the BatchNorm fold is really exercised.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ossid_code_torch.models.zephyr import features as tfeat
from ossid_code_torch.models.zephyr import module as tmod
from ossid_code_torch.models.zephyr.jax_import import pointnet2_from_jax
from ossid_code_torch.models.zephyr.pointnet2 import PointNet2SSG as TPointNet2SSG

torch.set_num_threads(2)
TOL = dict(rtol=2e-4, atol=2e-4)  # tests/test_zephyr_fused.py:75,121


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), jax.device_get(tree))


def _randomize(params, stats, rng):
    def walk(p, s):
        for key, node in p.items():
            if key.startswith("bn") or key.startswith("bn_"):
                node["scale"] = rng.uniform(0.5, 1.5, node["scale"].shape).astype(np.float32)
                node["bias"] = rng.uniform(0.5, 1.5, node["bias"].shape).astype(np.float32)
                s[key]["mean"] = rng.normal(0, 0.5, s[key]["mean"].shape).astype(np.float32)
                s[key]["var"] = (rng.normal(0, 0.5, s[key]["var"].shape) ** 2 + 0.3).astype(np.float32)
            elif isinstance(node, dict) and key in s:
                walk(node, s[key])
    walk(params, stats)
    if "align_head" in params:
        params["align_head"]["kernel"] = rng.normal(0, 1.0, params["align_head"]["kernel"].shape).astype(np.float32)
        params["align_head"]["bias"] = rng.normal(0, 0.5, params["align_head"]["bias"].shape).astype(np.float32)
    return params, stats


def _static_idx(rng, n):
    pts = rng.normal(0, 0.3, (n, 3)).astype(np.float32)
    sa1_n, sa2_n = min(512, n), min(128, n)
    sa1c = np.arange(sa1_n, dtype=np.int32) if sa1_n == n else tmod._fps_np(pts, sa1_n)
    c1 = pts[sa1c]
    sa1g = tmod._ball_np(c1, pts, 0.4, min(64, n))
    sa2c = tmod._fps_np(c1, sa2_n).astype(np.int32)
    sa2g = tmod._ball_np(c1[sa2c], c1, 0.8, 64)
    return {"sa1": (sa1c.astype(np.int32), sa1g), "sa2": (sa2c, sa2g)}


@pytest.mark.parametrize("align_feats", [False, True])
def test_pointnet2_matches_flax(align_feats):
    from ossid_code_tpu.models.zephyr.pointnet2 import PointNet2SSG
    from ossid_code_tpu.models.zephyr.torch_import import export_pointnet2_state_dict

    rng = np.random.default_rng(0)
    n = 256
    net = PointNet2SSG(num_class=1, dim_point=11, align_feats=align_feats)
    v = net.init(jax.random.PRNGKey(0), jnp.zeros((2, n, 11)), train=False)
    params, stats = _randomize(_np_tree(v["params"]), _np_tree(v["batch_stats"]), rng)
    idx = _static_idx(rng, n)
    point_x = rng.normal(0, 0.5, (4, n, 11)).astype(np.float32)
    point_x[..., 10] = rng.uniform(size=(4, n)) > 0.3
    want = np.asarray(net.apply({"params": params, "batch_stats": stats}, jnp.asarray(point_x),
                                train=False, static_idx={k: tuple(map(jnp.asarray, p)) for k, p in idx.items()}))

    tnet = TPointNet2SSG(num_class=1, dim_point=11, align_feats=align_feats)
    sd = pointnet2_from_jax(params, stats)
    tnet.load_state_dict(sd, strict=True)
    ref = export_pointnet2_state_dict(params, stats)
    assert set(sd) - {"align_head.weight", "align_head.bias"} == set(ref)
    for k, val in ref.items():
        np.testing.assert_array_equal(sd[k].numpy(), val, err_msg=k)
    with torch.inference_mode():
        got = tnet.eval()(torch.from_numpy(point_x),
                          {k: tuple(map(torch.from_numpy, p)) for k, p in idx.items()}).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def _scene(rng, h=48, w=64, n_pts=300, m=37):
    pts = rng.normal(0, 0.05, (n_pts, 3)).astype(np.float32)
    normals = rng.normal(0, 1, (n_pts, 3))
    normals = (normals / np.linalg.norm(normals, axis=1, keepdims=True)).astype(np.float32)
    poses = np.tile(np.eye(4, dtype=np.float32), (m, 1, 1))
    poses[:, :3, 3] = np.stack([rng.normal(0, 0.02, m), rng.normal(0, 0.02, m),
                                rng.uniform(0.8, 1.2, m)], 1)
    return {
        "img": (rng.uniform(0, 1, (h, w, 3)) * 255).astype(np.uint8),
        "depth": (rng.uniform(0.8, 1.3, (h, w)) * 1000).astype(np.uint16),
        "cam_K": np.array([[60.0, 0, w / 2], [0, 60.0, h / 2], [0, 0, 1]], np.float32),
        "model_points": pts,
        "model_colors": rng.uniform(0, 1, (n_pts, 3)).astype(np.float32),
        "model_normals": normals,
        "pose_hypos": poses,
    }


@pytest.mark.parametrize("packed", [False, True])
def test_features_and_blur_match_jax(packed):
    from ossid_code_tpu.models.zephyr.features import assemble_score_features
    from ossid_code_tpu.models.zephyr.module import _blur5

    rng = np.random.default_rng(1)
    d = _scene(rng)
    img = d["img"].astype(np.float32) / 255.0
    np.testing.assert_allclose(tmod._blur5(torch.from_numpy(img)).numpy(),
                               np.asarray(_blur5(jnp.asarray(img))), rtol=1e-6, atol=1e-6)
    depth = d["depth"].astype(np.float32) / 1000.0
    crop, origin = depth[5:45, 10:50], np.array([5, 10], np.int32)
    args = (img, crop, d["cam_K"], d["model_points"], d["model_colors"], d["model_normals"],
            d["pose_hypos"])
    want = assemble_score_features(*map(jnp.asarray, args), depth_origin=jnp.asarray(origin),
                                   packed_sample=packed)
    got = tfeat.assemble_score_features(*map(torch.from_numpy, args),
                                        depth_origin=torch.from_numpy(origin), packed_sample=packed)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)


def test_host_helpers_are_copies():
    from ossid_code_tpu.models.zephyr import module as jmod

    rng = np.random.default_rng(2)
    pts = rng.normal(0, 0.1, (200, 3))
    np.testing.assert_array_equal(tmod._fps_np(pts, 50), jmod._fps_np(pts, 50))
    c = pts[:20]
    np.testing.assert_array_equal(tmod._ball_np(c, pts, 0.1, 16), jmod._ball_np(c, pts, 0.1, 16))
    assert [tmod._bucket(m) for m in (1, 64, 65, 100, 300)] == [jmod._bucket(m) for m in (1, 64, 65, 100, 300)]
    np.testing.assert_array_equal(tmod._BLUR_K, jmod._BLUR_K)


@pytest.mark.parametrize("th", [100.0, 0.0])
def test_score_hypotheses_parity(th):
    """ZephyrModel.score_hypotheses at num_points=128: scores at 2e-4 and the
    same pick; th=0 prunes every hypothesis and exercises the fallback to the
    raw network scores."""
    from ossid_code_tpu.models.zephyr.module import ZephyrModel

    rng = np.random.default_rng(3)
    jz = ZephyrModel(num_points=128, inconst_ratio_th=th, seed=0, need_uv=True)
    params, stats = _randomize(_np_tree(jz.params), _np_tree(jz.batch_stats), rng)
    jz.load_state_dict({"params": params, "batch_stats": stats})
    tz = tmod.ZephyrModel(num_points=128, inconst_ratio_th=th, seed=0, need_uv=True, device="cpu")
    tz.load_state_dict(pointnet2_from_jax(params, stats))

    d = _scene(rng)
    want = jz.score_hypotheses(d, obj_id=7, fetch_uv=True)
    got = tz.score_hypotheses(d, obj_id=7, fetch_uv=True)
    np.testing.assert_allclose(got["scores"], want["scores"], **TOL)
    np.testing.assert_allclose(got["inconst_ratio"], want["inconst_ratio"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got["align_stat"], want["align_stat"], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got["uv"], want["uv"], rtol=1e-5, atol=1e-4)
    assert got["pred_idx"] == want["pred_idx"]
    np.testing.assert_array_equal(got["pred_pose"], want["pred_pose"])
    assert np.isfinite(got["scores"]).all()


def test_refine_top_is_not_ported_yet():
    """refine_top is ported now: the score program with device ICP of the
    first 4 hypotheses gives JAX's refined poses (1e-4) and scores (2e-4)."""
    from ossid_code_tpu.models.zephyr.module import ZephyrModel

    rng = np.random.default_rng(6)
    jz = ZephyrModel(num_points=128, seed=0, need_uv=False, refine_top=4)
    params, stats = _randomize(_np_tree(jz.params), _np_tree(jz.batch_stats), rng)
    jz.load_state_dict({"params": params, "batch_stats": stats})
    tz = tmod.ZephyrModel(num_points=128, seed=0, need_uv=False, refine_top=4, device="cpu")
    tz.load_state_dict(pointnet2_from_jax(params, stats))
    d = _scene(rng)
    handle = jz.score_hypotheses_async(d, obj_id=7)
    want = jz.fetch_scores(handle)
    got = tz.fetch_scores(tz.score_hypotheses_async(d, obj_id=7))
    np.testing.assert_allclose(got["refined"], np.asarray(jax.device_get(handle["refined_dev"])),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(got["scores"], want["scores"], **TOL)
    assert got["pred_idx"] == want["pred_idx"]
    np.testing.assert_allclose(got["pred_pose"], want["pred_pose"], rtol=0, atol=1e-4)


def test_fake_hypo_gen_is_a_copy():
    from ossid_code_tpu.hypo.fake import FakeHypoGen
    from ossid_code_torch.hypo.fake import FakeHypoGen as TFakeHypoGen

    anchor = np.eye(4)
    anchor[:3, 3] = (0.01, -0.02, 0.9)
    outs = []
    for cls in (FakeHypoGen, TFakeHypoGen):
        gen = cls(n_hypos=50, seed=4)
        gen.set_anchor(anchor)
        outs.append(gen.find_surface_model(np.zeros((0, 3)))[:2])
    np.testing.assert_allclose(outs[1][0], outs[0][0], rtol=0, atol=1e-12)
    np.testing.assert_array_equal(outs[1][1], outs[0][1])


@pytest.mark.parametrize("rank_blend", [0.0, 0.5, 2.0])
def test_pick_matches_jax(rank_blend):
    """The winning hypothesis with and without the blended ranking, with
    pruned (-inf) entries, as the JAX package's `_pick` chooses it."""
    from types import SimpleNamespace

    from ossid_code_tpu.models.zephyr.module import ZephyrModel

    rng = np.random.default_rng(5)
    tz = tmod.ZephyrModel(num_points=64, rank_blend=rank_blend, device="cpu")
    for _ in range(20):
        scores = rng.normal(0, 3, 40).astype(np.float32)
        scores[rng.uniform(size=40) < 0.3] = -np.inf
        stat = rng.uniform(0, 1, 40).astype(np.float32)
        want = ZephyrModel._pick(SimpleNamespace(rank_blend=rank_blend), scores, stat)
        assert tz._pick(scores, stat) == want
