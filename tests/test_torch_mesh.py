"""The port's device mesh and serving helpers (ossid_code_torch/parallel/mesh.py,
loop/multi_stream.py::make_farm_detect) against the JAX package's, on the
CPU: JAX's side on the conftest's eight virtual CPU devices, the port's on a
mesh of eight entries `torch.device("cpu")`, both from the same weights
(128x160, DenseNet (2, 2, 2)).

  * the plain F x T correlation against a per-frame loop, exactly;
  * the F-frame detect against JAX's `make_farm_detect` on a 2 x 4 mesh,
    frame by frame, to tests/test_multi_stream.py's tolerances;
  * `make_serving_farm_forward` and `make_template_parallel_forward`
    against JAX's and against the port's unsplit forward;
  * `make_hypothesis_parallel_scorer` with device ICP of the global first
    K hypotheses and M not a multiple of the devices, against JAX's (called
    as __graft_entry__.dryrun_multichip calls it) and the unsplit scorer.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ossid_code_torch.core.config import default_config as t_default_config
from ossid_code_torch.models.dtoid.jax_import import dtoid_from_jax
from ossid_code_torch.models.dtoid.module import DtoidModel as TDtoidModel
from ossid_code_torch.ops.conv import depthwise_corr_plain
from ossid_code_torch.parallel import mesh as tmesh

torch.set_num_threads(2)

H, W, T, F = 128, 160, 4, 2
CPU8 = [torch.device("cpu")] * 8
# entries unequal to the models' device "cpu": the helpers run on copies of
# the current weights there, the path a second card takes
OTHER8 = [torch.device("cpu", 0)] * 8


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), jax.device_get(tree))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cross_correlation_is_a_per_frame_loop(dtype):
    """depthwise_corr_plain(cross=True): sample f * T + t is frame f against
    template t, bit for bit the one-frame broadcast call of each frame."""
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.normal(size=(3, 6, 7, 16)), dtype=dtype)
    k = torch.tensor(rng.normal(size=(5, 3, 3, 16)), dtype=dtype)
    got = depthwise_corr_plain(x, k, 1, cross=True)
    want = torch.cat([depthwise_corr_plain(x[f:f + 1].expand(5, -1, -1, -1), k, 1) for f in range(3)])
    assert got.shape == (15, 6, 7, 16) and got.dtype == dtype
    assert torch.equal(got, want)


def test_mesh_helpers():
    """make_mesh / make_mesh_2d take JAX's arguments and raise with its
    message; shard_batch splits in order, replicate copies; the default
    device list is the cards, and raises without CUDA."""
    m = tmesh.make_mesh(8, devices=CPU8)
    assert m.shape == {"dp": 8} and m.size == 8
    m2 = tmesh.make_mesh_2d(2, 4, devices=CPU8)
    assert m2.shape == {"dp": 2, "tp": 4} and len(m2.axis_devices("tp")) == 4
    with pytest.raises(ValueError, match="requested 9 devices, have 8"):
        tmesh.make_mesh(9, devices=CPU8)
    with pytest.raises(ValueError, match="requested 3x3 devices, have 8"):
        tmesh.make_mesh_2d(3, 3, devices=CPU8)
    x = np.arange(16).reshape(8, 2)
    parts = tmesh.shard_batch(m, {"x": x})["x"]
    assert [p.tolist() for p in parts] == [[list(r)] for r in x.tolist()]
    with pytest.raises(ValueError, match="divide"):
        tmesh.shard_batch(m, x[:6])
    assert len(tmesh.replicate(m2, x)) == 8 and tmesh.batch_pspec() == ("dp",)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tmesh.make_mesh()


@pytest.fixture(scope="module")
def models():
    """A JAX DtoidModel with its heads moved off their init, the port's model
    from the same weights, and one object's template features in each."""
    from ossid_code_tpu.core.config import default_config
    from ossid_code_tpu.models.dtoid.module import DtoidModel

    jcfg, tcfg = default_config(), t_default_config()
    for cfg in (jcfg, tcfg):
        cfg.model.img_h, cfg.model.img_w = H, W
        cfg.model.densenet_blocks = (2, 2, 2)
    rng = np.random.default_rng(7)
    jd = DtoidModel(jcfg, seed=1)
    params = _np_tree(jd.params)
    for head, std in (("classification", 0.05), ("regression", 0.01)):
        node = params[head]["output"]
        node["kernel"] = rng.normal(0, std, node["kernel"].shape).astype(np.float32)
    seg = params["correlation_model"]["seg_final"]
    seg["kernel"] = rng.normal(0, 0.2, seg["kernel"].shape).astype(np.float32)
    stats = _np_tree(jd.batch_stats)
    jd.load_state_dict({"params": params, "batch_stats": stats})
    td = TDtoidModel(tcfg, seed=1, device="cpu")
    td.load_state_dict(dtoid_from_jax(params, stats))
    limg = rng.uniform(0, 1, (T, 124, 124, 3)).astype(np.float32)
    lmask = (rng.uniform(0, 1, (T, 124, 124)) > 0.4).astype(np.float32)
    frames = rng.integers(0, 256, (2 * F, H, W, 3), dtype=np.uint8)
    return jd, td, jd.get_template_features(1, limg, lmask), td.get_template_features(1, limg, lmask), frames


def test_farm_detect_matches_jax(models):
    """The port's farm detect, on one device (the F-frame detect: one pass of
    the trunk and kernel 1's head call for both frames) and on a 2 x 4 CPU
    mesh, frame by frame against JAX's make_farm_detect on make_mesh_2d(2, 4):
    scores rtol 1e-4 / atol 1e-5, boxes atol 1e-3, template ids equal."""
    from ossid_code_tpu.loop.multi_stream import make_farm_detect as jfarm
    from ossid_code_tpu.parallel.mesh import make_mesh_2d

    from ossid_code_torch.loop.multi_stream import make_farm_detect

    jd, td, (jl, jg), (tl, tg), frames = models
    imgs = frames[:F]
    want = jax.device_get(jfarm(jd, make_mesh_2d(2, 4))(jd.params, jd.batch_stats, imgs, jl, jg))
    for mesh in (tmesh.make_mesh_2d(1, 1, devices=CPU8), tmesh.make_mesh_2d(2, 4, devices=CPU8)):
        got = {k: v.numpy() for k, v in make_farm_detect(td, mesh)(imgs, tl, tg).items()}
        assert got["seg_u8"].shape == (F, H, W) and got["heat_map"].shape == (F, 7, 9)
        for i in range(F):
            np.testing.assert_allclose(got["pred_scores"][i], want["pred_scores"][i], rtol=1e-4, atol=1e-5)
            np.testing.assert_allclose(got["pred_bbox"][i], want["pred_bbox"][i], rtol=1e-4, atol=1e-3)
            np.testing.assert_array_equal(got["pred_template_ids"][i], want["pred_template_ids"][i])
            np.testing.assert_array_equal(got["valid"][i], want["valid"][i])


def test_serving_forwards_match_jax(models):
    """make_serving_farm_forward (4 frames on a 2 x 4 mesh) and
    make_template_parallel_forward (8 templates on 8 devices), on copies of
    the weights (OTHER8), against JAX's
    on the same meshes and against the port's unsplit forward_all_templates
    (JAX's tolerances in tests/test_parallel_mesh.py: rtol 2e-4, atol 2e-5)."""
    from ossid_code_tpu.parallel import mesh as jmesh
    from jax.sharding import NamedSharding, PartitionSpec as P

    jd, td, (jl, jg), (tl, tg), frames = models
    images = (frames / 255.0).astype(np.float32)
    m2 = jmesh.make_mesh_2d(2, 4)
    want = jmesh.make_serving_farm_forward(jd, m2)(
        jax.device_put(images, NamedSharding(m2, P("dp"))), jax.device_put(np.asarray(jl), NamedSharding(m2, P("tp"))),
        jg)
    got = tmesh.make_serving_farm_forward(td, tmesh.make_mesh_2d(2, 4, devices=OTHER8))(images, tl, tg)
    with torch.inference_mode():
        unsplit = [td.net.forward_all_templates(torch.from_numpy(images[i:i + 1]), tl, tg) for i in range(len(images))]
    for j, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, j
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(g.numpy(), torch.stack([u[j] for u in unsplit]).numpy(), rtol=2e-4, atol=2e-5)

    local8_j = jnp.concatenate([jl, jl[::-1]])
    local8_t = torch.cat([tl, tl.flip(0)])
    m1 = jmesh.make_mesh(8)
    want = jmesh.make_template_parallel_forward(jd, m1)(
        jnp.asarray(images[:1]), jax.device_put(local8_j, NamedSharding(m1, P("dp"))), jg)
    got = tmesh.make_template_parallel_forward(td, tmesh.make_mesh(8, devices=OTHER8))(images[:1], local8_t, tg)
    with torch.inference_mode():
        unsplit = td.net.forward_all_templates(torch.from_numpy(images[:1]), local8_t, tg)
    for g, w, u in zip(got, want, unsplit):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(g.numpy(), u.numpy(), rtol=2e-4, atol=2e-5)


def test_hypothesis_parallel_scorer_matches_jax():
    """M = 20 hypotheses on 8 devices (OTHER8: copies of the scorer) with
    device ICP of the first 8: the
    port pads to 24 and drops the padding, and refines the global first 8
    before the split. Held against JAX's hypothesis-parallel scorer on 8
    devices (M padded to 24 by the caller, as JAX's sharding needs) and
    against the port's unsplit score program: scores rtol 2e-4 / atol 2e-4
    (tests/test_torch_slice.py's limits) against both, refined poses atol
    1e-4 against the unsplit program. Against JAX the refined poses follow
    tests/test_torch_icp.py::test_refined_score_program_with_depth_crop's
    rule: ICP's nearest neighbours turn on float32 rounding, which differs
    between the packages, so every refined pose is a proper rotation within
    1 cm and 0.05 of JAX's and at least half agree within 1e-4."""
    from ossid_code_tpu.models.zephyr.module import ZephyrModel
    from ossid_code_tpu.parallel import mesh as jmesh

    from ossid_code_torch.models.zephyr.jax_import import pointnet2_from_jax
    from ossid_code_torch.models.zephyr.module import ZephyrModel as TZephyrModel

    from ossid_code_torch.utils.geometry import rotvec_to_matrix

    rng = np.random.default_rng(3)
    m, k = 20, 8
    jz = ZephyrModel(num_points=128, seed=0, refine_top=k)
    tz = TZephyrModel(num_points=128, seed=0, refine_top=k, device="cpu")
    tz.load_state_dict(pointnet2_from_jax(_np_tree(jz.params), _np_tree(jz.batch_stats)))
    # tests/test_torch_icp.py's scene: a 6 x 4 x 3 cm box at 0.6 m whose
    # front face stands 1.5 cm off a table at 0.7 m
    half = np.array([0.03, 0.02, 0.015])
    face = rng.integers(0, 6, 300)
    axis, sign = face // 2, np.where(face % 2, 1.0, -1.0)
    pts = rng.uniform(-1, 1, (300, 3)) * half
    pts[np.arange(300), axis] = sign * half[axis]
    nrms = np.zeros((300, 3))
    nrms[np.arange(300), axis] = sign
    pts, nrms = pts.astype(np.float32), nrms.astype(np.float32)
    cols = rng.uniform(0, 1, (300, 3)).astype(np.float32)
    h, w = 96, 128
    kmat = np.array([[150.0, 0, w / 2], [0, 150.0, h / 2], [0, 0, 1]], np.float32)
    yy, xx = np.mgrid[0:h, 0:w]
    depth = np.full((h, w), 0.7)
    depth[(np.abs((xx - w / 2) / 150 * 0.585) < 0.03) & (np.abs((yy - h / 2) / 150 * 0.585) < 0.02)] = 0.585
    depth = (depth * 1000).astype(np.uint16)
    img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    poses = np.tile(np.eye(4, dtype=np.float32), (m, 1, 1))
    for i in range(m):
        poses[i, :3, :3] = rotvec_to_matrix(rng.normal(0, 0.05, 3))
        poses[i, :3, 3] = rng.normal(0, 0.005, 3) + [0, 0, 0.6]
    valid = np.ones(m, bool)
    valid[3] = False

    jprep = jz.prepare_object(1, pts, cols, nrms)
    pad = 24 - m
    jposes = np.concatenate([poses, np.tile(np.eye(4, dtype=np.float32), (pad, 1, 1))])
    jvalid = np.concatenate([valid, np.zeros(pad, bool)])
    jm = jmesh.make_mesh(8)
    want = jmesh.make_hypothesis_parallel_scorer(jz, jm)(
        jz.params, jz.batch_stats, jnp.asarray(img), jnp.asarray(depth), jnp.zeros((2,), jnp.int32),
        jnp.asarray(kmat), *jprep, jmesh.shard_batch(jm, jnp.asarray(jposes)), jmesh.shard_batch(jm, jnp.asarray(jvalid)))
    want = [np.asarray(a) for a in want]

    tprep = tz.prepare_object(1, pts, cols, nrms)
    frame = [torch.from_numpy(img), torch.from_numpy(depth.astype(np.int32)), torch.zeros(2, dtype=torch.int32),
             torch.from_numpy(kmat)]
    got = tmesh.make_hypothesis_parallel_scorer(tz, tmesh.make_mesh(8, devices=OTHER8))(
        *frame, *tprep, poses, valid)
    with torch.inference_mode():
        unsplit = tz._score(*frame, *tprep, torch.from_numpy(poses), torch.from_numpy(valid))
    assert got[0].shape == (m,) and got[5].shape == (k, 4, 4)
    refined = got[5].numpy()
    np.testing.assert_allclose(refined, unsplit[5].numpy(), atol=1e-4)
    assert np.abs(refined[:, :3, 3] - want[5][:, :3, 3]).max() < 0.01
    assert np.abs(refined[:, :3, :3] - want[5][:, :3, :3]).max() < 0.05
    for r in refined[:, :3, :3]:
        np.testing.assert_allclose(r @ r.T, np.eye(3), atol=1e-4)
    agree = np.abs(refined - want[5]).max((1, 2)) <= 1e-4
    assert agree.sum() >= k // 2
    same_pose = np.concatenate([agree, np.ones(m - k, bool)])
    for i in (0, 1, 3, 4):  # scores, raw scores, inconsistency, alignment statistic
        np.testing.assert_allclose(got[i].numpy(), unsplit[i].numpy(), rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(got[i].numpy()[same_pose], want[i][:m][same_pose], rtol=2e-4, atol=2e-4)
    # the refined rows are the global first k and moved; the rows beyond k
    # scored as in the unsplit call (above), so no shard refined its own
    # first rows
    assert np.abs(refined - poses[:k]).max() > 1e-4
