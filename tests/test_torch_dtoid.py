"""Parity of the PyTorch port's DTOID with the JAX package's, on the CPU.

Weights go from the JAX model to the port through `dtoid_from_jax`; inputs
come from a seeded numpy generator. The zero-initialised output convs of the
class, heat-map and seg heads are perturbed, and so are the BatchNorm
statistics, so that scores, boxes, template ids and masks really differ
between anchors and a wrong weight mapping shows.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ossid_code_torch.core.config import default_config as t_default_config
from ossid_code_torch.models.dtoid.jax_import import dtoid_from_jax
from ossid_code_torch.models.dtoid.module import DtoidModel as TDtoidModel
from ossid_code_torch.models.dtoid.network import DtoidNetwork as TDtoidNetwork

torch.set_num_threads(2)

H, W, T, BLOCKS = 128, 160, 4, (2, 2, 2)
TOL = dict(rtol=2e-3, atol=1e-3)  # test_backbone_parity.py:206,238


def _to_np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _perturb(params, stats, rng, heads=True):
    """Random BatchNorm statistics and affine terms; random output convs."""
    def walk(p, s):
        for key, node in p.items():
            if not isinstance(node, dict):
                continue
            if "scale" in node and s is not None and key in s:
                node["scale"] = rng.uniform(0.8, 1.2, node["scale"].shape).astype(np.float32)
                node["bias"] = rng.normal(0, 0.05, node["bias"].shape).astype(np.float32)
                s[key]["mean"] = rng.normal(0, 0.1, s[key]["mean"].shape).astype(np.float32)
                s[key]["var"] = rng.uniform(0.5, 1.5, s[key]["var"].shape).astype(np.float32)
            else:
                walk(node, None if s is None else s.get(key))
    walk(params, stats)
    if heads:
        for path, std, bias in ((("classification", "output"), 0.05, None),
                                (("regression", "output"), 0.01, None),
                                (("correlation_model", "corr_conv_heatmap"), 0.05, None),
                                (("correlation_model", "seg_final"), 0.1, 0.0)):
            node = params[path[0]][path[1]]
            node["kernel"] = rng.normal(0, std, node["kernel"].shape).astype(np.float32)
            if bias is not None:
                node["bias"] = np.full_like(node["bias"], bias)
    return params, stats


def _random_tree(shapes, rng):
    """Values for an eval_shape tree: lecun-scaled kernels, small biases, unit
    BatchNorm terms (perturbed afterwards)."""
    def fill(path, leaf):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
            return rng.normal(0, fan_in ** -0.5, leaf.shape).astype(np.float32)
        if name in ("scale", "var"):
            return np.ones(leaf.shape, np.float32)
        return np.zeros(leaf.shape, np.float32)
    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def full_depth_weights():
    """A full-depth (densenet121 12/24/16) DTOID tree, made without running
    the flax init: its shapes come from eval_shape, its values from numpy."""
    from ossid_code_tpu.models.dtoid.network import DtoidNetwork

    net = DtoidNetwork(img_size=(64, 64))
    z = lambda *s: jnp.zeros(s)
    shapes = jax.eval_shape(lambda: net.init(jax.random.PRNGKey(0), z(1, 64, 64, 3),
                                             z(1, 124, 124, 3), z(1, 124, 124, 1),
                                             z(1, 124, 124, 3), z(1, 124, 124, 1), train=False))
    rng = np.random.default_rng(10)
    params = _random_tree(shapes["params"], rng)
    stats = _random_tree(shapes["batch_stats"], rng)
    return _perturb(params, stats, rng)


def test_state_dict_matches_export(full_depth_weights):
    """The port's state_dict equals export_dtoid_state_dict key for key and
    value for value (BatchNorm's num_batches_tracked is torch's own)."""
    from ossid_code_tpu.models.dtoid.torch_import import export_dtoid_state_dict

    params, stats = full_depth_weights
    ref = export_dtoid_state_dict(params, stats, with_model_prefix=False)
    net = TDtoidNetwork(img_size=(64, 64))
    net.load_state_dict(dtoid_from_jax(params, stats), strict=True)
    got = {k: v for k, v in net.state_dict().items() if not k.endswith("num_batches_tracked")}
    assert set(got) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


def test_densenet_image_encoder_parity(models):
    """ImageEncoder (stem, depthwise-correlation modulation, dense blocks,
    transitions with the stride-1 surgery, projection) of the small model."""
    from ossid_code_tpu.models.dtoid.network import ImageEncoder

    jm, tm = models
    rng = np.random.default_rng(11)
    img = rng.normal(0, 1, (1, 64, 64, 3)).astype(np.float32)
    gk = rng.normal(0, 0.1, (1, 3, 3, 64)).astype(np.float32)
    want = ImageEncoder(densenet_blocks=BLOCKS).apply(
        {"params": jm.params["image_feature_extractor"],
         "batch_stats": jm.batch_stats["image_feature_extractor"]},
        jnp.asarray(img), jnp.asarray(gk), False)
    with torch.inference_mode():
        got = tm.net.image_feature_extractor(torch.from_numpy(img), torch.from_numpy(gk))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("global_head", [False, True])
def test_squeezenet_template_encoder_parity(full_depth_weights, global_head):
    from ossid_code_tpu.models.dtoid.network import TemplateEncoderGlobal, TemplateEncoderLocal

    params, stats = full_depth_weights
    net = TDtoidNetwork(img_size=(64, 64))
    net.load_state_dict(dtoid_from_jax(params, stats))
    net.eval()
    name = "template_feature_extractor_global" if global_head else "template_feature_extractor"
    enc = TemplateEncoderGlobal() if global_head else TemplateEncoderLocal()
    t4 = np.random.default_rng(13 + global_head).normal(0, 1, (2, 124, 124, 4)).astype(np.float32)
    want = enc.apply({"params": params[name], "batch_stats": stats[name]}, jnp.asarray(t4), False)
    with torch.inference_mode():
        got = getattr(net, name)(torch.from_numpy(t4))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _small_cfgs():
    from ossid_code_tpu.core.config import default_config

    jcfg, tcfg = default_config(), t_default_config()
    for cfg in (jcfg, tcfg):
        cfg.model.img_h, cfg.model.img_w = H, W
        cfg.model.heatmap_h, cfg.model.heatmap_w = H // 16 - 1, W // 16 - 1
        cfg.model.densenet_blocks = BLOCKS
    return jcfg, tcfg


@pytest.fixture(scope="module")
def models():
    """(JAX DtoidModel, port DtoidModel on the CPU) with the same perturbed weights."""
    from ossid_code_tpu.models.dtoid.module import DtoidModel

    jcfg, tcfg = _small_cfgs()
    jm = DtoidModel(jcfg, seed=0)
    params, stats = _perturb(_to_np(jm.params), _to_np(jm.batch_stats), np.random.default_rng(20))
    jm.load_state_dict({"params": params, "batch_stats": stats})
    tm = TDtoidModel(tcfg, seed=0, device="cpu")
    tm.load_state_dict(dtoid_from_jax(params, stats))
    return jm, tm


def _frame(seed):
    rng = np.random.default_rng(seed)
    return {
        "img": rng.integers(0, 256, (H, W, 3), dtype=np.uint8),
        "obj_id": 3,
        "limg": rng.uniform(0, 1, (T, 124, 124, 3)).astype(np.float32),
        "lmask": (rng.uniform(0, 1, (T, 124, 124)) > 0.4).astype(np.float32),
        "mask": (rng.uniform(0, 1, (H, W)) > 0.5).astype(np.float32),
    }


def test_template_features_and_forward_all_templates(models):
    from ossid_code_tpu.models.dtoid.network import DtoidNetwork

    jm, tm = models
    batch = _frame(30)
    jl, jg = jm.get_template_features(99, batch["limg"], batch["lmask"])
    tl, tg = tm.get_template_features(99, batch["limg"], batch["lmask"])
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), **TOL)

    image = batch["img"][None].astype(np.float32) / 255.0
    want = jax.jit(lambda v, *a: jm.net.apply(v, *a, method=DtoidNetwork.forward_all_templates))(
        {"params": jm.params, "batch_stats": jm.batch_stats}, jnp.asarray(image), jl, jg)
    with torch.inference_mode():
        got = tm.net.forward_all_templates(torch.from_numpy(image), tl, tg)
    for name, g, w in zip(("cls", "reg", "heatmap"), got[:3], want[:3]):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name, **TOL)
    seg_t, seg_j = got[3].numpy() > 0.5, np.asarray(want[3]) > 0.5
    assert seg_t.shape == seg_j.shape
    assert (seg_t != seg_j).mean() <= 1e-3


def _match_detections(got, want, score_tol=1e-4, box_tol=2e-2):
    """Every port detection has a JAX detection of (nearly) the same score with
    the same box and template id; near-equal scores may swap places."""
    gv, wv = got["valid"], want["valid"]
    assert gv.sum() == wv.sum()
    n = int(wv.sum())
    ws, wb, wt = want["pred_scores"][:n], want["pred_bbox"][:n], want["pred_template_ids"][:n]
    for s, b, t in zip(got["pred_scores"][:n], got["pred_bbox"][:n], got["pred_template_ids"][:n]):
        cand = np.nonzero(np.abs(ws - s) <= score_tol)[0]
        ok = [j for j in cand if wt[j] == t and np.abs(wb[j] - b).max() <= box_tol]
        assert ok, (s, b, t)


def test_forward_test_time_parity(models):
    """DtoidModel.forward_test_time on one frame: the detections (boxes,
    scores, template ids, valid), the heat map and the seg mask agree."""
    jm, tm = models
    batch = _frame(40)
    want = jm.forward_test_time(batch)
    got = tm.forward_test_time(batch)
    assert set(got) == set(want)
    for k in ("pred_bbox", "pred_scores", "pred_template_ids", "valid", "segmentation", "heat_map"):
        assert got[k].shape == want[k].shape, k
        assert got[k].dtype == want[k].dtype, k
    assert len(np.unique(want["pred_scores"][want["valid"]])) > 10  # scores really differ
    _match_detections(got, want)
    np.testing.assert_allclose(got["heat_map"], want["heat_map"], **TOL)
    assert (got["segmentation"] != want["segmentation"]).mean() <= 1e-3
    assert abs(got["seg_IoU"] - want["seg_IoU"]) <= 1e-2


def test_filter_z_and_cache(models):
    jm, tm = models
    batch = _frame(50)
    rng = np.random.default_rng(51)
    zs = -rng.uniform(0.3, 1.5, T)
    jm.cfg.model.filter_z = tm.cfg.model.filter_z = True
    try:
        want = jm.forward_test_time(dict(batch, template_z_values=zs))
        got = tm.forward_test_time(dict(batch, template_z_values=zs))
    finally:
        jm.cfg.model.filter_z = tm.cfg.model.filter_z = False
    assert len(got["pred_scores"]) == len(want["pred_scores"])
    np.testing.assert_allclose(np.sort(got["pred_scores"]), np.sort(want["pred_scores"]), atol=1e-4)
    assert 3 in tm.template_feature_cache
    v = tm.weights_version
    tm.load_state_dict(tm.state_dict())
    assert tm.weights_version == v + 1 and not tm.template_feature_cache


def test_detect_u8_seg_matches_jax(models):
    """seg_transfer='u8': detect returns the winning template's graded mask,
    one byte per pixel, as the JAX package's detect does."""
    from ossid_code_tpu.models.dtoid.network import DtoidNetwork

    jm, tm = models
    batch = _frame(60)
    jl, jg = jm.get_template_features(61, batch["limg"], batch["lmask"])
    tl, tg = tm.get_template_features(61, batch["limg"], batch["lmask"])
    img = batch["img"][None]
    want = jax.jit(lambda v, *a: jm.net.apply(v, *a, pack_seg=False, method=DtoidNetwork.detect))(
        {"params": jm.params, "batch_stats": jm.batch_stats}, jnp.asarray(img), jl, jg, jm.anchors)
    with torch.inference_mode():
        got = tm.net.detect(torch.from_numpy(img), tl, tg, tm.anchors, pack_seg=False)
    assert set(got) == set(want)
    g, w = got["seg_u8"].numpy().astype(int), np.asarray(want["seg_u8"]).astype(int)
    assert g.shape == w.shape == (H, W)
    assert np.abs(g - w).max() <= 1 and (g != w).mean() <= 1e-3
    np.testing.assert_allclose(got["heat_map"].numpy(), np.asarray(want["heat_map"]), **TOL)
