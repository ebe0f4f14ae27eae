"""The port's legacy models (ossid_code_torch/models/{fewshot_seg,matcher,
layers}.py), their weight carry and checkpoint routing, and utils/metrics.py
against the JAX package's, on the CPU.

Limits: the few-shot model's logits, loss and BatchNorm statistics within
1e-4 of the largest magnitude; gradients leaf by leaf within 0.03 relative
L2 (ROADMAP.md §3 item 5) where a leaf's largest gradient is above
GRAD_NOISE of the largest of all (a bias before a training-mode BatchNorm,
or of a softmax's keys, has a gradient of rounding noise); parameters after
the first step within 1e-6 where a gradient is above 1e-3 of its leaf's
largest, in the leaves above the noise rule, and everywhere within twice
the learning rate (amsgrad's first step is the learning rate times the
gradient's sign, so a near-zero gradient may step either way). The
matcher's log assignment within MATCHER_Z_TOL: 30 Sinkhorn iterations of
float32 `logsumexp` in two libraries read 1.9e-6 absolute at magnitudes up
to 5 on these inputs (Sinkhorn alone 1.6e-7 of the largest: SINKHORN_TOL).
"""

import os
import pickle

import jax
import numpy as np
import pytest
import torch

from ossid_code_torch.models.jax_import import flax_to_state_dict, state_dict_to_flax

torch.set_num_threads(2)

REL = 1e-4
GRAD_TOL = 0.03
GRAD_NOISE = 1e-6
MATCHER_Z_TOL = 2e-5      # absolute, on log assignments of magnitude up to about 5
SINKHORN_TOL = 1e-5
H, W, SH = 64, 80, 32     # query and support sizes of the few-shot model


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), jax.device_get(tree))


def _close_rel(got, want, rel=REL, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= rel * max(float(np.abs(want).max()), 1e-12), f"{what}: max error {err:.3g}"


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v, np.float64) for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _hold_grads(got: dict, want: dict):
    assert got.keys() == want.keys()
    scale = max(np.abs(w).max() for w in want.values())
    for k, w in want.items():
        if np.abs(w).max() < GRAD_NOISE * scale:
            continue
        rel = np.linalg.norm(got[k] - w) / max(np.linalg.norm(w), 1e-30)
        assert rel <= GRAD_TOL, f"{k}: relative L2 error {rel:.3g}"


def _hold_step(got: dict, want: dict, grads: dict, lr: float):
    scale = max(np.abs(g).max() for g in grads.values())
    for k, w in want.items():
        g = np.abs(grads[k])
        firm = (g > 1e-3 * g.max()) & (g.max() >= GRAD_NOISE * scale)
        d = np.abs(got[k] - w)
        assert d[firm].max(initial=0.0) <= 1e-6 and d.max() <= 2 * lr + 1e-6, k


def _cfgs(**over):
    from ossid_code_tpu.core.config import default_config as jdefault

    from ossid_code_torch.core.config import default_config

    out = []
    for cfg in (jdefault(), default_config()):
        for group, kv in over.items():
            for k, v in kv.items():
                cfg[group][k] = v
        out.append(cfg)
    return out


# ------------------------------------------------------------------ few-shot
@pytest.fixture(scope="module")
def fewshot():
    """JAX FewshotSegModel at width 16 (64x80 queries, 2 supports of 32x32),
    its seg_final perturbed so the logits vary; the port's model carried
    from it."""
    from ossid_code_tpu.models.fewshot_seg import FewshotSegModel as J

    from ossid_code_torch.models.fewshot_seg import FewshotSegModel

    jcfg, tcfg = _cfgs(model=dict(img_h=H, img_w=W, width=16), dataset=dict(template_size=SH, k_support=2))
    jm = J(jcfg, seed=0)
    params = _np(jm.params)
    rng = np.random.default_rng(1)
    seg = params["seg_final"]
    seg["kernel"] = rng.normal(0, 0.3, seg["kernel"].shape).astype(np.float32)
    seg["bias"][:] = 0.0
    jm.params = params
    tm = FewshotSegModel(tcfg, seed=0, device="cpu")
    tm.load_state_dict({"params": params, "batch_stats": _np(jm.batch_stats)})
    return jm, tm


def _episode(rng, b=2, k=2):
    return {"img": rng.uniform(0, 1, (b, H, W, 3)).astype(np.float32),
            "mask": (rng.uniform(size=(b, H, W, 1)) > 0.6).astype(np.float32),
            "simg": rng.uniform(0, 1, (b, k, SH, SH, 3)).astype(np.float32),
            "smask": (rng.uniform(size=(b, k, SH, SH, 1)) > 0.5).astype(np.float32)}


def test_fewshot_forward_and_metric_match_jax(fewshot):
    """Eval-mode logits within 1e-4 of the largest; the per-sample IoU of
    `logits > 0` equal."""
    jm, tm = fewshot
    b = _episode(np.random.default_rng(2))
    want = np.asarray(jm._eval_forward(jm.params, jm.batch_stats, jm._feed(b)))
    with torch.no_grad():
        got = tm.forward(tm._feed(b)).numpy()
    assert got.shape == (2, H, W, 1) and np.std(want) > 0.02
    _close_rel(got, want, what="logits")
    assert tm.eval_metric(b) == pytest.approx(jm.eval_metric(b), abs=1e-6)


def test_fewshot_first_step_matches_jax(fewshot):
    """The first train step from the same weights: the loss and the BatchNorm
    running statistics within 1e-4, the gradients leaf by leaf within
    GRAD_TOL (JAX's from its amsgrad first moment, (1 - 0.9)(g + wd p)),
    the parameters after the step as the module states."""
    from ossid_code_torch.models.fewshot_seg import FewshotSegModel

    jm, tm0 = fewshot
    tm = FewshotSegModel(tm0.cfg, device="cpu")
    tm.load_state_dict(tm0.state_dict())
    params, stats = jm.params, jm.batch_stats
    b = _episode(np.random.default_rng(3))
    wd, lr = jm.cfg.model.weight_decay, jm.cfg.model.learning_rate
    try:
        want_loss = jm.train_step(b)["loss"]
        mu, want_s, want_p = _np(jm.opt_state[1][0].mu), _np(jm.batch_stats), _np(jm.params)
    finally:
        jm.params, jm.batch_stats, jm.opt_state = params, stats, jm.tx.init(params)
    want_g = jax.tree_util.tree_map(lambda m, p: m / (1.0 - 0.9) - wd * p, mu, _np(params))
    got_loss = float(tm.train_step(b)["loss"])
    _close_rel(got_loss, want_loss, what="loss")
    got_p, got_s = state_dict_to_flax(tm.state_dict())
    for k, w in _leaves(want_s).items():
        _close_rel(_leaves(got_s)[k], w, what=f"stat {k}")
    bns = {n for n, m in tm.net.named_modules() if isinstance(m, torch.nn.BatchNorm2d)}
    grads = _leaves(state_dict_to_flax({n: p.grad for n, p in tm.net.named_parameters()}, bns)[0])
    _hold_grads(grads, _leaves(want_g))
    _hold_step(_leaves(got_p), _leaves(want_p), _leaves(want_g), lr)


def test_zero_gradient_leaves_are_held_by_size():
    """The gradient rule of tests/test_torch_cuda.py::
    test_legacy_models_match_cpu, on the CPU: the conv biases that a
    training forward traces into a BatchNorm are the few-shot model's
    LEGACY_ZERO_LEAVES and none of the matcher's (the trace leaves the
    running statistics as they were); a float32 step's gradients
    pass the rule against a float64 evaluation of the same step, and each
    planted fault (a zero leaf scaled to 10 times its limit, a held leaf by
    1.2) fails it, alone."""
    import copy

    from ossid_code_torch.models.fewshot_seg import seg_bce
    from test_torch_cuda import (
        LEGACY_GRAD_TOL, LEGACY_TRAIN_FORWARD, LEGACY_ZERO_LEAVES, _legacy_pair, biases_before_batchnorm,
        legacy_grad_faults, plant_grad_faults,
    )

    for name in ("matcher", "fewshot_seg"):
        (m, _), batch = _legacy_pair(name, devices=("cpu", "cpu"))
        zero = LEGACY_ZERO_LEAVES[name]
        state = {k: v.clone() for k, v in m.net.state_dict().items()}
        assert biases_before_batchnorm(m.net, lambda: LEGACY_TRAIN_FORWARD[name](m, m._feed(batch))) == sorted(zero)
        assert all(torch.equal(v, state[k]) for k, v in m.net.state_dict().items())  # the trace changed nothing
    net64 = copy.deepcopy(m.net).double().train()
    feed = {k: v.double() for k, v in m._feed(batch).items()}
    seg_bce(net64(feed["img"], feed["simg"], feed["smask"]), feed["mask"]).backward()
    m.train_step(batch)
    g32 = {n: p.grad.double() for n, p in m.net.named_parameters()}
    g64 = {n: p.grad for n, p in net64.named_parameters()}
    tol = LEGACY_GRAD_TOL[name]
    assert legacy_grad_faults(g32, g64, zero, tol) == []
    for leaf, planted in plant_grad_faults(g32, zero, "d1.weight", tol):
        assert [n for n, _ in legacy_grad_faults(planted, g64, zero, tol)] == [leaf]


# ------------------------------------------------------------------- matcher
@pytest.fixture(scope="module")
def matcher():
    from ossid_code_tpu.models.matcher import SiftMatcher as J

    from ossid_code_torch.models.matcher import SiftMatcher

    jcfg, tcfg = _cfgs(model=dict(dim=64, n_layers=1), dataset=dict(n_kpts=32))
    jm = J(jcfg, seed=0)
    params = _np(jm.params)
    params["dustbin"] = np.float32(0.7)
    jm.params = params
    tm = SiftMatcher(tcfg, device="cpu")
    tm.load_state_dict({"params": params})
    return jm, tm


def _matches(rng, b=2, n=32, n_gt=20):
    M = np.zeros((b, n + 1, n + 1), np.float32)
    for i in range(b):
        perm = rng.permutation(n)
        M[i, np.arange(n_gt), perm[:n_gt]] = 1.0
        M[i, :n, -1] = 1.0 - M[i, :n, :-1].sum(1)
        M[i, -1, :n] = 1.0 - M[i, :-1, :n].sum(0)
    return M


def _correspondences(rng, b=2, n=32):
    return {"obs_desc": rng.uniform(0, 160, (b, n, 128)).astype(np.float32),
            "obs_uv": rng.uniform(0, 640, (b, n, 2)).astype(np.float32),
            "model_desc": rng.uniform(0, 160, (b, n, 128)).astype(np.float32),
            "model_pts": rng.normal(0, 0.05, (b, n, 3)).astype(np.float32), "matches": _matches(rng, b, n)}


def test_log_optimal_transport_matches_jax():
    """Sinkhorn alone at (2, 32, 32), 30 iterations, scores of a trained
    matcher's range: within SINKHORN_TOL of the largest magnitude."""
    from ossid_code_tpu.models.matcher import log_optimal_transport as jlot

    from ossid_code_torch.models.matcher import log_optimal_transport

    rng = np.random.default_rng(5)
    scores = rng.normal(0, 2.0, (2, 32, 32)).astype(np.float32)
    want = np.asarray(jlot(scores, np.float32(1.3), 30))
    got = log_optimal_transport(torch.from_numpy(scores), torch.tensor(1.3), 30).numpy()
    assert got.shape == (2, 33, 33)
    _close_rel(got, want, rel=SINKHORN_TOL, what="log assignment")
    assert np.allclose(np.exp(got[:, :-1]).sum(-1), 1.0, atol=1e-3)


def test_matcher_matches_jax(matcher):
    """The log assignment within MATCHER_Z_TOL, match recall equal on a fixed
    batch, and the first step: the loss within 1e-4, the gradients leaf by
    leaf within GRAD_TOL, the parameters as the module states."""
    from ossid_code_torch.models.matcher import SiftMatcher

    jm, tm0 = matcher
    b = _correspondences(np.random.default_rng(6))
    want_z = np.asarray(jm._eval_forward(jm.params, jm._feed(b)))
    with torch.no_grad():
        got_z = tm0.forward(tm0._feed(b)).numpy()
    assert np.abs(got_z - want_z).max() <= MATCHER_Z_TOL
    assert tm0.eval_metric(b) == jm.eval_metric(b)
    tm = SiftMatcher(tm0.cfg, device="cpu")
    tm.load_state_dict(tm0.state_dict())
    params = jm.params
    wd, lr = jm.cfg.model.weight_decay, jm.cfg.model.learning_rate
    try:
        want_loss = jm.train_step(b)["loss"]
        mu, want_p = _np(jm.opt_state[1][0].mu), _np(jm.params)
    finally:
        jm.params, jm.opt_state = params, jm.tx.init(params)
    want_g = jax.tree_util.tree_map(lambda m, p: m / (1.0 - 0.9) - wd * p, mu, _np(params))
    _close_rel(float(tm.train_step(b)["loss"]), want_loss, what="loss")
    grads = _leaves(state_dict_to_flax({n: p.grad for n, p in tm.net.named_parameters()})[0])
    _hold_grads(grads, _leaves(want_g))
    _hold_step(_leaves(state_dict_to_flax(tm.state_dict())[0]), _leaves(want_p), _leaves(want_g), lr)


# -------------------------------------------------------------------- layers
@pytest.mark.parametrize("block, planes, stride, cin", [
    ("BasicBlock", 8, 1, 8), ("BasicBlock", 16, 2, 8), ("Bottleneck", 4, 1, 16), ("Bottleneck", 8, 2, 16)])
def test_residual_blocks_match_jax(block, planes, stride, cin):
    """A block in eval and in training mode from the same weights: outputs
    and the updated running statistics within 1e-4; the projection
    shortcut where JAX makes one."""
    from ossid_code_tpu.models import layers as J

    from ossid_code_torch.models import layers as T

    rng = np.random.default_rng(7)
    x = rng.normal(0, 1, (2, 12, 10, cin)).astype(np.float32)
    jb = getattr(J, block)(planes=planes, stride=stride)
    v = _np(jb.init(jax.random.PRNGKey(0), x))
    v["batch_stats"] = jax.tree_util.tree_map(lambda a: a + rng.uniform(0, 0.5, a.shape).astype(np.float32),
                                              v["batch_stats"])
    tb = getattr(T, block)(cin, planes, stride)
    tb.load_state_dict(flax_to_state_dict(v["params"], v["batch_stats"]), strict=True)
    assert hasattr(tb, "downsample_conv") == ("downsample_conv" in v["params"])
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        _close_rel(tb.eval()(xt).permute(0, 2, 3, 1).numpy(), jb.apply(v, x), what="eval")
        got = tb.train()(xt).permute(0, 2, 3, 1).numpy()
    want, mut = jb.apply(v, x, train=True, mutable=["batch_stats"])
    _close_rel(got, want, what="train")
    got_s = state_dict_to_flax(tb.state_dict())[1]
    for k, w in _leaves(_np(mut["batch_stats"])).items():
        _close_rel(_leaves(got_s)[k], w, what=k)


# ------------------------------------------------------------------- metrics
def test_match_metrics_equal_jax():
    """match_precision, match_recall and obs_seg_iou: numpy copies, equal."""
    from ossid_code_tpu.utils import metrics as J

    from ossid_code_torch.utils import metrics as T

    rng = np.random.default_rng(8)
    for _ in range(5):
        scores = rng.normal(0, 1, (3, 17, 13))
        gt = np.zeros_like(scores)
        gt[:, np.arange(16), rng.integers(0, 13, 16)] = 1.0
        for name in ("match_precision", "match_recall"):
            assert getattr(T, name)(scores, gt) == getattr(J, name)(scores, gt)
        a, b = rng.uniform(size=(2, 20, 30))
        assert T.obs_seg_iou(a, b) == J.obs_seg_iou(a, b)
    assert T.obs_seg_iou(np.zeros((4, 4)), np.zeros((4, 4))) == J.obs_seg_iou(np.zeros((4, 4)), np.zeros((4, 4))) == 1.0


# ----------------------------------------------- weight carry and checkpoints
@pytest.mark.parametrize("family", ["fewshot", "matcher"])
def test_carry_round_trips(family, fewshot, matcher):
    """flax_to_state_dict then state_dict_to_flax gives JAX's tree back
    exactly, and the port's network loads it with strict=True."""
    jm, tm = fewshot if family == "fewshot" else matcher
    params = _np(jm.params)
    stats = _np(jm.batch_stats) if family == "fewshot" else {}
    sd = flax_to_state_dict(params, stats)
    tm.net.load_state_dict(sd, strict=True)
    for got, want in zip(state_dict_to_flax(sd), (params, stats)):
        got, want = _leaves(got), _leaves(want)
        assert got.keys() == want.keys() and all(np.array_equal(got[k], want[k]) for k in want)


@pytest.mark.parametrize("family", ["fewshot", "matcher"])
def test_jax_checkpoint_loads_through_load_checkpoint_and_the_cli(family, fewshot, matcher, tmp_path, monkeypatch):
    """A JAX-saved pickle of each new model loads through load_checkpoint
    into the port with outputs equal to JAX's, and through the train CLI's
    weights_path= (its build_model and load_checkpoint, max_epochs 0)."""
    from ossid_code_tpu.core.checkpoint import save_checkpoint as jsave

    from ossid_code_torch.core.checkpoint import load_checkpoint
    from ossid_code_torch.scripts import train

    jm, tm = fewshot if family == "fewshot" else matcher
    path = str(tmp_path / "jax.ckpt")
    jsave(path, jm.state_dict())
    tm.load_state_dict(load_checkpoint(path))
    if family == "fewshot":
        b = _episode(np.random.default_rng(9))
        want = np.asarray(jm._eval_forward(jm.params, jm.batch_stats, jm._feed(b)))
        argv = ["dataset=fewshot_bop", f"model.img_h={H}", f"model.img_w={W}", "model.width=16"]
    else:
        b = _correspondences(np.random.default_rng(9))
        want = np.asarray(jm._eval_forward(jm.params, jm._feed(b)))
        argv = ["dataset=ycbv_sift", "dataset.n_kpts=32", "model.dim=64", "model.n_layers=1"]
    with torch.no_grad():
        assert np.array_equal(tm.forward(tm._feed(b)).numpy(), tm.forward(tm._feed(b)).numpy())
        got = tm.forward(tm._feed(b)).numpy()
    assert np.abs(got - want).max() <= (MATCHER_Z_TOL if family == "matcher" else REL * np.abs(want).max())
    built = []
    monkeypatch.setattr(train, "build_model", lambda cfg, _f=train.build_model: built.append(_f(cfg)) or built[-1])
    monkeypatch.setattr(train, "build_dataloaders", lambda cfg: ([], [], []))
    monkeypatch.setenv("OSSID_RESULT_ROOT", str(tmp_path))
    assert train.main([*argv, "model.max_epochs=0", "device=cpu", f"weights_path={path}"]) == 0
    with torch.no_grad():
        assert np.array_equal(built[0].forward(built[0]._feed(b)).numpy(), got)


def test_load_checkpoint_routes_by_top_level_keys(tmp_path, monkeypatch):
    """JAX pickles route by their params' top-level keys: the scorer (sa1),
    the few-shot model (query_trunk, support_trunk, film_gamma), the matcher
    (dustbin, obs_desc, no batch_stats), MaskRCNN (seg_final and neck_bn) and
    DTOID for the rest, as before; a matcher-like tree with batch_stats is
    not the matcher's; a tree without params still raises."""
    from ossid_code_torch.core import checkpoint
    from ossid_code_torch.models import fewshot_seg, matcher
    from ossid_code_torch.models.dtoid import jax_import as dj
    from ossid_code_torch.models.zephyr import jax_import as zj

    for mod, fn in ((zj, "pointnet2_from_jax"), (fewshot_seg, "fewshot_seg_from_jax"), (matcher, "matcher_from_jax"),
                    (dj, "maskrcnn_from_jax"), (dj, "dtoid_from_jax")):
        monkeypatch.setattr(mod, fn, lambda *a, _n=fn: _n)
    x = np.zeros(1, np.float32)
    cases = [({"params": {"sa1": x, "fc1": x}, "batch_stats": {}}, "pointnet2_from_jax"),
             ({"params": {"query_trunk": x, "support_trunk": x, "film_gamma": x, "seg_final": x},
               "batch_stats": {}}, "fewshot_seg_from_jax"),
             ({"params": {"dustbin": x, "obs_desc": x}}, "matcher_from_jax"),
             ({"params": {"dustbin": x, "obs_desc": x}, "batch_stats": {}}, "dtoid_from_jax"),
             ({"params": {"seg_final": x, "neck_bn": x}, "batch_stats": {}}, "maskrcnn_from_jax"),
             ({"params": {"image_feature_extractor": x, "correlation_model": x}, "batch_stats": {}}, "dtoid_from_jax")]
    for i, (state, want) in enumerate(cases):
        for payload in ({"state": state}, state):
            path = str(tmp_path / f"{i}.ckpt")
            with open(path, "wb") as f:
                pickle.dump(payload, f)
            assert checkpoint.load_checkpoint(path) == want, (i, want)
    with open(str(tmp_path / "bad.ckpt"), "wb") as f:
        pickle.dump({"weights": x}, f)
    with pytest.raises(ValueError, match="unrecognized"):
        checkpoint.load_checkpoint(str(tmp_path / "bad.ckpt"))
    assert os.path.exists(str(tmp_path / "bad.ckpt"))
