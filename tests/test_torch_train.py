"""The port's DTOID finetune step against the JAX package's, on the CPU.

Losses on random inputs, the optax-rule optimizer against optax, the
depthwise-correlation gradients against `jax.grad`, and three float32 train
steps from one init (parameters, BatchNorm running statistics and losses),
all at 128x160 with DenseNet (2, 2, 2) and a batch of 2. Inputs come from a
seeded numpy generator and go to both packages as numpy arrays.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ossid_code_torch.core.config import default_config as t_default_config
from ossid_code_torch.core.optim import OptaxAmsgrad
from ossid_code_torch.models.dtoid.jax_import import dtoid_from_jax, dtoid_to_jax
from ossid_code_torch.models.dtoid.losses import detection_loss as t_detection_loss
from ossid_code_torch.models.dtoid.losses import dtoid_losses as t_dtoid_losses
from ossid_code_torch.models.dtoid.module import DtoidModel as TDtoidModel
from ossid_code_torch.ops.conv import depthwise_corr as t_depthwise_corr
from test_torch_loop import fresh_model

torch.set_num_threads(2)

H, W, B = 128, 160, 2
REL = 1e-4
GRAD_TOL = 0.03


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), jax.device_get(tree))


def _annotations(rng, b, g, n_valid):
    ann = np.full((b, g, 5), -1.0, np.float32)
    for i in range(b):
        for j in range(n_valid[i]):
            x1, y1 = rng.uniform(0, W - 40), rng.uniform(0, H - 40)
            ann[i, j] = [x1, y1, x1 + rng.uniform(16, 40), y1 + rng.uniform(16, 40), rng.integers(0, 2)]
    return ann


def _batch(rng):
    return {
        "img": rng.uniform(0, 1, (B, H, W, 3)).astype(np.float32),
        "limg": rng.uniform(0, 1, (B, 124, 124, 3)).astype(np.float32),
        "lmask": (rng.uniform(0, 1, (B, 124, 124, 1)) > 0.4).astype(np.float32),
        "gimg": rng.uniform(0, 1, (B, 124, 124, 3)).astype(np.float32),
        "gmask": (rng.uniform(0, 1, (B, 124, 124, 1)) > 0.4).astype(np.float32),
        "bbox_gt": _annotations(rng, B, 1, [1, 1]),
        "heatmap": rng.uniform(0, 1, (B, H // 16 - 1, W // 16 - 1, 1)).astype(np.float32),
        "mask": (rng.uniform(0, 1, (B, H, W, 1)) > 0.7).astype(np.float32),
    }


def _close_rel(got, want, rel=REL, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{what}: max abs err {err:.3g} > {rel} x {scale:.3g}"


def test_detection_losses_match_jax():
    from ossid_code_tpu.models.dtoid.anchors import generate_anchor_grid
    from ossid_code_tpu.models.dtoid.losses import detection_loss, dtoid_losses

    rng = np.random.default_rng(0)
    anchors = generate_anchor_grid(H // 16 - 1, W // 16 - 1).astype(np.float32)
    n = len(anchors)
    cls = rng.uniform(0, 1, (3, n, 2)).astype(np.float32)
    reg = rng.normal(0, 0.5, (3, n, 4)).astype(np.float32)
    ann = _annotations(rng, 3, 4, [2, 0, 4])  # one sample with no valid row
    cvalid = np.array([[1, 1], [1, 0], [0, 1]], np.float32)
    for cv in (None, cvalid):
        want = detection_loss(jnp.asarray(cls), jnp.asarray(reg), jnp.asarray(anchors), jnp.asarray(ann),
                              None if cv is None else jnp.asarray(cv))
        got = t_detection_loss(torch.from_numpy(cls), torch.from_numpy(reg), torch.from_numpy(anchors),
                               torch.from_numpy(ann), None if cv is None else torch.from_numpy(cv))
        for g_, w_ in zip(got, want):
            np.testing.assert_allclose(float(g_), float(w_), rtol=1e-5)

    out = {"classifications": cls, "regressions": reg,
           "heat_map": rng.uniform(0, 1, (3, 7, 9, 1)).astype(np.float32),
           "seg_logits": rng.normal(0, 3, (3, H, W, 1)).astype(np.float32)}
    batch = {"bbox_gt": ann, "heatmap": rng.uniform(0, 1, (3, 7, 9, 1)).astype(np.float32),
             "mask": (rng.uniform(0, 1, (3, H, W, 1)) > 0.5).astype(np.float32)}
    _, want = dtoid_losses({k: jnp.asarray(v) for k, v in out.items()},
                           {k: jnp.asarray(v) for k, v in batch.items()}, jnp.asarray(anchors))
    _, got = t_dtoid_losses({k: torch.from_numpy(v) for k, v in out.items()},
                            {k: torch.from_numpy(v) for k, v in batch.items()}, torch.from_numpy(anchors))
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, err_msg=k)


def test_optimizer_matches_optax():
    """The ROADMAP's gradient sequence on a scalar, and random gradients on a
    matrix, 7 steps at lr 1e-4, weight decay 1e-6; torch's own amsgrad is
    shown to differ on the same sequence."""
    from ossid_code_tpu.models.dtoid.module import make_optimizer

    rng = np.random.default_rng(1)
    seq = [3.0, 2.0, 0.5, 0.1, 0.05, 1.0, 0.01]
    p0 = {"s": np.float32(0.5), "m": rng.normal(0, 1, (5, 4)).astype(np.float32)}
    grads = [{"s": np.float32(g), "m": rng.normal(0, 1, (5, 4)).astype(np.float32)} for g in seq]

    tx = make_optimizer(1e-4, 1e-6)
    jp = jax.tree_util.tree_map(jnp.asarray, p0)
    state = tx.init(jp)
    import optax
    for g in grads:
        upd, state = tx.update(jax.tree_util.tree_map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, upd)

    tp = {k: torch.tensor(v, requires_grad=True) for k, v in p0.items()}
    ref = {k: torch.tensor(v, requires_grad=True) for k, v in p0.items()}
    opt = OptaxAmsgrad(list(tp.values()), lr=1e-4, weight_decay=1e-6)
    torch_opt = torch.optim.Adam(list(ref.values()), lr=1e-4, weight_decay=1e-6, amsgrad=True)
    for g in grads:
        for k in tp:
            tp[k].grad = torch.tensor(g[k])
            ref[k].grad = torch.tensor(g[k])
        opt.step()
        torch_opt.step()
    for k in tp:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), rtol=0, atol=1e-7, err_msg=k)
    assert abs(float(ref["s"].detach()) - float(jp["s"])) > 1e-5  # torch's rule parts from optax's


@pytest.mark.parametrize("k_broadcast", [False, True])
def test_depthwise_corr_gradients_match_jax(k_broadcast):
    from ossid_code_tpu.ops.conv import depthwise_corr

    rng = np.random.default_rng(2)
    x = rng.normal(0, 1, (3, 9, 11, 8)).astype(np.float32)
    k = rng.normal(0, 1, (1 if k_broadcast else 3, 3, 3, 8)).astype(np.float32)
    dout = rng.normal(0, 1, (3, 9, 11, 8)).astype(np.float32)

    def f(xj, kj):
        return jnp.sum(depthwise_corr(xj, jnp.broadcast_to(kj, (3, 3, 3, 8)), padding=1) * dout)

    want_dx, want_dk = jax.grad(f, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(k))
    xt = torch.from_numpy(x).requires_grad_(True)
    kt = torch.from_numpy(k).requires_grad_(True)
    out = t_depthwise_corr(xt, kt.expand(3, 3, 3, 8), padding=1)
    dx, dk = torch.autograd.grad(out, (xt, kt), torch.from_numpy(dout))
    _close_rel(dx.numpy(), want_dx, 1e-5, "dx")
    _close_rel(dk.numpy(), want_dk, 1e-5, "dk")


@pytest.fixture(scope="module")
def models():
    """The configurations, the weights both packages start from (output convs
    and BatchNorm statistics perturbed off the JAX model's init) and that
    JAX DtoidModel (its network and anchors define the JAX loss)."""
    from ossid_code_tpu.core.config import default_config
    from ossid_code_tpu.models.dtoid.module import DtoidModel

    jcfg, tcfg = default_config(), t_default_config()
    for cfg in (jcfg, tcfg):
        cfg.model.img_h, cfg.model.img_w = H, W
        cfg.model.densenet_blocks = (2, 2, 2)
    rng = np.random.default_rng(3)
    jd = DtoidModel(jcfg, seed=1)
    params = _np_tree(jd.params)
    for head, std in (("classification", 0.05), ("regression", 0.01)):
        node = params[head]["output"]
        node["kernel"] = rng.normal(0, std, node["kernel"].shape).astype(np.float32)
    for name in ("corr_conv_heatmap", "seg_final"):
        node = params["correlation_model"][name]
        node["kernel"] = rng.normal(0, 0.05, node["kernel"].shape).astype(np.float32)
    stats = jax.tree_util.tree_map(
        lambda a: (a + rng.uniform(0.5, 1.5, a.shape)).astype(np.float32), _np_tree(jd.batch_stats))
    return jcfg, tcfg, params, stats, jd


def test_first_step_gradients_match_jax(models):
    """The gradients of the first train step against `jax.grad` of the JAX
    package's training loss, leaf by leaf: the L2 norm of the difference
    over that of JAX's gradient, within GRAD_TOL. A leaf whose largest JAX
    gradient is below 1e-6 of the largest over all leaves is at float32
    rounding level and is left out (float32's epsilon is 1.2e-7): the stem's
    first BatchNorm scale, at 2.2e-7, whose next smallest leaf is at 1.4e-4.
    Measured on an x86 CPU: 0.0071 at most over the 273 other leaves. Unlike
    the parameters after Adam's step, this reads a gradient that is off by a
    constant factor."""
    from ossid_code_tpu.models.dtoid.losses import dtoid_losses

    jcfg, tcfg, params, stats, jd = models
    m = jcfg.model
    td = fresh_model(TDtoidModel, tcfg, seed=1, device="cpu")
    td.load_state_dict(dtoid_from_jax(params, stats))
    batch = _batch(np.random.default_rng(4))

    def loss_fn(p, jb):
        out, _ = jd.net.apply({"params": p, "batch_stats": stats}, jb["img"], jb["limg"], jb["lmask"],
                              jb["gimg"], jb["gmask"], train=True, mutable=["batch_stats"])
        return dtoid_losses(out, jb, jd.anchors, lam_seg=m.lam_seg, lam_center=m.lam_center,
                            lam_cls=m.lam_cls, lam_reg=m.lam_reg)[0]

    want = jax.tree_util.tree_flatten_with_path(
        _np_tree(jax.jit(jax.grad(loss_fn))(params, {k: jnp.asarray(v) for k, v in batch.items()})))[0]
    td.train_step(batch)
    sd = td.state_dict()
    sd.update({name: p.grad for name, p in td.net.named_parameters()})
    got = jax.tree_util.tree_leaves(dtoid_to_jax(sd)[0])
    assert len(got) == len(want)
    scale = max(float(np.abs(w).max()) for _, w in want)
    dropped = []
    for (path, w), g in zip(want, got):
        w, g = np.asarray(w, np.float64), np.asarray(g, np.float64)
        if np.abs(w).max() < 1e-6 * scale:
            dropped.append(jax.tree_util.keystr(path))
            continue
        err = np.linalg.norm(g - w) / np.linalg.norm(w)
        assert err <= GRAD_TOL, f"{jax.tree_util.keystr(path)}: relative L2 error {err:.3g}"
    assert len(dropped) <= 1, dropped


def test_train_steps_match_jax(models):
    """Three f32 finetune steps from one init, lr 1e-5. The first step, which
    both packages take from the same weights, gives losses within 1e-4
    relative and BatchNorm running statistics within 1e-4 of each leaf's
    largest magnitude (measured on an x86 CPU: 2.9e-6 and 3.3e-6). Adam's
    first step moves each element by about lr times the sign of its
    gradient, so where a gradient sits at float32 noise level the packages
    step in opposite directions (1932 of 26.8M elements here) and part by
    2 lr; later steps then start from weights that differ there. Measured
    after the second and third steps: losses 1.7e-4 and 1.2e-3 apart
    (classification loss), statistics 2.2e-4 and 2.1e-3 (the variance of the
    correlation features), parameters beyond 1e-4 of their leaf's largest
    magnitude on 0.11% and 0.24% of the elements, none more than 5.7 lr.
    The limits: losses 3e-3 and statistics 5e-3 after the first step,
    parameters at most 2 lr per step apart and within 1e-4 on all but 0.5%
    of the elements. test_first_step_gradients_match_jax holds the
    gradients themselves."""
    from ossid_code_tpu.models.dtoid.module import DtoidModel

    jcfg, tcfg, params, stats, _ = models
    jcfg, tcfg = jcfg.merged({"model": {"learning_rate": 1e-5}}), tcfg.merged({"model": {"learning_rate": 1e-5}})
    lr = tcfg.model.learning_rate
    jd = DtoidModel(jcfg, seed=1)
    jd.load_state_dict({"params": params, "batch_stats": stats})
    jd.reset_optimizer()
    td = fresh_model(TDtoidModel, tcfg, seed=1, device="cpu")
    td.load_state_dict(dtoid_from_jax(params, stats))
    td.reset_optimizer()

    def check_stats(rel):
        js, ts = _np_tree(jd.batch_stats), dtoid_to_jax(td.state_dict())[1]
        flat_s = jax.tree_util.tree_flatten_with_path(js)[0]
        assert len(flat_s) == len(jax.tree_util.tree_leaves(ts))
        for (path, want), got in zip(flat_s, jax.tree_util.tree_leaves(ts)):
            _close_rel(got, want, rel, f"stat {jax.tree_util.keystr(path)}")
        return js

    rng = np.random.default_rng(4)
    for step in range(3):
        batch = _batch(rng)
        jm = jd.train_step(batch)
        tm = td.train_step(batch)
        for k in jm:
            _close_rel(float(tm[k]), jm[k], REL if step == 0 else 30 * REL, f"step {step} {k}")
        if step == 0:
            check_stats(REL)
    js = check_stats(50 * REL)
    jp = _np_tree(jd.params)
    tp = dtoid_to_jax(td.state_dict())[0]
    n_far = n_all = 0
    for (path, want), got in zip(jax.tree_util.tree_flatten_with_path(jp)[0], jax.tree_util.tree_leaves(tp)):
        d = np.abs(got - want)
        far = d > REL * max(float(np.abs(want).max()), 1e-12)
        assert d.max() <= 3 * 2 * lr * 1.001, jax.tree_util.keystr(path)
        n_far += int(far.sum())
        n_all += d.size
    assert n_far <= 0.005 * n_all, (n_far, n_all)
    # the running statistics did move, by flax's rule, not torch's
    s0 = np.asarray(stats["image_feature_extractor"]["n1"]["var"])
    assert np.abs(np.asarray(js["image_feature_extractor"]["n1"]["var"]) - s0).max() > 1e-3


def test_train_step_u8_matches_train_step(models):
    """The compact feed (uint8 frames and templates, bit-packed mask) gives
    the same step as the float feed it encodes."""
    _, tcfg, params, stats, _ = models
    rng = np.random.default_rng(5)
    img_u8 = rng.integers(0, 256, (B, H, W, 3), dtype=np.uint8)
    mask = rng.uniform(0, 1, (B, H, W)) > 0.6
    limg_u8 = rng.integers(0, 256, (B, 124, 124, 3), dtype=np.uint8)
    gimg_u8 = rng.integers(0, 256, (B, 124, 124, 3), dtype=np.uint8)
    lmask = (rng.uniform(0, 1, (B, 124, 124, 1)) > 0.4).astype(np.uint8)
    gmask = (rng.uniform(0, 1, (B, 124, 124, 1)) > 0.4).astype(np.uint8)
    ann = _annotations(rng, B, 1, [1, 1])
    heat = rng.uniform(0, 1, (B, 7, 9, 1)).astype(np.float32)
    u8 = {"img_u8": img_u8, "limg_u8": limg_u8, "gimg_u8": gimg_u8, "lmask_u8": lmask, "gmask_u8": gmask,
          "mask_bits": np.packbits(mask.reshape(B, -1), axis=1, bitorder="little"),
          "bbox_gt": ann, "heatmap": heat}
    f32 = {"img": img_u8.astype(np.float32) / 255.0, "limg": limg_u8.astype(np.float32) / 255.0,
           "gimg": gimg_u8.astype(np.float32) / 255.0, "lmask": lmask.astype(np.float32),
           "gmask": gmask.astype(np.float32), "mask": mask[..., None].astype(np.float32),
           "bbox_gt": ann, "heatmap": heat}
    out = []
    for step, feed in (("train_step_u8", u8), ("train_step", f32)):
        td = fresh_model(TDtoidModel, tcfg, seed=1, device="cpu")
        td.load_state_dict(dtoid_from_jax(params, stats))
        metrics = getattr(td, step)(feed)
        out.append((float(metrics["loss"]), td.state_dict()))
    assert out[0][0] == out[1][0]
    for k in out[0][1]:
        assert torch.equal(out[0][1][k], out[1][1][k]), k
