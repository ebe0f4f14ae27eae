"""Half-resolution seg supervision (`model.seg_loss_half` / OSSID_SEG_HALF=1)
and the environment switches of the port's DtoidModel against the JAX
package's, on the CPU.

With the switch, every train step decodes the seg logits at half the image's
size and holds them to the exact 2x2 mean of the mask; inference decodes at
full resolution. Sizes are the tests' small ones: 128x160 frames, DenseNet
(2, 2, 2), a batch of 2; inputs from seeded numpy generators. The float32
step is held to tests/test_torch_train.py's limits, the bf16 step to
tests/test_torch_bf16.py's.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ossid_code_torch.core.config import default_config as t_default_config
from ossid_code_torch.models.dtoid.jax_import import dtoid_from_jax, dtoid_to_jax
from ossid_code_torch.models.dtoid.losses import dtoid_losses as t_dtoid_losses
from ossid_code_torch.models.dtoid.module import DtoidModel as TDtoidModel

torch.set_num_threads(2)

H, W, B, BLOCKS = 128, 160, 2, (2, 2, 2)
# tests/test_torch_train.py's float32 step limits: losses relative, gradients
# leaf by leaf (L2 of the difference over L2 of JAX's)
REL = 1e-4
GRAD_TOL = 0.03
# tests/test_torch_bf16.py's first bf16 step: losses, and the gradients'
# median and largest over leaves (bf16 gradients at random weights are mostly
# rounding noise: JAX's own bf16 and float32 gradients read 0.65 apart)
BF16_LOSS_REL = 5e-3
BF16_GRAD_MEDIAN = 0.45
BF16_GRAD_MAX = 1.5
SWITCHES = {"bf16_finetune": "OSSID_BF16_FINETUNE", "bf16_infer": "OSSID_BF16_INFER",
            "seg_loss_half": "OSSID_SEG_HALF"}


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), jax.device_get(tree))


def _cfgs(**model):
    from ossid_code_tpu.core.config import default_config

    jcfg, tcfg = default_config(), t_default_config()
    for cfg in (jcfg, tcfg):
        cfg.model.img_h, cfg.model.img_w = H, W
        cfg.model.heatmap_h, cfg.model.heatmap_w = H // 16 - 1, W // 16 - 1
        cfg.model.densenet_blocks = BLOCKS
        cfg.model.update(model)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def weights():
    """(params, batch_stats) in the JAX package's layout: the port's init
    (the JAX package's rule) with the output convs and BatchNorm statistics
    perturbed."""
    _, tcfg = _cfgs()
    params, stats = dtoid_to_jax(TDtoidModel(tcfg, seed=1, device="cpu").state_dict())
    rng = np.random.default_rng(3)
    for mod, name, std in (("classification", "output", 0.05), ("regression", "output", 0.01),
                           ("correlation_model", "corr_conv_heatmap", 0.05),
                           ("correlation_model", "seg_final", 0.1)):
        node = params[mod][name]
        node["kernel"] = rng.normal(0, std, node["kernel"].shape).astype(np.float32)
    stats = jax.tree_util.tree_map(lambda a: (a + rng.uniform(0.5, 1.5, a.shape)).astype(np.float32), stats)
    return params, stats


def _feed(rng):
    """A compact finetune feed (uint8 frames and templates, bit-packed mask)
    and the float32 batch it encodes; the mask is blobs, so its 2x2 means
    hold soft edges."""
    img = rng.integers(0, 256, (B, H, W, 3), dtype=np.uint8)
    yy, xx = np.mgrid[:H, :W]
    mask = np.stack([(yy - rng.uniform(30, 90)) ** 2 + (xx - rng.uniform(40, 120)) ** 2 < rng.uniform(300, 900)
                     for _ in range(B)])
    limg = rng.integers(0, 256, (B, 124, 124, 3), dtype=np.uint8)
    gimg = rng.integers(0, 256, (B, 124, 124, 3), dtype=np.uint8)
    lmask = (rng.uniform(0, 1, (B, 124, 124, 1)) > 0.4).astype(np.uint8)
    gmask = (rng.uniform(0, 1, (B, 124, 124, 1)) > 0.4).astype(np.uint8)
    ann = np.full((B, 1, 5), -1.0, np.float32)
    for i in range(B):
        x1, y1 = rng.uniform(0, W - 40), rng.uniform(0, H - 40)
        ann[i, 0] = [x1, y1, x1 + rng.uniform(16, 40), y1 + rng.uniform(16, 40), 1]
    heat = rng.uniform(0, 1, (B, H // 16 - 1, W // 16 - 1, 1)).astype(np.float32)
    feed = {"img_u8": img, "limg_u8": limg, "gimg_u8": gimg, "lmask_u8": lmask, "gmask_u8": gmask,
            "mask_bits": np.packbits(mask.reshape(B, -1), axis=1, bitorder="little"),
            "bbox_gt": ann, "heatmap": heat}
    dense = {"img": img.astype(np.float32) / 255.0, "limg": limg.astype(np.float32) / 255.0,
             "gimg": gimg.astype(np.float32) / 255.0, "lmask": lmask.astype(np.float32),
             "gmask": gmask.astype(np.float32), "mask": mask[..., None].astype(np.float32),
             "bbox_gt": ann, "heatmap": heat}
    return feed, dense


def _jax_step(tcfg, params, stats, dense, bf16: bool):
    """JAX's seg_half train loss terms and jax.grad of the loss: the loss
    function of its DtoidModel's train_step (ossid_code_tpu/models/dtoid/
    module.py:98-111; with bf16 train_step_mp's, :141-158: bf16 casts of
    the parameters, statistics and images, losses on float32 upcasts) on its
    DtoidNetwork, seg_half as the step passes it: ({term: value}, [(path,
    gradient leaf)])."""
    from ossid_code_tpu.models.dtoid.anchors import generate_anchor_grid
    from ossid_code_tpu.models.dtoid.losses import dtoid_losses
    from ossid_code_tpu.models.dtoid.network import DtoidNetwork

    m = tcfg.model
    net = DtoidNetwork(img_size=(H, W), densenet_blocks=BLOCKS)
    anchors = jnp.asarray(generate_anchor_grid(H // 16 - 1, W // 16 - 1))
    dt = jnp.bfloat16 if bf16 else jnp.float32
    cast = lambda t: jax.tree_util.tree_map(lambda a: a.astype(dt), t)
    jb = {k: jnp.asarray(v) for k, v in dense.items()}

    def loss_fn(p):
        out, _ = net.apply({"params": cast(p), "batch_stats": cast(stats)},
                           *(jb[k].astype(dt) for k in ("img", "limg", "lmask", "gimg", "gmask")),
                           train=True, seg_half=True, mutable=["batch_stats"])
        out = {k: (v.astype(jnp.float32) if hasattr(v, "dtype") else v) for k, v in out.items()}
        return dtoid_losses(out, jb, anchors, lam_seg=m.lam_seg, lam_center=m.lam_center, lam_cls=m.lam_cls,
                            lam_reg=m.lam_reg)

    (_, metrics), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    return ({k: float(v) for k, v in metrics.items()},
            jax.tree_util.tree_flatten_with_path(_np_tree(grads))[0])


def _gradient_errors(td, want_flat) -> dict:
    """Leaf by leaf, |port - JAX|_2 / |JAX|_2 of the port's first-step
    gradients, leaving out leaves whose largest JAX gradient is below 1e-6 of
    the largest over all leaves (float32 rounding level)."""
    sd = td.state_dict()
    sd.update({name: p.grad for name, p in td.net.named_parameters()})
    got = jax.tree_util.tree_leaves(dtoid_to_jax(sd)[0])
    assert len(got) == len(want_flat)
    scale = max(float(np.abs(w).max()) for _, w in want_flat)
    return {jax.tree_util.keystr(path): float(np.linalg.norm(np.asarray(g, np.float64) - w)
                                              / np.linalg.norm(np.asarray(w, np.float64)))
            for (path, w), g in zip(want_flat, got) if np.abs(w).max() >= 1e-6 * scale}


@pytest.mark.parametrize("bf16", [False, True], ids=["float32", "bf16"])
def test_seg_half_step_matches_jax(weights, bf16):
    """One train_step_u8 step of the port with seg_loss_half (and
    bf16_finetune for bf16) against JAX's train loss with seg_half from the
    same weights on the batch the feed encodes: the loss terms (JAX's
    dtoid_losses on half-resolution logits: the BCE target is the 2x2 mean
    of the mask, soft at its edges) and the gradients leaf by leaf
    (jax.grad).
    Only loss_seg depends on the switch (JAX's tests/test_dtoid.py:285);
    its value differs from the full-resolution step's.

    Readings on an x86 CPU. float32: loss terms 4.3e-6 apart at most,
    gradients 6.1e-5 median and 0.0097 at most over 273 leaves (the stem's
    first BatchNorm bias; a float64 step of the port puts JAX's float32
    leaf 0.0097 and the port's 0.0016 from it). bf16: the loss 1.2e-3 apart
    (its terms up to 2.2e-2: loss_cls, detection on bf16 features), the
    gradients 0.29 median and 1.16 at most over 274 leaves."""
    params, stats = weights
    _, tcfg = _cfgs(seg_loss_half=True, bf16_finetune=bf16, learning_rate=1e-5)
    td = TDtoidModel(tcfg, seed=1, device="cpu")
    assert td.seg_half and td.bf16_finetune == bf16
    td.load_state_dict(dtoid_from_jax(params, stats))
    td.reset_optimizer()
    feed, dense = _feed(np.random.default_rng(4))
    soft = dense["mask"].reshape(B, H // 2, 2, W // 2, 2, 1).mean((2, 4))
    assert ((soft > 0) & (soft < 1)).any()  # the 2x2-mean target has soft edges here
    jm, want = _jax_step(tcfg, params, stats, dense, bf16)
    tm = {k: float(v) for k, v in td.train_step_u8(feed).items()}
    errs = _gradient_errors(td, want)
    # bf16: the loss, as tests/test_torch_bf16.py holds it
    for k in ("loss",) if bf16 else jm:
        assert abs(tm[k] - jm[k]) <= (BF16_LOSS_REL if bf16 else REL) * abs(jm[k]), (k, tm[k], jm[k])
    if bf16:
        assert len(errs) >= 270 and np.median(list(errs.values())) <= BF16_GRAD_MEDIAN, errs
        assert max(errs.values()) <= BF16_GRAD_MAX, max(errs.items(), key=lambda kv: kv[1])
    else:
        assert len(errs) >= len(want) - 1  # at most one leaf at rounding level, as tests/test_torch_train.py
        worst = max(errs, key=errs.get)
        assert errs[worst] <= GRAD_TOL, (worst, errs[worst])
    # the same forward at full resolution moves loss_seg only
    full = TDtoidModel(tcfg.merged({"model": {"seg_loss_half": False}}), seed=1, device="cpu")
    full.load_state_dict(dtoid_from_jax(params, stats))
    full.net.train()
    with torch.no_grad():
        b = {k: torch.from_numpy(v) for k, v in dense.items()}
        images = [b[k].to(torch.bfloat16) if bf16 else b[k] for k in ("img", "limg", "lmask", "gimg", "gmask")]
        if bf16:
            full._bf16_step.cast()
        out = full._bf16_step.forward(*images) if bf16 else full.net(*images)
        _, fm = t_dtoid_losses({k: v.float() for k, v in out.items()}, b, full.anchors)
    assert out["seg_logits"].shape == (B, H, W, 1)
    assert float(fm["loss_seg"]) != tm["loss_seg"]
    for k in ("loss_center", "loss_cls", "loss_reg"):
        assert float(fm[k]) == tm[k], k


def test_env_switch_is_the_cfg_switch(monkeypatch):
    """Each of the JAX package's three switches (bf16_finetune, bf16_infer,
    seg_loss_half) turns on from its cfg key or from its environment
    variable set to "1" (OSSID_BF16_FINETUNE, OSSID_BF16_INFER,
    OSSID_SEG_HALF; read when the model is built), either one; "0" leaves
    the cfg's choice, as JAX's DtoidModel reads them
    (ossid_code_tpu/models/dtoid/module.py:95-96, 166-168, 239)."""
    _, tcfg = _cfgs()
    attrs = {"bf16_finetune": "bf16_finetune", "bf16_infer": "bf16_infer", "seg_loss_half": "seg_half"}
    for env in SWITCHES.values():
        monkeypatch.delenv(env, raising=False)
    by_cfg = TDtoidModel(tcfg.merged({"model": dict.fromkeys(SWITCHES, True)}), seed=2, device="cpu")
    for env in SWITCHES.values():
        monkeypatch.setenv(env, "0")
    off = TDtoidModel(tcfg, seed=2, device="cpu")
    for env in SWITCHES.values():
        monkeypatch.setenv(env, "1")
    by_env = TDtoidModel(tcfg, seed=2, device="cpu")
    for key, attr in attrs.items():
        assert getattr(by_cfg, attr) and getattr(by_env, attr) and not getattr(off, attr), key
    assert by_cfg._bf16_step is not None and by_env._bf16_step is not None and off._bf16_step is None
