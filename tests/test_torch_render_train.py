"""One DTOID train step on a batch of render samples (DtoidRenderDataset over
BlenderProc scenes, as the JAX package's tests compose it), the port against
the JAX package, on the CPU.

The world: 6 sampled objects, 2 scenes of 128x160 and 4 template renders an
object, written by the port's writer. The batch of 2 (train mode, the
closest-rotation local template) comes from the port's NumpyLoader and goes
to both packages as numpy arrays. Both models hold the same weights (the
JAX model's, perturbed off their init, carried by dtoid_from_jax); the loss
within 1e-4 relative, the gradients leaf by leaf within 0.03 relative L2,
and a leaf whose gradient is at float32 rounding level in JAX (below 1e-6 of
the largest) within ZERO_GRAD_TOL of the largest gradient in both packages.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ossid_code_torch.core.config import Config, default_config
from ossid_code_torch.data.dtoid_bop import NumpyLoader
from ossid_code_torch.data.hdf5_render import DtoidRenderDataset, RenderGridTemplates
from ossid_code_torch.data.synthetic import make_render_world, sampled_objects
from ossid_code_torch.models.dtoid.jax_import import dtoid_from_jax, dtoid_to_jax
from ossid_code_torch.models.dtoid.module import DtoidModel

torch.set_num_threads(2)

H, W, B = 128, 160, 2
LOSS_TOL = 1e-4
GRAD_TOL = 0.03
GRAD_NOISE = 1e-6
ZERO_GRAD_TOL = 1e-4


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), jax.device_get(tree))


@pytest.fixture(scope="module")
def batch(tmp_path_factory):
    import os

    scenes, grid = make_render_world(str(tmp_path_factory.mktemp("render")), n_scenes=2, n_grid_views=4,
                                     objects=sampled_objects(6))
    paths = sorted(os.path.join(scenes, f) for f in os.listdir(scenes) if f.endswith(".hdf5"))
    cfg = Config({"shorter_length": H, "keep_aspect_ratio": True, "heatmap_var": 1.5, "heatmap_shorter_length": 7,
                  "n_local_test": 3, "train_local_template_sample_from": 1, "augment_depth": True})
    ds = DtoidRenderDataset("train", paths, RenderGridTemplates(grid), cfg, seed=0)
    return next(iter(NumpyLoader(ds, batch_size=B, shuffle=True, seed=1)))


def test_render_batch_step_matches_jax(batch):
    """The first train step from the same weights on a render batch: the
    loss, and the gradients against jax.grad of JAX's training loss."""
    from ossid_code_tpu.core.config import default_config as jdefault
    from ossid_code_tpu.models.dtoid.losses import dtoid_losses
    from ossid_code_tpu.models.dtoid.module import DtoidModel as JDtoidModel

    assert batch["img"].shape == (B, H, W, 3) and batch["limg"].shape == (B, 124, 124, 3)
    assert batch["heatmap"].shape == (B, 7, 9, 1) and (batch["bbox_gt"][:, 0, 4] == 1).all()
    jcfg, tcfg = jdefault(), default_config()
    for cfg in (jcfg, tcfg):
        cfg.model.img_h, cfg.model.img_w = H, W
        cfg.model.densenet_blocks = (2, 2, 2)
    rng = np.random.default_rng(3)
    jd = JDtoidModel(jcfg, seed=1)
    params = _np_tree(jd.params)
    for head, std in (("classification", 0.05), ("regression", 0.01)):
        node = params[head]["output"]
        node["kernel"] = rng.normal(0, std, node["kernel"].shape).astype(np.float32)
    for name in ("corr_conv_heatmap", "seg_final"):
        node = params["correlation_model"][name]
        node["kernel"] = rng.normal(0, 0.05, node["kernel"].shape).astype(np.float32)
    stats = jax.tree_util.tree_map(lambda a: (a + rng.uniform(0.5, 1.5, a.shape)).astype(np.float32),
                                   _np_tree(jd.batch_stats))
    m = jcfg.model
    feed = {k: batch[k] for k in ("img", "limg", "lmask", "gimg", "gmask", "bbox_gt", "heatmap", "mask")}

    def loss_fn(p, jb):
        out, _ = jd.net.apply({"params": p, "batch_stats": stats}, jb["img"], jb["limg"], jb["lmask"],
                              jb["gimg"], jb["gmask"], train=True, mutable=["batch_stats"])
        return dtoid_losses(out, jb, jd.anchors, lam_seg=m.lam_seg, lam_center=m.lam_center,
                            lam_cls=m.lam_cls, lam_reg=m.lam_reg)[0]

    want_loss, want = jax.jit(jax.value_and_grad(loss_fn))(params, {k: jnp.asarray(v) for k, v in feed.items()})
    want = jax.tree_util.tree_flatten_with_path(_np_tree(want))[0]
    td = DtoidModel(tcfg, seed=1, device="cpu")
    td.load_state_dict(dtoid_from_jax(params, stats))
    got_loss = float(td.train_step(feed)["loss"])
    assert np.isfinite(got_loss) and abs(got_loss - float(want_loss)) <= LOSS_TOL * abs(float(want_loss))
    sd = td.state_dict()
    sd.update({name: p.grad for name, p in td.net.named_parameters()})
    got = jax.tree_util.tree_leaves(dtoid_to_jax(sd)[0])
    assert len(got) == len(want)
    scale = max(float(np.abs(w).max()) for _, w in want)
    held = 0
    for (path, w), g in zip(want, got):
        w, g = np.asarray(w, np.float64), np.asarray(g, np.float64)
        name = jax.tree_util.keystr(path)
        if np.abs(w).max() < GRAD_NOISE * scale:
            assert max(np.abs(w).max(), np.abs(g).max()) <= ZERO_GRAD_TOL * scale, name
            continue
        err = np.linalg.norm(g - w) / np.linalg.norm(w)
        assert err <= GRAD_TOL, f"{name}: relative L2 error {err:.3g}"
        held += 1
    assert held >= len(want) - 2
