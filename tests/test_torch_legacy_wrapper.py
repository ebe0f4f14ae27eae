"""The port's DTOID inference wrapper (ossid_code_torch/models/dtoid/
wrapper.py) against the JAX package's, on the CPU.

Both wrappers load one JAX-saved DTOID checkpoint (DenseNet (1, 1, 1) at
128x160, the classification output perturbed so the scores rank) and the
template grid of tests/test_torch_legacy_data.py's world, take `n_local`
templates by linspace and detect an object in a frame of the world. Limits
as tests/test_torch_slice.py holds a served frame: the top score within
1e-4, the top box within 0.02 px, the heat map within 1e-3 (relative
2e-3).
"""

import glob
import os

import jax
import numpy as np
import pytest
import torch
from test_torch_legacy_data import textured_world

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def wrappers(tmp_path_factory):
    from ossid_code_tpu.core.checkpoint import save_checkpoint
    from ossid_code_tpu.core.config import default_config as jdefault
    from ossid_code_tpu.models.dtoid.module import DtoidModel as JDtoid
    from ossid_code_tpu.models.dtoid.wrapper import DTOIDWrapper as JWrapper

    from ossid_code_torch.core.config import default_config
    from ossid_code_torch.models.dtoid.wrapper import DTOIDWrapper

    root = textured_world(str(tmp_path_factory.mktemp("wrapper_world")))
    cfgs = []
    for cfg in (jdefault(), default_config()):
        cfg.model.img_h, cfg.model.img_w, cfg.model.densenet_blocks = 128, 160, (1, 1, 1)
        cfgs.append(cfg)
    jm = JDtoid(cfgs[0], seed=0)
    params = jax.tree_util.tree_map(lambda a: np.array(a, np.float32), jax.device_get(jm.params))
    out = params["classification"]["output"]
    out["kernel"] = np.random.default_rng(1).normal(0, 0.3, out["kernel"].shape).astype(np.float32)
    jm.params = params
    ckpt = os.path.join(root, "dtoid.ckpt")
    save_checkpoint(ckpt, jm.state_dict())
    grid = os.path.join(root, "grid")
    frame = sorted(glob.glob(os.path.join(root, "synth", "*", "*", "rgb", "*.png")))[0]
    from ossid_code_torch.utils.png import read_png

    return (JWrapper(ckpt, grid, [1, 2], n_local=3, cfg=cfgs[0]),
            DTOIDWrapper(ckpt, grid, [1, 2], n_local=3, cfg=cfgs[1], device="cpu"), read_png(frame))


def test_templates_by_linspace(wrappers):
    """n_local of the grid's 8 views by linspace, as JAX's; all of them when
    there are fewer."""
    jw, tw, _ = wrappers
    for n in (3, 20):
        jw.n_local = tw.n_local = n
        for a, b in zip(tw.getTemplates(2), jw.getTemplates(2)):
            assert np.array_equal(a, b) and len(a) == min(n, 8)
    jw.n_local = tw.n_local = 3


def test_detection_matches_jax(wrappers):
    """A call of each wrapper on one frame, uint8 and float: the detection
    dict's keys, the top score and box and the heat map as JAX's."""
    jw, tw, img = wrappers
    for frame in (img, img.astype(np.float32) / 255.0):
        want, got = jw(frame, 1), tw(frame, 1)
        assert set(want) <= set(got)
        assert got["valid"].sum() == want["valid"].sum() > 0
        np.testing.assert_allclose(got["pred_scores"][:1], want["pred_scores"][:1], atol=1e-4)
        np.testing.assert_allclose(got["pred_bbox"][0], want["pred_bbox"][0], atol=2e-2)
        np.testing.assert_allclose(got["heat_map"], want["heat_map"], rtol=2e-3, atol=1e-3)
