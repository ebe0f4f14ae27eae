"""Every weight change of the port's DTOID bumps weights_version, which the
pipelined loop's speculation reads to tell a stale detection, on the CPU
(the pipelined loops against JAX's: tests/test_torch_pipeline.py).
"""

import numpy as np
import torch

from test_torch_loop import _configure

torch.set_num_threads(2)


def test_every_weight_change_bumps_weights_version(tmp_path):
    """The speculation's staleness check reads weights_version: train_step,
    train_step_u8, the bf16 step and load_state_dict each bump it."""
    from ossid_code_torch.core.config import default_config
    from ossid_code_torch.models.dtoid.module import DtoidModel

    cfg = _configure(default_config(), str(tmp_path))
    cfg.model.heatmap_h, cfg.model.heatmap_w = 7, 9
    rng = np.random.default_rng(0)
    b = 2
    ann = np.full((b, 1, 5), -1.0, np.float32)
    ann[:, 0] = [20, 20, 80, 90, 1]
    u8 = {"img_u8": rng.integers(0, 256, (b, 128, 160, 3), np.uint8),
          "mask_bits": np.packbits(rng.uniform(size=(b, 128 * 160)) > 0.8, axis=1, bitorder="little"),
          "limg_u8": rng.integers(0, 256, (b, 124, 124, 3), np.uint8),
          "lmask_u8": (rng.uniform(size=(b, 124, 124, 1)) > 0.4).astype(np.uint8),
          "gimg_u8": rng.integers(0, 256, (b, 124, 124, 3), np.uint8),
          "gmask_u8": (rng.uniform(size=(b, 124, 124, 1)) > 0.4).astype(np.uint8),
          "bbox_gt": ann, "heatmap": rng.uniform(size=(b, 7, 9, 1)).astype(np.float32)}
    for bf16 in (False, True):
        m = DtoidModel(cfg.merged({"model": {"bf16_finetune": bf16}}), seed=0, device="cpu")
        v = m.weights_version
        m.train_step_u8(u8)
        assert m.weights_version == v + 1
        m.load_state_dict(m.state_dict())
        assert m.weights_version == v + 2
    m = DtoidModel(cfg, seed=0, device="cpu")
    feed = {"img": u8["img_u8"] / 255.0, "limg": u8["limg_u8"] / 255.0, "lmask": u8["lmask_u8"] * 1.0,
            "gimg": u8["gimg_u8"] / 255.0, "gmask": u8["gmask_u8"] * 1.0, "bbox_gt": ann,
            "heatmap": u8["heatmap"], "mask": np.zeros((b, 128, 160, 1), np.float32)}
    m.train_step({k: np.asarray(x, np.float32) for k, x in feed.items()})
    assert m.weights_version == 1
