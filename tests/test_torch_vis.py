"""The port's training figures (ossid_code_torch/utils/vis.py, drawn in
numpy) against the JAX package's (matplotlib), and the figures both train
CLIs write, on the CPU.

The panels of `vis_in_out` equal the arrays JAX's axes hold exactly; a 2-D
panel's colours equal matplotlib's viridis under its autoscale within 1
LSB; boxes lie on their coordinates; the mask overlay equals JAX's within
1e-6. Both CLIs run `dataset=dtoid_bop model=dtoid` for 2 epochs on the
world of tests/test_torch_train_cli.py (DenseNet (2, 2, 2), 128x160) and
write figures/epoch{0,1}_{0,1}.png.
"""

import os

import matplotlib
import numpy as np
import pytest
import torch
from test_torch_train_cli import _argv, no_tensorflow, world  # noqa: F401  (fixtures)

from ossid_code_torch.utils import vis
from ossid_code_torch.utils.png import read_png

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
from matplotlib import cm  # noqa: E402
from matplotlib.colors import Normalize  # noqa: E402

torch.set_num_threads(2)
FIGURES = ["epoch0_0.png", "epoch0_1.png", "epoch1_0.png", "epoch1_1.png"]


def _batch(kind: str, seed: int = 0):
    """A DTOID batch of 2 and the network's outputs, numpy, from `seed`:
    float images in [0, 1] ('float'), 5-D all-templates limg ('templates'),
    no seg_logits ('no_seg'), or float images outside [0, 1] ('out_of_range')."""
    rng = np.random.default_rng(seed)
    b, h, w = 2, 40, 52
    img = rng.random((b, h, w, 3)).astype(np.float32)
    if kind == "out_of_range":
        img = img * 1.4 - 0.2
    limg = rng.random((b, 3, 12, 12, 3) if kind == "templates" else (b, 12, 12, 3)).astype(np.float32)
    batch = {"img": img, "gimg": rng.random((b, 12, 12, 3)).astype(np.float32), "limg": limg,
             "heatmap": rng.random((b, 5, 7, 1)).astype(np.float32),
             "mask": (rng.random((b, h, w, 1)) > 0.5).astype(np.float32),
             "bbox_gt": np.array([[[4, 6, 30, 33, 1]], [[10, 3, 50, 20, 1]]], np.float32)}
    out = {"heat_map": rng.random((b, 5, 7, 1)).astype(np.float32)}
    if kind != "no_seg":
        out["seg_logits"] = rng.normal(0, 2, (b, h, w, 1)).astype(np.float32)
    return batch, out


@pytest.mark.parametrize("kind", ["float", "templates", "no_seg", "out_of_range"])
def test_panels_match_jax_axes(kind):
    """The eight panel arrays, sample by sample, equal what JAX's
    axes[i].images[0].get_array() holds (None where the axis holds no
    image); the figure is 600x1200 RGB."""
    from ossid_code_tpu.utils.vis import vis_in_out as jvis

    batch, out = _batch(kind)
    for idx in range(2):
        fig, axes = jvis(batch, out, idx=idx)
        try:
            want = [np.asarray(ax.images[0].get_array()) if ax.images else None for ax in axes]
        finally:
            plt.close(fig)
        got_fig, got = vis.vis_in_out(batch, out, idx=idx)
        assert got_fig.shape == (vis.FIG_H, vis.FIG_W, 3) and got_fig.dtype == np.uint8
        assert len(got) == 8 and [g is None for g in got] == [w is None for w in want] == [False] * 3 + [True] + \
            [False] * 4
        for i, (g, w) in enumerate(zip(got, want)):
            if w is not None:
                assert g.dtype == w.dtype and g.shape == w.shape, i
                np.testing.assert_array_equal(g, w, err_msg=f"panel {i}")


@pytest.mark.parametrize("kind", ["float32", "float64", "int", "constant", "narrow"])
def test_viridis_matches_matplotlib(kind):
    """viridis under the array's min / max autoscale within 1 LSB of
    matplotlib's cm.viridis(Normalize()(a)); a constant array maps to the
    colormap's first entry, as matplotlib draws it."""
    rng = np.random.default_rng(3)
    a = {"float32": rng.normal(0, 5, (30, 41)).astype(np.float32), "float64": rng.random((30, 41)) * 1e3,
         "int": rng.integers(-40, 200, (30, 41)), "constant": np.full((30, 41), 0.7, np.float32),
         "narrow": (1.0 + rng.random((30, 41)) * 1e-3).astype(np.float32)}[kind]
    want = cm.viridis(Normalize()(a), bytes=True)[..., :3]
    got = vis.viridis(a)
    assert got.dtype == np.uint8 and got.shape == a.shape + (3,)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    if kind == "constant":
        assert (got == (68, 1, 84)).all()
    np.testing.assert_array_equal(vis.plot_images([a])[0], got)


def test_box_pixels_lie_on_the_boxes():
    """Predicted boxes (the top k) are 1-px red outlines on x1..x2, y1..y2
    with their score in red above; GT boxes lime; nothing else changes."""
    img = np.zeros((60, 80, 3), np.float32)
    pred = np.array([[10, 20, 50, 40], [55, 30, 75, 55], [0, 0, 5, 5]])
    gt = np.array([[5, 12, 70, 58]])
    out = vis.vis_bbox(img, pred_bbox=pred, pred_score=np.array([0.87, 0.5, 0.1]), gt_bbox=gt, topk=2)

    def outline(x1, y1, x2, y2):
        m = np.zeros((60, 80), bool)
        m[[y1, y2], x1:x2 + 1] = True
        m[y1:y2 + 1, [x1, x2]] = True
        return m

    red = (out == vis.RED).all(-1)
    lime = (out == vis.LIME).all(-1)
    text = np.zeros((60, 80), bool)
    for x1, y1 in pred[:2, :2]:
        text[y1 - 2 - vis.GLYPH_H:y1 - 2, x1:x1 + 4 * vis.GLYPH_W] = True
    boxes = outline(*pred[0]) | outline(*pred[1])
    np.testing.assert_array_equal(red & ~text, boxes & ~outline(*gt[0]) & ~text)
    np.testing.assert_array_equal(lime, outline(*gt[0]))
    assert (red & text).sum() > 20                           # the scores
    assert not (red | lime)[:6, :6].any()                    # the third box is past topk
    assert not out[~(red | lime)].any()


def test_vis_mask_overlay_matches_jax():
    """The overlay JAX's vis_mask shows (a probability mask, a uint8-range
    image) within 1e-6, and the drawn panel is its RGB truncated to uint8."""
    from ossid_code_tpu.utils.vis import vis_mask as jmask

    rng = np.random.default_rng(4)
    img = rng.integers(0, 256, (24, 30, 3)).astype(np.float32)
    mask = rng.random((24, 30, 1)).astype(np.float32)
    ax = jmask(img, mask, alpha=0.6, color=(0.2, 1.0, 0.0))
    try:
        want = np.asarray(ax.images[0].get_array())
    finally:
        plt.close("all")
    got = vis.mask_overlay(img, mask, alpha=0.6, color=(0.2, 1.0, 0.0))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(vis.vis_mask(img, mask, alpha=0.6, color=(0.2, 1.0, 0.0)),
                                  (got * 255).astype(np.uint8))


def test_both_clis_write_the_figures(world, tmp_path, monkeypatch):  # noqa: F811
    """dataset=dtoid_bop model=dtoid model.max_epochs=2 (the preset's
    figure_interval 10: epoch 0 and the last): the same figure files from
    both CLIs, the port's decoding at the figure's size. Each trainer's
    train_epoch is replaced by one that returns a loss of 0 (JAX's first
    train step compiles for 40 s here): the CLIs' loops, validation and
    log_figures run as they are. The port's figures after real epochs:
    tests/test_torch_train_cli.py::test_training_writes_its_run_and_resumes."""
    import ossid_code_tpu.core.config as C
    import ossid_code_tpu.scripts.train as J
    from ossid_code_tpu.train.offline import OfflineTrainer as JTrainer

    from ossid_code_torch.scripts import train
    from ossid_code_torch.train.offline import OfflineTrainer

    for cls in (JTrainer, OfflineTrainer):
        monkeypatch.setattr(cls, "train_epoch", lambda self, loader: {"loss": 0.0})
    monkeypatch.setattr(C, "OSSID_RESULT_ROOT", str(tmp_path / "jax"))
    monkeypatch.setenv("OSSID_RESULT_ROOT", str(tmp_path / "port"))
    argv = _argv(world, "dtoid_bop")
    assert J.main(argv) == 0
    assert train.main([*argv, "device=cpu"]) == 0
    dirs = {k: tmp_path / k / "train" / "dtoid_bop" / "figures" for k in ("jax", "port")}
    assert sorted(os.listdir(dirs["jax"])) == sorted(os.listdir(dirs["port"])) == FIGURES
    for name in FIGURES:
        fig = read_png(str(dirs["port"] / name))
        assert fig.shape == (vis.FIG_H, vis.FIG_W, 3) and fig.dtype == np.uint8 and fig.std() > 0
