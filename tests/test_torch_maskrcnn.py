"""The port's class-conditional detector (ossid_code_torch/models/maskrcnn.py)
and its data against the JAX package's, and the port's demo with it, on the
CPU (its training and the online loop with it:
tests/test_torch_maskrcnn_train.py, with the CLI).

One JAX MaskRCNN for the module: 128x160 frames, 3 classes and the full
DenseNet-121 trunk (the JAX network fixes its blocks at 12/24/16). Its
random output convs (class, box, segmentation) are perturbed from a seed so
the outputs are not the initial constants, and class 0's scores are raised
so that class 1 loses to it at most anchors. The port's model carries the
same weights through `maskrcnn_from_jax`. Limits: network outputs and
detections 1e-5 in score and 1e-3 px in box; data and feeds exactly.
"""

import json
import os
import pickle

import jax
import numpy as np
import pytest
import torch

from ossid_code_tpu.core.config import default_config as jax_default_config
from ossid_code_tpu.models.maskrcnn import MaskRCNN as JMaskRCNN

from ossid_code_torch.core.config import default_config
from ossid_code_torch.models.dtoid.jax_import import maskrcnn_from_jax, maskrcnn_to_jax
from ossid_code_torch.models.dtoid.network import PRIOR_BIAS
from ossid_code_torch.models.maskrcnn import SEG_PRIOR_BIAS, MaskRCNN

torch.set_num_threads(2)

H, W, C = 128, 160, 3
REL = 1e-4
CLASS0_BOOST = 1.5  # added to class 0's logits at every anchor


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), jax.device_get(tree))


def _cfgs(n_classes=C):
    out = []
    for cfg in (jax_default_config(), default_config()):
        cfg.dataset.n_classes = n_classes
        cfg.dataset.img_h, cfg.dataset.img_w = H, W
        out.append(cfg)
    return out


def _close_rel(got, want, rel=REL, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{what}: max abs err {err:.3g} > {rel} x {scale:.3g}"


def make_models():
    """(JAX model with the perturbed weights, its initial params, params,
    batch_stats)."""
    jcfg, _ = _cfgs()
    jm = JMaskRCNN(jcfg, seed=0)
    init = _np_tree(jm.params)
    params, stats = _np_tree(jm.params), _np_tree(jm.batch_stats)
    rng = np.random.default_rng(1)
    for node, std in ((params["classification"]["output"], 0.3), (params["regression"]["output"], 0.01),
                      (params["seg_final"], 0.05)):
        node["kernel"] = rng.normal(0, std, node["kernel"].shape).astype(np.float32)
    params["classification"]["output"]["bias"][0::C] += CLASS0_BOOST
    jm.params = params
    return jm, init, params, stats


@pytest.fixture(scope="module")
def models():
    return make_models()


def _port(params, stats, n_classes=C):
    tm = MaskRCNN(_cfgs(n_classes)[1], device="cpu")
    tm.load_state_dict(maskrcnn_from_jax(params, stats))
    return tm


def _frames(seed, n=2):
    return (np.random.default_rng(seed).uniform(0, 1, (n, H, W, 3)) * 255).round().astype(np.uint8)


def test_network_matches_jax(models):
    """cls, reg and segmentation logits in eval mode, bridged weights."""
    jm, _, params, stats = models
    tm = _port(params, stats)
    img = (_frames(2) / 255.0).astype(np.float32)
    want = jax.jit(lambda v, x: jm.net.apply(v, x, train=False))({"params": params, "batch_stats": stats}, img)
    with torch.no_grad():
        got = tm.net(torch.from_numpy(img))
    for g, w, name in zip(got, want, ("cls", "reg", "seg")):
        assert g.shape == w.shape, name
        _close_rel(g.numpy(), w, what=name)


def test_weight_bridge_and_initialisation(models):
    """The bridge is exact both ways and covers every parameter and running
    statistic; the port initialises as flax does: zero output convs with the
    heads' prior biases, seg_final's bias -4.595, and lecun kernels of the
    same scale as JAX's."""
    jm, init, params, stats = models
    sd = maskrcnn_from_jax(params, stats)
    tm = MaskRCNN(_cfgs()[1], seed=0, device="cpu")
    keys = {k for k in tm.net.state_dict() if not k.endswith("num_batches_tracked")}
    assert set(sd) == keys
    back = maskrcnn_to_jax(sd)
    for tree, ref in zip(back, (params, stats)):
        assert jax.tree_util.tree_structure(tree) == jax.tree_util.tree_structure(ref)
        assert all(np.array_equal(a, b) for a, b in zip(jax.tree_util.tree_leaves(tree),
                                                         jax.tree_util.tree_leaves(ref)))
    net = tm.net
    assert not net.seg_final.weight.any() and torch.all(net.seg_final.bias == SEG_PRIOR_BIAS)
    assert not net.classification.output.weight.any()
    assert torch.allclose(net.classification.output.bias, torch.tensor(PRIOR_BIAS))
    assert not net.regression.output.weight.any() and not net.regression.output.bias.any()
    np.testing.assert_array_equal(init["seg_final"]["bias"], np.float32(SEG_PRIOR_BIAS))
    mine = maskrcnn_to_jax(tm.state_dict())[0]
    for path, a in jax.tree_util.tree_flatten_with_path(init)[0]:
        if a.ndim == 4 and a.size >= 4096 and a.any():
            b = mine
            for k in path:
                b = b[k.key]
            assert 0.9 < b.std() / a.std() < 1.1, jax.tree_util.keystr(path)


def test_target_inference_matches_jax(models):
    """Scores, boxes, the valid mask and the target's segmentation for every
    class on two frames, with a GT mask for seg_IoU; class 1 loses to class
    0 at most anchors, so selecting it before top-k matters. The empty
    branch (no valid detection) gives JAX's full-frame box at score 0."""
    jm, _, params, stats = models
    tm = _port(params, stats)
    frames = _frames(3)
    cls = np.asarray(jax.jit(lambda v, x: jm.net.apply(v, x, train=False)[0])(
        {"params": params, "batch_stats": stats}, frames[:1] / 255.0))[0]
    assert (cls.argmax(-1) != 1).mean() > 0.75
    gt = np.zeros((H, W), np.float32)
    gt[30:90, 40:120] = 1.0
    for img in frames:
        for obj_id in (1, 2, 3):
            data = {"img": img, "obj_id": obj_id, "mask": gt}
            got, want = tm.forward_test_time(data), jm.forward_test_time(data)
            assert set(got) == set(want)
            assert len(got["final_score"][0]) == len(want["final_score"][0]) > 1
            np.testing.assert_allclose(got["final_score"][0], want["final_score"][0], rtol=0, atol=1e-5)
            np.testing.assert_allclose(got["final_bbox"][0], want["final_bbox"][0], rtol=0, atol=1e-3)
            np.testing.assert_allclose(got["segmentation"], want["segmentation"], rtol=0, atol=1e-5)
            assert abs(got["seg_IoU"] - want["seg_IoU"]) < 1e-3 and got["seg_IoU_50"] == want["seg_IoU_50"]
    none = (np.zeros(100, np.float32), np.zeros((100, 4), np.float32), np.zeros(100, bool),
            np.zeros((H, W), np.float32))
    jm._infer, infer = (lambda *a, **k: none), jm._infer
    tm.net.infer = lambda *a, **k: tuple(torch.from_numpy(x) for x in none)
    try:
        got, want = (m.forward_test_time({"img": frames[0], "obj_id": 1}) for m in (tm, jm))
    finally:
        jm._infer = infer
    assert set(got) == set(want)
    for k in ("final_bbox", "final_score"):
        np.testing.assert_array_equal(got[k][0], want[k][0])
    np.testing.assert_array_equal(got["final_bbox"][0], [[0, 0, W, H]])
    assert (got["seg_IoU"], got["seg_IoU_50"]) == (want["seg_IoU"], want["seg_IoU_50"]) == (0.0, 0.0)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The JAX package's synthetic world: 2 objects x 3 frames of 128x160,
    and scorer results for object 1 only, one of them at half resolution."""
    from ossid_code_tpu.data.bop import BopDataset, BopDatasetArgs
    from ossid_code_tpu.data.synthetic import make_synthetic_bop, make_zephyr_results_pkl

    root = str(tmp_path_factory.mktemp("detectworld"))
    make_synthetic_bop(root, n_frames=3, img_h=H, img_w=W)
    bop = BopDataset(BopDatasetArgs(bop_root=root, dataset_name="synth"))
    path = os.path.join(root, "zr.pkl")
    make_zephyr_results_pkl(path, bop, score=30.0)
    with open(path, "rb") as f:
        rows = [r for r in pickle.load(f) if r["obj_id"] == 1]
    rows[0]["pred_mask_visib"] = rows[0]["pred_mask_visib"][::2, ::2]
    with open(path, "wb") as f:
        pickle.dump(rows, f)
    return root, path


def _detect_cfgs(root, zr_path):
    cfgs = _cfgs(2)
    for cfg in cfgs:
        d = cfg.dataset
        d.bop_root, d.test_dataset_name, d.shorter_length = root, "synth", H
        d.load_zephyr_result, d.zephyr_result_path, d.max_objects = True, zr_path, 3
        cfg.train.batch_size = 2
    return cfgs


def test_detect_dataset_matches_jax(world):
    """Every frame's sample (image, boxes, per-class masks, labels,
    confidences) equals JAX's, with pseudo-labels for object 1 (one resized)
    and GT for object 2; the loaders split the frames as JAX's do."""
    from ossid_code_tpu.data.detect import get_detect_dataloaders as jloaders

    from ossid_code_torch.data.detect import get_detect_dataloaders

    jcfg, tcfg = _detect_cfgs(*world)
    want, got = jloaders(jcfg), get_detect_dataloaders(tcfg)
    for w, g in zip(want, got):
        assert g.dataset.frames == w.dataset.frames and len(g) == len(w)
    full_w, full_g = want[2].dataset, got[2].dataset
    assert len(full_g) == 3
    for i in range(len(full_g)):
        a, b = full_g[i], full_w[i]
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        np.testing.assert_array_equal(a["confidences"], [30.0, 1.0])
        assert (a["bbox_gt"][:2, 4] == [0, 1]).all() and a["masks"].shape == (H, W, 2)
    batch = next(iter(got[0]))
    assert batch["img"].shape == (2, H, W, 3) and batch["masks"].shape == (2, H, W, 2)


def test_eval_metric_matches_jax(models, world):
    """The monitored metric of dataset=detect: per-frame segmentation IoU
    over the classes present, on the detect loader's frames, within 1e-3."""
    from ossid_code_torch.data.detect import get_detect_dataloaders

    jm, _, params, stats = models
    tm = _port(params, stats)
    cfg = _detect_cfgs(*world)[1]
    cfg.dataset.n_classes = C
    for batch in get_detect_dataloaders(cfg)[2]:
        got, want = tm.eval_metric(batch), jm.eval_metric(batch)
        assert len(got) == len(want) == 1
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


def test_maskrcnn_feed_matches_jax():
    """A DtoidBopDataset batch as the detector's train feed, as JAX's."""
    from ossid_code_tpu.loop.online_learning import _maskrcnn_feed as jfeed

    from ossid_code_torch.loop.online_learning import _maskrcnn_feed

    rng = np.random.default_rng(6)
    bbox = np.full((3, 2, 5), -1.0, np.float32)
    bbox[:, 0] = [10, 12, 50, 60, 0]
    bbox[1, 1] = [5, 6, 30, 40, 0]
    batch = {"img": rng.uniform(size=(3, 16, 20, 3)).astype(np.float32), "obj_id": np.array([2, 1, 4]),
             "mask": (rng.uniform(size=(3, 16, 20, 1)) > 0.5).astype(np.float32), "bbox_gt": bbox}
    got, want = _maskrcnn_feed(batch, 5), jfeed(batch, 5)
    assert set(got) == set(want) == {"img", "bbox_gt", "masks", "cls_valid"}
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_cls_valid_masks_unlabeled_classes(world):
    """tests/test_alt_components.py's poisoning test on the port: garbage in
    an unlabelled class's mask channel (cls_valid 0) leaves the loss
    bitwise the same; a labelled channel's changes it."""
    from ossid_code_torch.data.detect import get_detect_dataloaders

    batch = next(iter(get_detect_dataloaders(_detect_cfgs(*world)[1])[0]))
    tm = MaskRCNN(_cfgs(2)[1], seed=0, device="cpu")
    sd0 = tm.state_dict()
    cls_valid = np.zeros((2, 2), np.float32)
    cls_valid[:, 0] = 1.0

    def loss_of(masks):
        tm.load_state_dict(sd0)
        return float(tm.train_step({"img": batch["img"], "bbox_gt": batch["bbox_gt"], "masks": masks,
                                    "cls_valid": cls_valid})["loss"])

    clean = np.asarray(batch["masks"], np.float32).copy()
    clean[..., 1] = 0.0
    poisoned = clean.copy()
    poisoned[..., 1] = 1.0
    base = loss_of(clean)
    assert loss_of(poisoned) == base
    poisoned0 = clean.copy()
    poisoned0[..., 0] = 1.0 - poisoned0[..., 0]
    assert loss_of(poisoned0) != base


def test_jax_checkpoint_loads_through_get_model(models, tmp_path):
    """A JAX MaskRCNN pickle (core/checkpoint.py's native format) loads
    through load_checkpoint, and get_model with weights_path, to the
    bridged model's outputs; get_model builds DTOID and refuses other names
    with ValueError, as JAX's does."""
    from ossid_code_tpu.core.checkpoint import save_checkpoint

    from ossid_code_torch.core.checkpoint import load_checkpoint
    from ossid_code_torch.models import get_model

    jm, _, params, stats = models
    path = str(tmp_path / "maskrcnn.ckpt")
    save_checkpoint(path, {"params": params, "batch_stats": stats})
    sd = load_checkpoint(path)
    ref = maskrcnn_from_jax(params, stats)
    assert sd.keys() == ref.keys() and all(torch.equal(sd[k], ref[k]) for k in sd)
    cfg = _cfgs()[1]
    cfg.model.name, cfg.weights_path = "maskrcnn", path
    tm = get_model(cfg, device="cpu")
    assert isinstance(tm, MaskRCNN)
    data = {"img": _frames(5, 1)[0], "obj_id": 2}
    got, want = tm.forward_test_time(data), _port(params, stats).forward_test_time(data)
    for k in ("final_bbox", "final_score"):
        np.testing.assert_array_equal(got[k][0], want[k][0])
    np.testing.assert_array_equal(got["segmentation"], want["segmentation"])
    cfg.model.name, cfg.weights_path, cfg.model.densenet_blocks = "dtoid", None, (2, 2, 2)
    assert type(get_model(cfg, device="cpu")).__name__ == "DtoidModel"
    cfg.model.name = "nope"
    with pytest.raises(ValueError, match="nope"):
        get_model(cfg, device="cpu")


def test_demo_with_maskrcnn_runs(tmp_path, capsys):
    """The port's demo with --use_maskrcnn at CPU size (1 object, 4 frames
    of 96x128, one pretraining epoch of one batch of 4 frames): --hard
    implies --same_pretrain, the pretraining ran, and the JSON summary line
    has the JAX script's keys and finite values."""
    from ossid_code_torch.scripts import demo_e2e

    out = demo_e2e.main(["--device", "cpu", "--use_maskrcnn", "--hard", "--n_objects", "1", "--frames", "4",
                         "--epochs", "1", "--zephyr_epochs", "1", "--img_h", "96", "--img_w", "128",
                         "--n_views", "3", "--n_templates", "2", "--num_points", "64", "--zephyr_hypos", "16",
                         "--root", str(tmp_path)])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(line) == ["dtoid_iou_untrained", "dtoid_iou_pretrained", "dtoid_iou_online", "pose_add01d",
                          "zephyr_visib_recall", "n_finetunes", "AR", "AR_vsd", "AR_mssd", "AR_mspd"]
    assert all(np.isfinite(v) for v in line.values()) and 0.0 <= line["AR"] <= 1.0
    counts = out["counts"]
    assert counts["pretrain_steps"] == 1 and counts["loop_frames"] == 4 and counts["bootstrap_scored"] == 0
