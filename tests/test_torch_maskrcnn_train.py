"""Training the port's class-conditional detector (ossid_code_torch/models/
maskrcnn.py), the online loop with it and the online-learning CLI with
`--use_maskrcnn`, against the JAX package's, on the CPU.

One JAX MaskRCNN for the module, as tests/test_torch_maskrcnn.py builds it
(128x160, 3 classes, full DenseNet-121, perturbed output convs); its train
step is compiled once and serves both training tests, and its initial
weights, perturbed from another seed, are the CLI's detector. Limits: the
first step's loss terms and BatchNorm statistics 1e-4 of the largest
magnitude, gradients 0.03 relative L2 leaf by leaf (ROADMAP.md §3 item 5),
the stem's first BatchNorm scale its own (chip_smoke.py's
MASKRCNN_STEM_SCALE_TOL); the loop and the CLI as their tests state.

The CLI runs on the loop's world (tests/test_torch_cli.py's layout: 2
objects x 2 frames of 128x160, its template grid, precomputed scorer
results) from the detector's JAX pickle and the CLI's 512-point scorer
saved by JAX as a torch file. No finetune event falls in its 4 targets: the
finetune with this detector is test_loop_with_maskrcnn_matches_jax's.
Floats are held to tests/test_torch_cli.py's limits: scores 2e-3 relative
and 5e-4 absolute, rotations 1e-4, translations 0.1 mm, the top detection
box 2e-2 px.
"""

import argparse
import os
import pickle

import jax
import numpy as np
import pytest
import torch

from chip_smoke import MASKRCNN_STEM_SCALE, MASKRCNN_STEM_SCALE_TOL, maskrcnn_gradients
from test_torch_cli import SUMMARY, _point_roots
from test_torch_maskrcnn import C, H, W, _cfgs, _close_rel, _np_tree, _port, make_models

from ossid_code_torch.models.dtoid.jax_import import maskrcnn_to_jax
from ossid_code_torch.models.maskrcnn import MaskRCNN

torch.set_num_threads(2)

B = 2
GRAD_TOL = 0.03
LOOP_FRAMES = 2  # x 2 objects = 4 targets


@pytest.fixture(scope="module")
def models():
    return make_models()


def _train_batch(rng):
    """One box a row, as the loop's feed (_maskrcnn_feed) has."""
    ann = np.zeros((B, 1, 5), np.float32)
    for i in range(B):
        x1, y1 = rng.uniform(0, W - 60), rng.uniform(0, H - 60)
        ann[i, 0] = [x1, y1, x1 + rng.uniform(24, 60), y1 + rng.uniform(24, 60), rng.integers(0, C)]
    cls_valid = np.ones((B, C), np.float32)
    cls_valid[1, 2] = 0.0
    return {"img": rng.uniform(0, 1, (B, H, W, 3)).astype(np.float32), "bbox_gt": ann,
            "masks": (rng.uniform(0, 1, (B, H, W, C)) > 0.7).astype(np.float32), "cls_valid": cls_valid}


def test_first_train_step_matches_jax(models):
    """JAX's first train step against the port's from the same weights: the
    loss terms within 1e-4, the BatchNorm running statistics within 1e-4
    of each leaf's largest, and the gradients leaf by leaf within GRAD_TOL
    relative L2. JAX's gradient g comes from its optimizer state: after one
    step amsgrad's first moment is (1 - 0.9)(g + wd p). The stem's first
    BatchNorm scale (`early/norm0`), whose gradient nearly cancels (the
    reason stands at chip_smoke.py's MASKRCNN_STEM_SCALE_TOL), is held to
    that limit instead, JAX against the port, and each of JAX's and the
    port's float32 gradients of it against the port's float64 gradient."""
    jm, _, params, stats = models
    tm = _port(params, stats)
    batch = _train_batch(np.random.default_rng(4))
    wd = jm.cfg.model.get("weight_decay", 1e-6)
    jm.opt_state = jm.tx.init(params)
    try:
        want_m = jm.train_step(batch)
        mu, want_s = _np_tree(jm.opt_state[1][0].mu), _np_tree(jm.batch_stats)
    finally:
        jm.params, jm.batch_stats = params, stats
        jm.opt_state = jm.tx.init(params)
    want_g = jax.tree_util.tree_map(lambda m, p: m / (1.0 - 0.9) - wd * p, mu, params)
    stem64 = maskrcnn_gradients(tm, batch, torch.float64)[MASKRCNN_STEM_SCALE].numpy()
    got_m = tm.train_step(batch)
    assert set(got_m) == set(want_m) == {"loss", "loss_classifier", "loss_box_reg", "loss_mask"}
    for k in want_m:
        _close_rel(float(got_m[k]), want_m[k], what=k)
    sd = tm.state_dict()
    for path, w in jax.tree_util.tree_flatten_with_path(want_s)[0]:
        g = maskrcnn_to_jax(sd)[1]
        for k in path:
            g = g[k.key]
        _close_rel(g, w, what=f"stat {jax.tree_util.keystr(path)}")
    sd.update({name: p.grad for name, p in tm.net.named_parameters()})
    got = jax.tree_util.tree_leaves(maskrcnn_to_jax(sd)[0])
    want = jax.tree_util.tree_flatten_with_path(want_g)[0]
    assert len(got) == len(want)
    rel = lambda g, w: np.linalg.norm(g - w) / np.linalg.norm(w)  # noqa: E731
    for (path, w), g in zip(want, got):
        w, g = np.asarray(w, np.float64), np.asarray(g, np.float64)
        stem = jax.tree_util.keystr(path) == "['early']['norm0']['scale']"
        tol = MASKRCNN_STEM_SCALE_TOL if stem else GRAD_TOL
        assert rel(g, w) <= tol, f"{jax.tree_util.keystr(path)}: relative L2 error {rel(g, w):.3g}"
        if stem:
            for who, v in (("JAX", w), ("port", g)):
                assert rel(v, stem64) <= tol, f"{who}'s float32 stem scale against float64: {rel(v, stem64):.3g}"


def test_state_round_trip_and_optimizer_reset(models):
    """What the loop's `finetune_reset` does between events: a state_dict
    taken before a step loads back exactly (weights and running
    statistics), reset_optimizer drops the optimizer's moments, and every
    weight change bumps weights_version."""
    _, _, params, stats = models
    tm = _port(params, stats)
    sd0, v0 = tm.state_dict(), tm.weights_version
    tm.train_step(_train_batch(np.random.default_rng(5)))
    assert tm.weights_version == v0 + 1 and tm.optimizer.state
    assert not all(torch.equal(v, sd0[k]) for k, v in tm.state_dict().items())
    tm.load_state_dict(sd0)
    tm.reset_optimizer()
    assert all(torch.equal(v, sd0[k]) for k, v in tm.state_dict().items())
    assert tm.weights_version == v0 + 2 and not tm.optimizer.state


@pytest.fixture(scope="module")
def loop_world(models, tmp_path_factory):
    """The loop's world in tests/test_torch_cli.py's layout (2 objects x
    LOOP_FRAMES frames, the template grid, precomputed scorer results) and
    its weight files: the module's detector as a JAX pickle, a 128-point
    scorer saved by JAX as a torch file, and a YAML of the detector's
    dataset sizes. Returns (root, files)."""
    from ossid_code_tpu.core.checkpoint import save_checkpoint
    from ossid_code_tpu.core.config import Config
    from ossid_code_tpu.data.bop import BopDataset, BopDatasetArgs
    from ossid_code_tpu.data.synthetic import (
        default_objects, make_synthetic_bop, make_template_grid, make_zephyr_results_pkl,
    )
    from ossid_code_tpu.models.zephyr.module import ZephyrModel

    _, _, params, stats = models
    root = str(tmp_path_factory.mktemp("maskrcnnloop"))
    make_synthetic_bop(root, n_frames=LOOP_FRAMES, img_h=H, img_w=W)
    make_template_grid(os.path.join(root, "grid"), default_objects(), n_views=8)
    bop = BopDataset(BopDatasetArgs(bop_root=root, dataset_name="synth"))
    make_zephyr_results_pkl(os.path.join(root, "synth_zephyr_results.pkl"), bop, score=50.0)
    files = {k: os.path.join(root, f) for k, f in (("conf", "conf.yaml"), ("maskrcnn", "maskrcnn.ckpt"),
                                                   ("scorer", "scorer.ckpt"))}
    Config(dataset={"n_classes": C, "img_h": H, "img_w": W}).save(files["conf"])
    save_checkpoint(files["maskrcnn"], {"params": params, "batch_stats": stats})
    zm = ZephyrModel(num_points=128, seed=4)
    save_checkpoint(files["scorer"], {"params": zm.params, "batch_stats": zm.batch_stats}, torch_format=True)
    return root, files


def _loop_args():
    return argparse.Namespace(
        dataset_name="synth", exp_name="m", use_offline_model=False, use_pretrained_dtoid=False,
        dtoid_weights_path=None, n_local_test=4, use_dtoid_segmask=False, ignore_dtoid_mask=False,
        always_dtoid_mask=True, use_oracle_gt=True, use_sift_hypos=False, test_seen=False, backward=False,
        use_maskrcnn=True, finetune_interval=2, finetune_warmup=0, finetune_epochs=1, finetune_reset=False,
        finetune_batch_size=2, non_cum=False, save_each=False, raw_dtoid=False, no_finetune=False, fast=True,
        zephyr_depth_crop=96, yuv_transfer=False)


def _run_loop(pkg, world, weights, model):
    """One package's loop over the world with `model` (the detector) and
    the scorer file: (rows, loop)."""
    import importlib

    def mod(name):
        return importlib.import_module(f"{pkg}.{name}")

    cfg = mod("core.config").default_config().merged(mod("core.config").Config.load(weights["conf"]).to_dict())
    d = cfg.dataset
    d.bop_root, d.test_dataset_name, d.grid_root = world, "synth", os.path.join(world, "grid")
    d.shorter_length, d.heatmap_shorter_length, d.n_local_test = H, 7, 4
    d.load_zephyr_result, d.zephyr_result_path = True, os.path.join(world, "synth_zephyr_results.pkl")
    cfg.model.img_h, cfg.model.img_w, cfg.model.heatmap_h, cfg.model.heatmap_w = H, W, 7, 9
    cfg.train.batch_size = 2
    with open(d.zephyr_result_path, "rb") as f:
        zr_list = pickle.load(f)
    bop = mod("data.bop").BopDataset(mod("data.bop").BopDatasetArgs(bop_root=world, dataset_name="synth"))
    train_loader, _, test_loader = mod("data.dtoid_bop").get_dataloaders(cfg, zr_list)
    test_loader.dataset.sortTargets()
    train_ds = train_loader.dataset
    train_ds.clearTargets()
    zr = {(r["obj_id"], r["scene_id"], r["im_id"]): dict(r) for r in zr_list}
    train_ds.zephyr_results = dict(zr)
    load = mod("core.checkpoint").load_checkpoint
    dev = {} if pkg == "ossid_code_tpu" else {"device": "cpu"}
    zmodel = mod("models.zephyr.module").ZephyrModel(num_points=128, inconst_ratio_th=100.0, seed=0,
                                                     need_uv=False, **dev)
    zmodel.load_state_dict(load(weights["scorer"]))
    gens = {oid: mod("hypo.fake").FakeHypoGen(n_hypos=16, seed=oid) for oid in bop.obj_ids}
    kw = {"pipeline_scoring": False} if pkg == "ossid_code_tpu" else {}
    loop = mod("loop.online_learning").OnlineLearningLoop(_loop_args(), cfg, model, bop, train_ds, test_loader,
                                                          zr, zephyr_model=zmodel, hypo_gens=gens, **kw)
    return loop.run(progress=False), loop


def test_loop_with_maskrcnn_matches_jax(models, loop_world, monkeypatch):
    """4 targets through both loops with the class-conditional detector
    (always its region, oracle labels, 16 fake hypotheses, a 96-px depth
    crop, a finetune every 2 targets at batch 2): the same gate decisions,
    finetune schedule (2 events from the host loader; the port keeps no
    replay buffer), row keys and hypothesis counts; per row the top
    detection within 2e-2 px and 1e-4 in score, the segmentation IoU within
    1e-3, the scores 2e-3 relative and 5e-4 absolute, and the pose within
    1e-4 where both pick the same hypothesis; the finetune's losses within
    1e-4 relative in the first event and 3e-3 in the second (after a step,
    as tests/test_torch_train.py holds later steps: Adam's first step moves
    each weight by the learning rate times its gradient's sign, and signs
    at rounding level differ). The JAX loop runs the module's JAX model
    (its programs are compiled already); the port's loads the JAX pickle."""
    from ossid_code_torch.core.checkpoint import load_checkpoint

    monkeypatch.setenv("OSSID_SPEC_FETCH", "inline")
    monkeypatch.setenv("OSSID_FETCH_BUNDLE", "1")
    jm, _, params, stats = models
    root, files = loop_world
    jm.params, jm.batch_stats, jm.opt_state = params, stats, jm.tx.init(params)
    try:
        want, jloop = _run_loop("ossid_code_tpu", root, files, jm)
    finally:
        jm.params, jm.batch_stats, jm.opt_state = params, stats, jm.tx.init(params)
    tm = MaskRCNN(_cfgs()[1], device="cpu")
    tm.load_state_dict(load_checkpoint(files["maskrcnn"]))
    got, loop = _run_loop("ossid_code_torch", root, files, tm)
    assert len(got) == len(want) == 2 * LOOP_FRAMES
    assert loop.replay is None
    for key in ("obj_id", "scene_id", "im_id", "dtoid_confident", "zephyr_confident", "use_dtoid_mask",
                "finetune", "n_hypos"):
        assert [r[key] for r in got] == [r[key] for r in want], key
    assert sum(r["finetune"] for r in got) == 2
    assert set(got[0]) == set(want[0])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["dtoid_bbox"][0], w["dtoid_bbox"][0], rtol=0, atol=2e-2)
        np.testing.assert_allclose(g["dtoid_score"][:1], w["dtoid_score"][:1], rtol=0, atol=1e-4)
        assert abs(g["dtoid_iou"] - w["dtoid_iou"]) < 1e-3
        np.testing.assert_allclose(g["hypo_scores"], w["hypo_scores"], rtol=2e-3, atol=5e-4)
        if np.argmax(g["hypo_scores"]) == np.argmax(w["hypo_scores"]):
            np.testing.assert_allclose(g["pred_pose"], w["pred_pose"], rtol=0, atol=1e-4)
    logs = [[[[s["train_loss"] for s in ep] for ep in event] for event in run]
            for run in (loop.finetune_logs, jloop.finetune_logs)]
    assert logs[0] and [[len(ep) for ep in ev] for ev in logs[0]] == [[len(ep) for ep in ev] for ev in logs[1]]
    np.testing.assert_allclose(logs[0][0], logs[1][0], rtol=1e-4)
    for got_ev, want_ev in zip(logs[0][1:], logs[1][1:]):
        np.testing.assert_allclose(got_ev, want_ev, rtol=3e-3)


@pytest.fixture(scope="module")
def cli_weights(models, loop_world):
    """The CLI's files: the loop world's YAML of the detector's sizes, its
    scorer file (the CLI builds a 512-point scorer; the weights do not
    depend on the point count), and the detector as a JAX pickle: the
    module's JAX model's initial weights with the output convs perturbed
    from their own seed."""
    from ossid_code_tpu.core.checkpoint import save_checkpoint

    _, init, _, stats = models
    root, files = loop_world
    params = jax.tree_util.tree_map(np.copy, init)
    rng = np.random.default_rng(11)
    for node, std in ((params["classification"]["output"], 0.3),
                      (params["regression"]["output"], 0.01), (params["seg_final"], 0.05)):
        node["kernel"] = rng.normal(0, std, node["kernel"].shape).astype(np.float32)
    path = os.path.join(root, "maskrcnn_cli.ckpt")
    save_checkpoint(path, {"params": params, "batch_stats": stats})
    return {"conf": files["conf"], "maskrcnn": path, "scorer": files["scorer"]}


def test_cli_with_maskrcnn_matches_jax(loop_world, cli_weights, tmp_path, monkeypatch, capsys):
    """Both CLIs with --use_maskrcnn, the detector's JAX pickle as
    --dtoid_weights_path and its sizes from --conf_path: the same printed
    summary (AR, IoUs, mAP), the results pickle's rows and the BOP CSV."""
    import ossid_code_tpu.scripts.online_learning as J

    import ossid_code_torch.scripts.online_learning as T
    from ossid_code_torch.eval.bop_csv import read_results_bop
    from ossid_code_torch.models.maskrcnn import MaskRCNNNetwork

    world, weights = loop_world[0], cli_weights
    monkeypatch.setenv("OSSID_SPEC_FETCH", "inline")
    argv = ["--dataset_name", "synth", "--exp_name", "cli", "--conf_path", weights["conf"], "--use_maskrcnn",
            "--hypo_backend", "fake", "--n_fake_hypos", "8", "--finetune_interval", "100", "--n_local_test", "4",
            "--always_dtoid_mask", "--use_oracle_gt", "--dtoid_weights_path", weights["maskrcnn"],
            "--zephyr_ckpt_path", weights["scorer"]]
    runs = []
    for tag, mod, dev in (("jax", J, []), ("port", T, ["--device", "cpu"])):
        roots = _point_roots(monkeypatch, str(tmp_path), bop_root=world, tag=tag)
        capsys.readouterr()
        mod.main(mod.build_parser().parse_args(argv + dev))
        printed = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith(SUMMARY)]
        with open(os.path.join(roots["OSSID_RESULT_ROOT"], "results_cli.pkl"), "rb") as f:
            saved = pickle.load(f)
        csv = read_results_bop(os.path.join(roots["BOP_RESULTS_FOLDER"], "online-cli_synth-test.csv"))
        runs.append((printed, saved, csv))
    (jsum, want, jcsv), (tsum, got, tcsv) = runs
    assert tsum == jsum and len(tsum) == len(SUMMARY), (tsum, jsum)
    assert {k: v for k, v in got["main_args"].items() if k != "device"} == want["main_args"]
    assert got["main_args"]["use_maskrcnn"] is True
    assert got["finetune_logs"] == want["finetune_logs"] == []
    assert set(got["final_state_dict"]) == set(MaskRCNNNetwork(C, (H, W)).state_dict())
    rows, jrows = got["test_results"], want["test_results"]
    assert len(rows) == len(jrows) == 2 * LOOP_FRAMES
    for key in ("obj_id", "im_id", "dtoid_confident", "zephyr_confident", "use_dtoid_mask", "n_hypos"):
        assert [r[key] for r in rows] == [r[key] for r in jrows], key
    for g, w in zip(rows, jrows):
        np.testing.assert_allclose(g["hypo_scores"], w["hypo_scores"], rtol=2e-3, atol=5e-4)
        np.testing.assert_allclose(g["pred_score"], w["pred_score"], rtol=2e-3, atol=5e-4)
        np.testing.assert_allclose(g["dtoid_bbox"][0], w["dtoid_bbox"][0], rtol=0, atol=2e-2)
        assert abs(g["dtoid_iou"] - w["dtoid_iou"]) < 1e-3
        if np.argmax(g["hypo_scores"]) == np.argmax(w["hypo_scores"]):
            np.testing.assert_allclose(g["pred_pose"], w["pred_pose"], rtol=0, atol=1e-4)
    assert len(tcsv) == len(jcsv) == len(rows)
    for g, w in zip(tcsv, jcsv):
        assert (g["obj_id"], g["scene_id"], g["im_id"]) == (w["obj_id"], w["scene_id"], w["im_id"])
        np.testing.assert_allclose(g["score"], w["score"], rtol=2e-3, atol=5e-4)
        np.testing.assert_allclose(g["pose"][:3, :3], w["pose"][:3, :3], rtol=0, atol=1e-4)
        np.testing.assert_allclose(g["pose"][:3, 3], w["pose"][:3, 3], rtol=0, atol=0.1)  # mm
