"""The port's multi-stream loop (ossid_code_torch/loop/multi_stream.py)
against the JAX package's, on the CPU.

tests/test_multi_stream.py's world: 2 scenes (streams) of 4 frames of
128x160 with 2 objects, fake hypotheses (8 a frame), a finetune every 6
buffered targets at batch 2, oracle labels and always the DTOID mask, with
DenseNet (2, 2, 2) as the port's tests run it, a finetune rate of 1e-5 and
a 64-point scorer. JAX's loop runs on its 2 x 4 mesh of the conftest's
virtual CPU devices, the port's on a one-device CPU mesh (the F-frame
detect; tests/test_torch_mesh.py holds the port's 2 x 4 farm to it), from
the same weights. Per stream the rows' picks, finetune
flags and hypothesis counts are equal; hypothesis scores, pp_err and the
picked poses are held as tests/test_torch_loop.py holds the loops' rows.
"""

import argparse
import os
import pickle
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

H, W = 128, 160
N_SCENES, N_FRAMES = 2, 4
# the scorer's cloud: 64 points (tests/test_multi_stream.py takes 128), as the
# port's plain scorer on the CPU takes most of the port loop's time
NUM_POINTS = 64


def make_args():
    return argparse.Namespace(
        dataset_name="synth", exp_name="ms", use_offline_model=False, use_pretrained_dtoid=False,
        dtoid_weights_path=None, n_local_test=4, use_dtoid_segmask=False, ignore_dtoid_mask=False,
        always_dtoid_mask=True, use_oracle_gt=True, use_sift_hypos=False, test_seen=False, backward=False,
        use_maskrcnn=False, finetune_interval=6, finetune_warmup=0, finetune_epochs=1, finetune_reset=False,
        finetune_batch_size=2, non_cum=False, save_each=False, raw_dtoid=False, no_finetune=False, fast=True,
        hypo_backend="fake", n_fake_hypos=8, zephyr_depth_crop=0, yuv_transfer=False)


def _configure(cfg, root):
    cfg.dataset.bop_root = root
    cfg.dataset.test_dataset_name = "synth"
    cfg.dataset.grid_root = os.path.join(root, "grid")
    cfg.dataset.shorter_length = H
    cfg.dataset.heatmap_shorter_length = 7
    cfg.dataset.n_local_test = 4
    cfg.dataset.load_zephyr_result = True
    cfg.dataset.zephyr_result_path = os.path.join(root, "zephyr_results.pkl")
    cfg.model.img_h, cfg.model.img_w = H, W
    cfg.model.heatmap_h, cfg.model.heatmap_w = 7, 9
    cfg.model.densenet_blocks = (2, 2, 2)
    # tests/test_torch_offline.py's rate: optax's amsgrad moves a weight by
    # up to a rate a step whatever its gradient's size, so at the default
    # rate two finetunes turn float32 rounding into different boxes
    cfg.model.learning_rate = 1e-5
    cfg.train.batch_size = 2
    return cfg


def _loop_parts(pkg, root):
    """(cfg, BopDataset, train dataset, test loader, zephyr results) of one
    package on the world."""
    import importlib

    config = importlib.import_module(f"{pkg}.core.config")
    bop_mod = importlib.import_module(f"{pkg}.data.bop")
    dtoid_bop = importlib.import_module(f"{pkg}.data.dtoid_bop")
    cfg = _configure(config.default_config(), root)
    with open(cfg.dataset.zephyr_result_path, "rb") as f:
        zr_list = pickle.load(f)
    bop = bop_mod.BopDataset(bop_mod.BopDatasetArgs(bop_root=root, dataset_name="synth"))
    train_loader, _, test_loader = dtoid_bop.get_dataloaders(cfg, zr_list)
    test_loader.dataset.sortTargets()
    train_ds = train_loader.dataset
    train_ds.clearTargets()
    zr = {(r["obj_id"], r["scene_id"], r["im_id"]): dict(r) for r in zr_list}
    train_ds.zephyr_results = dict(zr)
    return cfg, bop, train_ds, test_loader, zr


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' MultiStreamLoop runs on one world from one set of
    weights: (JAX's per-stream rows, the port's, the two DTOID models)."""
    import jax

    from ossid_code_tpu.data.synthetic import (
        default_objects, make_synthetic_bop, make_template_grid, make_zephyr_results_pkl,
    )
    from ossid_code_tpu.data.bop import BopDataset, BopDatasetArgs
    from ossid_code_tpu.hypo.fake import FakeHypoGen
    from ossid_code_tpu.loop.multi_stream import MultiStreamLoop
    from ossid_code_tpu.models.dtoid.module import DtoidModel
    from ossid_code_tpu.models.zephyr.module import ZephyrModel
    from ossid_code_tpu.parallel.mesh import make_mesh_2d

    from ossid_code_torch.hypo.fake import FakeHypoGen as TFakeHypoGen
    from ossid_code_torch.loop.multi_stream import MultiStreamLoop as TMultiStreamLoop
    from ossid_code_torch.models.dtoid.jax_import import dtoid_from_jax
    from ossid_code_torch.models.dtoid.module import DtoidModel as TDtoidModel
    from ossid_code_torch.models.zephyr.jax_import import pointnet2_from_jax
    from ossid_code_torch.models.zephyr.module import ZephyrModel as TZephyrModel
    from ossid_code_torch.parallel.mesh import make_mesh_2d as t_make_mesh_2d

    root = str(tmp_path_factory.mktemp("msworld"))
    make_synthetic_bop(root, n_frames=N_FRAMES, img_h=H, img_w=W, n_scenes=N_SCENES)
    make_template_grid(os.path.join(root, "grid"), default_objects(), n_views=8)
    make_zephyr_results_pkl(os.path.join(root, "zephyr_results.pkl"),
                            BopDataset(BopDatasetArgs(bop_root=root, dataset_name="synth")), score=50.0)
    cfg, bop, train_ds, test_loader, zr = _loop_parts("ossid_code_tpu", root)
    args = make_args()

    jd = DtoidModel(cfg, seed=0)
    # the heads' output convs moved off their zero init, so that detection
    # scores do not tie and the finetuned detectors pick the same boxes
    rng = np.random.default_rng(5)
    params = jax.tree_util.tree_map(lambda a: np.array(a, np.float32), jax.device_get(jd.params))
    for head, std in (("classification", 0.05), ("regression", 0.01)):
        node = params[head]["output"]
        node["kernel"] = rng.normal(0, std, node["kernel"].shape).astype(np.float32)
    jd.load_state_dict({"params": params, "batch_stats": jax.device_get(jd.batch_stats)})
    jz = ZephyrModel(num_points=NUM_POINTS, inconst_ratio_th=100.0, seed=0, need_uv=False)
    weights = (jax.device_get(jd.state_dict()), jax.device_get(jz.state_dict()))

    tcfg, tbop, ttrain_ds, ttest_loader, tzr = _loop_parts("ossid_code_torch", root)
    td = TDtoidModel(tcfg, seed=0, device="cpu")
    td.load_state_dict(dtoid_from_jax(weights[0]["params"], weights[0]["batch_stats"]))
    td.reset_optimizer()
    wv0 = td.weights_version
    tz = TZephyrModel(num_points=NUM_POINTS, inconst_ratio_th=100.0, seed=0, need_uv=False, device="cpu")
    tz.load_state_dict(pointnet2_from_jax(weights[1]["params"], weights[1]["batch_stats"]))
    tgens = {oid: TFakeHypoGen(n_hypos=args.n_fake_hypos, seed=oid) for oid in tbop.obj_ids}
    loop = TMultiStreamLoop(args, tcfg, td, tbop, ttrain_ds, ttest_loader, tzr, zephyr_model=tz, hypo_gens=tgens,
                            use_icp=False, mesh=t_make_mesh_2d(1, 1, devices=["cpu"]))
    # the two loops share nothing: the port's runs on a thread beside JAX's
    with ThreadPoolExecutor(1) as pool:
        port = pool.submit(loop.run, progress=False)
        gens = {oid: FakeHypoGen(n_hypos=args.n_fake_hypos, seed=oid) for oid in bop.obj_ids}
        want = MultiStreamLoop(args, cfg, jd, bop, train_ds, test_loader, zr, zephyr_model=jz, hypo_gens=gens,
                               use_icp=False, mesh=make_mesh_2d(2, 4)).run(progress=False)
        got = port.result()
    return want, got, td, wv0, loop


def test_streams_cover_every_target(runs):
    """One row list a stream covering each (frame, object), finetunes of the
    shared buffer, the shared weights moved, the loop's threads closed."""
    _, got, td, wv0, loop = runs
    assert sorted(got) == list(range(N_SCENES))
    for sid, rows in got.items():
        assert len(rows) == N_FRAMES * 2
        assert all(r["scene_id"] == sid for r in rows)
        assert {r["obj_id"] for r in rows} == {1, 2}
        assert all(np.isfinite(r["pred_score"]) and r["n_hypos"] == 8 for r in rows)
    assert sum(r["finetune"] for rows in got.values() for r in rows) >= 2
    assert td.weights_version > wv0
    assert loop._io_pool is None and loop._fetch_pool is None
    assert len(loop.finetune_logs) == sum(r["finetune"] for rows in got.values() for r in rows)


@pytest.mark.parametrize("stream", range(N_SCENES))
def test_stream_rows_match_jax(runs, stream):
    """Per stream: the same targets in order, finetune flags, gate decisions,
    hypothesis counts and picks; hypothesis scores within 2e-3 relative /
    5e-4 absolute, pp_err within 1e-4, the picked pose within 1e-4."""
    want, got, _, _, _ = runs
    g_rows, w_rows = got[stream], want[stream]
    assert len(g_rows) == len(w_rows)
    for key in ("obj_id", "im_id", "finetune", "dtoid_confident", "zephyr_confident", "use_dtoid_mask",
                "n_hypos"):
        assert [r[key] for r in g_rows] == [r[key] for r in w_rows], key
    for g, w in zip(g_rows, w_rows):
        fin = np.isfinite(w["hypo_scores"])
        np.testing.assert_array_equal(np.isfinite(g["hypo_scores"]), fin)
        np.testing.assert_allclose(g["hypo_scores"][fin], w["hypo_scores"][fin], rtol=2e-3, atol=5e-4)
        assert np.argmax(g["hypo_scores"]) == np.argmax(w["hypo_scores"])
        np.testing.assert_allclose(g["pp_err"], w["pp_err"], rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(g["pred_pose"], w["pred_pose"], rtol=0, atol=1e-4)
        # the detectors after the shared-buffer finetunes: amsgrad steps of
        # up to the rate (1e-5) a weight from gradients that agree to float32
        np.testing.assert_allclose(g["dtoid_score"][:5], w["dtoid_score"][:5], rtol=1e-3, atol=1e-4)
