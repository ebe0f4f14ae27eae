"""The loop tests' world and runners, and the port's online loop against the
JAX loop's pieces, on the CPU.

One world, written by the JAX package's synthetic writer: 4 frames of
128x160 with 2 objects (8 targets), 4 templates per object. The loops start
from the same DTOID and scorer weights and run the bench's gating profile
(always_dtoid_mask, use_oracle_gt, device ICP of the top 4 hypotheses, a
96-px depth crop) with DenseNet (2, 2, 2), a 128-point scorer, 16 fake
hypotheses per frame and a finetune every 4 buffered targets at batch 2.
tests/test_torch_pipeline.py holds the port's synchronous loop to the JAX
loop's synchronous path (pipeline_scoring=False, the JAX loop with inline
fetches and one frame per fetch), the pipelined loops to each other and
the pipelined loops of both packages on this world.
"""

import argparse
import copy
import os
import pickle
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

H, W = 128, 160
N_FRAMES = 4
REFINE_TOP = 4
ROW_KEYS = ("obj_id", "pred_pose", "pred_score", "pred_err", "pred_add01d", "pred_mask_visib",
            "pred_iou_visib", "dtoid_bbox", "dtoid_score", "time_dtoid", "time_finetune",
            "use_dtoid_mask", "finetune")


_PROTOTYPES: dict = {}


def fresh_model(cls, *args, **kw):
    """`cls(*args, **kw)` as a deep copy of one instance built per process
    from the same arguments (a config compares by its contents) and the same
    OSSID_* environment: the copy holds what a new build holds (the seeded
    weights, no optimizer moments, empty caches) without the seconds that
    building and initialising the port's networks take on the CPU. The
    instance built is never handed out."""
    key = (cls, repr([a.to_dict() if hasattr(a, "to_dict") else a for a in args]), repr(sorted(kw.items())),
           repr(sorted((k, v) for k, v in os.environ.items() if k.startswith("OSSID_"))))
    if key not in _PROTOTYPES:
        _PROTOTYPES[key] = cls(*args, **kw)
    return copy.deepcopy(_PROTOTYPES[key])


def make_args(**kw):
    d = dict(
        dataset_name="synth", exp_name="t", use_offline_model=False, use_pretrained_dtoid=False,
        dtoid_weights_path=None, n_local_test=4, use_dtoid_segmask=False, ignore_dtoid_mask=False,
        always_dtoid_mask=True, use_oracle_gt=True, use_sift_hypos=False, test_seen=False,
        backward=False, use_maskrcnn=False, finetune_interval=4, finetune_warmup=0,
        finetune_epochs=1, finetune_reset=False, finetune_batch_size=2, non_cum=False,
        save_each=False, raw_dtoid=False, no_finetune=False, fast=True,
        zephyr_depth_crop=96, yuv_transfer=False,
    )
    d.update(kw)
    return argparse.Namespace(**d)


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
    cfg.train.batch_size = 2
    return cfg


@pytest.fixture(scope="module", autouse=True)
def jax_native_libraries():
    """The JAX package loads its PPF and rasterizer libraries from native/
    (built there as its own tests build them); without them it falls back to
    fake hypotheses and a numpy rasterizer, and would not be the reference."""
    subprocess.run(["make", "-C", str(Path(__file__).resolve().parents[1] / "native"), "-s"], check=True)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    from ossid_code_tpu.data.bop import BopDataset, BopDatasetArgs
    from ossid_code_tpu.data.synthetic import (
        default_objects, make_synthetic_bop, make_template_grid, make_zephyr_results_pkl,
    )

    root = str(tmp_path_factory.mktemp("bopworld"))
    make_synthetic_bop(root, n_frames=N_FRAMES, img_h=H, img_w=W)
    make_template_grid(os.path.join(root, "grid"), default_objects(), n_views=8)
    bop = BopDataset(BopDatasetArgs(bop_root=root, dataset_name="synth"))
    make_zephyr_results_pkl(os.path.join(root, "zephyr_results.pkl"), bop, score=50.0)
    return root


def _run_jax(root, args, refine_top=REFINE_TOP, pipeline_scoring=False, **loop_kw):
    from ossid_code_tpu.core.config import default_config
    from ossid_code_tpu.data.bop import BopDataset, BopDatasetArgs
    from ossid_code_tpu.data.dtoid_bop import get_dataloaders
    from ossid_code_tpu.hypo.fake import FakeHypoGen
    from ossid_code_tpu.loop.online_learning import OnlineLearningLoop
    from ossid_code_tpu.models.dtoid.module import DtoidModel
    from ossid_code_tpu.models.zephyr.module import ZephyrModel

    cfg = _configure(default_config(), root)
    with open(cfg.dataset.zephyr_result_path, "rb") as f:
        zr_list = pickle.load(f)
    bop = BopDataset(BopDatasetArgs(bop_root=root, dataset_name="synth"))
    train_loader, _, test_loader = get_dataloaders(cfg, zr_list)
    test_loader.dataset.sortTargets()
    train_ds = train_loader.dataset
    train_ds.clearTargets()
    zr = {(r["obj_id"], r["scene_id"], r["im_id"]): dict(r) for r in zr_list}
    train_ds.zephyr_results = dict(zr)
    model = DtoidModel(cfg, seed=0)
    zmodel = ZephyrModel(num_points=128, inconst_ratio_th=100.0, seed=0, need_uv=False,
                         refine_top=refine_top)
    weights = (model.state_dict(), zmodel.state_dict())
    gens = {oid: FakeHypoGen(n_hypos=16, seed=oid) for oid in bop.obj_ids}
    loop = OnlineLearningLoop(args, cfg, model, bop, train_ds, test_loader, zr,
                              zephyr_model=zmodel, hypo_gens=gens, pipeline_scoring=pipeline_scoring, **loop_kw)
    return loop.run(progress=False), weights, loop


def _run_port(root, args, weights, refine_top=REFINE_TOP, **loop_kw):
    from ossid_code_torch.core.config import default_config
    from ossid_code_torch.data.bop import BopDataset, BopDatasetArgs
    from ossid_code_torch.data.dtoid_bop import get_dataloaders
    from ossid_code_torch.hypo.fake import FakeHypoGen
    from ossid_code_torch.loop.online_learning import OnlineLearningLoop
    from ossid_code_torch.models.dtoid.jax_import import dtoid_from_jax
    from ossid_code_torch.models.dtoid.module import DtoidModel
    from ossid_code_torch.models.zephyr.jax_import import pointnet2_from_jax
    from ossid_code_torch.models.zephyr.module import ZephyrModel

    cfg = _configure(default_config(), root)
    with open(cfg.dataset.zephyr_result_path, "rb") as f:
        zr_list = pickle.load(f)
    bop = BopDataset(BopDatasetArgs(bop_root=root, dataset_name="synth"))
    train_loader, _, test_loader = get_dataloaders(cfg, zr_list)
    test_loader.dataset.sortTargets()
    train_ds = train_loader.dataset
    train_ds.clearTargets()
    zr = {(r["obj_id"], r["scene_id"], r["im_id"]): dict(r) for r in zr_list}
    train_ds.zephyr_results = dict(zr)
    model = fresh_model(DtoidModel, cfg, seed=0, device="cpu")
    model.load_state_dict(dtoid_from_jax(weights[0]["params"], weights[0]["batch_stats"]))
    model.reset_optimizer()
    zmodel = fresh_model(ZephyrModel, num_points=128, inconst_ratio_th=100.0, seed=0, need_uv=False,
                         refine_top=refine_top, device="cpu")
    zmodel.load_state_dict(pointnet2_from_jax(weights[1]["params"], weights[1]["batch_stats"]))
    gens = {oid: FakeHypoGen(n_hypos=16, seed=oid) for oid in bop.obj_ids}
    loop = OnlineLearningLoop(args, cfg, model, bop, train_ds, test_loader, zr,
                              zephyr_model=zmodel, hypo_gens=gens, **loop_kw)
    return loop.run(progress=False), loop


def assert_rows_match_jax(got, want, loop):
    """tests/test_torch_pipeline.py::test_loop_matches_jax_sync_path's
    criteria on two loops' rows."""
    assert len(got) == len(want) == 2 * N_FRAMES
    assert [r["finetune"] for r in got] == [r["finetune"] for r in want]
    assert sum(r["finetune"] for r in got) == 2
    assert loop.replay.n_replay_events == 2
    for key in ("obj_id", "scene_id", "im_id", "dtoid_confident", "zephyr_confident",
                "use_dtoid_mask", "n_hypos"):
        assert [r[key] for r in got] == [r[key] for r in want], key
    assert set(got[0]) == set(want[0]) and all(k in got[0] for k in ROW_KEYS)
    n_exact = 0
    for g, w in zip(got, want):
        gs, ws = g["hypo_scores"][REFINE_TOP:], w["hypo_scores"][REFINE_TOP:]
        fin = np.isfinite(ws)
        np.testing.assert_array_equal(np.isfinite(gs), fin)
        np.testing.assert_allclose(gs[fin], ws[fin], rtol=2e-3, atol=5e-4)
        np.testing.assert_allclose(g["pp_err"], w["pp_err"], rtol=1e-4, atol=1e-6)
        rot = g["pred_pose"][:3, :3]
        assert np.isfinite(g["pred_pose"]).all()
        np.testing.assert_allclose(rot @ rot.T, np.eye(3), atol=1e-4)
        gi, wi = np.argmax(g["hypo_scores"]), np.argmax(w["hypo_scores"])
        if gi == wi >= REFINE_TOP:
            n_exact += 1
            np.testing.assert_allclose(g["pred_pose"], w["pred_pose"], rtol=0, atol=1e-4)
            assert abs(g["pred_err"] - w["pred_err"]) <= 1e-4
    assert n_exact >= 1


@pytest.mark.parametrize("segmask", [False, True])
def test_region_mask_and_depth_crop_match(segmask):
    """The detection region (boxes rescaled, expanded 1.2x, stopped after the
    first confident box with depth; or the thresholded seg mask, resized)
    and the depth crop window, as the JAX loop builds them."""
    from types import SimpleNamespace

    from ossid_code_tpu.loop.online_learning import OnlineLearningLoop as JLoop

    from ossid_code_torch.loop.online_learning import OnlineLearningLoop as TLoop

    rng = np.random.default_rng(7)
    depth = rng.uniform(0.5, 1.0, (96, 120)).astype(np.float32)
    depth[:40] = 0.0
    x1, y1 = rng.uniform(0, 100, 6), rng.uniform(0, 60, 6)
    boxes = np.stack([x1, y1, x1 + rng.uniform(5, 40, 6), y1 + rng.uniform(5, 40, 6)], 1)
    out = {"final_bbox": [boxes.astype(np.float32)],
           "final_score": [np.array([0.9, 0.6, 0.45, 0.3, 0.2, 0.1], np.float32)],
           "segmentation": (rng.uniform(0, 1, (48, 60)) > 0.7).astype(np.float32)}
    me = SimpleNamespace(args=make_args(use_dtoid_segmask=segmask, zephyr_depth_crop=64),
                         proc_hw=(48, 60))
    want = JLoop._dtoid_mask(me, None, out, depth)
    got = TLoop._dtoid_mask(me, out, depth)
    np.testing.assert_array_equal(got, want)
    assert TLoop._depth_crop_window(me, got, depth.shape) == JLoop._depth_crop_window(me, want, depth.shape)


def test_loop_refuses_unported_flags():
    """The port's table of unported options is gone: every option of the
    JAX loop is taken. yuv_transfer (tests/test_torch_pipeline.py runs it),
    use_maskrcnn (tests/test_torch_maskrcnn_train.py), save_each, raw_dtoid,
    use_icp (tests/test_torch_demo.py runs them) and use_sift_hypos
    (tests/test_torch_sift.py) pass the flag check and fail here only at the
    first use of the absent dataset."""
    import ossid_code_torch.loop.online_learning as L
    import ossid_code_torch.scripts.online_learning as S

    assert not any(hasattr(m, name) for m in (L, S) for name in ("_NOT_PORTED", "refuse_unported"))
    for kw in ({"args": make_args(yuv_transfer=True)}, {"args": make_args(use_maskrcnn=True)},
               {"args": make_args(save_each=True)}, {"args": make_args(raw_dtoid=True)},
               {"args": make_args(), "use_icp": True}, {"args": make_args(use_sift_hypos=True)},
               {"args": make_args(), "pipeline_scoring": False}):
        with pytest.raises(AttributeError, match="obj_ids"):
            L.OnlineLearningLoop(kw.pop("args"), None, None, None, None, None, {}, **kw)
