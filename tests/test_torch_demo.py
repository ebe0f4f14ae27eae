"""The end-to-end demo's parts against the JAX package's, on the CPU: the
object sets' meshes, the detection-only pass (`test_dtoid_model`), the loop
with host ICP of the pick (`use_icp=True`, with `save_each`), and the port's
`scripts/demo_e2e.main` at a tiny size.
"""

import json
import os

import numpy as np
import pytest
import torch

from test_torch_loop import _configure, _run_jax, _run_port, fresh_model, jax_native_libraries, make_args  # noqa: F401

torch.set_num_threads(2)

N_FRAMES = 2


def _same_mesh(a, b):
    for k in ("vertices", "faces", "colors", "normals"):
        x, y = getattr(a, k), getattr(b, k)
        assert (x is None) == (y is None), k
        if x is not None:
            np.testing.assert_array_equal(x, y, err_msg=k)


@pytest.mark.parametrize("name", ["default_objects", "hard_objects", "pretrain_objects", "sampled_objects"])
def test_object_sets_match_jax(name):
    """Vertex for vertex (and faces, colours, normals): the meshes the
    demo's worlds are built of."""
    from ossid_code_tpu.data import synthetic as jsyn

    from ossid_code_torch.data import synthetic as tsyn

    args = (5,) if name == "sampled_objects" else ()
    want, got = getattr(jsyn, name)(*args), getattr(tsyn, name)(*args)
    assert list(got) == list(want)
    for oid in want:
        _same_mesh(got[oid], want[oid])


def test_mesh_primitives_match_jax():
    from ossid_code_tpu.render import mesh as jm

    from ossid_code_torch.render import mesh as tm

    for fn, args in (("make_wedge_mesh", (70, 48, 55)), ("make_icosphere", (28, 2)), ("make_box_mesh", (5, 6, 7))):
        _same_mesh(getattr(tm, fn)(*args), getattr(jm, fn)(*args))
    box = jm.make_box_mesh(30, 20, 10)
    _same_mesh(tm.subdivide_mesh(tm.make_box_mesh(30, 20, 10), 2), jm.subdivide_mesh(box, 2))
    _same_mesh(tm.concat_meshes([tm.make_box_mesh(30, 20, 10), tm.translate_mesh(tm.make_icosphere(9), (1, 2, 3))]),
               jm.concat_meshes([box, jm.translate_mesh(jm.make_icosphere(9), (1, 2, 3))]))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    from ossid_code_tpu.data.bop import BopDataset, BopDatasetArgs
    from ossid_code_tpu.data.synthetic import (
        default_objects, make_synthetic_bop, make_template_grid, make_zephyr_results_pkl,
    )

    root = str(tmp_path_factory.mktemp("demoworld"))
    make_synthetic_bop(root, n_frames=N_FRAMES, img_h=128, img_w=160)
    make_template_grid(os.path.join(root, "grid"), default_objects(), n_views=8)
    bop = BopDataset(BopDatasetArgs(bop_root=root, dataset_name="synth"))
    make_zephyr_results_pkl(os.path.join(root, "zephyr_results.pkl"), bop, score=50.0)
    return root


def test_dtoid_model_rows_match_jax(world):
    """The detection-only pass over the test loader, from the same weights:
    the same targets in the same order, the same ground-truth boxes, the top
    detections' scores within 1e-4 and boxes within 0.05 px, the
    segmentation IoU within 1e-3."""
    from ossid_code_tpu.core.config import default_config
    from ossid_code_tpu.data.dtoid_bop import get_dataloaders
    from ossid_code_tpu.loop.online_learning import test_dtoid_model
    from ossid_code_tpu.models.dtoid.module import DtoidModel

    from ossid_code_torch.core.config import default_config as t_default_config
    from ossid_code_torch.data.dtoid_bop import get_dataloaders as t_get_dataloaders
    from ossid_code_torch.loop.online_learning import test_dtoid_model as t_test_dtoid_model
    from ossid_code_torch.models.dtoid.jax_import import dtoid_from_jax
    from ossid_code_torch.models.dtoid.module import DtoidModel as TDtoidModel

    rows = []
    for cfg_fn, loaders, model_fn, run in (
            (default_config, get_dataloaders, lambda c: DtoidModel(c, seed=0), test_dtoid_model),
            (t_default_config, t_get_dataloaders, lambda c: fresh_model(TDtoidModel, c, seed=0, device="cpu"), t_test_dtoid_model)):
        cfg = _configure(cfg_fn(), world)
        _, _, test_loader = loaders(cfg)
        test_loader.dataset.sortTargets()
        model = model_fn(cfg)
        if rows:
            sd = rows[0][1]
            model.load_state_dict(dtoid_from_jax(sd["params"], sd["batch_stats"]))
        rows.append((run(model, test_loader), model.state_dict()))
    want, got = rows[0][0], rows[1][0]
    assert len(got) == len(want) == 2 * N_FRAMES
    for g, w in zip(got, want):
        assert (g["obj_id"], g["scene_id"], g["im_id"]) == (w["obj_id"], w["scene_id"], w["im_id"])
        np.testing.assert_array_equal(g["gt_bbox"], w["gt_bbox"])
        np.testing.assert_allclose(g["dtoid_score"][:5], w["dtoid_score"][:5], atol=1e-4)
        np.testing.assert_allclose(g["dtoid_bbox"][0], w["dtoid_bbox"][0], atol=5e-2)
        assert abs(g["dtoid_iou"] - w["dtoid_iou"]) <= 1e-3
        assert g["dtoid_pred_mask"].shape == w["dtoid_pred_mask"].shape


def test_loop_with_host_icp_matches_jax(world, monkeypatch, tmp_path):
    """The loop with `use_icp=True` (and no device ICP, so the pick is a
    hypothesis itself): same gates, finetune schedule and picks; where the
    picks agree, host ICP starts from the same pose on the same depth and
    returns JAX's refined pose to 1e-9 (the same C++ solver). `save_each`
    writes one checkpoint per finetune, which loads back into the model."""
    from ossid_code_tpu.hypo.icp import _load_icp_lib

    from ossid_code_torch.core.checkpoint import load_checkpoint

    assert _load_icp_lib() is not None
    monkeypatch.setenv("OSSID_SPEC_FETCH", "inline")
    monkeypatch.setenv("OSSID_FETCH_BUNDLE", "1")
    args = make_args(finetune_interval=2)
    want, weights, _ = _run_jax(world, args, refine_top=0, use_icp=True)
    got, loop = _run_port(world, make_args(finetune_interval=2, save_each=True, save_root=str(tmp_path)),
                          weights, refine_top=0, use_icp=True)
    assert len(got) == len(want) == 2 * N_FRAMES
    for key in ("obj_id", "finetune", "dtoid_confident", "zephyr_confident", "use_dtoid_mask", "n_hypos"):
        assert [r[key] for r in got] == [r[key] for r in want], key
    n_refined = 0
    for g, w in zip(got, want):
        assert g["time_icp"] is not None and w["time_icp"] is not None
        if np.argmax(g["hypo_scores"]) == np.argmax(w["hypo_scores"]):
            n_refined += 1
            np.testing.assert_allclose(g["pred_pose"], w["pred_pose"], rtol=0, atol=1e-9)
            assert abs(g["pred_err"] - w["pred_err"]) <= 1e-9
    assert n_refined >= len(got) - 1
    events = [i for i, r in enumerate(got) if r["finetune"]]
    assert len(events) == 2
    for i in events:
        sd = load_checkpoint(str(tmp_path / "t" / f"epoch_{i}.ckpt"))
        assert set(sd) == set(loop.model.state_dict())
    final = load_checkpoint(str(tmp_path / "t" / f"epoch_{events[-1]}.ckpt"))
    assert all(torch.equal(final[k], v) for k, v in loop.model.state_dict().items())


def test_demo_main_runs_on_the_cpu(tmp_path, capsys):
    """The port's demo end to end at a tiny size (--hard: disjoint
    pretraining, scorer training and calibration, the bootstrap, the loop
    with host ICP, AR; a 64-point scorer on 16 hypotheses a training frame):
    the JSON summary line has the JAX script's keys."""
    from ossid_code_torch.scripts import demo_e2e

    out = demo_e2e.main(["--device", "cpu", "--hard", "--n_objects", "1", "--frames", "2",
                         "--pretrain_frames", "2", "--epochs", "1", "--zephyr_epochs", "1", "--img_h", "96",
                         "--img_w", "128", "--n_views", "3", "--n_templates", "2", "--densenet_blocks", "2,2,2",
                         "--num_points", "64", "--zephyr_hypos", "16", "--root", str(tmp_path)])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(line) == ["dtoid_iou_untrained", "dtoid_iou_pretrained", "dtoid_iou_online", "pose_add01d",
                          "zephyr_visib_recall", "n_finetunes", "AR", "AR_vsd", "AR_mssd", "AR_mspd"]
    assert all(np.isfinite(v) for v in line.values()) and 0.0 <= line["AR"] <= 1.0
    assert set(out["stage_s"]) == set(demo_e2e.STAGES)
    assert out["counts"]["pretrain_steps"] > 0 and out["counts"]["loop_frames"] == 2
    assert demo_e2e.parse_args(["--use_maskrcnn"]).use_maskrcnn
