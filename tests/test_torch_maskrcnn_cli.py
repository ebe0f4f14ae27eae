"""The class-conditional detector (`--use_maskrcnn`) through the port's
online-learning CLI, on the CPU (the demo with it:
tests/test_torch_maskrcnn.py).

Both CLIs run on one synthetic world in tests/test_torch_cli.py's layout (2
objects x 2 frames of 128x160, its template grid, precomputed scorer
results), from one JAX MaskRCNN (3 classes, full DenseNet-121, output convs
perturbed from a seed) saved as a JAX pickle and the CLI's 512-point scorer
saved by JAX as a torch file. No finetune event falls in the 4 targets: the
finetune with this detector is compared in
tests/test_torch_maskrcnn.py::test_loop_with_maskrcnn_matches_jax. Floats
are held to tests/test_torch_cli.py's limits: scores 2e-3 relative and 5e-4
absolute, rotations 1e-4, translations 0.1 mm, the top detection box 2e-2 px.
"""

import os
import pickle

import numpy as np
import pytest
import torch

from test_torch_cli import SUMMARY, _point_roots

torch.set_num_threads(2)

H, W, N_CLASSES = 128, 160, 3
N_FRAMES = 2  # x 2 objects = 4 targets


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    from ossid_code_tpu.data.bop import BopDataset, BopDatasetArgs
    from ossid_code_tpu.data.synthetic import (
        default_objects, make_synthetic_bop, make_template_grid, make_zephyr_results_pkl,
    )

    root = str(tmp_path_factory.mktemp("maskrcnnworld"))
    make_synthetic_bop(root, n_frames=N_FRAMES, img_h=H, img_w=W)
    make_template_grid(os.path.join(root, "grid"), default_objects(), n_views=8)
    bop = BopDataset(BopDatasetArgs(bop_root=root, dataset_name="synth"))
    make_zephyr_results_pkl(os.path.join(root, "synth_zephyr_results.pkl"), bop, score=50.0)
    return root


@pytest.fixture(scope="module")
def weights(world, tmp_path_factory):
    """The detector as a JAX pickle, the scorer as a torch file written by
    JAX's save_checkpoint, and the --conf_path YAML that sizes the detector
    (the dataset group's n_classes and frame size)."""
    import jax

    from ossid_code_tpu.core.checkpoint import save_checkpoint
    from ossid_code_tpu.core.config import Config, default_config
    from ossid_code_tpu.models.maskrcnn import MaskRCNN
    from ossid_code_tpu.models.zephyr.module import ZephyrModel

    d = tmp_path_factory.mktemp("maskrcnn_weights")
    conf = str(d / "conf.yaml")
    Config(dataset={"n_classes": N_CLASSES, "img_h": H, "img_w": W}).save(conf)
    model = MaskRCNN(default_config().merged(Config.load(conf).to_dict()), seed=0)
    state = jax.tree_util.tree_map(lambda a: np.array(a, np.float32), jax.device_get(model.state_dict()))
    rng = np.random.default_rng(11)
    for node, std in ((state["params"]["classification"]["output"], 0.3),
                      (state["params"]["regression"]["output"], 0.01), (state["params"]["seg_final"], 0.05)):
        node["kernel"] = rng.normal(0, std, node["kernel"].shape).astype(np.float32)
    save_checkpoint(str(d / "maskrcnn.ckpt"), state)
    zm = ZephyrModel(num_points=512, seed=4)
    save_checkpoint(str(d / "scorer.ckpt"), {"params": zm.params, "batch_stats": zm.batch_stats},
                    torch_format=True)
    return {"conf": conf, "maskrcnn": str(d / "maskrcnn.ckpt"), "scorer": str(d / "scorer.ckpt")}


def test_cli_with_maskrcnn_matches_jax(world, weights, tmp_path, monkeypatch, capsys):
    """Both CLIs with --use_maskrcnn, the detector's JAX pickle as
    --dtoid_weights_path and its sizes from --conf_path: the same printed
    summary (AR, IoUs, mAP), the results pickle's rows and the BOP CSV."""
    import ossid_code_tpu.scripts.online_learning as J

    import ossid_code_torch.scripts.online_learning as T
    from ossid_code_torch.eval.bop_csv import read_results_bop
    from ossid_code_torch.models.maskrcnn import MaskRCNNNetwork

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
    assert set(got["final_state_dict"]) == set(MaskRCNNNetwork(N_CLASSES, (H, W)).state_dict())
    rows, jrows = got["test_results"], want["test_results"]
    assert len(rows) == len(jrows) == 2 * N_FRAMES
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
