"""The train CLI's render families (`dataset=render`, `dataset=dtoid`; BlenderProc
HDF5 scenes through data/hdf5_render.py) in the port against the JAX
package's CLI, on the CPU.

The world: 6 sampled objects (the reference's split gives 4 train, 1
valid-unseen and 1 test object), 4 scenes of 128x160 and 4 template renders
an object, written by the port's writer. `dataset=render model=fewshot_seg`
at the scenes' size trains 2 epochs at batch 2 in both CLIs: the saved
configs are equal (port-only keys aside, as tests/test_torch_legacy_cli.py
has them) and the losses are finite and the port's move, as that file
holds them. `dataset=dtoid` builds few-shot episodes for the DTOID model
in both packages, so both CLIs stop at the first batch with KeyError
'limg' (a fault of the reference the port copies, ROADMAP.md).
"""

import json
import os
import sys

import numpy as np
import pytest
import torch
import yaml

torch.set_num_threads(2)

PORT_ONLY_MODEL = ("bf16_finetune", "bf16_infer")
CASES = {
    "render_fewshot_seg": ["dataset=render", "model=fewshot_seg", "dataset.shorter_length=128", "model.img_h=128",
                           "model.img_w=160", "model.width=16"],
    "dtoid": ["dataset=dtoid", "dataset.shorter_length=128", "dataset.heatmap_shorter_length=7", "model.img_h=128",
              "model.img_w=160", "model.heatmap_h=7", "model.heatmap_w=9", "model.densenet_blocks=[2, 2, 2]"],
}


@pytest.fixture(scope="module", autouse=True)
def no_tensorflow():
    """tensorboard loads TensorFlow where it is installed; kept out of the
    import, its own stub writes the same event files."""
    mp = pytest.MonkeyPatch()
    if "tensorflow" not in sys.modules:
        mp.setitem(sys.modules, "tensorflow", None)
    yield
    mp.undo()


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    from ossid_code_torch.data.synthetic import make_render_world, sampled_objects

    return make_render_world(str(tmp_path_factory.mktemp("render_cli")), n_scenes=4, n_grid_views=4,
                             objects=sampled_objects(6))[0]


def _argv(scenes, case, *extra):
    # the BOP roots too: the JAX package reads their defaults from its
    # environment when it is imported, the port when it runs
    return [*CASES[case], f"dataset.dataset_root={scenes}", f"dataset.bop_root={scenes}",
            f"dataset.grid_root={scenes}", "train.batch_size=2", "model.max_epochs=2", f"exp_name={case}", *extra]


@pytest.fixture(scope="module")
def runs(scenes, tmp_path_factory):
    """Every case through JAX's CLI and the port's (on the CPU), each
    package under its own results root: {(case, package): (the run's
    directory, main's return value or the KeyError it raised)}."""
    import ossid_code_tpu.core.config as C
    import ossid_code_tpu.scripts.train as J

    from ossid_code_torch.scripts import train

    root = tmp_path_factory.mktemp("render_cli_runs")
    out = {}
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(C, "OSSID_RESULT_ROOT", str(root / "jax"))
        mp.setenv("OSSID_RESULT_ROOT", str(root / "port"))
        for case in CASES:
            for package, main, extra in (("jax", J.main, ()), ("port", train.main, ("device=cpu",))):
                try:
                    result = main(_argv(scenes, case, *extra))
                except KeyError as e:
                    result = e
                out[case, package] = (str(root / package / "train" / case), result)
    finally:
        mp.undo()
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_saved_config_matches_jax(case, runs):
    """config_v0.yaml equals JAX's for the same argv, port-only keys aside
    (`dataset=dtoid` saves it before its first batch)."""
    def config(package):
        with open(os.path.join(runs[case, package][0], "config_v0.yaml")) as f:
            return yaml.safe_load(f)

    got, want = config("port"), config("jax")
    assert got.pop("device") == "cpu"
    for k in PORT_ONLY_MODEL:
        assert got["model"].pop(k) is False
    assert list(got) == list(want) and got == want
    assert got["model"]["name"] == {"dtoid": "dtoid", "render_fewshot_seg": "fewshot_seg"}[case]
    assert got["dataset"]["name"] == case.split("_")[0]


def test_render_fewshot_seg_trains_in_both_clis(runs):
    """2 epochs in each CLI: a finite loss an epoch in both, moving in the
    port, and the monitored metric logged."""
    losses = {}
    for package in ("jax", "port"):
        exp, rc = runs["render_fewshot_seg", package]
        assert rc == 0
        with open(os.path.join(exp, "metrics_v0.jsonl")) as f:
            rows = [json.loads(line) for line in f if line.strip()]
        assert [r["step"] for r in rows] == [0, 1] and all("valunseen_seg_IoU" in r for r in rows)
        losses[package] = [r["loss"] for r in rows]
    assert np.isfinite(losses["jax"] + losses["port"]).all()
    assert losses["port"][1] != losses["port"][0]


def test_dtoid_family_stops_at_limg_in_both_clis(runs):
    """dataset=dtoid feeds few-shot episodes to the DTOID trainer: KeyError
    'limg' at the first batch, in JAX's CLI and in the port's alike."""
    for package in ("jax", "port"):
        _, err = runs["dtoid", package]
        assert isinstance(err, KeyError) and err.args == ("limg",), (package, err)
