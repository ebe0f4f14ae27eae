"""The port's train CLI (ossid_code_torch/scripts/train.py) on the legacy
families against the JAX package's CLI, on the CPU.

One synthetic world of 2 textured objects x 5 frames of 128x160 with a
template grid (the JAX package's tests/test_train_families.py world) and an
FSS-1000 layout of 2 classes x 3 images written by cv2. `dataset=fewshot_bop`,
`dataset=fss_1000`, `dataset=ycbv_sift` and `dataset=ycbv_sift
model=superglue` each train 2 epochs at batch 2 through the port's CLI, on
the CPU; the config_v0.yaml each saves equals the one JAX's CLI saves for
the same argv (JAX's CLI stops once it has saved it; the port-only keys
aside, as tests/test_torch_train_cli.py has them), the losses are finite and
move, the matcher's loss falls, and the monitored metric is logged.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch
import yaml
from test_torch_legacy_data import fss_layout, textured_world

torch.set_num_threads(2)

PORT_ONLY_MODEL = ("bf16_finetune", "bf16_infer")
COMMON = ["train.batch_size=2", "model.max_epochs=2"]
FAMILIES = {
    "fewshot_bop": ["dataset=fewshot_bop", "dataset.min_visib_fract=0", "model.img_h=128", "model.img_w=160",
                    "dataset.template_size=128", "model.width=16"],
    "fss_1000": ["dataset=fss_1000", "dataset.image_size=64", "model.width=16"],
    "ycbv_sift": ["dataset=ycbv_sift", "dataset.n_kpts=32", "model.dim=64", "model.n_layers=1"],
    "superglue": ["dataset=ycbv_sift", "model=superglue", "dataset.n_kpts=32", "model.dim=64", "model.n_layers=1"],
}
MONITOR = {"fewshot_bop": "valunseen_seg_IoU", "fss_1000": "valunseen_seg_IoU", "ycbv_sift": "val_match_recall",
           "superglue": "val_match_recall"}
MODEL = {"fewshot_bop": "fewshot_seg", "fss_1000": "fewshot_seg", "ycbv_sift": "matcher", "superglue": "matcher"}


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
def worlds(tmp_path_factory):
    return {"bop": textured_world(str(tmp_path_factory.mktemp("legacy_world"))),
            "fss": fss_layout(str(tmp_path_factory.mktemp("fss") / "fss"))}


def _argv(worlds, family, *extra):
    w = worlds["bop"]
    # the BOP roots on every family's argv: the JAX package reads their
    # defaults from its environment when it is imported, the port when it runs
    where = [f"dataset.bop_root={w}", f"dataset.grid_root={os.path.join(w, 'grid')}"]
    where += [f"dataset.dataset_root={worlds['fss']}"] if family == "fss_1000" else [
        "dataset.test_dataset_name=synth", "dataset.shorter_length=128", "dataset.keep_aspect_ratio=true"]
    return [*FAMILIES[family], *where, *COMMON, f"exp_name={family}", *extra]


@pytest.fixture(scope="module")
def runs(worlds, tmp_path_factory):
    """Each family trained by the port's CLI on the CPU: {family: its run's
    directory}."""
    from ossid_code_torch.scripts import train

    results = str(tmp_path_factory.mktemp("legacy_results"))
    mp = pytest.MonkeyPatch()
    mp.setenv("OSSID_RESULT_ROOT", results)
    try:
        for family in FAMILIES:
            assert train.main(_argv(worlds, family, "device=cpu")) == 0
    finally:
        mp.undo()
    return {f: os.path.join(results, "train", f) for f in FAMILIES}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_saved_config_matches_jax(family, worlds, runs, tmp_path, monkeypatch):
    """config_v0.yaml equals the one JAX's CLI saves for the same argv
    (presets, the family's default model, the ycbv_sift fix-ups), port-only
    keys aside."""
    import ossid_code_tpu.core.config as C
    import ossid_code_tpu.scripts.train as J

    class Saved(Exception):
        pass

    def stop(cfg):
        raise Saved

    monkeypatch.setattr(C, "OSSID_RESULT_ROOT", str(tmp_path))
    monkeypatch.setattr(J, "build_dataloaders", stop)
    with pytest.raises(Saved):
        J.main(_argv(worlds, family))
    with open(os.path.join(str(tmp_path), "train", family, "config_v0.yaml")) as f:
        want = yaml.safe_load(f)
    with open(os.path.join(runs[family], "config_v0.yaml")) as f:
        got = yaml.safe_load(f)
    assert got.pop("device") == "cpu"
    for k in PORT_ONLY_MODEL:
        assert got["model"].pop(k) is False
    assert list(got) == list(want) and got == want
    assert got["model"]["name"] == MODEL[family]


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_training_writes_its_run(family, runs):
    """Two epochs write the run's files and a metric row an epoch with a
    finite, moving loss and the monitored metric; the matcher's loss falls
    (as the JAX package's test asks); best.ckpt loads back."""
    from ossid_code_torch.core.checkpoint import load_checkpoint

    exp = runs[family]
    for name in ("config_v0.yaml", "last.ckpt", "best.ckpt"):
        assert os.path.exists(os.path.join(exp, name)), name
    with open(os.path.join(exp, "metrics_v0.jsonl")) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    assert [r["step"] for r in rows] == [0, 1]
    assert all(np.isfinite(r["loss"]) and MONITOR[family] in r for r in rows)
    assert rows[1]["loss"] != rows[0]["loss"]
    if MODEL[family] == "matcher":
        assert rows[1]["loss"] < rows[0]["loss"]
    last = torch.load(os.path.join(exp, "last.ckpt"), map_location="cpu", weights_only=False)
    assert last["epoch"] == 2
    assert load_checkpoint(os.path.join(exp, "best.ckpt")).keys() == last["state_dict"].keys()


@pytest.mark.parametrize("family", ["fss_1000", "ycbv_sift"])
def test_resume_and_weights_path(family, worlds, runs, tmp_path, monkeypatch):
    """resume_path= restarts at the saved epoch (a third epoch, step 2);
    weights_path= starts a run from a checkpoint's weights, so its first
    loss is not the seed's."""
    from ossid_code_torch.scripts import train

    monkeypatch.setenv("OSSID_RESULT_ROOT", str(tmp_path))
    last = os.path.join(runs[family], "last.ckpt")
    assert train.main(_argv(worlds, family, "device=cpu", "model.max_epochs=3", f"resume_path={last}")) == 0
    exp = os.path.join(str(tmp_path), "train", family)
    with open(os.path.join(exp, "metrics_v0.jsonl")) as f:
        assert [json.loads(line)["step"] for line in f if line.strip()] == [2]
    assert train.main(_argv(worlds, family, "device=cpu", "model.max_epochs=1", f"weights_path={last}",
                            "exp_name=w")) == 0
    with open(os.path.join(str(tmp_path), "train", "w", "metrics_v0.jsonl")) as f:
        first = json.loads(f.readline())["loss"]
    with open(os.path.join(runs[family], "metrics_v0.jsonl")) as f:
        assert first != json.loads(f.readline())["loss"]
