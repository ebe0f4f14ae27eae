"""The port's offline training CLI (ossid_code_torch/scripts/train.py) against
the JAX package's, on the CPU.

One synthetic world (2 objects x 5 frames of 128x160, a template grid).
`dataset=detect` trains the class-conditional detector (full DenseNet-121,
2 classes) and `dataset=dtoid_bop model=dtoid` DTOID (DenseNet (2, 2, 2);
the preset's figure_interval draws figures), 2 epochs at batch 2 each, once
per module; the override parser and the saved
config_v0.yaml are compared with JAX's for the same argv (JAX's CLI stops
after it has saved its config). The port's config tree has three keys the
JAX tree lacks, left out of the comparison: `device` (the port's own CLI
key) and the model group's `bf16_finetune` / `bf16_infer` (the JAX
package's bf16 switches, which its tree leaves out and reads as False;
tests/test_torch_slice.py::test_config_is_a_copy).
"""

import json
import os
import sys

import numpy as np
import pytest
import torch
import yaml

from ossid_code_torch.utils.png import read_png
from ossid_code_torch.utils.vis import FIG_H, FIG_W

torch.set_num_threads(2)

H, W = 128, 160
PORT_ONLY_MODEL = ("bf16_finetune", "bf16_infer")
FAMILIES = {
    "detect": ["dataset=detect", "dataset.n_classes=2", "dataset.img_h=128", "dataset.img_w=160"],
    "dtoid_bop": ["dataset=dtoid_bop", "model=dtoid", "dataset.heatmap_shorter_length=7", "dataset.n_local_test=2",
                  "model.img_h=128", "model.img_w=160", "model.heatmap_h=7", "model.heatmap_w=9",
                  "model.densenet_blocks=[2, 2, 2]"],
}
MONITOR = {"detect": "val_seg_IoU", "dtoid_bop": "valunseen_seg_IoU"}


@pytest.fixture(scope="module", autouse=True)
def no_tensorflow():
    """The train CLI writes TensorBoard events through torch.utils.tensorboard,
    and tensorboard loads TensorFlow where it is installed (12 s here; the
    card's machine has none). Kept out of the import, tensorboard's own stub
    writes the same event files."""
    mp = pytest.MonkeyPatch()
    if "tensorflow" not in sys.modules:
        mp.setitem(sys.modules, "tensorflow", None)
    yield
    mp.undo()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    from ossid_code_tpu.data.synthetic import default_objects, make_synthetic_bop, make_template_grid

    root = str(tmp_path_factory.mktemp("trainworld"))
    make_synthetic_bop(root, n_frames=5, img_h=H, img_w=W)
    make_template_grid(os.path.join(root, "grid"), default_objects(), n_views=6)
    return root


def _argv(world, family, *extra):
    return [*FAMILIES[family], f"dataset.bop_root={world}", "dataset.test_dataset_name=synth",
            f"dataset.grid_root={os.path.join(world, 'grid')}", "dataset.shorter_length=128",
            "train.batch_size=2", "model.max_epochs=2", f"exp_name={family}", *extra]


def _rows(exp, version):
    with open(os.path.join(exp, f"metrics_v{version}.jsonl")) as f:
        return [json.loads(line) for line in f if line.strip()]


@pytest.fixture(scope="module")
def runs(world, tmp_path_factory):
    """Each family trained by the port's CLI for 2 epochs, then resumed
    from its last.ckpt for a third: {family: its run's directory}."""
    from ossid_code_torch.scripts import train

    out = {}
    results = str(tmp_path_factory.mktemp("train_results"))
    mp = pytest.MonkeyPatch()
    mp.setenv("OSSID_RESULT_ROOT", results)
    try:
        for family in FAMILIES:
            assert train.main(_argv(world, family, "device=cpu")) == 0
            exp = os.path.join(results, "train", family)
            assert train.main(_argv(world, family, "device=cpu", "model.max_epochs=3",
                                    f"resume_path={os.path.join(exp, 'last.ckpt')}")) == 0
            out[family] = exp
    finally:
        mp.undo()
    return out


def test_parse_overrides_matches_jax():
    """Values typed as YAML, dotted keys nested, a group shortcut lifted to
    {'name': ...} when dotted keys follow it, and bad arguments refused."""
    from ossid_code_tpu.scripts.train import parse_overrides as jparse

    from ossid_code_torch.scripts.train import parse_overrides

    for argv in (["dataset=detect", "dataset.n_classes=2", "train.batch_size=4", "model.lr=1e-4"],
                 ["model.densenet_blocks=[2, 2, 2]", "exp_name=x", "seed=3", "resume_path=null", "debug=true"],
                 ["dataset.bop_root=/a/b", "dataset=dtoid_bop", "model=maskrcnn", "model.max_epochs=1"]):
        assert parse_overrides(argv) == jparse(argv)
    for bad in (["dataset"], ["x"]):
        with pytest.raises(SystemExit):
            parse_overrides(bad)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_saved_config_matches_jax(family, world, runs, tmp_path, monkeypatch):
    """config_v0.yaml equals the one JAX's CLI saves for the same argv
    (presets, the detect family's default model), port-only keys aside."""
    import ossid_code_tpu.core.config as C
    import ossid_code_tpu.scripts.train as J

    class Saved(Exception):
        pass

    def stop(cfg):
        raise Saved

    monkeypatch.setattr(C, "OSSID_RESULT_ROOT", str(tmp_path))
    monkeypatch.setattr(J, "build_dataloaders", stop)
    with pytest.raises(Saved):
        J.main(_argv(world, family))
    with open(os.path.join(str(tmp_path), "train", family, "config_v0.yaml")) as f:
        want = yaml.safe_load(f)
    with open(os.path.join(runs[family], "config_v0.yaml")) as f:
        got = yaml.safe_load(f)
    assert got.pop("device") == "cpu"
    for k in PORT_ONLY_MODEL:
        assert got["model"].pop(k) is False
    assert list(got) == list(want) and got == want
    assert got["model"]["name"] == {"detect": "maskrcnn", "dtoid_bop": "dtoid"}[family]


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_training_writes_its_run_and_resumes(family, runs):
    """Two epochs write config_v0.yaml, metrics_v0.jsonl (a row an epoch
    with the loss terms and the monitored metric), TensorBoard events,
    last.ckpt and best.ckpt, and DTOID's prediction figures; the loss moves.
    The resume from last.ckpt starts at epoch 2, writes version 1 and logs
    one epoch."""
    from ossid_code_torch.core.checkpoint import load_checkpoint

    exp = runs[family]
    for name in ("config_v0.yaml", "config_v1.yaml", "last.ckpt", "best.ckpt"):
        assert os.path.exists(os.path.join(exp, name)), name
    assert any(f.startswith("events.out.tfevents") for f in os.listdir(os.path.join(exp, "tb")))
    rows = _rows(exp, 0)
    assert [r["step"] for r in rows] == [0, 1]
    assert all(np.isfinite(r["loss"]) and MONITOR[family] in r for r in rows)
    assert rows[1]["loss"] != rows[0]["loss"]
    assert [r["step"] for r in _rows(exp, 1)] == [2]
    last = torch.load(os.path.join(exp, "last.ckpt"), map_location="cpu", weights_only=False)
    assert last["epoch"] == 3 and ("opt_state" in last) == (family == "dtoid_bop")
    fig_dir = os.path.join(exp, "figures")
    if family == "dtoid_bop":
        # the prediction figures at epoch 0 and at each run's last epoch
        assert sorted(os.listdir(fig_dir)) == [f"epoch{e}_{i}.png" for e in range(3) for i in range(2)]
        for name in os.listdir(fig_dir):
            assert read_png(os.path.join(fig_dir, name)).shape == (FIG_H, FIG_W, 3)
    else:
        assert not os.path.exists(fig_dir)   # GenericTrainer draws none
    assert load_checkpoint(os.path.join(exp, "best.ckpt")).keys() == last["state_dict"].keys()


def test_weights_path_loads(world, runs, tmp_path, monkeypatch, capsys):
    """weights_path= starts a run from a checkpoint's weights: from the
    detect run's last.ckpt (3 epochs trained) the first epoch's loss is not
    the one from the seed's weights, which the same argv gives without it."""
    from ossid_code_torch.scripts import train

    monkeypatch.setenv("OSSID_RESULT_ROOT", str(tmp_path))
    last = os.path.join(runs["detect"], "last.ckpt")
    assert train.main(_argv(world, "detect", "device=cpu", "model.max_epochs=1", f"weights_path={last}")) == 0
    assert f"loaded weights from {last}" in capsys.readouterr().out
    rows = _rows(os.path.join(str(tmp_path), "train", "detect"), 0)
    assert len(rows) == 1 and rows[0]["loss"] != _rows(runs["detect"], 0)[0]["loss"]


def test_offline_validate_matches_jax(world):
    """OfflineTrainer.validate (the dtoid_bop family's monitored metric, the
    mean segmentation IoU of the eval forward) on the valid loader, from the
    same DTOID weights (DenseNet (2, 2, 2), a segmentation head that
    predicts), within 1e-3 of JAX's."""
    import jax

    from ossid_code_tpu.core.config import default_config as jdefault
    from ossid_code_tpu.data.dtoid_bop import get_dataloaders as jloaders
    from ossid_code_tpu.models.dtoid.module import DtoidModel as JDtoid
    from ossid_code_tpu.train.offline import OfflineTrainer as JTrainer

    from ossid_code_torch.core.config import default_config
    from ossid_code_torch.data.dtoid_bop import get_dataloaders
    from ossid_code_torch.models.dtoid.jax_import import dtoid_from_jax
    from ossid_code_torch.models.dtoid.module import DtoidModel
    from ossid_code_torch.train.offline import OfflineTrainer

    cfgs = []
    for cfg in (jdefault(), default_config()):
        d = cfg.dataset
        d.bop_root, d.test_dataset_name, d.grid_root = world, "synth", os.path.join(world, "grid")
        d.shorter_length, d.heatmap_shorter_length, d.n_local_test = H, 7, 2
        cfg.model.img_h, cfg.model.img_w, cfg.model.heatmap_h, cfg.model.heatmap_w = H, W, 7, 9
        cfg.model.densenet_blocks = (2, 2, 2)
        cfgs.append(cfg)
    jm = JDtoid(cfgs[0], seed=0)
    params = jax.tree_util.tree_map(lambda a: np.array(a, np.float32), jax.device_get(jm.params))
    seg = params["correlation_model"]["seg_final"]
    seg["kernel"] = np.random.default_rng(2).normal(0, 0.2, seg["kernel"].shape).astype(np.float32)
    seg["bias"][:] = 0.0
    jm.params = params
    tm = DtoidModel(cfgs[1], seed=0, device="cpu")
    tm.load_state_dict(dtoid_from_jax(params, jax.device_get(jm.batch_stats)))
    want = JTrainer(jm, cfgs[0], n_devices=1).validate(jloaders(cfgs[0])[1])
    got = OfflineTrainer(tm, cfgs[1]).validate(get_dataloaders(cfgs[1])[1])
    assert 0.0 < want < 1.0 and abs(got - want) <= 1e-3, (got, want)


def test_data_parallel_devices_raise(world, tmp_path, monkeypatch):
    """train.dp_devices=N on the cards starts one NCCL process a card, and
    more devices than cards raise as JAX's make_mesh does ("requested N
    devices, have M"), before any process starts. On the CPU (device=cpu)
    N gloo processes train: tests/test_torch_dp.py runs that against
    train.dp_devices=1."""
    from ossid_code_torch.scripts import train

    monkeypatch.setenv("OSSID_RESULT_ROOT", str(tmp_path))
    have = torch.cuda.device_count()
    with pytest.raises(ValueError, match=f"requested {have + 2} devices, have {have}"):
        train.main(_argv(world, "dtoid_bop", f"train.dp_devices={have + 2}", f"train.batch_size={have + 2}"))
