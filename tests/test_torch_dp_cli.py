"""The train CLI's data parallelism (ossid_code_torch/scripts/train.py,
`train.dp_devices`), on the CPU: `train.dp_devices=2 device=cpu` trains
DTOID in two gloo processes for one epoch, and its metrics rows equal
`train.dp_devices=1`'s on the same world within tests/test_torch_offline.py's
REL = 1e-4 (the one-device CLI is held against JAX's in
tests/test_torch_train_cli.py; one step of the two processes against JAX's
two-device step in tests/test_torch_dp.py).
"""

import json
import os
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

H, W = 128, 160
REL = 1e-4


def _close_rel(got, want, rel, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{what}: max abs err {err:.3g} > {rel} x {scale:.3g}"


@pytest.fixture(scope="module")
def no_tensorflow():
    """As tests/test_torch_train_cli.py: tensorboard's stub writes the events."""
    mp = pytest.MonkeyPatch()
    if "tensorflow" not in sys.modules:
        mp.setitem(sys.modules, "tensorflow", None)
    yield
    mp.undo()


def test_cli_dp_devices_two_matches_one(tmp_path, monkeypatch, no_tensorflow):
    """`train.dp_devices=2 device=cpu` trains in two gloo processes; its
    metrics rows equal `train.dp_devices=1`'s within REL, and only rank 0
    wrote the run (one config, one metrics file, the checkpoints)."""
    from ossid_code_torch.data.synthetic import default_objects, make_synthetic_bop, make_template_grid
    from ossid_code_torch.scripts import train

    world = str(tmp_path / "world")
    make_synthetic_bop(world, n_frames=2, img_h=H, img_w=W)
    make_template_grid(os.path.join(world, "grid"), default_objects(), n_views=6)
    base = ["dataset=dtoid_bop", "model=dtoid", "dataset.heatmap_shorter_length=7", "dataset.n_local_test=2",
            "model.img_h=128", "model.img_w=160", "model.heatmap_h=7", "model.heatmap_w=9",
            "model.densenet_blocks=[2, 2, 2]", f"dataset.bop_root={world}", "dataset.test_dataset_name=synth",
            f"dataset.grid_root={os.path.join(world, 'grid')}", "dataset.shorter_length=128",
            "train.batch_size=2", "model.max_epochs=1", "model.figure_interval=0", "model.learning_rate=0.00001",
            "device=cpu"]
    monkeypatch.setenv("OSSID_RESULT_ROOT", str(tmp_path / "runs"))
    # the two gloo processes train while this one runs train.dp_devices=1
    with ThreadPoolExecutor(1) as pool:
        two = pool.submit(train.main, [*base, "train.dp_devices=2", "exp_name=dp2"])
        assert train.main([*base, "train.dp_devices=1", "exp_name=dp1"]) == 0
        assert two.result() == 0
    rows = {}
    for n in (1, 2):
        exp = tmp_path / "runs" / "train" / f"dp{n}"
        assert sorted(p.name for p in exp.glob("config_v*.yaml")) == ["config_v0.yaml"]
        assert (exp / "last.ckpt").exists()
        with open(exp / "metrics_v0.jsonl") as f:
            rows[n] = [json.loads(line) for line in f if line.strip()]
    assert len(rows[1]) == len(rows[2]) == 1
    assert set(rows[1][0]) == set(rows[2][0])
    for k, v in rows[1][0].items():
        if k != "time":  # the wall clock of the row
            _close_rel(rows[2][0][k], v, REL, k)
