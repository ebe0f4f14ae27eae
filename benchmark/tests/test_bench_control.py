"""The check's control on the card: the port's own bf16 paths (detection,
scoring and the finetune step) put in the float32 program's place, each
cell at its own size, on three seeds; every run must come out as not
correct. Marked `cuda`: it skips without a card (decided inside the test).
On the card: `python -m pytest -q benchmark/tests/test_bench_control.py`."""

import json
import subprocess
import sys

import pytest

from benchmark.tests.tiny import REPO

SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
SEEDS = (2**31 + 7, 2**32 + 17, 2**33 + 27)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_bf16_control_is_not_correct(workload):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the control runs the port's bf16 kernels")
    for seed in SEEDS:
        p = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", workload, "--seed", str(seed),
                            "--seconds", "5", "--trace", "0", "--control", "bf16"],
                           cwd=REPO, capture_output=True, text=True, timeout=900)
        assert p.returncode == 0, p.stderr[-4000:]
        res = json.loads(p.stdout.strip().splitlines()[-1])
        assert res["correct"] is False, res["checked"]
