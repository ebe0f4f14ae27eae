"""Faults planted under the timed path (faults.py) come out as not correct:
a step that leaves the weights unchanged, half of each batch left out, and
an answer altered where it is produced (the scorer's pick, the detector's
scores), and the window's finetune events skipped (the numbers that only
those events yield are missing, and a missing number fails). The cells run on one chip, so no exchange between chips exists to
leave out."""

import pytest

from benchmark.tests.tiny import run_cell


@pytest.mark.parametrize("workload,fault,fails", [
    ("tiny_ttt", "frozen_step", ("grad_gap", "update_gap", "window_update_gap")),
    ("tiny_ttt", "half_batch", ("grad_gap", "window_loss_gap")),
    ("tiny_serve", "altered_pick", ("pose_mm",)),
    ("tiny_serve", "altered_detection", ("det_p90",)),
    ("tiny_ttt", "skipped_events", ("schedule_steps", "window_loss_gap", "window_update_gap")),
])
def test_fault_is_not_correct(tiny_copy, workload, fault, fails):
    rc, res, err = run_cell(tiny_copy, workload, 2**32 + 99, "--fault", fault)
    assert rc == 0, err[-4000:]
    assert res["correct"] is False
    for name in fails:
        c = res["checked"][name]
        assert c["value"] is None or c["value"] > c["limit"], res["checked"]
