"""The checks `chip_smoke.py` holds the loop's runs in turns with (phases 11
and 16), and the settings of phase 16c, on the CPU.

- `first_divergence` reports a run with a row fewer, with two rows swapped
  and with one changed hypothesis count, naming the first divergent
  target; `run_spread` counts rows that do not pair with their target and
  takes NaN against NaN as equal; `divergent_stage` names the stage where
  a run departs from another by the fingerprints `fingerprinting` leaves
  (detection, mask, host PPF, scoring, finetune).
- The port's CLI and the JAX CLI parse phase 16c's arguments
  (`--n_local_test 160 --finetune_interval 32 --always_dtoid_mask`) to the
  same loop settings, and both packages' `make_template_grid` give 16c's
  160 distinct views.
"""

import copy
import os
import pickle

import numpy as np
import pytest
import torch

import chip_smoke as cs

torch.set_num_threads(2)


def _rows(n=6, seed=0):
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        k = int(rng.integers(60, 120))
        scores = np.full(128, -np.inf, np.float32)
        scores[:k] = rng.normal(0, 5, k)
        rows.append({"obj_id": 1 + i % 2, "scene_id": 0, "im_id": i // 2, "dtoid_confident": bool(i % 3),
                     "zephyr_confident": True, "use_dtoid_mask": True, "finetune": i == 3, "n_hypos": k,
                     "pred_score": float(scores[0]), "hypo_scores": scores, "pred_pose": rng.normal(0, 1, (4, 4)),
                     "dtoid_bbox": rng.uniform(0, 400, (5, 4)), "dtoid_score": np.sort(rng.uniform(0, 1, 5))[::-1],
                     "dtoid_pred_mask": (rng.uniform(0, 1, (48, 64)) > 0.5).astype(np.float32)})
    return rows


def test_equal_runs_agree():
    a = _rows()
    b = copy.deepcopy(a)
    assert cs.first_divergence(a, b) is None
    assert cs.run_spread(a, b) == {"pred_score": 0.0, "hypo_scores": 0.0, "pred_pose": 0.0, "hypo_counts_differ": 0,
                                   "rows_misaligned": 0}


def test_a_missing_row_is_reported():
    a = _rows()
    b = copy.deepcopy(a)[:-1]
    d = cs.first_divergence(a, b)
    assert d["index"] == 5 and d["rows"] == [6, 5] and d["b"] is None and d["a"]["im_id"] == 2
    s = cs.run_spread(a, b)
    assert s["rows_misaligned"] == 1 and s["pred_score"] == s["pred_pose"] == float("inf")


def test_swapped_rows_are_reported():
    a = _rows()
    b = copy.deepcopy(a)
    b[2], b[3] = b[3], b[2]
    d = cs.first_divergence(a, b)
    assert d["index"] == 2 and d["rows"] == [6, 6]
    assert (d["a"]["obj_id"], d["b"]["obj_id"]) == (1, 2)
    assert cs.run_spread(a, b)["rows_misaligned"] == 2


def test_one_changed_hypothesis_count_is_reported():
    a = _rows()
    b = copy.deepcopy(a)
    b[4]["n_hypos"] += 13
    d = cs.first_divergence(a, b)
    assert d["index"] == 4 and d["b"]["n_hypos"] - d["a"]["n_hypos"] == 13
    assert {k for k in cs.PIPE_KEYS if d["a"][k] != d["b"][k]} == {"n_hypos"}


def test_nan_equals_nan_and_nothing_else():
    a = _rows()
    b = copy.deepcopy(a)
    for r in (a[1], b[1]):
        r["pred_score"] = float("nan")
        r["pred_pose"][0, 0] = np.nan
        r["hypo_scores"][3] = np.nan
    assert cs.run_spread(a, b) == {"pred_score": 0.0, "hypo_scores": 0.0, "pred_pose": 0.0,
                                   "hypo_counts_differ": 0, "rows_misaligned": 0}
    b[1]["pred_score"] = 1.0
    b[2]["hypo_scores"][200 % 128] = 0.5 if np.isinf(a[2]["hypo_scores"][200 % 128]) else np.inf
    b[3]["pred_pose"] = b[3]["pred_pose"] + 1e-3
    s = cs.run_spread(a, b)
    assert s["pred_score"] == s["hypo_scores"] == float("inf")
    assert s["pred_pose"] == pytest.approx(1e-3)
    assert cs.max_diff([np.nan, -np.inf], [np.nan, -np.inf]) == 0.0
    assert cs.max_diff([np.nan], [0.0]) == cs.max_diff([1.0, 2.0], [1.0]) == float("inf")


def _run(rows, n_events=1):
    """A pipe_turns run with the fingerprints fingerprinting leaves."""
    return {"rows": rows,
            "fingerprints": {"ppf": [(r["obj_id"], cs.digest(np.full(3, i)), r["n_hypos"]) for i, r in enumerate(rows)],
                             "finetunes": [(4 * (k + 1), 1000 + k, [2]) for k in range(n_events)]}}


@pytest.mark.parametrize("where", ["detection", "mask", "host PPF", "scoring", "finetune", "after a finetune"])
def test_divergent_stage_names_the_stage(where):
    a = _run(_rows())
    b = copy.deepcopy(a)
    i = 2
    if where == "detection":
        b["rows"][i]["dtoid_score"] = b["rows"][i]["dtoid_score"] + 1e-7
    elif where == "mask":
        b["fingerprints"]["ppf"][i] = (1, cs.digest(np.zeros(3)), b["fingerprints"]["ppf"][i][2])
    elif where == "host PPF":
        oid, crop, n = b["fingerprints"]["ppf"][i]
        b["fingerprints"]["ppf"][i] = (oid, crop, n + 1)
    elif where == "scoring":
        b["rows"][i]["pred_pose"] = b["rows"][i]["pred_pose"] * 1.0001
    elif where == "finetune":
        b["fingerprints"]["finetunes"][0] = (4, 999, [2])
    else:
        i = 5
        b["rows"][i]["dtoid_bbox"] = b["rows"][i]["dtoid_bbox"] + 1.0
    st = cs.divergent_stage(a, b)
    want = {"detection": "detection before any finetune", "mask": "mask", "host PPF": "host PPF",
            "scoring": "scoring", "finetune": "finetune", "after a finetune": "detection"}[where]
    assert st["stage"] == want
    assert st["index"] == (3 if where == "finetune" else i)
    assert st["finetunes_before"] == (1 if where == "after a finetune" else 0)
    assert cs.divergent_stage(a, copy.deepcopy(a)) is None


def test_turns_summary_reports_a_short_run():
    """A pipelined run a row short: schedules unequal, the first divergence
    names the missing target, the spread is inf."""
    sync = _run(_rows())
    turns = []
    for mode, rows in (("sync", sync["rows"]), ("pipelined", sync["rows"][:-1]), ("pipelined", sync["rows"]),
                       ("sync", sync["rows"])):
        turns.append(dict(_run(copy.deepcopy(rows)), mode=mode, wall_s=1.0, hit_rate=None, fetches_per_frame=1.0,
                          stats={"counts": {}, "rpcs": {}}, steps=1, redispatches=0, launches={}, peak_gib=1.0))
    out = cs.turns_summary(turns)
    assert not out["schedules_equal"] and out["first_divergence"][1]["index"] == 5
    assert out["divergent_stage"][1]["stage"] == "rows" and out["schedule_diffs"][1] == {"rows": -1}
    assert out["spread"]["sync_vs_sync"]["pred_score"] == 0.0
    assert out["spread"]["pipelined_vs_sync"][0]["pred_score"] == float("inf")


# ------------------------------------------------------------------ 16c
def test_cli_parses_16c_to_the_same_loop_settings(tmp_path, monkeypatch):
    import ossid_code_tpu.scripts.online_learning as J

    import ossid_code_torch.scripts.online_learning as T
    from test_torch_cli import _point_roots

    _point_roots(monkeypatch, str(tmp_path))
    argv = [*cs.LMO_ARGV, "--exp_name", "t160"]
    jargs, targs = J.build_parser().parse_args(argv), T.build_parser().parse_args(argv)
    got = vars(targs)
    assert got.pop("device") is None and got == vars(jargs)
    assert (targs.n_local_test, targs.finetune_interval, targs.finetune_epochs, targs.always_dtoid_mask) == \
        (cs.T_PRETRAINED, 32, 1, True)
    jcfg, tcfg = J.build_config(jargs), T.build_config(targs)
    assert tcfg.dataset == jcfg.dataset and tcfg.dataset.n_local_test == 160
    assert tcfg.dataset.grid_root.endswith("templates_LMO_DTOID")


def test_template_grid_of_16c_has_160_distinct_views_in_both(tmp_path):
    import ossid_code_tpu.data.synthetic as J

    import ossid_code_torch.data.synthetic as T

    for pkg, root in ((J, tmp_path / "jax"), (T, tmp_path / "port")):
        pkg.make_template_grid(str(root), {1: pkg.default_objects()[1]}, n_views=cs.LMO_VIEWS, obj_id_offset=500)
    rots = {}
    for name in ("jax", "port"):
        with open(tmp_path / name / "vid2rot.pkl", "rb") as f:
            rots[name] = np.stack([v for _, v in sorted(pickle.load(f).items())])
        assert len(os.listdir(tmp_path / name / "000501")) >= 3 * cs.LMO_VIEWS
    assert len(rots["port"]) == cs.LMO_VIEWS == 160
    np.testing.assert_allclose(rots["port"], rots["jax"], atol=1e-12)
    distinct = {tuple(np.round(r, 9).ravel()) for r in rots["port"]}
    assert len(distinct) == 160


# -------------------------------------- the cause 16a found: resize gradients
@pytest.mark.parametrize("mode,hw,out_hw", [("nearest", (29, 39), (60, 80)), ("nearest", (60, 80), (29, 39)),
                                            ("bilinear", (30, 30), (7, 7)), ("bilinear", (7, 9), (16, 20))])
def test_resize_gradients_sum_by_gathers(mode, hw, out_hw):
    """The port's resize_nearest / resize_bilinear: the forward is PyTorch's
    own (index_select; F.interpolate) bit for bit, and the gradient equals
    PyTorch's to rounding while the backward dispatches neither index_add
    nor upsample_bilinear2d_backward (on the card both add with float
    atomics in an order that changes from run to run: phase 16a's finetune
    checksums parted there)."""
    import torch.nn.functional as F
    from torch.utils._python_dispatch import TorchDispatchMode

    from ossid_code_torch.ops import resize

    x = torch.from_numpy(np.random.default_rng(3).normal(0, 1, (2, *hw, 5)).astype(np.float32))
    g = torch.from_numpy(np.random.default_rng(4).normal(0, 1, (2, *out_hw, 5)).astype(np.float32))
    fn = resize.resize_nearest if mode == "nearest" else resize.resize_bilinear
    if mode == "nearest":
        rows = torch.floor(torch.arange(out_hw[0], dtype=torch.float32) * (hw[0] / out_hw[0])).long()
        cols = torch.floor(torch.arange(out_hw[1], dtype=torch.float32) * (hw[1] / out_hw[1])).long()
        native = lambda t: t.index_select(1, rows).index_select(2, cols)  # noqa: E731
    else:
        native = lambda t: F.interpolate(t.permute(0, 3, 1, 2), size=out_hw, mode="bilinear",  # noqa: E731
                                         align_corners=False).permute(0, 2, 3, 1)
    want_x = x.clone().requires_grad_()
    want = native(want_x)
    want.backward(g)
    ops = set()

    class Ops(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            ops.add(str(func.overloadpacket))
            return func(*args, **(kwargs or {}))

    grads = []
    for _ in range(2):
        got_x = x.clone().requires_grad_()
        with Ops():
            got = fn(got_x, out_hw)
            got.backward(g)
        assert torch.equal(got, want)
        grads.append(got_x.grad)
    torch.testing.assert_close(grads[0], want_x.grad, rtol=1e-6, atol=1e-6)
    assert torch.equal(grads[0], grads[1])
    assert not ops & {"aten.index_add", "aten.index_add_", "aten.upsample_bilinear2d_backward"}, ops
