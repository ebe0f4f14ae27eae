"""The port's A/B scripts (ossid_code_torch/scripts/ab_*.py) on the CPU at tiny
sizes, against the JAX package's where the two can meet.

`ab_templates`, `ab_scorer` and `ab_finetune` run through and print the JAX
scripts' keys; the JAX scripts start from random weights the port cannot
reproduce, so the scorer's two sampling paths are held against JAX's
`ZephyrModel._score` under the matching OSSID_PACKED_SAMPLE on weights
carried from JAX. `ab_rank_blend` runs in both packages on one tiny hard
world: the rows that do not depend on the scorer's weights (the ceiling and
every statistic cell: oracle masks, the same PPF C++, the same statistic)
must be equal, and the statistic itself is held to JAX's within 1e-6.
"""

import json
import re
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ossid_code_torch.models.zephyr.jax_import import pointnet2_from_jax
from ossid_code_torch.models.zephyr.module import ZephyrModel as TZephyrModel
from ossid_code_torch.scripts import ab_finetune, ab_rank_blend, ab_scorer, ab_templates, roofline

torch.set_num_threads(2)
SMALL = ["--img_h", "128", "--img_w", "160", "--device", "cpu"]
TOL = dict(rtol=2e-4, atol=2e-4)  # the scorer's parity tolerance, tests/test_torch_zephyr.py
# the JAX scripts' JSON keys (ossid_code_tpu/scripts/ab_templates.py:80-87,
# ab_scorer.py:87-90, ab_finetune.py:69-72)
TEMPLATES_KEYS = {"metric", "templates", "img", "value", "unit", "template_featurize_s", "first_call_s", "fps_equiv"}
SCORER_KEYS = {"config", "m", "bf16", "ms", "score_sum"}
FINETUNE_KEYS = {"metric", "bf16", "seg_half", "batch", "value", "unit"}
# the smallest hard world on which the JAX and the port's scripts see
# hypotheses on several targets and the statistic's cells differ (3 targets,
# ceiling 1/3 here)
RANK_BLEND_ARGV = ["--frames", "2", "--targets", "3", "--zephyr_epochs", "0", "--align_feats", "0",
                   "--img_h", "128", "--img_w", "160", "--max_poses", "32"]


def _json_lines(text: str) -> list:
    return [json.loads(line) for line in text.splitlines() if line.startswith("{")]


def test_ab_templates_runs_on_cpu(capsys):
    lines = ab_templates.main(["--sizes", "2", "4", "--iters", "1", "--densenet_blocks", "2", "2", "2", *SMALL])
    printed = _json_lines(capsys.readouterr().out)
    assert printed == json.loads(json.dumps(lines))
    assert [ln["templates"] for ln in lines] == [2, 4]
    for ln in lines:
        assert TEMPLATES_KEYS <= set(ln)
        assert ln["metric"] == "detect_ms_per_frame" and ln["value"] > 0 and ln["img"] == [128, 160]
        # the plain version ran: no kernel launch, no device memory
        assert ln["device"] == "cpu" and ln["peak_memory_mb"] is None
        assert ln["dw_corr3x3_launches_per_detect"] == 0


def test_ab_scorer_runs_on_cpu(capsys):
    rows = ab_scorer.main(["--hypos", "8", "--iters", "1", "--num_points", "128", *SMALL])
    out = capsys.readouterr().out
    assert _json_lines(out) == [{"ab_scorer": json.loads(json.dumps(rows))}]
    assert [(r["config"], r["bf16"]) for r in rows] == [("baseline", False), ("packed", False),
                                                       ("baseline", True), ("packed", True)]
    for r in rows:
        assert SCORER_KEYS <= set(r) and r["device"] == "cpu" and r["sa_mlp_max_launches"] == 0
    # the two sampling paths give the same values
    for bf16 in (False, True):
        base, packed = (r["score_sum"] for r in rows if r["bf16"] == bf16)
        assert packed == base


@pytest.mark.parametrize("packed", [False, True])
def test_sampling_paths_match_jax_score(monkeypatch, packed):
    """ZephyrModel(packed_sample=...) against JAX's score program under the
    matching OSSID_PACKED_SAMPLE (read when the JAX model is built), on
    weights carried from JAX, the roofline's score inputs at M = 8."""
    from ossid_code_tpu.models.zephyr.module import ZephyrModel

    monkeypatch.setenv("OSSID_PACKED_SAMPLE", "1" if packed else "0")
    m = 8
    jz = ZephyrModel(num_points=128, inconst_ratio_th=100.0, seed=0, need_uv=False)
    tz = TZephyrModel(num_points=128, inconst_ratio_th=100.0, seed=0, need_uv=False, packed_sample=packed,
                      device="cpu")
    np_tree = lambda t: jax.tree_util.tree_map(lambda a: np.array(a, np.float32), jax.device_get(t))  # noqa: E731
    tz.load_state_dict(pointnet2_from_jax(np_tree(jz.params), np_tree(jz.batch_stats)))
    inputs = roofline.score_inputs(np.random.default_rng(3), (128, 160))
    # poses spread over the frame so the samples fall between pixels
    fn, args = roofline.score_program(tz, inputs, m)
    poses = np.tile(np.eye(4, dtype=np.float32), (m, 1, 1))
    poses[:, :3, 3] = np.stack([np.linspace(-0.05, 0.05, m), np.linspace(0.04, -0.04, m), np.full(m, 0.6)], 1)
    args = (*args[:-2], torch.from_numpy(poses), args[-1])
    got = fn(*args)

    prep = jz.prepare_object(1, inputs["pts"], inputs["cols"], inputs["nrms"])
    want = jz._score(*jz._score_vars(), *map(jnp.asarray, (inputs["img"], inputs["depth"], inputs["origin"],
                                                          inputs["K"])),
                     *prep, jnp.asarray(poses), jnp.ones((m,), bool))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **TOL)  # scores, -inf where pruned
    np.testing.assert_allclose(got[4].numpy(), np.asarray(want[4]), rtol=0, atol=1e-6)  # alignment statistic


def test_ab_finetune_runs_on_cpu(capsys):
    lines = ab_finetune.main(["--iters", "1", "--batch", "2", "--densenet_blocks", "2", "2", "2", *SMALL])
    assert _json_lines(capsys.readouterr().out) == json.loads(json.dumps(lines))
    # JAX's four rows in its order: bf16 x seg_half (ossid_code_tpu/scripts/ab_finetune.py:58-72)
    assert [(ln["bf16"], ln["seg_half"]) for ln in lines] == [(True, False), (True, True), (False, False),
                                                               (False, True)]
    for ln in lines:
        assert FINETUNE_KEYS <= set(ln)
        assert ln["metric"] == "finetune_step_ms" and ln["batch"] == 2
        assert ln["value"] > 0 and ln["device"] == "cpu"
        assert ln["dw_corr3x3_dx_launches"] == ln["dw_corr3x3_dk_launches"] == 0


@pytest.fixture(scope="module")
def native_ppf():
    """The JAX package loads the PPF library `make -C native` builds."""
    subprocess.run(["make", "-C", str(Path(__file__).resolve().parents[1] / "native"), "-s"], check=True)


def _rank_blend_rows(text: str) -> dict:
    """{strategy: pick rate} of the JSON lines and {stat cell: pick rate} of
    the log, from one run's captured output."""
    rows = {d["strategy"]: d["pick_add01d"] for d in _json_lines(text) if "strategy" in d}
    rows.update({m[1]: float(m[2]) for m in re.finditer(r"\]\s+(stat_d[0-9.]+_h[0-9.]+): ([0-9.]+)", text)})
    return rows


_RANK_BLEND: dict = {}


def _rank_blend_runs(capsys):
    """Both packages' ab_rank_blend on RANK_BLEND_ARGV at --rank_weight 0.5,
    run once a module: {'want': JAX's rows, 'got': the port's, 'summary':
    the port's summary line, 'built': the rank weight of each scorer the
    port's script built}. With --zephyr_epochs 0 no scorer trains, so the
    weight changes no row."""
    if not _RANK_BLEND:
        from ossid_code_tpu.scripts import ab_rank_blend as jax_script

        from ossid_code_torch.models.zephyr import module as zmod

        argv = [*RANK_BLEND_ARGV, "--rank_weight", "0.5"]
        capsys.readouterr()
        assert jax_script.main(argv) == 0
        cap = capsys.readouterr()
        want = _rank_blend_rows(cap.out + cap.err)
        built = []
        init = zmod.ZephyrModel.__init__

        def recording_init(self, *a, **kw):
            init(self, *a, **kw)
            built.append(self.rank_weight)

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(zmod.ZephyrModel, "__init__", recording_init)
            assert ab_rank_blend.main([*argv, "--device", "cpu"]) == 0
        cap = capsys.readouterr()
        _RANK_BLEND.update(want=want, got=_rank_blend_rows(cap.out + cap.err),
                           summary=[d for d in _json_lines(cap.out) if "summary" in d][0], built=built)
    return _RANK_BLEND


def test_ab_rank_blend_matches_jax(native_ppf, capsys):
    runs = _rank_blend_runs(capsys)
    want, got = runs["want"], runs["got"]
    assert runs["summary"]["n_frames"] >= 2

    assert set(got) == set(want)
    cells = [k for k in want if k.startswith("stat_d")]
    assert len(cells) == len(ab_rank_blend.CELLS)
    assert len({want[k] for k in cells}) > 1  # the cells differ: the comparison has teeth
    for k in ["ceiling", "stat_best", *cells]:
        assert got[k] == want[k], k
    for k, v in got.items():  # the rows that depend on the scorer's weights
        assert 0.0 <= v <= 1.0, k


def test_ab_rank_blend_takes_only_the_ports_rank_weight(native_ppf, capsys):
    """--rank_weight reaches the scorer as ZephyrModel(rank_weight=), as in
    the JAX script (ossid_code_tpu/scripts/ab_rank_blend.py:54,95): the run
    at 0.5 of _rank_blend_runs ends and builds its scorer with that weight
    (tests/test_torch_zephyr_train.py holds the weighted loss to JAX's)."""
    assert _rank_blend_runs(capsys)["built"] == [0.5]


def test_alignment_stats_match_jax():
    """ab_rank_blend.alignment_stats against JAX's `_stats` arithmetic
    (ossid_code_tpu/scripts/ab_rank_blend.py:110-123, a closure there),
    re-stated here on the JAX package's features, within 1e-6."""
    from ossid_code_tpu.models.zephyr.features import assemble_score_features
    from ossid_code_tpu.models.zephyr.module import _blur5

    rng = np.random.default_rng(4)
    h, w, n, m = 48, 64, 200, 12
    img = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    depth = rng.uniform(0.55, 0.65, (h, w)).astype(np.float32)
    depth[rng.uniform(size=(h, w)) < 0.1] = 0.0
    cam_k = np.array([[60.0, 0, w / 2], [0, 60.0, h / 2], [0, 0, 1]], np.float32)
    pts = rng.normal(0, 0.03, (n, 3)).astype(np.float32)
    cols = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    nrms = rng.normal(0, 1, (n, 3))
    nrms = (nrms / np.linalg.norm(nrms, axis=1, keepdims=True)).astype(np.float32)
    poses = np.tile(np.eye(4, dtype=np.float32), (m, 1, 1))
    poses[:, :3, 3] = np.stack([rng.normal(0, 0.01, m), rng.normal(0, 0.01, m), rng.uniform(0.57, 0.63, m)], 1)

    args = (img, depth, cam_k, pts, cols, nrms, poses)
    got = ab_rank_blend.alignment_stats(*map(torch.from_numpy, args)).numpy()
    point_x, _, _ = assemble_score_features(_blur5(jnp.asarray(img)), *map(jnp.asarray, args[1:]))
    dh, dd, ok = point_x[..., 3], jnp.abs(point_x[..., 6]), point_x[..., 10]
    nvalid = jnp.maximum(ok.sum(-1), 1.0)
    want = np.stack([np.asarray((ok * (dd < td) * (dh < th_)).sum(-1) / nvalid)
                     for td in ab_rank_blend.TAU_D for th_ in ab_rank_blend.TAU_H], -1)
    assert got.shape == (m, 25) and 0.0 < got.max() <= 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_strategies_on_hand_made_sets():
    """pick_rate, blend and rerank on two hand-made hypothesis sets where
    the net and the statistic disagree."""
    r1 = {"scores": np.array([3.0, 1.0, 2.0]), "stats": np.tile(np.array([[0.1], [0.9], [0.5]]), (1, 25)),
          "errs": np.array([5.0, 0.5, 5.0]), "diam": 10.0}
    r2 = {"scores": np.array([1.0, 3.0, -np.inf]), "stats": np.tile(np.array([[0.2], [0.8], [0.99]]), (1, 25)),
          "errs": np.array([5.0, 0.5, 0.1]), "diam": 10.0}
    assert ab_rank_blend.pick_rate([r1, r2], lambda r: np.argmax(r["scores"])) == 0.5
    assert ab_rank_blend.rerank(r1, 2, 0) == 2 and ab_rank_blend.rerank(r1, 3, 0) == 1
    assert ab_rank_blend.blend(r1, 4.0, 0) == 1 and ab_rank_blend.blend(r1, 0.25, 0) == 0
    # fewer than 2 finite scores: the statistic alone
    r3 = dict(r2, scores=np.array([1.0, -np.inf, -np.inf]))
    assert ab_rank_blend.blend(r3, 1.0, 0) == 2
    results, cells = ab_rank_blend.strategies([r1, r2])
    assert results["ceiling"] == 1.0 and results["net_only"] == 0.5 and len(cells) == 25
