"""The port's online-learning CLI (ossid_code_torch/scripts/online_learning.py)
and the modules it brought, against the JAX package's, on the CPU.

The whole CLI runs in both packages on one synthetic world (2 objects x 2
frames of 128x160, DenseNet (2, 2, 2) from --conf_path, 8 fake hypotheses,
a finetune every 2 targets at batch 2) from the same DTOID weights (a JAX
pickle) and scorer (a torch file written by JAX's save_checkpoint), with
the env roots pointed at the world (JAX's core.config reads them at import,
so its module attributes are patched). Floats are held to the limits of
tests/test_torch_loop.py: scores 2e-3 relative and 5e-4 absolute, poses
1e-4 where both pick the same hypothesis.
"""

import argparse
import os
import pickle
from types import SimpleNamespace

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

H, W = 128, 160
N_FRAMES = 2
SUMMARY = ("BOP AR", "DTOID mean IoU", "DTOID Valid IoU recall", "Zephyr Valid IoU recall", "ADD(-S) < 0.1d",
           "Detection mAP@0.5")


def _point_roots(monkeypatch, base, bop_root=None, tag="x"):
    """Both packages' roots at `base` (the port reads the environment when
    it runs; JAX's CLI reads its config module's attributes)."""
    import ossid_code_tpu.core.config as C
    import ossid_code_tpu.eval.bop_csv as jcsv

    roots = {"OSSID_ROOT": base, "BOP_DATASETS_ROOT": bop_root or os.path.join(base, "bop"),
             "OSSID_CKPT_ROOT": os.path.join(base, "ckpts"), "OSSID_DATA_ROOT": os.path.join(base, "data"),
             "OSSID_RESULT_ROOT": os.path.join(base, f"results_{tag}"),
             "BOP_RESULTS_FOLDER": os.path.join(base, f"bop_results_{tag}"),
             "BOP_TOOLKIT_PATH": os.path.join(base, "no_toolkit")}
    for k, v in roots.items():
        monkeypatch.setenv(k, v)
        monkeypatch.setattr(C, k, v)
    monkeypatch.setattr(jcsv, "BOP_TOOLKIT_PATH", roots["BOP_TOOLKIT_PATH"])
    return roots


# ------------------------------------------------------------ CSV and mAP

def _rows(rng, n=12):
    rows = []
    for i in range(n):
        pose = np.eye(4)
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        pose[:3, :3] = q * np.sign(np.linalg.det(q))
        pose[:3, 3] = rng.uniform(-0.3, 0.9, 3)
        rows.append({"obj_id": int(rng.integers(1, 4)), "scene_id": 0, "im_id": i, "pred_pose": pose,
                     "pred_score": float(rng.normal(0, 30)), "time": float(rng.uniform(0, 1))})
    return rows


def test_bop_csv_bytes_match_jax(tmp_path):
    from ossid_code_tpu.eval.bop_csv import read_results_bop as jread
    from ossid_code_tpu.eval.bop_csv import save_results_bop as jsave

    from ossid_code_torch.eval.bop_csv import read_results_bop, save_results_bop

    rows = _rows(np.random.default_rng(0))
    kw = dict(pose_key="pred_pose", score_key="pred_score")
    want = jsave(rows, str(tmp_path / "j"), "online-cli_t", "synth", **kw)
    got = save_results_bop(rows, str(tmp_path / "t"), "online-cli_t", "synth", **kw)
    assert os.path.basename(got) == os.path.basename(want) == "online-cli-t_synth-test.csv"
    with open(got, "rb") as f, open(want, "rb") as g:
        assert f.read() == g.read()
    back, jback = read_results_bop(got), jread(want)
    assert len(back) == len(rows)
    for b, j, r in zip(back, jback, rows):
        assert {k: b[k] for k in ("obj_id", "scene_id", "im_id", "score", "time")} == \
            {k: j[k] for k in ("obj_id", "scene_id", "im_id", "score", "time")}
        np.testing.assert_array_equal(b["pose"], j["pose"])
        assert b["score"] == r["pred_score"]
        np.testing.assert_allclose(b["pose"][:3, :3], r["pred_pose"][:3, :3], rtol=0, atol=1e-12)
        np.testing.assert_allclose(b["pose"][:3, 3], r["pred_pose"][:3, 3] * 1000, rtol=0, atol=1e-9)


def _det_rows(rng, n_img=10, n_obj=3):
    """Loop-style rows: a top box jittered around the GT box (some misses,
    some duplicates) with a score; GT boxes per (obj, scene, im)."""
    rows, gt = [], {}
    for im in range(n_img):
        for obj in range(1, n_obj + 1):
            if rng.uniform() < 0.85:
                x1, y1 = rng.uniform(0, 100, 2)
                box = np.array([x1, y1, x1 + rng.uniform(10, 60), y1 + rng.uniform(10, 60)])
                gt[(obj, 0, im)] = tuple(box)
            else:
                box = rng.uniform(0, 100, 4)
                box[2:] += box[:2]
            pred = box + rng.normal(0, rng.choice([1.0, 8.0, 25.0]), 4)
            rows.append({"obj_id": obj, "scene_id": 0, "im_id": im,
                         "dtoid_bbox": np.stack([pred, pred + 3]) if rng.uniform() < 0.9 else np.zeros((0, 4)),
                         "dtoid_score": np.array([rng.uniform(), 0.1])})
    return rows, gt


@pytest.mark.parametrize("what", ["all_point", "11_point", "eval_detection_results"])
def test_detection_map_matches_jax(what):
    """box_iou, both AP methods and the loop rows' evaluation give JAX's
    numbers on seeded random boxes."""
    import ossid_code_tpu.eval.detection_map as J

    import ossid_code_torch.eval.detection_map as T

    rng = np.random.default_rng({"all_point": 0, "11_point": 1, "eval_detection_results": 2}[what])
    rows, gt = _det_rows(rng)
    if what == "eval_detection_results":
        got, want = T.eval_detection_results(rows, gt), J.eval_detection_results(rows, gt)
    else:
        dets = [((r["scene_id"], r["im_id"]), r["obj_id"], float(r["dtoid_score"][0]), r["dtoid_bbox"][0])
                for r in rows if len(r["dtoid_bbox"])]
        gts = [((s, i), o, np.asarray(b)) for (o, s, i), b in gt.items()]
        got, want = T.voc_map(dets, gts, method=what), J.voc_map(dets, gts, method=what)
        a, b = rng.uniform(0, 50, (7, 4)), rng.uniform(0, 50, (5, 4))
        np.testing.assert_array_equal(T.box_iou(a, b), J.box_iou(a, b))
    assert got == want and 0 < got[1] < 1


# -------------------------------------------------------- flags and choices

def test_parser_matches_jax():
    from ossid_code_tpu.scripts.online_learning import build_parser as jparser

    from ossid_code_torch.scripts.online_learning import build_parser

    got = {a.dest: (a.default, a.type, a.choices, type(a).__name__) for a in build_parser()._actions}
    want = {a.dest: (a.default, a.type, a.choices, type(a).__name__) for a in jparser()._actions}
    assert got.pop("device") == (None, str, None, "_StoreAction")
    assert got == want
    assert vars(build_parser().parse_args([]))["rank_blend"] is None


def _flag_cases():
    return {
        "ycbv": ["--dataset_name", "ycbv"],
        "ycbv_seen": ["--dataset_name", "ycbv", "--test_seen", "--use_offline_model", "--finetune_interval", "32"],
        "ycbv_explicit": ["--dataset_name", "ycbv", "--zephyr_ckpt_path_odd", "ODD", "--use_pretrained_dtoid"],
        "lmo": ["--dataset_name", "lmo", "--use_pretrained_dtoid", "--n_local_test", "40"],
        "lmo_offline": ["--dataset_name", "lmo", "--use_offline_model", "--zephyr_ckpt_path", "SCORER",
                        "--finetune_interval", "1000000"],
        "synth": ["--dataset_name", "synth", "--dtoid_weights_path", "W", "--finetune_interval", "2"],
    }


@pytest.mark.parametrize("case", sorted(_flag_cases()))
@pytest.mark.parametrize("files", [False, True])
def test_config_and_checkpoint_choice_match_jax(case, files, tmp_path, monkeypatch):
    """build_config, select_dtoid_weights and select_zephyr_ckpts give JAX's
    answers for each flag combination, with the checkpoint files absent and
    present."""
    import ossid_code_tpu.scripts.online_learning as J

    import ossid_code_torch.scripts.online_learning as T

    roots = _point_roots(monkeypatch, str(tmp_path))
    os.makedirs(os.path.join(roots["BOP_DATASETS_ROOT"], "synth"))
    with open(os.path.join(roots["BOP_DATASETS_ROOT"], "synth", "camera.json"), "w") as f:
        f.write('{"height": 128, "width": 160, "fx": 100.0}')
    argv = [a.replace("ODD", str(tmp_path / "odd.ckpt")).replace("SCORER", str(tmp_path / "s.ckpt"))
            for a in _flag_cases()[case]]
    if files:
        os.makedirs(roots["OSSID_CKPT_ROOT"])
        for name in ("final_ycbv.ckpt", "final_ycbv_valodd.ckpt", "final_lmo.ckpt", "dtoid_pretrained.ckpt",
                     "dtoid_pretrained_original.pth.tar", "dtoid_transductive_lmo.ckpt",
                     "dtoid_transductive_ycbv.ckpt"):
            open(os.path.join(roots["OSSID_CKPT_ROOT"], name), "w").close()
        open(tmp_path / "odd.ckpt", "w").close()
    jargs, targs = J.build_parser().parse_args(argv), T.build_parser().parse_args(argv)
    jcfg, tcfg = J.build_config(jargs), T.build_config(targs)
    assert tcfg.dataset == jcfg.dataset
    for k in ("img_h", "img_w", "heatmap_h", "heatmap_w"):
        assert tcfg.model[k] == jcfg.model[k], k
    assert T.select_dtoid_weights(targs) == J.select_dtoid_weights(jargs)
    assert T.select_zephyr_ckpts(targs) == J.select_zephyr_ckpts(jargs)


def test_unported_flags_raise():
    from ossid_code_torch.scripts.online_learning import build_parser, main

    for flag, item in (("--use_maskrcnn", "item 8"), ("--yuv_transfer", "item 6")):
        with pytest.raises(NotImplementedError, match=f"ROADMAP.md §1, {item}"):
            main(build_parser().parse_args([flag, "--device", "cpu"]))


# ------------------------------------------------- loop: shifts and scorers

@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The JAX package's synthetic world with the CLI's layout under one BOP
    root: synth/ (2 objects x N_FRAMES frames), grid/, the precomputed
    scorer results, a model-shift JSON."""
    from ossid_code_tpu.data.bop import BopDataset, BopDatasetArgs
    from ossid_code_tpu.data.synthetic import (
        default_objects, make_synthetic_bop, make_template_grid, make_zephyr_results_pkl,
    )

    root = str(tmp_path_factory.mktemp("cliworld"))
    make_synthetic_bop(root, n_frames=N_FRAMES, img_h=H, img_w=W)
    make_template_grid(os.path.join(root, "grid"), default_objects(), n_views=8)
    bop = BopDataset(BopDatasetArgs(bop_root=root, dataset_name="synth"))
    make_zephyr_results_pkl(os.path.join(root, "synth_zephyr_results.pkl"), bop, score=50.0)
    with open(os.path.join(root, "shifts.json"), "w") as f:
        f.write('{"1": [0.004, -0.01, 0.02], "2": [-0.03, 0.0, 0.005]}')
    return root


class _Scorer:
    """Stands in for a scorer: records what it is prepared with."""

    def __init__(self):
        self.prepared = {}

    def prepare_object(self, oid, pts, cols, nrms):
        self.prepared[oid] = pts


def _loops(world, **kw):
    from ossid_code_tpu.data.bop import BopDataset as JBop, BopDatasetArgs as JArgs
    from ossid_code_tpu.loop.online_learning import OnlineLearningLoop as JLoop

    from ossid_code_torch.data.bop import BopDataset, BopDatasetArgs
    from ossid_code_torch.loop.online_learning import OnlineLearningLoop

    args = argparse.Namespace(finetune_interval=2)
    dtoid = SimpleNamespace(state_dict=dict)
    j = JLoop(args, None, dtoid, JBop(JArgs(bop_root=world, dataset_name="synth")), None, None, {}, **kw["j"])
    t = OnlineLearningLoop(args, None, dtoid, BopDataset(BopDatasetArgs(bop_root=world, dataset_name="synth")),
                           None, None, {}, **kw["t"])
    return j, t


def test_model_shifts_match_jax(world):
    """With --model_shift_path both loops shift the scorer's model clouds
    before the diameters, and prepare the shifted clouds."""
    from ossid_code_tpu.utils.geometry import load_model_shifts as jload

    from ossid_code_torch.utils.geometry import load_model_shifts

    path = os.path.join(world, "shifts.json")
    shifts, jshifts = load_model_shifts(path), jload(path)
    assert shifts.keys() == jshifts.keys() and all(np.array_equal(shifts[k], jshifts[k]) for k in shifts)
    zj, zt = _Scorer(), _Scorer()
    j, t = _loops(world, j=dict(zephyr_model=zj, model_shifts=jshifts), t=dict(zephyr_model=zt, model_shifts=shifts))
    _, t0 = _loops(world, j=dict(), t=dict())
    for oid in (1, 2):
        for a, b in zip(t.model_clouds[oid], j.model_clouds[oid]):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_allclose(t.model_clouds[oid][0] - t0.model_clouds[oid][0],
                                   np.broadcast_to(shifts[oid], t0.model_clouds[oid][0].shape), atol=1e-6)
        assert t.diameters[oid] == j.diameters[oid]
        np.testing.assert_array_equal(zt.prepared[oid], zj.prepared[oid])


@pytest.mark.parametrize("what", ["mask_visib", "mask", "meta"])
def test_bop_frame_lookups_match_jax(world, what):
    """getMaskByIds (visible and full, with the box mask_to_bbox makes of it
    for the CLI's mAP) and getMetaDataByIds give JAX's on every target."""
    from ossid_code_tpu.data.bop import BopDataset as JBop, BopDatasetArgs as JArgs
    from ossid_code_tpu.utils.geometry import mask_to_bbox as jbox

    from ossid_code_torch.data.bop import BopDataset, BopDatasetArgs
    from ossid_code_torch.utils.geometry import mask_to_bbox

    j = JBop(JArgs(bop_root=world, dataset_name="synth"))
    t = BopDataset(BopDatasetArgs(bop_root=world, dataset_name="synth"))
    assert t.targets == j.targets and len(t.targets) == 2 * N_FRAMES
    for tg in t.targets:
        ids = (tg["obj_id"], tg["scene_id"], tg["im_id"])
        if what == "meta":
            assert t.getMetaDataByIds(*ids) == j.getMetaDataByIds(*ids)
            continue
        got, want = (np.asarray(d.getMaskByIds(*ids, visib=what == "mask_visib")) for d in (t, j))
        np.testing.assert_array_equal(got, want)
        assert mask_to_bbox(got > 0) == jbox(want > 0) is not None


@pytest.mark.parametrize("pair", ["both", "even_only", "odd_only", "single"])
def test_two_scorer_routing_matches_jax(world, pair):
    """Each object is scored by the scorer JAX's _zephyr_for picks (the even
    one for even ids, the odd one for odd ids, the single scorer where the
    parity's is missing; tests/test_online_loop.py:314), and every distinct
    scorer is prepared for every object."""
    scorers = {name: (_Scorer(), _Scorer()) for name in ("single", "even", "odd")}
    use = {"both": ("even", "odd"), "even_only": ("even",), "odd_only": ("odd",), "single": ()}[pair]
    kw = [dict(zephyr_model=scorers["single"][i],
               **{f"zephyr_model_{p}": scorers[p][i] for p in use}) for i in (0, 1)]
    j, t = _loops(world, j=kw[0], t=kw[1])
    names = {id(s[i]): n for n, s in scorers.items() for i in (0, 1)}
    for oid in range(1, 7):
        assert names[id(t._zephyr_for(oid))] == names[id(j._zephyr_for(oid))], oid
    for n in ("single", *use):
        assert sorted(scorers[n][1].prepared) == sorted(scorers[n][0].prepared) == [1, 2]


# -------------------------------------------------------------- checkpoints

def test_legacy_pth_tar_loads_in_both(tmp_path):
    """A legacy (non-zip) torch file, as the original author's
    dtoid_pretrained_original.pth.tar, loads in both packages to the same
    weights; the port also takes it under another suffix."""
    from ossid_code_tpu.core.checkpoint import load_checkpoint as jload

    from ossid_code_torch.core.checkpoint import load_checkpoint
    from ossid_code_torch.core.config import default_config
    from ossid_code_torch.models.dtoid.jax_import import dtoid_from_jax
    from ossid_code_torch.models.dtoid.module import DtoidModel

    sd = {k: v.clone() for k, v in DtoidModel(default_config(), seed=3, device="cpu").state_dict().items()}
    for name in ("dtoid_pretrained_original.pth.tar", "legacy.ckpt"):
        path = str(tmp_path / name)
        torch.save({"state_dict": sd, "epoch": 7}, path, _use_new_zipfile_serialization=False)
        got = load_checkpoint(path)
        assert got.keys() == sd.keys() and all(torch.equal(got[k], sd[k]) for k in sd)
    tree = jload(str(tmp_path / "dtoid_pretrained_original.pth.tar"))
    back = dtoid_from_jax(tree["params"], tree["batch_stats"])
    assert all(torch.equal(back[k].to(sd[k].dtype), sd[k]) for k in sd if "num_batches_tracked" not in k)


# --------------------------------------------------------- the whole CLI

@pytest.fixture(scope="module")
def weights(world, tmp_path_factory):
    """DTOID weights as a JAX pickle (heads perturbed so boxes rank
    clearly), the scorer as a torch file from JAX's save_checkpoint, and the
    --conf_path YAML."""
    import jax

    from ossid_code_tpu.core.checkpoint import save_checkpoint
    from ossid_code_tpu.core.config import Config, default_config
    from ossid_code_tpu.models.dtoid.module import DtoidModel
    from ossid_code_tpu.models.zephyr.module import ZephyrModel

    d = tmp_path_factory.mktemp("weights")
    conf = str(d / "conf.yaml")
    Config(model={"densenet_blocks": [2, 2, 2]}).save(conf)
    cfg = default_config().merged(Config.load(conf).to_dict())
    cfg.model.img_h, cfg.model.img_w = H, W
    model = DtoidModel(cfg, seed=0)
    state = jax.tree_util.tree_map(lambda a: np.array(a, np.float32), jax.device_get(model.state_dict()))
    rng = np.random.default_rng(11)
    for head, std in (("classification", 0.05), ("regression", 0.01)):
        node = state["params"][head]["output"]
        node["kernel"] = rng.normal(0, std, node["kernel"].shape).astype(np.float32)
    save_checkpoint(str(d / "dtoid.ckpt"), state)
    zm = ZephyrModel(num_points=512, seed=4)
    save_checkpoint(str(d / "scorer.ckpt"), {"params": zm.params, "batch_stats": zm.batch_stats},
                    torch_format=True)
    return {"conf": conf, "dtoid": str(d / "dtoid.ckpt"), "scorer": str(d / "scorer.ckpt")}


def _argv(weights, *extra):
    return ["--dataset_name", "synth", "--exp_name", "cli", "--conf_path", weights["conf"],
            "--hypo_backend", "fake", "--n_fake_hypos", "8", "--finetune_interval", "2",
            "--finetune_batch_size", "2", "--n_local_test", "4", "--always_dtoid_mask", "--use_oracle_gt",
            "--dtoid_weights_path", weights["dtoid"], "--zephyr_ckpt_path", weights["scorer"], *extra]


def _run_both(world, weights, tmp_path, monkeypatch, capsys, *extra):
    """(JAX's pickle, its summary lines, its results dir), then the port's."""
    import ossid_code_tpu.scripts.online_learning as J

    import ossid_code_torch.scripts.online_learning as T

    monkeypatch.setenv("OSSID_SPEC_FETCH", "inline")
    out = []
    for tag, mod, dev in (("jax", J, []), ("port", T, ["--device", "cpu"])):
        roots = _point_roots(monkeypatch, str(tmp_path), bop_root=world, tag=tag)
        capsys.readouterr()
        mod.main(mod.build_parser().parse_args(_argv(weights, *extra, *dev)))
        printed = capsys.readouterr().out.splitlines()
        out.append((roots, [ln for ln in printed if ln.startswith(SUMMARY)]))
    return out


def test_cli_matches_jax(world, weights, tmp_path, monkeypatch, capsys):
    from ossid_code_torch.eval.bop_csv import read_results_bop

    (jroots, jsum), (troots, tsum) = _run_both(world, weights, tmp_path, monkeypatch, capsys)
    assert tsum == jsum and len(tsum) == len(SUMMARY), (tsum, jsum)
    picked = []
    for roots in (jroots, troots):
        with open(os.path.join(roots["OSSID_RESULT_ROOT"], "results_cli.pkl"), "rb") as f:
            picked.append(pickle.load(f))
    want, got = picked
    assert set(got) == set(want) == {"test_results", "main_args", "finetune_logs", "final_state_dict"}
    assert {k: v for k, v in got["main_args"].items() if k != "device"} == want["main_args"]
    assert len(got["finetune_logs"]) == len(want["finetune_logs"]) == 2
    rows, jrows = got["test_results"], want["test_results"]
    assert len(rows) == len(jrows) == 2 * N_FRAMES
    for key in ("obj_id", "scene_id", "im_id", "dtoid_confident", "zephyr_confident", "use_dtoid_mask",
                "finetune", "n_hypos"):
        assert [r[key] for r in rows] == [r[key] for r in jrows], key
    for g, w in zip(rows, jrows):
        np.testing.assert_allclose(g["hypo_scores"], w["hypo_scores"], rtol=2e-3, atol=5e-4)
        assert np.argmax(g["hypo_scores"]) == np.argmax(w["hypo_scores"])
        np.testing.assert_allclose(g["pred_pose"], w["pred_pose"], rtol=0, atol=1e-4)
        np.testing.assert_allclose(g["pred_score"], w["pred_score"], rtol=2e-3, atol=5e-4)
        np.testing.assert_allclose(g["dtoid_bbox"][0], w["dtoid_bbox"][0], rtol=0, atol=2e-2)
    csvs = [read_results_bop(os.path.join(r["BOP_RESULTS_FOLDER"], "online-cli_synth-test.csv"))
            for r in (jroots, troots)]
    assert len(csvs[0]) == len(csvs[1]) == len(rows)
    for g, w, r in zip(csvs[1], csvs[0], rows):
        assert (g["obj_id"], g["scene_id"], g["im_id"]) == (w["obj_id"], w["scene_id"], w["im_id"])
        assert g["score"] == r["pred_score"]
        np.testing.assert_allclose(g["score"], w["score"], rtol=2e-3, atol=5e-4)
        np.testing.assert_allclose(g["pose"][:3, :3], w["pose"][:3, :3], rtol=0, atol=1e-4)
        np.testing.assert_allclose(g["pose"][:3, 3], w["pose"][:3, 3], rtol=0, atol=0.1)  # mm


def test_cli_raw_dtoid_matches_jax(world, weights, tmp_path, monkeypatch, capsys):
    (jroots, jsum), (troots, tsum) = _run_both(world, weights, tmp_path, monkeypatch, capsys, "--raw_dtoid")
    assert tsum == jsum and len(tsum) == 2, (tsum, jsum)
    picked = []
    for roots in (jroots, troots):
        with open(os.path.join(roots["OSSID_RESULT_ROOT"], "before_finetune_dtoid_results_cli.pkl"), "rb") as f:
            picked.append(pickle.load(f)["test_results"])
    want, got = picked
    assert [(r["obj_id"], r["im_id"]) for r in got] == [(r["obj_id"], r["im_id"]) for r in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["dtoid_bbox"][0], w["dtoid_bbox"][0], rtol=0, atol=2e-2)
        np.testing.assert_allclose(g["dtoid_score"][:1], w["dtoid_score"][:1], atol=1e-4)
        assert g["dtoid_iou"] == w["dtoid_iou"]
        np.testing.assert_array_equal(g["gt_bbox"], w["gt_bbox"])
