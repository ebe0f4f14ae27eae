"""The port's pipelined online loop (speculative detection, bundled fetches,
deferred completion, the IO thread) and its YUV 4:2:0 frame transport, on
the CPU.

The world is tests/test_torch_loop.py's: 4 frames of 128x160 with 2 objects
(8 targets), DenseNet (2, 2, 2), a 128-point scorer with device ICP of the
top 4 of 16 fake hypotheses, always the detection region, oracle labels,
a finetune every 4 buffered targets at batch 2, so 2 finetunes, and
speculative detections that a finetune makes stale.

(a) The pipelined loop's rows equal the synchronous loop's (pipeline_scoring
    False) under tests/test_online_loop.py's criterion (time_* skipped,
    arrays to rtol 1e-5 / atol 1e-6, the rest exact), for the environment
    knobs of the JAX loop (every value of each taken over the two flag
    sets); each run sees deferred and inline completions. Here without the
    YUV transport; with it and a 96-px depth crop in
    tests/test_torch_pipeline_yuv.py.
(b) The port's pipelined loop against the JAX package's pipelined loop:
    tests/test_torch_pipeline_jax.py.
(c) The transport: the I420 pack bit for bit equal to JAX's and to
    cv2.cvtColor, the unpack within 1 of JAX's on every pixel.
Beside them: HostCopy and RunStats. Each loop run takes about 20 s here
(the plain scorer), so the runs are split over three files.
"""

import json
import pickle

import numpy as np
import pytest
import torch

from test_torch_loop import N_FRAMES, _configure, jax_native_libraries, make_args, world  # noqa: F401

torch.set_num_threads(2)

FLAGS = {"plain": {}, "yuv": {"yuv_transfer": True, "zephyr_depth_crop": 96}}
# the knobs of each pipelined run: every value of each knob is taken
# (OSSID_MERGED_FETCH and OSSID_FETCH_BUNDLE act in thread mode only)
KNOBS = {
    "default": {},
    "inline_noshare": {"OSSID_SPEC_FETCH": "inline", "OSSID_FRAME_SHARE": "0"},
    "thread_bundle1_unmerged_noshare": {"OSSID_SPEC_FETCH": "thread", "OSSID_FETCH_BUNDLE": "1",
                                        "OSSID_MERGED_FETCH": "0", "OSSID_FRAME_SHARE": "0"},
    # completion tuples fetched in the completion itself, one deferred at most
    "noprefetch_depth1": {"OSSID_COMPLETE_PREFETCH": "0", "OSSID_PIPELINE_DEPTH": "1"},
}
KNOBS_BY_FLAGS = {"plain": ("default", "inline_noshare", "noprefetch_depth1"), "yuv": ("default", "thread_bundle1_unmerged_noshare")}
ENV = ("OSSID_SPEC_FETCH", "OSSID_FETCH_BUNDLE", "OSSID_MERGED_FETCH", "OSSID_FRAME_SHARE",
       "OSSID_PIPELINE_DEPTH", "OSSID_COMPLETE_PREFETCH")


def _assert_rows_equal(r_on, r_off):
    """tests/test_online_loop.py:193-211."""
    assert len(r_on) == len(r_off)
    for a, b in zip(r_on, r_off):
        assert set(a) == set(b)
        for k in a:
            if k.startswith("time_"):
                continue
            va, vb = a[k], b[k]
            if va is None or vb is None:
                assert va is vb, k
            elif isinstance(va, np.ndarray) or hasattr(va, "shape"):
                np.testing.assert_allclose(np.asarray(va, np.float64), np.asarray(vb, np.float64),
                                           rtol=1e-5, atol=1e-6, err_msg=k)
            elif isinstance(va, float):
                assert (va == vb) or abs(va - vb) < 1e-6, (k, va, vb)
            else:
                assert va == vb, (k, va, vb)


@pytest.fixture(scope="module")
def port_weights(world):
    """The port's DTOID and scorer weights from seeds (no JAX needed)."""
    from ossid_code_torch.core.config import default_config
    from ossid_code_torch.models.dtoid.module import DtoidModel
    from ossid_code_torch.models.zephyr.module import ZephyrModel

    cfg = _configure(default_config(), world)
    return (DtoidModel(cfg, seed=0, device="cpu").state_dict(),
            ZephyrModel(num_points=128, seed=0, device="cpu").state_dict())


def _run(root, args, weights, pipeline_scoring):
    """The port's loop from `weights`, recording the order of detections and
    completions: returns (rows, loop, [(i, completed after k detections)])."""
    from ossid_code_torch.core.config import default_config
    from ossid_code_torch.data.bop import BopDataset, BopDatasetArgs
    from ossid_code_torch.data.dtoid_bop import get_dataloaders
    from ossid_code_torch.hypo.fake import FakeHypoGen
    from ossid_code_torch.loop.online_learning import OnlineLearningLoop
    from ossid_code_torch.models.dtoid.module import DtoidModel
    from ossid_code_torch.models.zephyr.module import ZephyrModel

    cfg = _configure(default_config(), root)
    with open(cfg.dataset.zephyr_result_path, "rb") as f:
        zr_list = pickle.load(f)
    bop = BopDataset(BopDatasetArgs(bop_root=root, dataset_name="synth"))
    train_loader, _, test_loader = get_dataloaders(cfg, zr_list)
    test_loader.dataset.sortTargets()
    train_ds = train_loader.dataset
    train_ds.clearTargets()
    zr = {(r["obj_id"], r["scene_id"], r["im_id"]): dict(r) for r in zr_list}
    train_ds.zephyr_results = dict(zr)
    model = DtoidModel(cfg, seed=0, device="cpu")
    model.load_state_dict(weights[0])
    model.reset_optimizer()
    zmodel = ZephyrModel(num_points=128, inconst_ratio_th=100.0, seed=0, need_uv=False, refine_top=4,
                         device="cpu")
    zmodel.load_state_dict(weights[1])
    gens = {oid: FakeHypoGen(n_hypos=16, seed=oid) for oid in bop.obj_ids}
    loop = OnlineLearningLoop(args, cfg, model, bop, train_ds, test_loader, zr, zephyr_model=zmodel,
                              hypo_gens=gens, pipeline_scoring=pipeline_scoring)
    order, n_det = [], [0]
    detect, complete, dispatch = loop._detect, loop._complete_frame, model.detect_async

    def spy_detect(*a):
        n_det[0] += 1
        return detect(*a)

    def spy_complete(ctx, *a):
        order.append((ctx["iteration"], n_det[0]))
        return complete(ctx, *a)

    def spy_dispatch(*a, **k):
        loop.n_dispatched += 1
        return dispatch(*a, **k)

    loop._detect, loop._complete_frame, model.detect_async = spy_detect, spy_complete, spy_dispatch
    loop.n_dispatched = 0
    return loop.run(progress=False), loop, order


_SYNC: dict = {}


def check_pipelined_against_sync(world, port_weights, monkeypatch, flags, knobs):
    """The pipelined loop gives the synchronous loop's rows, finetune
    schedule and finetune losses; it deferred some completions and ran
    others at once (the frames that may finetune), and its speculation hit
    and went stale."""
    from ossid_code_torch.utils.rpc_stats import STATS

    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    args = make_args(**FLAGS[flags])
    if flags not in _SYNC:
        _SYNC[flags] = _run(world, args, port_weights, pipeline_scoring=False)
    want, want_loop, want_order = _SYNC[flags]
    assert all(k == i + 1 for i, k in want_order)
    for k, v in KNOBS[knobs].items():
        monkeypatch.setenv(k, v)
    STATS.reset()
    got, loop, order = _run(world, args, port_weights, pipeline_scoring=True)
    assert sum(r["finetune"] for r in got) == 2
    _assert_rows_equal(got, want)
    assert loop.finetune_logs == want_loop.finetune_logs
    deferred = sum(k > i + 1 for i, k in order)
    assert deferred >= 2 and len(order) - deferred >= 2, order
    assert sorted(i for i, _ in order) == list(range(2 * N_FRAMES))
    assert want_loop.n_dispatched == 2 * N_FRAMES
    c = STATS.snapshot()["counts"]
    assert c.get("spec_hit", 0) >= 2 and c.get("spec_stale", 0) + c.get("spec_redispatch", 0) >= 1, c
    assert sum(c.get(k, 0) for k in ("spec_hit", "spec_stale", "spec_absent")) == 2 * N_FRAMES
    # a finetune makes stale at most the two detections dispatched ahead of it
    assert c.get("spec_stale", 0) + c.get("spec_redispatch", 0) <= 2 * 2, c
    # a detection a target, and one more for each that a finetune made stale
    assert loop.n_dispatched == 2 * N_FRAMES + c.get("spec_stale", 0) + c.get("spec_redispatch", 0), c


@pytest.mark.parametrize("knobs", KNOBS_BY_FLAGS["plain"])
def test_pipelined_rows_equal_synchronous(world, port_weights, monkeypatch, knobs):
    """(a) without the YUV transport (tests/test_torch_pipeline_yuv.py runs
    it with)."""
    check_pipelined_against_sync(world, port_weights, monkeypatch, "plain", knobs)


# ------------------------------------------------------------ the transport

SIZES = [(480, 640), (128, 160), (6, 10), (2, 2)]


@pytest.mark.parametrize("hw", SIZES)
def test_pack_i420_matches_jax_and_cv2(hw):
    """Bit for bit cv2's I420 and the JAX package's pack_i420 (which takes
    cv2 where it is installed); the JAX package's numpy fallback, in 16-bit
    fixed point, is off by one on a few pixels (JAX's own test allows 1 on
    y and 2 on chroma), never more. Every colour of the 24-bit cube packs
    as cv2 packs it."""
    import cv2
    from ossid_code_tpu.ops import yuv as J

    from ossid_code_torch.ops.yuv import pack_i420, pack_yuv420

    img = np.random.default_rng(hw[0]).integers(0, 256, (*hw, 3), np.uint8)
    got = pack_i420(img)
    want = cv2.cvtColor(img, cv2.COLOR_RGB2YUV_I420)
    assert got.dtype == np.uint8 and got.shape == (3 * hw[0] // 2, hw[1])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, J.pack_i420(img))
    y, u, v = pack_yuv420(img)
    assert y.nbytes + u.nbytes + v.nbytes == img.nbytes // 2 == got.nbytes
    if hw[0] % 4 == 0:  # JAX's fallback stacks the chroma planes by rows
        real = J.cv2
        try:
            J.cv2 = None
            fallback = J.pack_i420(img)
        finally:
            J.cv2 = real
        assert np.abs(got.astype(int) - fallback.astype(int)).max() <= 1
    if hw == SIZES[0]:
        cube = np.stack(np.meshgrid(*[np.arange(256)] * 3, indexing="ij"), -1).reshape(4096, 4096, 3)
        cube = cube.astype(np.uint8)
        np.testing.assert_array_equal(pack_i420(cube), cv2.cvtColor(cube, cv2.COLOR_RGB2YUV_I420))


@pytest.mark.parametrize("hw", [(480, 640), (128, 160), (8, 10)])
def test_unpack_matches_jax(hw):
    """The CPU unpack is within 1 of JAX's _unpack_i420 on every pixel, and
    exact on all but a share of values under 1e-3 (float32 products that
    round either way at .5, in another order than XLA's): at 480x640, 71 of
    921,600 values differ (0.99992 exact), at 128x160 3, at 8x10 none. The
    upload through the I420 buffer has a direct upload's shape and dtype."""
    from ossid_code_tpu.ops.yuv import _unpack_i420

    from ossid_code_torch.ops.yuv import pack_i420, ship_rgb_yuv420, unpack_i420

    img = np.random.default_rng(hw[1]).integers(0, 256, (*hw, 3), np.uint8)
    buf = pack_i420(img)
    got = unpack_i420(torch.from_numpy(buf)).numpy()
    want = np.asarray(_unpack_i420(buf))
    assert got.shape == want.shape == img.shape and got.dtype == np.uint8
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1
    assert (diff > 0).mean() < 1e-3, (diff > 0).mean()
    shipped = ship_rgb_yuv420(img, "cpu")
    assert shipped.dtype == torch.uint8 and shipped.device.type == "cpu"
    np.testing.assert_array_equal(shipped.numpy(), got)


@pytest.mark.parametrize("hw", [(5, 6), (6, 5), (7, 7)])
def test_odd_sizes_refused(hw):
    """An odd height or width is refused, as the JAX package refuses it."""
    from ossid_code_tpu.ops import yuv as J

    from ossid_code_torch.ops.yuv import pack_i420, unpack_i420

    img = np.zeros((*hw, 3), np.uint8)
    with pytest.raises(Exception):
        J.pack_i420(img)
    with pytest.raises(ValueError, match="even"):
        pack_i420(img)
    with pytest.raises(ValueError):
        unpack_i420(torch.zeros((hw[0] * 3 // 2, hw[1]), dtype=torch.uint8))


# ------------------------------------------------------ weights and fetches

def test_host_copy_tree_on_the_cpu():
    """HostCopy keeps the tree's structure, gives numpy leaves, passes None
    and numpy through and waits on nested copies."""
    from ossid_code_torch.utils.host_copy import HostCopy, to_device

    a = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    inner = HostCopy({"x": a})
    out = HostCopy((inner, [a, None], {"n": np.ones(2)})).wait()
    assert isinstance(out, tuple) and isinstance(out[1], list)
    np.testing.assert_array_equal(out[0]["x"], a.numpy())
    np.testing.assert_array_equal(out[1][0], a.numpy())
    assert out[1][1] is None and out[2]["n"].sum() == 2
    t = to_device(np.ones((2, 2), np.uint16)[:, :1], "cpu")
    assert t.shape == (2, 1) and t.is_contiguous()


def test_rpc_stats_matches_jax():
    """RunStats: the same summary, fetches per frame and hit rate as the
    JAX package's on the same records (kinds ending in _wait are not
    fetches)."""
    from ossid_code_tpu.utils.rpc_stats import RunStats as J

    from ossid_code_torch.utils.rpc_stats import RunStats

    stats = [RunStats(), J()]
    for s in stats:
        for kind in ("spec_hit", "spec_hit", "spec_stale", "spec_absent"):
            s.count(kind)
        for kind, sec in (("det_fetch", 0.01), ("det+complete", 0.02), ("spec_wait", 0.5),
                          ("complete", 0.004), ("complete_wait", 0.25)):
            s.rpc(kind, sec)
    got, want = stats
    assert got.snapshot() == want.snapshot()
    assert got.summary(4) == want.summary(4)
    assert got.fetch_rpcs_per_frame(4) == want.fetch_rpcs_per_frame(4) == 0.75
    assert got.spec_hit_rate() == want.spec_hit_rate() == 0.5
    got.reset()
    assert got.summary() == "(no rpc stats)" and got.spec_hit_rate() is None



def test_turns_report_runs_whose_hypothesis_counts_differ():
    """chip_smoke.py's report of runs in turns: a target scored with another
    number of hypotheses in one run (or not scored at all) is counted and
    its scores left out of the spread, and the schedule's differences are
    counted by key, where the schedule check alone would fail."""
    import chip_smoke

    def row(n, shift=0.0):
        return {"obj_id": 1, "scene_id": 0, "im_id": 0, "dtoid_confident": True, "zephyr_confident": True,
                "use_dtoid_mask": True, "finetune": False, "n_hypos": n, "pred_score": 0.5 + shift,
                "hypo_scores": None if n == 0 else np.linspace(0.0, 1.0, n) + shift, "pred_pose": np.eye(4)}

    sync = [row(132), row(8), row(0)]
    pipe = [row(119), row(8, 0.25), row(4)]
    d = chip_smoke.run_spread(pipe, sync)
    assert d == pytest.approx({"pred_score": 0.25, "hypo_scores": 0.25, "pred_pose": 0.0, "hypo_counts_differ": 2,
                               "rows_misaligned": 0})
    assert chip_smoke.run_spread(sync, sync)["hypo_counts_differ"] == 0
    runs = [{"mode": m, "rows": r, "wall_s": 1.0, "stats": {"counts": {}, "rpcs": {}}, "hit_rate": None,
             "fetches_per_frame": 2.0, "launches": {}, "steps": 0, "redispatches": 0, "peak_gib": 1.0,
             "fingerprints": {"finetunes": [], "ppf": [(1, "crop", x["n_hypos"]) for x in r]}}
            for m, r in (("sync", sync), ("pipelined", pipe), ("pipelined", pipe), ("sync", sync))]
    for r in sync + pipe:
        r.update(dtoid_bbox=np.zeros((1, 4)), dtoid_score=np.ones(1), dtoid_pred_mask=np.zeros((4, 4)))
    out = chip_smoke.turns_summary(runs)
    assert not out["schedules_equal"]
    assert out["first_divergence"][1]["index"] == 0 and out["divergent_stage"][1]["stage"] == "host PPF"
    assert out["schedule_diffs"] == [{}, {"n_hypos": 2}, {"n_hypos": 2}, {}]
    assert out["spread"]["pipelined_vs_sync"][0]["hypo_counts_differ"] == 2
    json.dumps(out)
