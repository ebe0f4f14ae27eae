"""The port's measuring tools and last helpers against the JAX package's, on
the CPU: utils/timing.py, utils/profiling.py, utils/probe.py, the log readers
of utils/logging.py (with utils/event_file.py), scripts/file_copy.py, and the
helpers in ops/icp_device.py, models/zephyr/features.py, utils/geometry.py,
utils/image.py, data/dtoid_bop.py and render/visib.py.
"""

import json
import os
import pickle
import struct
import time

import numpy as np
import pandas as pd
import pytest
import torch
from scipy.spatial.transform import Rotation

import jax
import jax.numpy as jnp

from ossid_code_torch.utils import logging as tlog
from ossid_code_torch.utils import probe as tprobe
from ossid_code_torch.utils import profiling, timing

torch.set_num_threads(2)


# ------------------------------------------------------------------ timing
def _drive(mod):
    """One sequence of timed blocks through a package's Timer and
    StageTimes: (agg_list, explicitly exited stage times, `with` stage
    times)."""
    agg = []
    for heading in ("a", "b", "a"):
        with mod.Timer(heading=heading, agg_list=agg):
            time.sleep(0.001)
    explicit = mod.StageTimes()
    for name in ("x", "y", "x"):
        t = explicit.timer(name)
        t.__enter__()
        time.sleep(0.001)
        t.__exit__(None, None, None)
    with_stages = mod.StageTimes()
    for name in ("x", "y", "x"):
        with with_stages.timer(name):
            time.sleep(0.001)
    return agg, explicit, with_stages


def test_timer_and_stage_times_match_jax(capsys):
    from ossid_code_tpu.utils import timing as jtiming

    jagg, jexp, jwith = _drive(jtiming)
    tagg, texp, twith = _drive(timing)
    assert [h for h, _ in tagg] == [h for h, _ in jagg] == ["a", "b", "a"]
    assert all(isinstance(s, float) and s > 0 for _, s in tagg)
    # re-entry sums: x twice, y once, in both packages
    assert list(texp.times) == list(jexp.times) == ["x", "y"]
    assert texp.get("x") > texp.get("y") > 0 and texp.get("z", 7) == jexp.get("z", 7) == 7
    # a `with` block: JAX's instance-level __exit__ is never called by the
    # statement (a fault of the reference); the port records the same sums
    assert jwith.times == {}
    assert list(twith.times) == ["x", "y"] and twith.get("x") > twith.get("y") > 0
    with timing.Timer(heading="v", verbose=True):
        pass
    assert capsys.readouterr().out.startswith("v ")


# --------------------------------------------------------------- profiling
def test_trace_writes_a_chrome_trace_with_the_span(tmp_path):
    x = torch.randn(64, 64)
    with profiling.trace(str(tmp_path), device="cpu") as prof:
        with profiling.annotate("probe_span"):
            (x @ x).sum()
    assert os.path.dirname(prof.trace_path) == str(tmp_path)
    with open(prof.trace_path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "probe_span" in names
    summary = profiling.device_summary(prof, ["probe_span"])
    # the CPU has no device events: nothing is read as device time
    assert summary["device_events"] == 0 and summary["device_idle_share"] is None
    assert summary["window_ms"] > 0 and summary["spans_device_ms"] == {"probe_span": 0.0}


def test_trace_on_the_card_needs_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: nothing to refuse")
    with pytest.raises(RuntimeError, match="CUDA"):
        with profiling.trace(str(tmp_path)):
            pass


def test_device_timer_on_the_cpu_says_so():
    x = torch.randn(128, 128)
    t = profiling.device_timer(torch.matmul, x, x, iters=5, warmup=1)
    assert t.seconds > 0 and t.device == "cpu" and t.clock == "host clock"


# ------------------------------------------------------------------- probe
class _Tiny(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.d1 = torch.nn.Linear(5, 4)
        self.d2 = torch.nn.Linear(4, 2)

    def forward(self, x):
        return self.d2(torch.relu(self.d1(x)))


def test_capture_activations():
    net = _Tiny()
    x = torch.ones(3, 5)
    out, acts = tprobe.capture_activations(net, x)
    assert out.shape == (3, 2) and list(acts) == ["__root__", "d1", "d2"]
    assert acts["d1"].shape == (3, 4)
    np.testing.assert_allclose(acts["d2"], out.detach().numpy(), rtol=1e-6)


def test_capture_activation_gradients_analytic():
    """loss = sum(W2 relu(a1) + b2): d loss / d a1 = relu'(a1) * column sums
    of W2 (JAX's tests/test_probe.py::test_capture_activation_gradients_analytic)."""
    torch.manual_seed(1)
    net = _Tiny()
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(3, 5)).astype(np.float32))
    loss, grads = tprobe.capture_activation_gradients(net, lambda o: o.sum(), x)
    np.testing.assert_allclose(grads["d2"], np.ones((3, 2)), rtol=1e-6)
    _, acts = tprobe.capture_activations(net, x)
    w2 = net.d2.weight.detach().numpy()  # (2, 4)
    expected = (acts["d1"] > 0).astype(np.float32) * w2.sum(0)[None, :]
    np.testing.assert_allclose(grads["d1"], expected, rtol=1e-5, atol=1e-6)
    assert np.isfinite(loss) and all(p.grad is None for p in net.parameters())


def test_module_called_twice_gets_suffixes_and_summed_gradients():
    class Twice(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.d = torch.nn.Linear(3, 3)

        def forward(self, x):
            return self.d(self.d(x))

    net = Twice()
    x = torch.randn(2, 3)
    out, acts = tprobe.capture_activations(net, x)
    assert list(acts) == ["__root__", "d_0", "d_1"]
    np.testing.assert_allclose(acts["d_1"], out.detach().numpy())
    _, grads = tprobe.capture_activation_gradients(net, lambda o: o.sum(), x)
    # d loss / d (first output) = W^T 1, plus the second call's all-ones
    w = net.d.weight.detach().numpy()
    np.testing.assert_allclose(grads["d"], np.ones((2, 3)) + w.sum(0)[None, :], rtol=1e-5, atol=1e-6)


def test_probe_densenet_stem_matches_jax():
    """The DenseNet stem (conv0) in both packages on the same weights and
    input: activations and gradients equal within 1e-4 under the name map
    flax path -> port module name, NHWC <-> NCHW."""
    from ossid_code_tpu.models.backbones.densenet import DenseNetStem
    from ossid_code_tpu.utils.probe import capture_activation_gradients, capture_activations

    from ossid_code_torch.models.backbones.densenet import stem

    rng = np.random.default_rng(0)
    x = rng.normal(size=(1, 32, 32, 3)).astype(np.float32)
    jnet = DenseNetStem()
    variables = jnet.init(jax.random.PRNGKey(0), jnp.asarray(x))
    kernel = np.asarray(variables["params"]["conv0"]["kernel"])  # (7, 7, 3, 64) HWIO
    tnet = stem()
    with torch.no_grad():
        tnet[0].weight.copy_(torch.from_numpy(kernel.transpose(3, 2, 0, 1)))
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy())

    _, jacts = capture_activations(jnet, variables, jnp.asarray(x))
    _, tacts = tprobe.capture_activations(tnet, xt)
    names = {"conv0/__call__": "0", "__call__": "__root__"}
    assert set(jacts) == set(names) and set(tacts) == set(names.values())
    for jname, tname in names.items():
        np.testing.assert_allclose(tacts[tname].transpose(0, 2, 3, 1), jacts[jname], rtol=1e-4, atol=1e-4)

    jloss, jgrads = capture_activation_gradients(jnet, variables, lambda o: (o ** 2).mean(), jnp.asarray(x))
    tloss, tgrads = tprobe.capture_activation_gradients(tnet, lambda o: (o ** 2).mean(), xt)
    assert tloss == pytest.approx(jloss, rel=1e-4)
    gnames = {"conv0": "0", "__root__": "__root__"}
    assert set(jgrads) == set(gnames) and set(tgrads) == set(gnames.values())
    for jname, tname in gnames.items():
        g = jgrads[jname]
        np.testing.assert_allclose(tgrads[tname].transpose(0, 2, 3, 1), g, rtol=1e-4, atol=1e-4 * np.abs(g).max())


# ------------------------------------------------------------- log readers
def assert_columns_match(cols: dict, df: pd.DataFrame) -> None:
    """The port's columns equal a JAX DataFrame's: the same names in the same
    order, numbers within 1e-12 (NaN where pandas has NaN), the rest equal."""
    assert list(cols) == list(df.columns)
    for k in df.columns:
        want = df[k].to_numpy()
        got = cols[k]
        assert len(got) == len(want), k
        if want.dtype.kind in "biuf" and got.dtype.kind in "biuf":
            np.testing.assert_allclose(got.astype(np.float64), want.astype(np.float64), rtol=1e-12, equal_nan=True,
                                       err_msg=k)
        else:
            assert [None if (isinstance(v, float) and np.isnan(v)) else v for v in want] == list(got), k


def test_tflog2pandas_matches_jax_on_a_metric_logger_run(tmp_path):
    """A MetricLogger run (JAX's, with tensorboard's writer) read by both
    packages' tflog2pandas: the same columns, rows and order."""
    from ossid_code_tpu.utils.logging import MetricLogger, tflog2pandas

    tb = str(tmp_path / "tb")
    ml = MetricLogger(str(tmp_path / "log.jsonl"), tb_dir=tb)
    for step, (loss, iou) in enumerate([(1.5, 0.3), (1.2, 0.4), (0.9, 0.45)]):
        ml.log(step, loss=loss, iou=iou)
    ml.log(3, loss=0.7)
    ml.close()
    got = tlog.tflog2pandas(tb)
    assert_columns_match(got, tflog2pandas(tb))
    assert list(got["metric"]) == ["loss"] * 4 + ["iou"] * 3
    np.testing.assert_array_equal(got["step"], [0, 1, 2, 3, 0, 1, 2])
    # one event file, read as a file
    (event,) = [f for f in os.listdir(tb) if "tfevents" in f]
    assert_columns_match(tlog.tflog2pandas(os.path.join(tb, event)), tflog2pandas(tb))

    # read_log of the same run's JSONL stream
    from ossid_code_tpu.utils.logging import read_log

    assert_columns_match(tlog.read_log(str(tmp_path / "log.jsonl")), read_log(str(tmp_path / "log.jsonl")))


def test_event_file_corruption_raises(tmp_path):
    from ossid_code_torch.utils import event_file

    assert event_file.crc32c(b"123456789") == 0xE3069283  # the CRC-32C check value
    path = str(tmp_path / "events.out.tfevents.1")
    rec = b"\x09" + struct.pack("<d", 1.0) + b"\x10\x05"  # wall_time 1.0, step 5, no summary
    head = struct.pack("<Q", len(rec))
    good = head + struct.pack("<I", event_file.masked_crc32c(head)) + rec + struct.pack(
        "<I", event_file.masked_crc32c(rec))
    with open(path, "wb") as f:
        f.write(good)
    assert list(event_file.read_scalars(path)) == []
    with open(path, "wb") as f:
        f.write(good[:-1] + bytes([good[-1] ^ 1]))
    with pytest.raises(ValueError, match="bad data CRC") as e:
        list(event_file.read_scalars(path))
    assert path in str(e.value)
    # a summary value with no simple_value (an image) raises and names the file
    value = b"\x0a\x03img" + b"\x22\x00"  # tag 'img', image {}
    summary = b"\x0a" + bytes([len(value)]) + value
    rec = b"\x10\x01" + b"\x2a" + bytes([len(summary)]) + summary
    head = struct.pack("<Q", len(rec))
    with open(path, "wb") as f:
        f.write(head + struct.pack("<I", event_file.masked_crc32c(head)) + rec
                + struct.pack("<I", event_file.masked_crc32c(rec)))
    with pytest.raises(ValueError, match="holds no scalar") as e:
        list(event_file.read_scalars(path))
    assert path in str(e.value)


def test_result_readers_match_jax(tmp_path):
    """load_result / summarize_result on tests/test_utils_extra.py's payload
    (plus a row with missing and None fields), and read_log on a JSONL
    stream with a missing key: the port's columns equal JAX's DataFrames."""
    from ossid_code_tpu.utils.logging import load_result, read_log, summarize_result

    rows = [
        {"obj_id": 1, "dtoid_iou": 0.7, "pred_iou_visib": 0.8, "pred_add01d": 1.0,
         "time_dtoid": 0.05, "pred_mask": np.ones((4, 4))},
        {"obj_id": 2, "dtoid_iou": 0.2, "pred_iou_visib": 0.4, "pred_add01d": 0.0,
         "time_dtoid": 0.07, "pred_mask": np.ones((4, 4))},
        {"obj_id": 3, "dtoid_iou": 0.6, "pred_add01d": 1.0, "time_dtoid": None, "time_ppf": 0.01,
         "use_dtoid_mask": True, "name": "c"},
    ]
    p = str(tmp_path / "r.pkl")
    with open(p, "wb") as f:
        pickle.dump({"test_results": rows}, f)
    cols = tlog.load_result(p)
    assert "pred_mask" not in cols
    assert_columns_match(cols, load_result(p))
    assert tlog.summarize_result(p) == pytest.approx(summarize_result(p), rel=1e-12, nan_ok=True)
    assert tlog.summarize_result(p)["dtoid_valid_iou_recall"] == pytest.approx(2 / 3)

    log = str(tmp_path / "m.jsonl")
    with open(log, "w") as f:
        for r in ({"step": 0, "time": 1.0, "loss": 2.0}, {"step": 1, "time": 2.0, "loss": 1.0, "iou": 0.5}):
            f.write(json.dumps(r) + "\n")
    assert_columns_match(tlog.read_log(log), read_log(log))


# ---------------------------------------------------------------- file_copy
def test_file_copy_matches_jax(tmp_path):
    from ossid_code_tpu.scripts.file_copy import copy_files

    from ossid_code_torch.scripts import file_copy

    src = tmp_path / "src"
    src.mkdir()
    for i in range(3):
        (src / f"f{i}.bin").write_bytes(bytes(i + 1))
    (src / "skip.txt").write_text("x")
    for mod_copy, dst in ((copy_files, tmp_path / "j"), (file_copy.copy_files, tmp_path / "t")):
        assert mod_copy(str(src / "*.bin"), str(dst), verbose=False) == 3
        assert mod_copy(str(src / "*.bin"), str(dst), verbose=False) == 0  # same sizes: skipped
    assert sorted(os.listdir(tmp_path / "j")) == sorted(os.listdir(tmp_path / "t")) == ["f0.bin", "f1.bin", "f2.bin"]


# ------------------------------------------------------------------ helpers
def _gt_pose():
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = Rotation.from_euler("xyz", [15, -10, 25], degrees=True).as_matrix()
    pose[:3, 3] = [0.03, -0.02, 0.55]
    return pose


def test_batched_icp_plane_converges_and_matches_jax():
    """tests/test_icp_device.py::test_batched_icp_plane_converges_on_well_conditioned_data
    mirrored: sub-0.1 mm ADD from 4 degree / 6 mm perturbations, and the
    refined poses equal JAX's within 1e-4 (tests/test_torch_icp.py's limit)."""
    from ossid_code_tpu.eval.pose_metrics import add_err
    from ossid_code_tpu.loop.online_learning import model_cloud_from_ply
    from ossid_code_tpu.ops.icp_device import batched_icp_plane
    from ossid_code_tpu.render.mesh import make_wedge_mesh

    from ossid_code_torch.ops import icp_device

    pts, _, nrms = model_cloud_from_ply(make_wedge_mesh(90, 60, 40), n_points=500)
    gt = _gt_pose()
    scene = (pts @ gt[:3, :3].T + gt[:3, 3]).astype(np.float32)
    snrm = (nrms @ gt[:3, :3].T).astype(np.float32)
    rng = np.random.default_rng(6)
    hypos = []
    for _ in range(6):
        p = gt.copy()
        p[:3, :3] = Rotation.from_rotvec(rng.normal(0, np.deg2rad(4.0), 3)).as_matrix() @ p[:3, :3]
        p[:3, 3] += rng.normal(0, 0.006, 3)
        hypos.append(p)
    hypos = np.stack(hypos).astype(np.float32)
    valid = np.ones(len(scene), bool)
    got = icp_device.batched_icp_plane(*map(torch.from_numpy, (hypos, pts.astype(np.float32), scene, snrm, valid)),
                                       max_dist=0.01, iters=10).numpy()
    want = np.asarray(batched_icp_plane(hypos, pts, scene, snrm, valid, max_dist=0.01, iters=10))
    for r in got:
        assert add_err(r[:3, :3], r[:3, 3], gt[:3, :3], gt[:3, 3], pts) < 1e-4
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    omega = torch.tensor([[0.0, 0.0, np.pi / 2], [0.1, -0.2, 0.3]])
    np.testing.assert_allclose(icp_device._rodrigues(omega).numpy(),
                               Rotation.from_rotvec(omega.numpy()).as_matrix(), atol=1e-6)


def test_small_helpers_match_jax():
    """tests/test_utils_extra.py:198-221 and tests/test_geometry.py:34, 45,
    133 mirrored, each helper against its JAX counterpart."""
    from ossid_code_tpu.data.dtoid_bop import sort_target_by_image
    from ossid_code_tpu.models.zephyr.features import filter_hypos_by_mask
    from ossid_code_tpu.render.visib import estimate_visib_mask
    from ossid_code_tpu.utils import geometry as jgeo
    from ossid_code_tpu.utils import image as jimage

    from ossid_code_torch.data import dtoid_bop
    from ossid_code_torch.models.zephyr import features
    from ossid_code_torch.render import visib
    from ossid_code_torch.utils import geometry as tgeo
    from ossid_code_torch.utils import image as timage

    targets = [{"obj_id": 1, "scene_id": 0, "im_id": 0}, {"obj_id": 2, "scene_id": 0, "im_id": 0},
               {"obj_id": 1, "scene_id": 0, "im_id": 1}]
    out = dtoid_bop.sort_target_by_image(targets)
    assert out == sort_target_by_image(targets) and out[(0, 0)] == [1, 2] and out[(0, 1)] == [1]

    K = np.array([[100.0, 0, 32], [0, 100.0, 32], [0, 0, 1]])
    pts = np.random.default_rng(0).normal(0, 0.01, (50, 3))
    mask = np.zeros((64, 64), bool)
    mask[20:45, 20:45] = True
    inside, outside = np.eye(4), np.eye(4)
    inside[:3, 3] = [0, 0, 1.0]
    outside[:3, 3] = [0.2, 0.2, 1.0]
    keep = features.filter_hypos_by_mask(pts, K, np.stack([inside, outside]), mask)
    assert keep.tolist() == [True, False]
    np.testing.assert_array_equal(keep, filter_hypos_by_mask(pts, K, np.stack([inside, outside]), mask))

    # project_points_uv (tests/test_geometry.py:45) and proj_cloud
    K2 = np.array([[100.0, 0, 50], [0, 100.0, 40], [0, 0, 1]])
    p2 = np.array([[0.0, 0.0, 1.0], [0.1, -0.2, 2.0]])
    uv = tgeo.project_points_uv(np.eye(4)[None], p2, K2)
    np.testing.assert_array_equal(uv[0], [[50, 40], [55, 30]])
    np.testing.assert_array_equal(uv, jgeo.project_points_uv(np.eye(4)[None], p2, K2))
    np.testing.assert_array_equal(tgeo.proj_cloud(p2, K2), jgeo.proj_cloud(p2, K2))
    # quat2mat round trip against scipy and JAX's
    q = Rotation.random(4, random_state=3).as_quat()
    np.testing.assert_allclose(tgeo.quat2mat(q), Rotation.from_quat(q).as_matrix(), atol=1e-12)
    np.testing.assert_array_equal(tgeo.quat2mat(q[0]), jgeo.quat2mat(q[0]))
    assert abs(float(tgeo.mat2quat(tgeo.quat2mat(q[0])) @ q[0])) == pytest.approx(1.0, abs=1e-12)  # q or -q
    # depth_im_to_dist_im (tests/test_geometry.py:133)
    K3 = np.array([[100.0, 0, 20], [0, 100.0, 10], [0, 0, 1]])
    depth = np.full((21, 41), 2.0, np.float32)
    dist = tgeo.depth_im_to_dist_im(depth, K3)
    np.testing.assert_allclose(dist[10, 20], 2.0, rtol=1e-6)
    np.testing.assert_allclose(dist[0, 0], 2.0 * np.sqrt(1.05), rtol=1e-6)
    np.testing.assert_array_equal(dist, jgeo.depth_im_to_dist_im(depth, K3))

    img = np.random.default_rng(1).uniform(0, 1, (5, 6, 3)).astype(np.float32)
    norm = timage.normalize_image_range(img)
    np.testing.assert_array_equal(norm, jimage.normalize_image_range(img))
    np.testing.assert_allclose(timage.denormalize_image_range(norm), img, atol=1e-6)
    np.testing.assert_array_equal(timage.denormalize_image_range(norm), jimage.denormalize_image_range(norm))

    rng = np.random.default_rng(2)
    d_test = rng.uniform(0.5, 1.0, (8, 9)).astype(np.float32)
    d_test[0, :3] = 0
    d_model = rng.uniform(0.4, 1.1, (8, 9)).astype(np.float32)
    d_model[1, :2] = 0
    for mode in ("bop19", "bop18"):
        np.testing.assert_array_equal(visib.estimate_visib_mask(d_test, d_model, 0.015, mode),
                                      estimate_visib_mask(d_test, d_model, 0.015, mode))



def test_device_summary_counts_each_kernel_record_and_its_span():
    """The records of each span's kernel, and those inside a span of its name
    (within the span's device range): a record outside every span counts
    among the first and not the second, so a lost tie shows."""
    from types import SimpleNamespace as NS

    from torch.autograd import DeviceType

    def ev(name, dev, start, end, ann=False):
        return NS(name=name, device_type=dev, time_range=NS(start=start, end=end), is_user_annotation=ann)

    k1 = "void (anonymous namespace)::dw_corr3x3_kernel<F32x4, 8, 2, false>(float const*, int)"
    events = [ev("dw_corr3x3", DeviceType.CPU, 0, 5, ann=True),
              ev("dw_corr3x3", DeviceType.CUDA, 10, 12, ann=True),       # the span's device range
              ev(k1, DeviceType.CUDA, 10, 12),                            # within it
              ev(k1, DeviceType.CUDA, 20, 21),                            # in no span
              ev("void dk_kernel<F32x4>(uint4 const*)", DeviceType.CUDA, 30, 31),
              ev("sa_mlp_max", DeviceType.CPU, 40, 41, ann=True),
              ev("void sa_mlp_max_bf16_kernel<P1>(bf16 const*)", DeviceType.CUDA, 50, 52)]
    prof = NS(events=lambda: events, key_averages=lambda: [])
    s = profiling.device_summary(prof, kernels={"dw_corr3x3": "dw_corr3x3_kernel", "sa_mlp_max": "sa_mlp_max_kernel"})
    assert s["kernel_records"] == {"dw_corr3x3": 2, "sa_mlp_max": 0}
    assert s["records_in_span"] == {"dw_corr3x3": 1, "sa_mlp_max": 0}
    assert s["device_events"] == 4 and s["device_busy_ms"] == pytest.approx(0.006)
    assert s["kernels_device_ms"]["dw_corr3x3"] == pytest.approx(0.003)
