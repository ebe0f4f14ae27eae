"""The port's host side against the JAX package's, on the CPU: the PNG codec
against imageio, the cv2-free resizes against cv2, the BOP reader and the
DTOID dataset, the renderer, visibility, pose metrics, the PPF matcher,
the loop's model cloud and the synthetic world writer. The world is written
by the JAX package's writer at 128x160 (2 frames, 2 objects)."""

import filecmp
import os
import pickle
import subprocess
from pathlib import Path

import cv2
import imageio.v2 as imageio
import numpy as np
import pytest
import torch

from ossid_code_torch.utils import image as timage
from ossid_code_torch.utils.png import read_png, write_png

torch.set_num_threads(2)
H, W = 128, 160


@pytest.mark.parametrize("kind", ["rgb", "rgba", "gray", "gray16", "smooth"])
def test_png_codec_matches_imageio(tmp_path, kind):
    """imageio's files read back pixel-equal, and imageio reads ours so."""
    rng = np.random.default_rng(0)
    img = {
        "rgb": rng.integers(0, 256, (48, 64, 3), dtype=np.uint8),
        "rgba": rng.integers(0, 256, (17, 23, 4), dtype=np.uint8),
        "gray": rng.integers(0, 256, (31, 29), dtype=np.uint8),
        "gray16": rng.integers(0, 65536, (40, 50), dtype=np.uint16),
        # smooth content makes the encoder pick the average and Paeth filters
        "smooth": (np.add.outer(np.arange(120), np.arange(160)) % 256).astype(np.uint8)[..., None]
        .repeat(3, 2),
    }[kind]
    imageio.imwrite(tmp_path / "a.png", img)
    got = read_png(str(tmp_path / "a.png"))
    assert got.dtype == img.dtype
    np.testing.assert_array_equal(got, img)
    write_png(str(tmp_path / "b.png"), img)
    np.testing.assert_array_equal(np.asarray(imageio.imread(tmp_path / "b.png")), img)


@pytest.mark.parametrize("src,dst", [((480, 640), (128, 160)), ((128, 160), (480, 640)),
                                     ((37, 53), (64, 20))])
def test_resizes_match_cv2(src, dst):
    """INTER_LINEAR (half-pixel centres): float within 1e-6, uint8 within
    1 LSB (cv2 weighs uint8 in 11-bit fixed point); INTER_NEAREST exactly."""
    rng = np.random.default_rng(1)
    size = (dst[1], dst[0])
    u8 = rng.integers(0, 256, src + (3,), dtype=np.uint8)
    f = rng.random(src).astype(np.float32)
    x3 = rng.random(src + (3,)).astype(np.float32)
    assert np.abs(timage.resize_linear(u8, size).astype(int) - cv2.resize(u8, size).astype(int)).max() <= 1
    np.testing.assert_allclose(timage.resize_linear(f, size), cv2.resize(f, size), atol=1e-6)
    np.testing.assert_allclose(timage.resize_linear(x3, size), cv2.resize(x3, size), atol=1e-6)
    np.testing.assert_array_equal(timage.resize_nearest(f, size),
                                  cv2.resize(f, size, interpolation=cv2.INTER_NEAREST))


@pytest.fixture(scope="module", autouse=True)
def jax_native_libraries():
    """The JAX package loads its PPF and rasterizer libraries from native/
    (built there as its own tests build them); without them it falls back to
    fake hypotheses and a numpy rasterizer, and would not be the reference."""
    subprocess.run(["make", "-C", str(Path(__file__).resolve().parents[1] / "native"), "-s"], check=True)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    from ossid_code_tpu.data.bop import BopDataset, BopDatasetArgs
    from ossid_code_tpu.data.synthetic import (
        default_objects, make_synthetic_bop, make_template_grid, make_zephyr_results_pkl,
    )

    root = str(tmp_path_factory.mktemp("bopworld"))
    make_synthetic_bop(root, n_frames=2, img_h=H, img_w=W)
    make_template_grid(os.path.join(root, "grid"), default_objects(), n_views=6)
    bop = BopDataset(BopDatasetArgs(bop_root=root, dataset_name="synth"))
    make_zephyr_results_pkl(os.path.join(root, "zr.pkl"), bop, score=50.0)
    return root


def _cfg(module, root):
    cfg = module.default_config()
    d = cfg.dataset
    d.bop_root, d.test_dataset_name, d.grid_root = root, "synth", os.path.join(root, "grid")
    d.shorter_length, d.heatmap_shorter_length, d.n_local_test = H, 7, 4
    cfg.train.batch_size = 2
    return cfg


def _assert_same(a, b, what=""):
    if isinstance(a, dict):
        assert set(a) == set(b), what
        for k in a:
            _assert_same(a[k], b[k], f"{what}.{k}")
    elif isinstance(a, (np.ndarray, np.generic)) or isinstance(b, (np.ndarray, np.generic)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=what)
    else:
        assert a == b, what


def test_bop_reader_and_dataset_items_match(world):
    """Frames, masks, poses and camera read the same; the DTOID dataset's
    test item, train item (pseudo-labelled) and replay annotations are
    equal for the same rng seed."""
    from ossid_code_tpu.core import config as jconfig
    from ossid_code_tpu.data.bop import BopDataset, BopDatasetArgs
    from ossid_code_tpu.data.dtoid_bop import get_dataloaders

    from ossid_code_torch.core import config as tconfig
    from ossid_code_torch.data.bop import BopDataset as TBopDataset, BopDatasetArgs as TBopDatasetArgs
    from ossid_code_torch.data.dtoid_bop import get_dataloaders as t_get_dataloaders

    jb = BopDataset(BopDatasetArgs(bop_root=world, dataset_name="synth"))
    tb = TBopDataset(TBopDatasetArgs(bop_root=world, dataset_name="synth"))
    assert jb.targets == tb.targets and jb.obj_ids == tb.obj_ids
    for t in jb.targets:
        _assert_same(tb.getDataByIds(t["obj_id"], t["scene_id"], t["im_id"]),
                     jb.getDataByIds(t["obj_id"], t["scene_id"], t["im_id"]), str(t))
    with open(os.path.join(world, "zr.pkl"), "rb") as f:
        zr = pickle.load(f)
    jl = get_dataloaders(_cfg(jconfig, world), zr)
    tl = t_get_dataloaders(_cfg(tconfig, world), zr)
    for j, t in ((jl[2], tl[2]), (jl[0], tl[0])):
        for i in range(len(j.dataset)):
            _assert_same(t.dataset[i], j.dataset[i], f"item {i}")
    jt, tt = jl[0].dataset, tl[0].dataset
    k = tuple(jt.bop_dataset.targets[0][n] for n in ("obj_id", "scene_id", "im_id"))
    mat = jb.getDataByIds(*k)["mat_gt"]
    mask = jt.zephyr_results[k]["pred_mask_visib"]
    _assert_same(tt.replay_annotations(k[0], mat, mask), jt.replay_annotations(k[0], mat, mask))


def _frame(world):
    from ossid_code_tpu.data.bop import BopDataset, BopDatasetArgs

    bop = BopDataset(BopDatasetArgs(bop_root=world, dataset_name="synth"))
    t = bop.targets[1]
    data = bop.getDataByIds(t["obj_id"], t["scene_id"], t["im_id"])
    return data, np.asarray(data["scene_camera"]["cam_K"]), bop.getObjPath(t["obj_id"])


def _render(renderer_cls, meta, k, path, pose):
    r = renderer_cls(meta(k), img_h=H, img_w=W)
    r.addObject(1, path, pose=pose, mm2m=True, simplify=True)
    return r.render(depth_only=True)[1]


def test_renderer_matches(world):
    """The native depth render: the port builds native/rasterizer.cpp itself,
    the JAX package loads the library `make -C native` built."""
    from ossid_code_tpu.render.rasterizer import Renderer, _load_raster_lib
    from ossid_code_tpu.utils.geometry import K2meta

    from ossid_code_torch.render.rasterizer import Renderer as TRenderer

    assert _load_raster_lib() is not None
    data, k, path = _frame(world)
    want = _render(Renderer, K2meta, k, path, data["mat_gt"])
    np.testing.assert_array_equal(_render(TRenderer, K2meta, k, path, data["mat_gt"]), want)
    assert (want > 0).sum() > 100


def test_visibility_and_model_cloud_match(world):
    """The visible-mask estimate on the port's render, and the loop's sampled
    model cloud."""
    from ossid_code_tpu.loop.online_learning import model_cloud_from_ply
    from ossid_code_tpu.render.mesh import load_ply
    from ossid_code_tpu.render.visib import estimate_visib_mask_gt

    from ossid_code_torch.loop.online_learning import model_cloud_from_ply as t_cloud
    from ossid_code_torch.render.mesh import load_ply as t_load_ply
    from ossid_code_torch.render.rasterizer import Renderer as TRenderer
    from ossid_code_torch.render.visib import estimate_visib_mask_gt as t_visib
    from ossid_code_torch.utils.geometry import K2meta

    data, k, path = _frame(world)
    depth = _render(TRenderer, K2meta, k, path, data["mat_gt"])
    assert (depth > 0).sum() > 100
    np.testing.assert_array_equal(t_visib(data["depth"], depth, 0.015),
                                  estimate_visib_mask_gt(data["depth"], depth, 0.015))
    for a, b in zip(t_cloud(t_load_ply(path)), model_cloud_from_ply(load_ply(path))):
        np.testing.assert_array_equal(a, b)


def test_pose_metrics_match():
    import jax.numpy as jnp

    from ossid_code_tpu.eval import pose_metrics as jm
    from ossid_code_torch.eval import pose_metrics as tm
    from ossid_code_torch.utils.geometry import perturb_trans

    rng = np.random.default_rng(2)
    pts = rng.normal(0, 0.05, (1500, 3)).astype(np.float32)
    gt = np.eye(4)
    gt[:3, 3] = (0.0, 0.1, 0.8)
    poses = perturb_trans(gt, 20, rng=rng).astype(np.float32)
    p = poses[3]
    for f in ("add_err", "adi_err"):
        assert getattr(tm, f)(p[:3, :3], p[:3, 3], gt[:3, :3], gt[:3, 3], pts) == \
            getattr(jm, f)(p[:3, :3], p[:3, 3], gt[:3, :3], gt[:3, 3], pts)
    assert tm.object_diameter(pts) == jm.object_diameter(pts)
    np.testing.assert_array_equal(tm.add_err_batch(poses, gt, pts), jm.add_err_batch(poses, gt, pts))
    np.testing.assert_array_equal(tm.adi_err_batch(poses, gt, pts), jm.adi_err_batch(poses, gt, pts))
    pts_q = pts[np.linspace(0, len(pts) - 1, 1000).round().astype(int)]
    for sym in (False, True):
        want = jm.pp_err_fetch(jm.pp_err_batch_async(poses, gt, jnp.asarray(pts), symmetric=sym,
                                                     pts_q_dev=jnp.asarray(pts_q)))
        got = tm.pp_err_fetch(tm.pp_err_batch_async(poses, gt, torch.from_numpy(pts), symmetric=sym,
                                                    pts_q_dev=torch.from_numpy(pts_q)))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_ppf_hypotheses_match(world):
    """The port's PPF wrapper, over the library it builds from native/ppf.cpp,
    gives the JAX wrapper's hypotheses on a frame of the world."""
    from ossid_code_tpu.data.bop import BopDataset, BopDatasetArgs
    from ossid_code_tpu.hypo.ppf import PPFModelMeters, native_available

    from ossid_code_torch.hypo.ppf import PPFModelMeters as TPPFModelMeters
    from ossid_code_torch.utils.geometry import depth2cloud

    assert native_available()
    bop = BopDataset(BopDatasetArgs(bop_root=world, dataset_name="synth"))
    t = bop.targets[0]
    data = bop.getDataByIds(t["obj_id"], t["scene_id"], t["im_id"])
    depth = data["depth"]
    scene = depth2cloud(depth, depth > 0, np.asarray(data["scene_camera"]["cam_K"]))
    kw = dict(ModelSamplingDist=0.04, scene_sampling_dist=0.05, ref_pt_rate=0.25, max_poses=64)
    want = PPFModelMeters(bop.getObjPath(t["obj_id"]), refine_top=0, **kw).find_surface_model(scene)
    got = TPPFModelMeters(bop.getObjPath(t["obj_id"]), refine_top=0, **kw).find_surface_model(scene)
    assert len(want[0]) > 0
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    # host ICP of the top 5 against the object's visible cloud: the same C++
    # solver (native/icp.cpp) on both sides, so the refined poses agree to
    # rounding (1e-9)
    from ossid_code_tpu.hypo.icp import _load_icp_lib

    assert _load_icp_lib() is not None
    obj = depth2cloud(depth, (data["mask_gt_visib"] > 0) & (depth > 0), np.asarray(data["scene_camera"]["cam_K"]))
    unrefined = PPFModelMeters(bop.getObjPath(t["obj_id"]), refine_top=0, **kw).find_surface_model(obj)[0]
    want = PPFModelMeters(bop.getObjPath(t["obj_id"]), refine_top=5, **kw).find_surface_model(obj)
    got = TPPFModelMeters(bop.getObjPath(t["obj_id"]), refine_top=5, **kw).find_surface_model(obj)
    assert np.abs(want[0][:5] - unrefined[:5]).max() > 1e-3  # ICP moved the top 5
    np.testing.assert_array_equal(want[0][5:], unrefined[5:])
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-9)


def test_synthetic_writer_matches_jax(tmp_path):
    """Same file tree; PNGs pixel-equal (the encoders compress differently),
    every other file byte-equal."""
    from ossid_code_tpu.data import synthetic as jsyn
    from ossid_code_tpu.data.bop import BopDataset, BopDatasetArgs

    from ossid_code_torch.data import synthetic as tsyn
    from ossid_code_torch.data.bop import BopDataset as TBopDataset, BopDatasetArgs as TBopDatasetArgs

    for mod, sub, bop_cls, args_cls in ((jsyn, "j", BopDataset, BopDatasetArgs),
                                        (tsyn, "t", TBopDataset, TBopDatasetArgs)):
        root = str(tmp_path / sub)
        mod.make_synthetic_bop(root, n_frames=2, img_h=64, img_w=80)
        mod.make_template_grid(os.path.join(root, "grid"), mod.default_objects(), n_views=3)
        bop = bop_cls(args_cls(bop_root=root, dataset_name="synth"))
        mod.make_zephyr_results_pkl(os.path.join(root, "zr.pkl"), bop, score=50.0)
    files = sorted(str(p.relative_to(tmp_path / "j")) for p in (tmp_path / "j").rglob("*") if p.is_file())
    assert files == sorted(str(p.relative_to(tmp_path / "t")) for p in (tmp_path / "t").rglob("*")
                           if p.is_file())
    for rel in files:
        a, b = tmp_path / "j" / rel, tmp_path / "t" / rel
        if rel.endswith(".png"):
            np.testing.assert_array_equal(read_png(str(b)), np.asarray(imageio.imread(a)), err_msg=rel)
        else:
            assert filecmp.cmp(a, b, shallow=False), rel
