"""The port's SIFT (ops/sift.py, hypo/sift.py) against OpenCV's and the JAX
package's, on the CPU.

The port computes SIFT itself (the card's machine has no cv2); these tests
may import cv2, the port may not (tests/test_torch_slice.py). Held to:
  * the matcher: JAX's hypotheses bit for bit on the same features;
  * the descriptor at cv2's own keypoints: cv2's descriptors, L2 distance
    (descriptors are integers 0-255 of norm about 512) at most
    DESC_MEDIAN_TOL in the median and DESC_WORST_TOL at worst;
  * the detector: its agreement with cv2 (the share of its keypoints within
    1.5 px of a cv2 keypoint of a size within 25%) no worse than cv2's own
    agreement with itself on the image shifted by one pixel;
  * the pose: the JAX test's ADI limit on its textured scene;
  * the loop: SIFT's poses before the fake ones, the fallback on a blanked
    frame, and the rows of the JAX loop where both take the fallback.
"""

import argparse
import os
import pickle
import subprocess
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from ossid_code_torch.ops import sift as tsift

cv2 = pytest.importorskip("cv2")
torch.set_num_threads(2)

# measured on these images: 0.0 and 0.0 (descriptors equal)
DESC_MEDIAN_TOL = 1.0
DESC_WORST_TOL = 4.0
H, W = 128, 160


def _keypoints(ck) -> tsift.Keypoints:
    return tsift.Keypoints(
        pt=np.array([k.pt for k in ck], np.float32).reshape(-1, 2),
        size=np.array([k.size for k in ck], np.float32), angle=np.array([k.angle for k in ck], np.float32),
        response=np.array([k.response for k in ck], np.float32),
        octave=np.array([k.octave for k in ck], np.int32))


def _agreement(a: tsift.Keypoints, b: tsift.Keypoints) -> float:
    """Share of a's keypoints within 1.5 px of a keypoint of b whose size is
    within 25% of theirs."""
    if not a.count:
        return 0.0
    tree = cKDTree(b.pt)
    hits = 0
    for p, s in zip(a.pt, a.size):
        hits += any(abs(np.log(b.size[i] / s)) < np.log(1.25) for i in tree.query_ball_point(p, 1.5))
    return hits / a.count


@pytest.fixture(scope="module")
def textured():
    """The JAX SIFT test's scene (tests/test_hdf5_sift.py:134): a textured
    box at 0.5 m in a 240x320 frame, its 12-view template grid."""
    from scipy.spatial.transform import Rotation

    from ossid_code_torch.data.synthetic import make_template_grid
    from ossid_code_torch.data.templates import TemplateDataset
    from ossid_code_torch.render.mesh import make_box_mesh, subdivide_mesh
    from ossid_code_torch.render.rasterizer import render_depth

    mesh = subdivide_mesh(make_box_mesh(120, 90, 60), 3)
    r2 = np.random.default_rng(7)
    mesh.colors = np.clip(mesh.colors + r2.uniform(-0.4, 0.4, mesh.colors.shape), 0, 1)
    grid = tempfile.mkdtemp()
    make_template_grid(grid, {1: mesh}, n_views=12, size=192)
    td = TemplateDataset(grid, [1])
    K = np.array([[400.0, 0, 160], [0, 400.0, 120], [0, 0, 1]])
    pose_gt = np.eye(4)
    pose_gt[:3, :3] = Rotation.from_euler("xyz", [10, -15, 20], degrees=True).as_matrix()
    pose_gt[:3, 3] = [0.01, -0.01, 0.5]
    depth, color = render_depth(mesh.vertices / 1000.0, mesh.faces, K, pose_gt, 240, 320, colors=mesh.colors)
    img = (np.clip(color, 0, 1) * 255).astype(np.uint8)
    return dict(mesh=mesh, td=td, K=K, pose_gt=pose_gt, depth=depth, img=img)


def _images(textured):
    """(name, gray, mask, nfeatures): the scene as the loop featurizes it
    and one template view as the feature bank does."""
    timg, _, tmask = textured["td"].getTemplate(1, textured["td"].view_ids[3])
    scene = cv2.cvtColor(textured["img"], cv2.COLOR_RGB2GRAY)
    template = cv2.cvtColor((timg * 255).astype(np.uint8), cv2.COLOR_RGB2GRAY)
    return [("scene", scene, (textured["depth"] > 0).astype(np.uint8) * 255, 500),
            ("template", template, (tmask[..., 0] > 0).astype(np.uint8) * 255, 200)]


def test_gray_is_opencvs():
    img = np.random.default_rng(0).integers(0, 256, (64, 80, 3), dtype=np.uint8)
    got = tsift.rgb_to_gray(torch.from_numpy(img)).numpy()
    np.testing.assert_array_equal(got, cv2.cvtColor(img, cv2.COLOR_RGB2GRAY))


def test_primitives_follow_opencv():
    """OpenCV's polynomial atan2 exactly; its float blur and 2x upscale to
    float32 rounding on the 0-255 scale."""
    rng = np.random.default_rng(1)
    y, x = rng.normal(size=(2, 500)).astype(np.float32)
    got = tsift.fast_atan2(torch.from_numpy(y), torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, [cv2.fastAtan2(float(a), float(b)) for a, b in zip(y, x)])
    img = rng.uniform(0, 255, (37, 50)).astype(np.float32)
    for sigma in (1.2489996, 1.9463, 3.0910):
        np.testing.assert_allclose(tsift.gaussian_blur(torch.from_numpy(img), sigma).numpy(),
                                   cv2.GaussianBlur(img, (0, 0), sigma, sigma), rtol=0, atol=2e-4)
    np.testing.assert_allclose(tsift.upscale2x(torch.from_numpy(img)).numpy(),
                               cv2.resize(img, (100, 74), interpolation=cv2.INTER_LINEAR), rtol=0, atol=1e-4)


def test_descriptor_at_opencv_keypoints(textured):
    for name, gray, mask, nf in _images(textured):
        ck, cd = cv2.SIFT_create(nfeatures=nf).detectAndCompute(gray, mask)
        assert len(ck) > 20, name
        got = tsift.describe(torch.from_numpy(gray), _keypoints(ck)).numpy()
        dist = np.linalg.norm(got - cd, axis=1)
        assert np.median(dist) <= DESC_MEDIAN_TOL and dist.max() <= DESC_WORST_TOL, \
            f"{name}: descriptor L2 median {np.median(dist)}, worst {dist.max()}"


def test_detector_within_opencvs_noise_floor(textured):
    """Keypoints and their sizes as cv2 finds them, relative to cv2's own
    repeatability under a one-pixel shift, and as many of them (within 5%)."""
    for name, gray, mask, nf in _images(textured):
        sift = cv2.SIFT_create(nfeatures=nf)
        ref = _keypoints(sift.detectAndCompute(gray, mask)[0])
        shifted = _keypoints(sift.detectAndCompute(np.roll(gray, (1, 1), (0, 1)), np.roll(mask, (1, 1), (0, 1)))[0])
        shifted = shifted._replace(pt=shifted.pt - 1.0)
        got, desc = tsift.detect_and_compute(torch.from_numpy(gray), torch.from_numpy(mask), nfeatures=nf)
        port_share, cv2_share = _agreement(got, ref), _agreement(shifted, ref)
        assert port_share >= cv2_share, f"{name}: port-cv2 {port_share:.3f} < cv2-shifted {cv2_share:.3f}"
        assert abs(got.count - ref.count) <= max(2, 0.05 * ref.count), (name, got.count, ref.count)


def test_mask_without_keypoints(textured):
    """A mask that holds none of the keypoints leaves none (OpenCV masks
    after its selection), and the scene featurization raises SIFT's own
    error for it."""
    from ossid_code_torch.hypo.sift import featurize_scene

    gray = torch.from_numpy(cv2.cvtColor(textured["img"], cv2.COLOR_RGB2GRAY))
    mask = torch.zeros(gray.shape, dtype=torch.bool)
    mask[:3, :3] = True
    kps, desc = tsift.detect_and_compute(gray, mask, nfeatures=500)
    assert kps.count == 0 and desc.shape == (0, 128)
    with pytest.raises(tsift.SiftError, match="no SIFT features"):
        featurize_scene(textured["img"], textured["depth"], mask.numpy(), textured["K"], device="cpu")


def test_pose_from_port_sift(textured):
    """SiftHypoGen over the port's SIFT recovers the scene's pose within the
    JAX test's ADI limit (2 cm)."""
    from ossid_code_torch.eval.pose_metrics import adi_err
    from ossid_code_torch.hypo.sift import SiftFeatureModel, SiftHypoGen
    from ossid_code_torch.loop.online_learning import model_cloud_from_ply

    mesh, pose_gt = textured["mesh"], textured["pose_gt"]
    verts = mesh.vertices / 1000.0
    diam = float(np.linalg.norm(verts.max(0) - verts.min(0)))
    fm = SiftFeatureModel(device="cpu").construct_from_templates(textured["td"], 1, view_dist=diam * 1.6)
    assert len(fm.descs) > 30
    poses = SiftHypoGen(fm, textured["K"], n_hypos=10).match(textured["img"], textured["depth"],
                                                             textured["depth"] > 0)
    pts, _, _ = model_cloud_from_ply(mesh)
    errs = [adi_err(p[:3, :3], p[:3, 3], pose_gt[:3, :3], pose_gt[:3, 3], pts) for p in poses]
    assert min(errs) < 0.02, f"best SIFT ADI {min(errs):.4f}"


def _bank(rng, n=300):
    return (rng.integers(0, 256, (n, 128)).astype(np.float32), rng.uniform(-0.05, 0.05, (n, 3)))


@pytest.mark.parametrize("case", ["consistent", "noisy", "too_few"])
def test_matcher_matches_jax_bit_for_bit(case, monkeypatch):
    """The same bank and scene features give JAX's hypotheses bit for bit
    (same seed); too few correspondences raise in both."""
    from scipy.spatial.transform import Rotation

    import ossid_code_tpu.hypo.sift as jsift
    from ossid_code_torch.hypo.sift import SiftFeatureModel

    rng = np.random.default_rng({"consistent": 0, "noisy": 1, "too_few": 2}[case])
    descs, pts = _bank(rng)
    pose = np.eye(4)
    pose[:3, :3] = Rotation.from_rotvec(rng.normal(0, 0.5, 3)).as_matrix()
    pose[:3, 3] = [0.02, -0.01, 0.6]
    n = 2 if case == "too_few" else 80
    pick = rng.choice(len(pts), n, replace=False)
    scene_desc = descs[pick] + rng.normal(0, 2.0, (n, 128)).astype(np.float32)
    scene3d = pts[pick] @ pose[:3, :3].T + pose[:3, 3]
    if case == "noisy":
        scene3d[::2] += rng.normal(0, 0.05, (len(scene3d[::2]), 3))
    uv = rng.uniform(0, 100, (n, 2))
    monkeypatch.setattr(jsift, "featurize_scene", lambda *a, **k: (uv, scene_desc, scene3d))
    models = [jsift.SiftFeatureModel(), SiftFeatureModel(device="cpu")]
    for m in models:
        m.descs, m.points_obj, m._tree = descs, pts, cKDTree(descs)
    jm, tm = models
    if case == "too_few":
        with pytest.raises(ValueError, match="too few"):
            jm.match(None, None, None, None)
        with pytest.raises(tsift.SiftError, match="too few"):
            tm.match_features(uv, scene_desc, scene3d)
        return
    want = jm.match(None, None, None, None, n_hypos=20, seed=3)
    got = tm.match_features(uv, scene_desc, scene3d, n_hypos=20, seed=3)
    np.testing.assert_array_equal(got, want)
    assert len(got) >= 1


# ------------------------------------------------------------------ the loop

@pytest.fixture(scope="module", autouse=True)
def jax_native_libraries():
    """The JAX loop renders with its native rasterizer (built as its own
    tests build it)."""
    subprocess.run(["make", "-C", str(Path(__file__).resolve().parents[1] / "native"), "-s"], check=True)


def _args(**kw):
    d = dict(dataset_name="synth", exp_name="t", use_offline_model=False, use_pretrained_dtoid=False,
             dtoid_weights_path=None, n_local_test=4, use_dtoid_segmask=True, ignore_dtoid_mask=False,
             always_dtoid_mask=True, use_oracle_gt=False, use_sift_hypos=True, test_seen=False,
             backward=False, use_maskrcnn=False, finetune_interval=4, finetune_warmup=0, finetune_epochs=1,
             finetune_reset=False, finetune_batch_size=2, non_cum=False, save_each=False, raw_dtoid=False,
             no_finetune=True, fast=True, zephyr_depth_crop=0, yuv_transfer=False, n_fake_hypos=8)
    d.update(kw)
    return argparse.Namespace(**d)


def _configure(cfg, root):
    d = cfg.dataset
    d.bop_root, d.test_dataset_name, d.grid_root = root, "synth", os.path.join(root, "grid")
    d.shorter_length, d.heatmap_shorter_length, d.n_local_test = H, 7, 4
    d.load_zephyr_result, d.zephyr_result_path = True, os.path.join(root, "zr.pkl")
    cfg.model.img_h, cfg.model.img_w = H, W
    cfg.model.heatmap_h, cfg.model.heatmap_w = 7, 9
    cfg.model.densenet_blocks = (2, 2, 2)
    cfg.train.batch_size = 2
    return cfg


BLANK_IM = 2


@pytest.fixture(scope="module")
def sift_world(tmp_path_factory):
    """The JAX loop test's SIFT world (tests/test_online_loop.py:595): 2
    textured wedges, 4 frames of 128x160, frame 2 blanked to one grey."""
    from ossid_code_tpu.data.bop import BopDataset, BopDatasetArgs
    from ossid_code_tpu.data.synthetic import make_synthetic_bop, make_template_grid, make_zephyr_results_pkl
    from ossid_code_tpu.render.mesh import make_wedge_mesh, texture_mesh

    from ossid_code_torch.utils.png import read_png, write_png

    root = str(tmp_path_factory.mktemp("siftworld"))
    objects = {
        1: texture_mesh(make_wedge_mesh(85, 62, 45, taper=0.55, shear=0.35), amp=0.3, subdiv=3, seed=1),
        2: texture_mesh(make_wedge_mesh(70, 48, 55, taper=0.4, shear=-0.25), amp=0.3, subdiv=3, seed=2),
    }
    make_synthetic_bop(root, n_frames=4, img_h=H, img_w=W, objects=objects)
    make_template_grid(os.path.join(root, "grid"), objects, n_views=8)
    rgb = os.path.join(root, "synth", "test", "000000", "rgb", f"{BLANK_IM:06d}.png")
    write_png(rgb, np.full_like(read_png(rgb), 128))
    bop = BopDataset(BopDatasetArgs(bop_root=root, dataset_name="synth"))
    make_zephyr_results_pkl(os.path.join(root, "zr.pkl"), bop, score=50.0)
    return root


def _empty_seg(params):
    """Zero the segmentation head with bias -6: the seg mask is empty, so the
    loop's <= 25-pixel fallback makes SIFT's region the whole frame."""
    seg = params["correlation_model"]["seg_final"]
    seg["kernel"] = np.zeros_like(seg["kernel"])
    seg["bias"] = np.full_like(seg["bias"], -6.0)


def _loaders(get_dataloaders, cfg):
    with open(cfg.dataset.zephyr_result_path, "rb") as f:
        zr_list = pickle.load(f)
    train_loader, _, test_loader = get_dataloaders(cfg, zr_list)
    test_loader.dataset.sortTargets()
    train_ds = train_loader.dataset
    train_ds.clearTargets()
    zr = {(r["obj_id"], r["scene_id"], r["im_id"]): dict(r) for r in zr_list}
    train_ds.zephyr_results = dict(zr)
    return train_ds, test_loader, zr


@pytest.fixture(scope="module")
def jax_sift_run(sift_world):
    """The JAX loop with cv2 SIFT; returns its rows and its weights."""
    import jax

    from ossid_code_tpu.core.config import default_config
    from ossid_code_tpu.data.bop import BopDataset, BopDatasetArgs
    from ossid_code_tpu.data.dtoid_bop import get_dataloaders
    from ossid_code_tpu.hypo.fake import FakeHypoGen
    from ossid_code_tpu.hypo.sift import SiftFeatureModel, SiftHypoGen
    from ossid_code_tpu.loop.online_learning import OnlineLearningLoop
    from ossid_code_tpu.models.dtoid.module import DtoidModel
    from ossid_code_tpu.models.zephyr.module import ZephyrModel

    cfg = _configure(default_config(), sift_world)
    bop = BopDataset(BopDatasetArgs(bop_root=sift_world, dataset_name="synth"))
    train_ds, test_loader, zr = _loaders(get_dataloaders, cfg)
    model = DtoidModel(cfg, seed=0)
    sd = jax.tree_util.tree_map(np.array, jax.device_get(model.state_dict()))
    _empty_seg(sd["params"])
    model.load_state_dict(sd)
    zmodel = ZephyrModel(num_points=128, inconst_ratio_th=100.0, seed=0, need_uv=False)
    td = test_loader.dataset.template_dataset
    gens = {oid: SiftHypoGen(SiftFeatureModel().construct_from_templates(td, oid), bop.dataset_camera["K"])
            for oid in bop.obj_ids}
    loop = OnlineLearningLoop(_args(), cfg, model, bop, train_ds, test_loader, zr, zephyr_model=zmodel,
                              hypo_gens={oid: FakeHypoGen(n_hypos=8, seed=oid) for oid in bop.obj_ids},
                              sift_gens=gens, pipeline_scoring=False)
    return loop.run(progress=False), (sd, jax.device_get(zmodel.state_dict()))


def _port_loop(sift_world, weights, gens=None):
    from ossid_code_torch.core.config import default_config
    from ossid_code_torch.data.bop import BopDataset, BopDatasetArgs
    from ossid_code_torch.data.dtoid_bop import get_dataloaders
    from ossid_code_torch.hypo.fake import FakeHypoGen
    from ossid_code_torch.hypo.sift import SiftFeatureModel, SiftHypoGen
    from ossid_code_torch.loop.online_learning import OnlineLearningLoop
    from ossid_code_torch.models.dtoid.jax_import import dtoid_from_jax
    from ossid_code_torch.models.dtoid.module import DtoidModel
    from ossid_code_torch.models.zephyr.jax_import import pointnet2_from_jax
    from ossid_code_torch.models.zephyr.module import ZephyrModel

    cfg = _configure(default_config(), sift_world)
    bop = BopDataset(BopDatasetArgs(bop_root=sift_world, dataset_name="synth"))
    train_ds, test_loader, zr = _loaders(get_dataloaders, cfg)
    model = DtoidModel(cfg, seed=0, device="cpu")
    model.load_state_dict(dtoid_from_jax(weights[0]["params"], weights[0]["batch_stats"]))
    zmodel = ZephyrModel(num_points=128, inconst_ratio_th=100.0, seed=0, need_uv=False, device="cpu")
    zmodel.load_state_dict(pointnet2_from_jax(weights[1]["params"], weights[1]["batch_stats"]))
    if gens is None:
        td = test_loader.dataset.template_dataset
        gens = {oid: SiftHypoGen(SiftFeatureModel(device="cpu").construct_from_templates(td, oid),
                                 bop.dataset_camera["K"]) for oid in bop.obj_ids}
    return OnlineLearningLoop(_args(), cfg, model, bop, train_ds, test_loader, zr, zephyr_model=zmodel,
                              hypo_gens={oid: FakeHypoGen(n_hypos=8, seed=oid) for oid in bop.obj_ids},
                              sift_gens=gens)


def test_sift_branch_in_loop_matches_jax(sift_world, jax_sift_run):
    """SIFT's poses join the fake ones on the textured frames (n_hypos = 8 +
    SIFT's, time_sift > 0); the blanked frame takes the fallback (20 identity
    poses, time_sift None) in both loops, and there the rows agree: the same
    hypotheses, scores within the loop test's limits (2e-3 relative, 5e-4
    absolute), the same pick and pose."""
    want, weights = jax_sift_run
    got = _port_loop(sift_world, weights).run(progress=False)
    assert [(r["obj_id"], r["im_id"]) for r in got] == [(r["obj_id"], r["im_id"]) for r in want]
    blank = [i for i, r in enumerate(got) if r["im_id"] == BLANK_IM]
    assert len(blank) == 2
    for i, (g, w) in enumerate(zip(got, want)):
        if i in blank:
            assert g["time_sift"] is None and w["time_sift"] is None
            assert g["n_hypos"] == w["n_hypos"] == 8 + 20
            np.testing.assert_allclose(g["hypo_scores"], w["hypo_scores"], rtol=2e-3, atol=5e-4)
            assert np.argmax(g["hypo_scores"]) == np.argmax(w["hypo_scores"])
            np.testing.assert_allclose(g["pred_pose"], w["pred_pose"], rtol=0, atol=1e-6)
        else:
            assert g["time_sift"] is not None and g["time_sift"] > 0, (i, g["time_sift"])
            assert 8 < g["n_hypos"] <= 8 + 20
    assert any(g["n_hypos"] > 8 for g in got)


def test_non_sift_failure_propagates(sift_world, jax_sift_run):
    """Only SIFT's own errors fall back: any other error (a CUDA fault, a bug)
    leaves the loop."""
    class Broken:
        def match(self, *a, **k):
            raise RuntimeError("device fault")

    loop = _port_loop(sift_world, jax_sift_run[1], gens={1: Broken(), 2: Broken()})
    with pytest.raises(RuntimeError, match="device fault"):
        loop.run(progress=False)
