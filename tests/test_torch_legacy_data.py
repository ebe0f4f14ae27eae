"""The port's legacy data and host utilities against the JAX package's (and
cv2's), on the CPU: data/fewshot.py, data/ycbv_sift.py, utils/jpeg.py,
ops/warp.py, utils/homographies.py, utils/augmentation.py and
utils/sphere_sampling.py.

Limits: few-shot episodes item for item, images within 1 LSB (1/255: cv2's
uint8 INTER_LINEAR rounds its 11-bit fixed-point weights, the port
interpolates in float64), everything else equal; JPEG decode within 1 level
of cv2.imread (measured: equal); SIFT grids by tests/test_torch_sift.py's
detector criterion against cv2; the rest bit for bit, except
warp_perspective (WARP_TOL: the inverse homography in float32 in two
libraries; measured 1.4e-5).
"""

import os

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")
torch.set_num_threads(2)

LSB = 1.0 / 255.0 + 1e-6
JPEG_TOL = 1
WARP_TOL = 5e-5


def textured_world(root: str) -> str:
    """2 textured boxes x 5 frames of 128x160 and an 8-view template grid
    (tests/test_train_families.py's world), written by the JAX package."""
    from ossid_code_tpu.data.synthetic import make_synthetic_bop, make_template_grid
    from ossid_code_tpu.render.mesh import make_box_mesh, subdivide_mesh

    rng = np.random.default_rng(3)
    objs = {}
    for oid, dims in ((1, (120, 90, 60)), (2, (100, 70, 50))):
        m = subdivide_mesh(make_box_mesh(*dims), 3)
        m.colors = np.clip(m.colors + rng.uniform(-0.4, 0.4, m.colors.shape), 0, 1)
        objs[oid] = m
    make_synthetic_bop(root, n_frames=5, img_h=128, img_w=160, objects=objs)
    make_template_grid(os.path.join(root, "grid"), objs, n_views=8, size=128)
    return root


def fss_layout(root: str, classes=("ab", "cd"), n: int = 3, hw=(48, 48)) -> str:
    """An FSS-1000 layout <root>/<class>/{i.jpg, i.png} written by cv2."""
    rng = np.random.default_rng(0)
    for cls in classes:
        os.makedirs(os.path.join(root, cls))
        for i in range(1, n + 1):
            img = rng.integers(0, 255, hw + (3,), dtype=np.uint8)
            mask = np.zeros(hw, np.uint8)
            mask[10:30, 12:36] = 255
            cv2.imwrite(os.path.join(root, cls, f"{i}.jpg"), img)
            cv2.imwrite(os.path.join(root, cls, f"{i}.png"), mask)
    return root


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return textured_world(str(tmp_path_factory.mktemp("legacy_data")))


def _hold_items(got: dict, want: dict, image_keys=()):
    assert got.keys() == want.keys()
    for k, w in want.items():
        if k in image_keys:
            assert np.abs(np.asarray(got[k], np.float64) - w).max() <= LSB, k
        elif isinstance(w, np.ndarray):
            assert got[k].dtype == w.dtype and np.array_equal(got[k], w), k
        else:
            assert got[k] == w, k


def _cfg(world):
    from ossid_code_tpu.core.config import Config

    return Config(name="fewshot_bop", bop_root=world, test_dataset_name="synth", grid_root=os.path.join(world, "grid"),
                  shorter_length=128, keep_aspect_ratio=True, k_support=2, min_visib_fract=0.0)


def test_fewshot_bop_items_match_jax(world):
    """FewshotBopDataset for the seen and unseen splits: every item equal to
    JAX's (the same rng draws of support views), the image within 1 LSB."""
    from ossid_code_tpu.data import fewshot as J
    from ossid_code_tpu.data.bop import BopDataset as JBop, BopDatasetArgs as JArgs

    from ossid_code_torch.data import fewshot as T
    from ossid_code_torch.data.bop import BopDataset, BopDatasetArgs

    d = _cfg(world)
    jb = JBop(JArgs(bop_root=world, dataset_name="synth", split_name="bop_test", split="test"))
    tb = BopDataset(BopDatasetArgs(bop_root=world, dataset_name="synth", split_name="bop_test", split="test"))
    assert T.split_seen_unseen_objects("ycbv", [1, 2, 3, 4]) == J.split_seen_unseen_objects("ycbv", [1, 2, 3, 4])
    assert T.split_seen_unseen_objects("synth", [1, 2]) == J.split_seen_unseen_objects("synth", [1, 2])
    for seed, objs in ((0, [1]), (1, [1, 2])):
        jd = J.FewshotBopDataset("train", objs, jb, d, seed=seed)
        td = T.FewshotBopDataset("train", objs, tb, d, seed=seed)
        assert len(td) == len(jd) > 0
        for i in range(len(jd)):
            _hold_items(td[i], jd[i], image_keys=("img",))


def test_fss1000_items_and_loaders_match_jax(tmp_path):
    """FSS-1000 on a cv2-written layout: the loaders' class split, and every
    episode of both splits equal to JAX's (imageio's JPEG decode against
    utils/jpeg.py, cv2's resizes against utils/image.py), images within 1
    LSB, masks equal."""
    from ossid_code_tpu.core.config import Config
    from ossid_code_tpu.data import fewshot as J

    from ossid_code_torch.data import fewshot as T

    root = fss_layout(str(tmp_path / "fss"), classes=("ab", "cd", "ef"), n=3, hw=(50, 37))
    cfg = Config(dataset=Config(dataset_root=root, k_shot=2, image_size=64), train=Config(batch_size=2))
    jl, tl = J.get_fss1000_dataloaders(cfg), T.get_fss1000_dataloaders(cfg)
    for jloader, tloader in zip(jl, tl):
        assert jloader.dataset.classes == tloader.dataset.classes and len(jloader) == len(tloader)
        for i in range(len(jloader.dataset)):
            _hold_items(tloader.dataset[i], jloader.dataset[i], image_keys=("img", "simg"))
    with pytest.raises(SystemExit):
        T.get_fss1000_dataloaders(Config(dataset=Config(dataset_root=str(tmp_path / "none")), train=Config(batch_size=1)))


def _natural(rng, h, w):
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([128 + 100 * np.sin(x / 7.0 + c) * np.cos(y / 11.0 - c) for c in range(3)], -1)
    return np.clip(img + rng.normal(0, 12, img.shape), 0, 255).astype(np.uint8)


@pytest.mark.parametrize("quality", [75, 95])
@pytest.mark.parametrize("sampling", ["444", "420"])
def test_read_jpeg_matches_cv2(quality, sampling, tmp_path):
    """Baseline files written by cv2 at 4:4:4 and 4:2:0 (odd sizes, one with
    restart markers, one grey): read_jpeg within JPEG_TOL of cv2.imread."""
    from ossid_code_torch.utils.jpeg import read_jpeg

    flag = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444, "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420}[sampling]
    rng = np.random.default_rng(quality)
    for (h, w), rst in (((224, 224), 0), ((37, 61), 2)):
        p = str(tmp_path / f"{h}.jpg")
        params = [cv2.IMWRITE_JPEG_QUALITY, quality, cv2.IMWRITE_JPEG_SAMPLING_FACTOR, flag]
        cv2.imwrite(p, _natural(rng, h, w)[..., ::-1], params + ([cv2.IMWRITE_JPEG_RST_INTERVAL, rst] if rst else []))
        got = read_jpeg(p)
        assert got.shape == (h, w, 3) and got.dtype == np.uint8
        assert np.abs(got.astype(int) - cv2.imread(p)[..., ::-1]).max() <= JPEG_TOL
    p = str(tmp_path / "grey.jpg")
    cv2.imwrite(p, _natural(rng, 29, 33)[..., 0], [cv2.IMWRITE_JPEG_QUALITY, quality])
    assert np.abs(read_jpeg(p).astype(int) - cv2.imread(p, cv2.IMREAD_GRAYSCALE)).max() <= JPEG_TOL


@pytest.mark.parametrize("subsampling", ["4:2:0", "4:4:4"])
def test_write_jpeg_reads_back_in_cv2(subsampling, tmp_path):
    """write_jpeg's baseline files: cv2 decodes them to read_jpeg's pixels,
    and close to the image written."""
    from ossid_code_torch.utils.jpeg import read_jpeg, write_jpeg

    img = _natural(np.random.default_rng(4), 45, 70)
    p = str(tmp_path / "w.jpg")
    write_jpeg(p, img, quality=90, subsampling=subsampling)
    got = read_jpeg(p)
    assert np.abs(got.astype(int) - cv2.imread(p)[..., ::-1]).max() <= JPEG_TOL
    assert np.abs(got.astype(int) - img).mean() < 12


def test_progressive_jpeg_raises(tmp_path):
    """A progressive file raises, naming the file; so does a non-JPEG."""
    from ossid_code_torch.utils.jpeg import read_jpeg

    p = str(tmp_path / "prog.jpg")
    cv2.imwrite(p, _natural(np.random.default_rng(5), 32, 32), [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    with pytest.raises(ValueError, match=f"{p}: progressive"):
        read_jpeg(p)
    q = str(tmp_path / "x.jpg")
    cv2.imwrite(str(tmp_path / "x.png"), np.zeros((4, 4), np.uint8))
    os.replace(str(tmp_path / "x.png"), q)
    with pytest.raises(ValueError, match="not a JPEG"):
        read_jpeg(q)


# ------------------------------------------------------------------ ycbv_sift
@pytest.fixture(scope="module")
def sift_objects(world):
    """The JAX package's and the port's YcbvObject for each object of the
    world's grid (cv2's SIFT against the port's on the CPU)."""
    from ossid_code_tpu.data.templates import TemplateDataset as JT
    from ossid_code_tpu.data.ycbv_sift import YcbvObject as JO

    from ossid_code_torch.data.templates import TemplateDataset
    from ossid_code_torch.data.ycbv_sift import YcbvObject

    grid = os.path.join(world, "grid")
    jt, tt = JT(grid, [1, 2]), TemplateDataset(grid, [1, 2])
    return {oid: (JO(jt, oid), YcbvObject(tt, oid, device="cpu")) for oid in (1, 2)}, tt


def test_sift_grid_by_the_detector_criterion(sift_objects):
    """Each view and scale of the grid: the port's keypoints agree with cv2's
    `SIFT_create(nfeatures=200)` at least as well as cv2 agrees with itself
    under a one-pixel shift (tests/test_torch_sift.py's criterion), as many
    within 5%; the grids hold as many features within 5%, and the view
    directions, and the cosines between them, equal JAX's."""
    from test_torch_sift import _agreement, _keypoints

    from ossid_code_torch.ops.sift import detect_and_compute, rgb_to_gray
    from ossid_code_torch.utils.image import resize_linear

    objects, tt = sift_objects
    for oid, (jo, to) in objects.items():
        assert np.array_equal(to.view_dirs, jo.view_dirs) and np.array_equal(to.view_poses, jo.view_poses)
        assert abs(len(to.descs) - len(jo.descs)) <= max(2, 0.05 * len(jo.descs))
        assert to.kpt_proj_grid_cos().shape == (len(to.descs), len(to.view_dirs))
        for vid in tt.view_ids:
            img = tt.getTemplate(oid, vid)[0]
            for im in (img, resize_linear(img, (img.shape[1] // 2, img.shape[0] // 2))):
                gray = cv2.cvtColor((im * 255).astype(np.uint8), cv2.COLOR_RGB2GRAY)
                sift = cv2.SIFT_create(nfeatures=200)
                ref = _keypoints(sift.detectAndCompute(gray, None)[0])
                if ref.count < 5:
                    continue
                shifted = _keypoints(sift.detectAndCompute(np.roll(gray, (1, 1), (0, 1)), None)[0])
                shifted = shifted._replace(pt=shifted.pt - 1.0)
                got, _ = detect_and_compute(rgb_to_gray(torch.from_numpy((im * 255).astype(np.uint8))), nfeatures=200)
                assert _agreement(got, ref) >= _agreement(shifted, ref), (oid, vid, im.shape)
                assert abs(got.count - ref.count) <= max(2, 0.05 * ref.count), (oid, vid, got.count, ref.count)


def test_ycbv_sift_helpers_bit_for_bit():
    """project_model_points, assign_matches (Hungarian with dustbin rows and
    columns, padding slots to the dustbin) and get_most_straight_features on
    injected arrays: equal to JAX's."""
    from ossid_code_tpu.data.ycbv_sift import YcbvObject as JO, YcbvSiftDataset as JD

    from ossid_code_torch.data.ycbv_sift import YcbvObject, YcbvSiftDataset

    rng = np.random.default_rng(11)
    cfg = {"n_kpts_obs": 40, "n_kpts_model": 30, "match_px_th": 4.0}
    jd, td = JD.__new__(JD), YcbvSiftDataset.__new__(YcbvSiftDataset)
    for ds in (jd, td):
        ds.match_px_th, ds.cfg = 4.0, cfg
    K = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]])
    pose = np.eye(4)
    pose[:3, 3] = [0.05, -0.02, 0.6]
    pts = rng.normal(0, 0.05, (30, 3))
    want_uv = JD.project_model_points(jd, pts, pose, K)
    assert np.array_equal(YcbvSiftDataset.project_model_points(td, pts, pose, K), want_uv)
    obs = np.concatenate([want_uv[:20] + rng.normal(0, 2.0, (20, 2)), rng.uniform(0, 640, (15, 2))])
    for no, nm in ((40, 30), (35, 30)):
        got, want = td.assign_matches(obs[:no], want_uv, 40, 30), jd.assign_matches(obs[:no], want_uv, 40, 30)
        assert got.dtype == want.dtype and np.array_equal(got, want) and want[:-1, :-1].sum() > 5
    assert np.array_equal(td.assign_matches(obs[:0], want_uv, 40, 30), jd.assign_matches(obs[:0], want_uv, 40, 30))
    jo, to = JO.__new__(JO), YcbvObject.__new__(YcbvObject)
    dirs = rng.normal(0, 1, (8, 3))
    for o in (jo, to):
        o.view_dirs = dirs / np.linalg.norm(dirs, axis=1, keepdims=True)
        o.kpt_view_ids = rng.integers(0, 8, 200) if o is jo else jo.kpt_view_ids
        o.descs = rng.uniform(0, 255, (200, 128)).astype(np.float32) if o is jo else jo.descs
        o.points_obj = rng.normal(0, 0.05, (200, 3)) if o is jo else jo.points_obj
    v = rng.normal(0, 1, 3)
    for a, b in zip(to.get_most_straight_features(v, 64), jo.get_most_straight_features(v, 64)):
        assert np.array_equal(a, b)
    assert np.array_equal(to.kpt_proj_grid_cos(), jo.kpt_proj_grid_cos())


def test_ycbv_sift_items_with_injected_features(world, sift_objects, monkeypatch):
    """YcbvSiftDataset's items from the same object grids and the same scene
    features (each package's featurize_scene replaced by one function):
    equal to JAX's, padding and GT matrices included; the search index
    finds each descriptor's own row."""
    import ossid_code_tpu.data.ycbv_sift as J
    from ossid_code_tpu.core.config import Config
    from ossid_code_tpu.data.bop import BopDataset as JBop, BopDatasetArgs as JArgs

    import ossid_code_torch.data.ycbv_sift as T
    from ossid_code_torch.data.bop import BopDataset, BopDatasetArgs

    objects, _ = sift_objects
    jobj = {oid: pair[0] for oid, pair in objects.items()}
    tobj = {oid: pair[1] for oid, pair in objects.items()}
    for oid in tobj:  # the same grid in both
        for k in ("descs", "points_obj", "kpt_view_ids"):
            setattr(tobj[oid], k, getattr(jobj[oid], k))

    def features(img, depth, mask, cam_K, max_kpts=500, device=None):
        rng = np.random.default_rng(int(np.asarray(img, np.int64).sum() % 1000))
        n = min(int(np.count_nonzero(mask)) // 4 + 3, max_kpts)
        uv = np.stack([rng.uniform(0, img.shape[1], n), rng.uniform(0, img.shape[0], n)], 1)
        return uv, rng.uniform(0, 200, (n, 128)).astype(np.float32), rng.normal(0, 0.1, (n, 3)) + [0, 0, 0.6]

    monkeypatch.setattr(J, "featurize_scene", features)
    monkeypatch.setattr(T, "featurize_scene", features)
    d = Config(n_kpts_obs=24, n_kpts_model=16, match_px_th=4.0)
    args = dict(bop_root=world, dataset_name="synth", split_name="bop_test", split="test")
    jd = J.YcbvSiftDataset(JBop(JArgs(**args)), jobj, d)
    td = T.YcbvSiftDataset(BopDataset(BopDatasetArgs(**args)), tobj, d, device="cpu")
    assert len(td) == len(jd) > 0
    for i in range(len(jd)):
        _hold_items(td[i], jd[i])
    descs = jobj[1].descs
    assert np.array_equal(T.create_search_index(descs).query(descs[:5])[1], np.arange(5))


# ------------------------------------------------------------- host utilities
def test_bilinear_sample_bit_for_bit():
    """bilinear_sample_nhwc at coordinates inside, on the last row and
    column, and outside: equal to JAX's."""
    import jax.numpy as jnp

    from ossid_code_tpu.ops.warp import bilinear_sample_nhwc as jsample

    from ossid_code_torch.ops.warp import bilinear_sample_nhwc

    rng = np.random.default_rng(12)
    img = rng.uniform(0, 1, (9, 13, 3)).astype(np.float32)
    u = np.concatenate([rng.uniform(-2, 15, 200), [0.0, 12.0, 12.0, -1e-3, 12.5]]).astype(np.float32)
    v = np.concatenate([rng.uniform(-2, 11, 200), [0.0, 8.0, 3.5, 4.0, 8.0]]).astype(np.float32)
    want = np.asarray(jsample(jnp.asarray(img), jnp.asarray(u), jnp.asarray(v)))
    got = bilinear_sample_nhwc(torch.from_numpy(img), torch.from_numpy(u), torch.from_numpy(v)).numpy()
    assert np.array_equal(got, want)


def test_warp_perspective_matches_jax():
    """warp_perspective by random homographies within WARP_TOL of JAX's."""
    import jax.numpy as jnp

    from ossid_code_tpu.ops.warp import warp_perspective as jwarp
    from ossid_code_tpu.utils.homographies import sample_homography

    from ossid_code_torch.ops.warp import warp_perspective

    rng = np.random.default_rng(13)
    img = rng.uniform(0, 1, (2, 24, 32, 3)).astype(np.float32)
    H = np.stack([sample_homography((24, 32), rng=np.random.default_rng(s)) for s in (1, 2)]).astype(np.float32)
    want = np.asarray(jwarp(jnp.asarray(img), jnp.asarray(H), out_hw=(20, 30)))
    got = warp_perspective(torch.from_numpy(img), torch.from_numpy(H), out_hw=(20, 30)).numpy()
    assert got.shape == want.shape and np.abs(got - want).max() <= WARP_TOL


@pytest.mark.parametrize("warp_3d", [False, True])
def test_homographies_random_keypoints_bit_for_bit(warp_3d):
    """sample_warp's random-keypoint branch (sample_homography or
    sample_trans_3d, cv2's getPerspectiveTransform and perspectiveTransform
    in numpy): keypoints, H, R and t equal to JAX's for the same rng."""
    from ossid_code_tpu.utils import homographies as J

    from ossid_code_torch.utils import homographies as T

    rng = np.random.default_rng(14)
    img = (rng.uniform(0, 1, (96, 128, 3)) * 255).astype(np.uint8)
    K = np.array([[200.0, 0, 64], [0, 200.0, 48], [0, 0, 1]])
    from ossid_code_tpu.utils.geometry import depth2xyz

    xyz = depth2xyz(np.full((96, 128), 0.7) + rng.uniform(0, 0.05, (96, 128)), K)
    for seed in range(4):
        want = J.sample_warp(img, xyz, K, n_kpts=64, warp_3d=warp_3d, rng=np.random.default_rng(seed))
        got = T.sample_warp(img, xyz, K, n_kpts=64, warp_3d=warp_3d, rng=np.random.default_rng(seed))
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    for seed in range(20):
        assert np.array_equal(T.sample_homography((24, 32), rng=np.random.default_rng(seed)),
                              J.sample_homography((24, 32), rng=np.random.default_rng(seed)))
    assert np.array_equal(T.proj_cloud(xyz[0], K), J.proj_cloud(xyz[0], K))


def test_homographies_sift_branch_where_keypoints_agree(sift_objects):
    """sample_warp's SIFT branch on a textured template: the port's keypoints
    in cv2's detect order; where they agree with cv2's (the same keypoints
    in the same order, within 1e-3 px: checked first), the sampled
    keypoints, H, R and t equal JAX's."""
    from ossid_code_tpu.utils import homographies as J

    from ossid_code_torch.utils import homographies as T

    _, tt = sift_objects
    img, xyz, _ = tt.getTemplate(1, tt.view_ids[0])
    u8 = (img * 255).astype(np.uint8)
    K = np.array([[300.0, 0, 64], [0, 300.0, 64], [0, 0, 1]])
    ref = cv2.SIFT_create().detect(cv2.cvtColor(u8, cv2.COLOR_RGB2GRAY), None)
    pts, resp = T._sift_keypoints(u8, "cpu")
    assert len(pts) == len(ref) and np.abs(pts - cv2.KeyPoint_convert(ref)).max() <= 1e-3
    assert np.allclose(resp, [k.response for k in ref], rtol=1e-4)
    for n_kpts in (8, 4 * len(ref)):
        want = J.sample_warp(u8, xyz, K, n_kpts=n_kpts, random_kpt=False, rng=np.random.default_rng(3))
        got = T.sample_warp(u8, xyz, K, n_kpts=n_kpts, random_kpt=False, rng=np.random.default_rng(3), device="cpu")
        for a, b in zip(got, want):
            assert np.array_equal(a, b)


def test_augmentation_and_sphere_sampling_bit_for_bit():
    """augment_depth_map under the same rng, the icosphere view directions
    and their rotations: equal to JAX's."""
    from ossid_code_tpu.utils import augmentation as JA, sphere_sampling as JS

    from ossid_code_torch.utils import augmentation as TA, sphere_sampling as TS

    rng = np.random.default_rng(15)
    depth = rng.uniform(0.3, 1.0, (40, 50))
    normals = rng.normal(0, 1, (40, 50, 3))
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    for seed in range(5):
        assert np.array_equal(TA.augment_depth_map(depth, normals, rng=np.random.default_rng(seed)),
                              JA.augment_depth_map(depth, normals, rng=np.random.default_rng(seed)))
    for subdiv, hemi in ((0, False), (1, True), (2, False)):
        dirs = TS.sample_points(subdiv, hemi)
        assert np.array_equal(dirs, JS.sample_points(subdiv, hemi))
        assert np.array_equal(TS.view_rotations(dirs), JS.view_rotations(dirs))
    for a, b in zip(TS.get_triangles(1), JS.get_triangles(1)):
        assert np.array_equal(a, b)
