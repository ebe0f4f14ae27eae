"""The port's BlenderProc render family (data/hdf5_render.py,
data/synthetic.py's render writers, scripts/index_render_dataset.py)
against the JAX package's, item by item, on the CPU.

The world: 6 sampled objects (4 train, 1 valid-unseen, 1 test, the
reference's split), 4 scenes of 128x160 and 6 template renders of 128x128
an object, written by the port's `make_render_world` once through the JAX
package's `make_blenderproc_hdf5` (h5py and the JAX rasterizer) and once
through its own (utils/hdf5.py); each family function runs on both worlds
in both packages. Tolerances: uint8 within 1 LSB and float within 1e-6 (the
port's resize_linear against cv2.resize); a template image within 1/255 +
1e-6 (its colours pass through a uint8 resize first); everything else
exactly.
"""

import json
import os

import h5py
import numpy as np
import pytest
import torch

from ossid_code_tpu.data import hdf5_render as J
from ossid_code_tpu.data import synthetic as jsyn

from ossid_code_torch.data import hdf5_render as T
from ossid_code_torch.data import synthetic as tsyn

torch.set_num_threads(2)

H, W = 128, 160
N_OBJECTS, N_SCENES, N_VIEWS = 6, 4, 6
FLOAT_TOL = 1e-6
TEMPLATE_TOL = 1 / 255 + 1e-6
TEMPLATE_KEYS = ("gimg", "limg")


def _close(got, want, what, tol=FLOAT_TOL):
    """Equal structure; float arrays within `tol` and uint8 arrays within
    1 LSB (exactly where `tol` is 0), anything else exactly."""
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            _close(got[k], want[k], f"{what}.{k}", TEMPLATE_TOL if k in TEMPLATE_KEYS else tol)
    elif isinstance(want, (list, tuple)) and not isinstance(want, str):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, f"{what}[{i}]", tol)
    elif isinstance(want, (np.ndarray, np.generic)):
        got = np.asarray(got)
        assert got.shape == want.shape and got.dtype == want.dtype, (what, got.shape, want.shape, got.dtype)
        if want.dtype == np.uint8:
            assert np.abs(got.astype(int) - want.astype(int)).max(initial=0) <= (1 if tol else 0), what
        elif want.dtype.kind == "f":
            np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=what)
        else:
            np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        assert got == want, what


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """{writer: (scenes_dir, grid_dir)}: the same world written through the
    JAX package's scene writer and through the port's."""
    root = tmp_path_factory.mktemp("render_worlds")
    objects = tsyn.sampled_objects(N_OBJECTS)
    out = {}
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(tsyn, "make_blenderproc_hdf5", jsyn.make_blenderproc_hdf5)
        out["jax"] = tsyn.make_render_world(str(root / "jax"), N_SCENES, N_VIEWS, objects=objects)
    finally:
        mp.undo()
    out["port"] = tsyn.make_render_world(str(root / "port"), N_SCENES, N_VIEWS, objects=objects)
    return out


def _scene_paths(scenes):
    return sorted(os.path.join(scenes, f) for f in os.listdir(scenes) if f.endswith(".hdf5"))


def _dataset_cfg(module, scenes):
    """The dataset group both packages' render datasets read, in the
    package's own Config."""
    from ossid_code_tpu.core.config import Config as JConfig

    from ossid_code_torch.core.config import Config as TConfig

    return (JConfig if module is J else TConfig)({
        "dataset_root": scenes, "shorter_length": H, "keep_aspect_ratio": True, "heatmap_var": 1.5,
        "heatmap_shorter_length": 7, "n_local_test": 3, "train_local_template_sample_from": 2, "k_support": 2,
        "crop": False, "augment_depth": True})


@pytest.mark.parametrize("case", [(10, 50, 20, 60), (-8, 30, -5, 25), (100, 140, 120, 170), (-3, 131, -2, 163)])
def test_robust_crop_matches_jax(case):
    """Rows first, zero padding outside the image, in and out of bounds."""
    from ossid_code_tpu.utils.geometry import robust_crop as jcrop

    from ossid_code_torch.utils.geometry import robust_crop

    img = np.random.default_rng(0).integers(0, 256, (H, W, 3), dtype=np.uint8)
    got, want = robust_crop(img, *case), jcrop(img, *case)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_make_render_world_matches_jax(tmp_path):
    """At equal seeds (the default 2 objects, where the port places objects
    as the JAX package does) the same files with equal arrays: the
    rasterizers agree exactly, the writers differ only in layout."""
    jsyn.make_render_world(str(tmp_path / "j"), n_scenes=2, n_grid_views=2, seed=3)
    tsyn.make_render_world(str(tmp_path / "t"), n_scenes=2, n_grid_views=2, seed=3)
    files = sorted(str(p.relative_to(tmp_path / "j")) for p in (tmp_path / "j").rglob("*") if p.is_file())
    assert files == sorted(str(p.relative_to(tmp_path / "t")) for p in (tmp_path / "t").rglob("*") if p.is_file())
    assert len(files) == 2 + 2 * 2 + 1
    for rel in files:
        if rel.endswith(".json"):
            assert (tmp_path / "j" / rel).read_text() == (tmp_path / "t" / rel).read_text()
            continue
        with h5py.File(tmp_path / "j" / rel, "r") as a, h5py.File(tmp_path / "t" / rel, "r") as b:
            assert sorted(a.keys()) == sorted(b.keys())
            for k in a.keys():
                assert a[k].dtype == b[k].dtype, (rel, k)
                np.testing.assert_array_equal(a[k][()], b[k][()], err_msg=f"{rel}:{k}")


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_load_hdf5_and_masks_match(writer, worlds):
    """Every scene and template render loads to the same arrays, JSON
    fields and object poses; every object's mask from the segmap is equal."""
    scenes, grid = worlds[writer]
    paths = _scene_paths(scenes) + [os.path.join(grid, o, f) for o in sorted(os.listdir(grid))
                                    for f in sorted(os.listdir(os.path.join(grid, o)))]
    assert len(paths) == N_SCENES + N_OBJECTS * N_VIEWS
    for p in paths:
        got, want = T.load_hdf5(p), J.load_hdf5(p)
        _close(got, want, p, tol=0.0)
        for obj in want["objects"]:
            m = J.object_mask_from_segmap(want["segmap"], want["segcolormap"], obj["obj_id"])
            assert m.any()
            np.testing.assert_array_equal(T.object_mask_from_segmap(got["segmap"], got["segcolormap"],
                                                                    obj["obj_id"]), m)
        assert T.object_mask_from_segmap(got["segmap"], got["segcolormap"], 99) is None


def test_load_hdf5_takes_string_scalars(tmp_path):
    """BlenderProc stores campose, segcolormap and object_states as np.bytes_
    scalars (|S<n>, shape ()); both packages parse them as they parse the
    uint8 arrays, from a gzip-chunked scene."""
    scene = tsyn.make_blenderproc_hdf5(str(tmp_path / "a.hdf5"), tsyn.default_objects(),
                                       {1: np.array([[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 0.5], [0, 0, 0, 1]])})
    with h5py.File(scene, "r") as f, h5py.File(str(tmp_path / "b.hdf5"), "w") as g:
        for k in f.keys():
            a = f[k][()]
            if a.dtype == np.uint8 and a.ndim == 1:
                g.create_dataset(k, data=np.bytes_(a.tobytes()))
            else:
                g.create_dataset(k, data=a, compression="gzip", chunks=True)
    got, want = T.load_hdf5(str(tmp_path / "b.hdf5")), J.load_hdf5(str(tmp_path / "b.hdf5"))
    _close(got, want, "bytes scene", tol=0.0)
    _close(got, T.load_hdf5(scene), "bytes against uint8 fields", tol=0.0)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_templates_match(writer, worlds):
    """process_render_grid of every render and RenderGridTemplates.get_all
    of every object (124x124 crops)."""
    _, grid = worlds[writer]
    for o in sorted(os.listdir(grid)):
        for f in sorted(os.listdir(os.path.join(grid, o))):
            p = os.path.join(grid, o, f)
            _close(T.process_render_grid(p, (124, 124)), J.process_render_grid(p, (124, 124)), p)
    tt, jt = T.RenderGridTemplates(grid), J.RenderGridTemplates(grid)
    for o in range(1, N_OBJECTS + 1):
        assert tt.paths(o) == jt.paths(o) and len(jt.paths(o)) == N_VIEWS
        got, want = tt.get_all(o), jt.get_all(o)
        assert got[0].shape == (N_VIEWS, 124, 124, 3)
        _close(dict(zip(("gimg", "xyz", "mask", "quat"), got)), dict(zip(("gimg", "xyz", "mask", "quat"), want)),
               f"object {o}")
        assert tt.get_all(o) is got


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("mode", ["train", "test"])
def test_dtoid_render_dataset_matches(writer, mode, worlds):
    """DtoidRenderDataset items with the same seed (depth augmentation, the
    global view, the closest-rotation local view in train mode, the
    n_local_test views in test mode)."""
    scenes, grid = worlds[writer]
    tds = T.DtoidRenderDataset(mode, _scene_paths(scenes), T.RenderGridTemplates(grid),
                               _dataset_cfg(T, scenes), seed=4)
    jds = J.DtoidRenderDataset(mode, _scene_paths(scenes), J.RenderGridTemplates(grid),
                               _dataset_cfg(J, scenes), seed=4)
    assert tds.datapoints == jds.datapoints and len(jds) == N_SCENES * N_OBJECTS
    for i in range(len(jds)):
        _close(tds[i], jds[i], f"{mode} item {i}")
    assert jds[0]["limg"].ndim == (3 if mode == "train" else 4)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_render_loaders_and_episodes_match(writer, worlds):
    """get_render_dataloaders' object and image splits (4/1/1 objects, 3/4
    of the train objects' images to train), and every episode of every
    split with its support views, batched by each package's NumpyLoader."""
    from ossid_code_tpu.core.config import default_config as jdefault

    from ossid_code_torch.core.config import default_config

    scenes, _ = worlds[writer]
    loaders = []
    for mod, cfg in ((T, default_config()), (J, jdefault())):
        cfg.dataset = _dataset_cfg(mod, scenes)
        cfg.train.batch_size = 2
        loaders.append(mod.get_render_dataloaders(cfg))
    (tt, tv, tte), (jt, jv, jte) = loaders
    pairs = [(tt, jt), (tv[0], jv[0]), (tv[1], jv[1]), (tte, jte)]
    assert [len(j.dataset) for _, j in pairs] == [4 * 3, 1 * N_SCENES, 4 * 1, 1 * N_SCENES]
    for t, j in pairs:
        assert t.dataset.datapoints == j.dataset.datapoints and len(t) == len(j)
    for t, j in pairs[1:]:
        for i, (bt, bj) in enumerate(zip(t, j)):
            _close(bt, bj, f"batch {i}")
    assert jv[0].dataset[0]["simg"].shape == (2, H, W, 3)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_index_render_dataset_matches(writer, worlds, tmp_path):
    """The object -> scenes index at two pixel thresholds, and the script's
    object2files.json."""
    from ossid_code_tpu.scripts.index_render_dataset import index_render_dataset as jindex

    from ossid_code_torch.scripts.index_render_dataset import index_render_dataset, main

    scenes, _ = worlds[writer]
    for min_pixels in (1, 450):
        want = jindex(scenes, min_pixels)
        assert index_render_dataset(scenes, min_pixels) == want
    assert len(jindex(scenes, 1)) == N_OBJECTS and jindex(scenes, 450) != jindex(scenes, 1)
    for f in os.listdir(scenes):
        if f.endswith(".hdf5"):
            os.link(os.path.join(scenes, f), tmp_path / f)
    main(["--dataset_root", str(tmp_path), "--min_pixels", "1"])
    with open(tmp_path / "object2files.json") as f:
        assert json.load(f) == jindex(scenes, 1)
