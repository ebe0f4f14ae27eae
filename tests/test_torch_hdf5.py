"""The port's HDF5 reader and writer (ossid_code_torch/utils/hdf5.py)
against h5py, on the CPU: h5py's files read back equal, with equal dtypes,
over dtypes, shapes, layouts and filters; h5py reads the writer's files
equal; what the reader does not take raises, naming the file."""

import os

import h5py
import numpy as np
import pytest
import torch

from ossid_code_torch.utils import hdf5

torch.set_num_threads(2)

DTYPES = ["uint8", "int16", "uint16", "int32", "float32", "float64"]
SHAPES = {"scalar": (), "1d": (37,), "3d": (19, 23, 3)}
# (h5py create_dataset keywords, or None for contiguous): gzip at two levels,
# with and without shuffle, chunk shapes that do not divide the arrays
STORAGE = {
    "contiguous": None,
    "gzip1": {"compression": "gzip", "compression_opts": 1, "chunks": {1: (10,), 3: (7, 10, 2)}},
    "gzip9_shuffle": {"compression": "gzip", "compression_opts": 9, "shuffle": True,
                      "chunks": {1: (16,), 3: (8, 6, 3)}},
    "gzip4_shuffle_auto": {"compression": "gzip", "compression_opts": 4, "shuffle": True, "chunks": True},
}


def _array(dtype, shape, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.normal(0, 1000, shape)
    info = np.iinfo(dtype) if np.dtype(dtype).kind in "iu" else None
    return (np.clip(a, info.min, info.max) if info else a).astype(dtype)


def _cases():
    for dtype in DTYPES:
        for sname, shape in SHAPES.items():
            for storage in STORAGE:
                if storage == "contiguous" or shape:   # h5py chunks no scalar
                    yield dtype, sname, storage


@pytest.mark.parametrize("dtype, shape, storage", list(_cases()))
def test_reads_h5py_files(dtype, shape, storage, tmp_path):
    """Every case reads back equal with h5py's dtype and shape, beside a
    fixed-length string scalar (BlenderProc's JSON fields)."""
    a = _array(dtype, SHAPES[shape])
    path = str(tmp_path / "a.h5")
    text = b'[{"cam_K": [1.5, 0, 2]}]'
    with h5py.File(path, "w") as f:
        kw = dict(STORAGE[storage] or {})
        if isinstance(kw.get("chunks"), dict):
            kw["chunks"] = kw["chunks"][a.ndim]
        f.create_dataset("x", data=a, **kw)
        f.create_dataset("campose", data=np.bytes_(text))
    with hdf5.File(path) as f:
        assert sorted(f.keys()) == ["campose", "x"] and "x" in f and "y" not in f
        got = f["x"]
        s = f["campose"]
    with h5py.File(path, "r") as f:
        want = f["x"][()]
        assert (f["x"].chunks is None) == (storage == "contiguous")
    assert got.dtype == np.asarray(want).dtype and got.shape == np.shape(want)
    np.testing.assert_array_equal(got, want)
    assert s.dtype == np.dtype(f"S{len(text)}") and s.shape == () and s.tobytes() == text


def test_reads_fill_value_multilevel_index_and_continuations(tmp_path):
    """Unallocated chunks read as the fill value; 2000 chunks need a
    B-tree of two levels; 40 attributes push a header into continuation
    blocks."""
    path = str(tmp_path / "a.h5")
    big = np.arange(200_000, dtype=np.int32).reshape(400, 500)
    with h5py.File(path, "w") as f:
        ds = f.create_dataset("partial", shape=(10, 11), dtype="f4", chunks=(4, 4), fillvalue=7.5,
                              compression="gzip")
        ds[:4, :4] = 1.0
        f.create_dataset("unwritten", shape=(5,), dtype="i2", fillvalue=-3)
        f.create_dataset("big", data=big, chunks=(10, 10), compression="gzip", shuffle=True)
        attrs = f.create_dataset("attrs", data=np.arange(10.0)).attrs
        for i in range(40):
            attrs[f"a{i}"] = np.arange(i + 5)
        f.attrs["note"] = "x" * 300
        want = {k: f[k][()] for k in f.keys()}
    with hdf5.File(path) as f:
        for k, v in want.items():
            np.testing.assert_array_equal(f[k], v, err_msg=k)
            assert f[k].dtype == v.dtype
    assert want["partial"][9, 9] == 7.5 and (want["unwritten"] == -3).all()


def test_writer_files_open_in_h5py(tmp_path):
    """The writer's files (the render scene's fields, other dtypes, an empty
    array, 20 names over one symbol-table node) read equal in h5py and in
    the reader."""
    rng = np.random.default_rng(1)
    datasets = {
        "colors": rng.integers(0, 256, (48, 64, 3), dtype=np.uint8),
        "depth": rng.random((48, 64)).astype(np.float32),
        "segmap": rng.integers(0, 7, (48, 64, 2)).astype(np.int32),
        "normals": rng.random((48, 64, 3)).astype(np.float32),
        "campose": np.frombuffer(b'[{"cam2world_matrix": [[1, 0], [0, 1]]}]', np.uint8),
        "object_states": np.bytes_('[{"name": "obj_000001"}]'),
        "f64": rng.random(5), "i16": np.arange(-5, 5, dtype=np.int16), "u16": np.arange(9, dtype=np.uint16),
        "scalar": np.float64(2.5), "empty": np.zeros((0, 3), np.float32),
        **{f"n{i:02d}": np.arange(i, dtype=np.int64) for i in range(13)},
    }
    path = str(tmp_path / "w.h5")
    hdf5.write(path, datasets)
    with h5py.File(path, "r") as f:
        assert sorted(f.keys()) == sorted(datasets)
        for k, v in datasets.items():
            got = f[k][()]
            assert np.asarray(got).dtype == np.asarray(v).dtype and np.shape(got) == np.shape(v), k
            np.testing.assert_array_equal(got, v, err_msg=k)
    with hdf5.File(path) as f:
        for k, v in datasets.items():
            assert f[k].dtype == np.asarray(v).dtype
            np.testing.assert_array_equal(f[k], v, err_msg=k)


@pytest.mark.parametrize("feature, match", [("lzf", "lzf filter"), ("vlen", "variable-length"),
                                            ("group", "nested group"), ("latest", "superblock version")])
def test_unsupported_features_raise(feature, match, tmp_path):
    """lzf compression, a variable-length string, a nested group and h5py's
    libver='latest' file raise ValueError naming the file and the feature."""
    path = str(tmp_path / f"{feature}.h5")
    with h5py.File(path, "w", **({"libver": "latest"} if feature == "latest" else {})) as f:
        if feature == "lzf":
            f.create_dataset("x", data=np.arange(100), compression="lzf")
        elif feature == "vlen":
            f.create_dataset("x", data="a python str is stored variable-length")
        elif feature == "group":
            f.create_group("g").create_dataset("x", data=np.arange(3))
        else:
            f.create_dataset("x", data=np.arange(3))
    with pytest.raises(ValueError, match=match) as err:
        hdf5.File(path)
    assert path in str(err.value)


def test_not_hdf5_raises(tmp_path):
    path = str(tmp_path / "x.h5")
    with open(path, "wb") as f:
        f.write(os.urandom(200))
    with pytest.raises(ValueError, match="not an HDF5 file"):
        hdf5.File(path)
