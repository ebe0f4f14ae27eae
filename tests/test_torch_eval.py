"""The port's BOP evaluator (eval/bop_ar.py) against the JAX package's, on
the CPU: the same result rows on one synthetic world, whose models_info
declares a discrete symmetry for object 1 and a continuous one for object 2,
give the same AR, VSD, MSSD and MSPD to 1e-6; the analytic golden cases of
tests/test_bop_ar.py hold for the port's functions.
"""

import json
import os
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from ossid_code_torch.eval import bop_ar as tar

torch.set_num_threads(2)

TOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def jax_native_libraries():
    """The JAX package's rasterizer from native/ (built as its own tests
    build it); without it JAX renders VSD's depths in numpy."""
    subprocess.run(["make", "-C", str(Path(__file__).resolve().parents[1] / "native"), "-s"], check=True)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    from ossid_code_tpu.data.synthetic import make_synthetic_bop

    root = str(tmp_path_factory.mktemp("evalworld"))
    make_synthetic_bop(root, n_frames=3, img_h=120, img_w=160)
    path = os.path.join(root, "synth", "models", "models_info.json")
    with open(path) as f:
        info = json.load(f)
    flip = np.eye(4)
    flip[0, 0] = flip[1, 1] = -1.0
    info["1"]["symmetries_discrete"] = [list(flip.reshape(-1))]
    info["2"]["symmetries_continuous"] = [{"axis": [0, 0, 1], "offset": [0, 0, 0]}]
    with open(path, "w") as f:
        json.dump(info, f)
    return root


def _rows(bop):
    """Per target: GT, GT turned by its declared symmetry (object 2 by 32
    steps of the continuous symmetry's discretisation, 2 pi / 315), a few-mm
    shift, a small rotation, a gross error."""
    rng = np.random.default_rng(0)
    rows = []
    for t in bop.targets:
        gt = np.asarray(bop.getDataByIds(t["obj_id"], t["scene_id"], t["im_id"])["mat_gt"], np.float64)
        turned = gt.copy()
        turned[:3, :3] = gt[:3, :3] @ Rotation.from_euler(
            "z", np.pi if t["obj_id"] == 1 else 32 * 2 * np.pi / 315).as_matrix()
        shift = gt.copy()
        shift[:3, 3] += rng.normal(0, 0.004, 3)
        rot = gt.copy()
        rot[:3, :3] = Rotation.from_rotvec(rng.normal(0, 0.08, 3)).as_matrix() @ gt[:3, :3]
        gross = gt.copy()
        gross[:3, 3] += [0.15, 0.1, 0.2]
        rows += [{**t, "pred_pose": p} for p in (gt, turned, shift, rot, gross)]
    return rows


def test_bop_evaluator_matches_jax(world):
    from ossid_code_tpu.data.bop import BopDataset, BopDatasetArgs
    from ossid_code_tpu.eval.bop_ar import BopEvaluator
    from ossid_code_tpu.render.rasterizer import _load_raster_lib

    from ossid_code_torch.data.bop import BopDataset as TBopDataset
    from ossid_code_torch.data.bop import BopDatasetArgs as TBopDatasetArgs

    assert _load_raster_lib() is not None
    jbop = BopDataset(BopDatasetArgs(bop_root=world, dataset_name="synth"))
    tbop = TBopDataset(TBopDatasetArgs(bop_root=world, dataset_name="synth"))
    assert sorted(tbop.sym_obj_ids) == sorted(jbop.sym_obj_ids) == [1, 2]
    rows = _rows(jbop)
    want = BopEvaluator(jbop).evaluate(rows)
    got = tar.BopEvaluator(tbop).evaluate(rows)
    for k in ("AR", "AR_vsd", "AR_mssd", "AR_mspd"):
        assert abs(got[k] - want[k]) <= TOL, k
    for g, w in zip(got["per_image"], want["per_image"]):
        for k in ("e_vsd", "e_mssd", "e_mspd"):
            assert abs(g[k] - w[k]) <= TOL * max(1.0, abs(w[k])), (k, g, w)
    # the symmetric turns score as the GT does, and the rows span the range
    assert 0.2 < got["AR"] < 0.95
    per = got["per_image"]
    for i in range(0, len(per), 5):
        assert per[i + 1]["e_mssd"] < 1e-6 and per[i + 1]["e_mspd"] < 1e-3


def test_symmetry_transforms_match_jax():
    from ossid_code_tpu.eval.bop_ar import symmetry_transforms

    flip = np.eye(4)
    flip[0, 0] = flip[1, 1] = -1.0
    info = {"diameter": 100.0, "symmetries_discrete": [list(flip.reshape(-1))],
            "symmetries_continuous": [{"axis": [0, 1, 1], "offset": [10.0, 0, 0]}]}
    for step in (0.01, 0.1):
        want = symmetry_transforms(info, max_sym_disc_step=step)
        got = tar.symmetry_transforms(info, max_sym_disc_step=step)
        assert len(got) == len(want) == 2 * int(np.ceil(np.pi / step))
        np.testing.assert_array_equal(np.stack(got), np.stack(want))


def test_mssd_mspd_golden_values():
    """A pure translation moves every surface point by |t| (MSSD = |t|); an
    x-shift of a planar object at depth Z moves its projection by f dx / Z."""
    rng = np.random.default_rng(1)
    pts = rng.normal(0, 0.04, (64, 3))
    pose_gt = np.eye(4)
    pose_gt[2, 3] = 0.5
    pose_est = pose_gt.copy()
    pose_est[:3, 3] += [0.003, -0.004, 0.012]
    assert abs(tar.mssd(pose_est, pose_gt, pts, [np.eye(4)]) - 0.013) < 1e-12
    planar = pts.copy()
    planar[:, 2] = 0.0
    K = np.array([[250.0, 0, 80], [0, 250.0, 60], [0, 0, 1]])
    pose_est = pose_gt.copy()
    pose_est[0, 3] += 0.02
    assert abs(tar.mspd(pose_est, pose_gt, planar, [np.eye(4)], K) - 250.0 * 0.02 / 0.5) < 1e-9
    sym = np.eye(4)
    sym[:3, :3] = Rotation.from_euler("z", 180, degrees=True).as_matrix()
    assert tar.mssd(pose_gt @ sym, pose_gt, pts, [np.eye(4)]) > 0.01
    assert tar.mssd(pose_gt @ sym, pose_gt, pts, [np.eye(4), sym]) < 1e-9


def test_vsd_golden_values():
    """Exact pose -> 0; disjoint silhouettes -> 1; half overlap at equal depth
    -> 2/3; behind by dz -> 1 where tau * diameter < dz."""
    from ossid_code_torch.render.mesh import Mesh
    from ossid_code_torch.render.rasterizer import render_depth_native

    s = 0.05
    mesh = Mesh(np.array([[-s, -s, 0], [s, -s, 0], [s, s, 0], [-s, s, 0]]) * 1000.0, np.array([[0, 1, 2], [0, 2, 3]]))
    diam = float(np.sqrt(2) * 2 * s)
    K = np.array([[200.0, 0, 80], [0, 200.0, 60], [0, 0, 1]])
    pose_gt = np.eye(4)
    pose_gt[2, 3] = 0.4
    d_test = render_depth_native(mesh.vertices / 1000.0, mesh.faces, K, pose_gt, 120, 160)
    np.testing.assert_allclose(tar.vsd(pose_gt, pose_gt, d_test, K, mesh, diam), 0.0, atol=1e-9)
    for dx, want in ((0.15, 1.0), (0.05, 2.0 / 3.0)):
        est = pose_gt.copy()
        est[0, 3] += dx
        np.testing.assert_allclose(tar.vsd(est, pose_gt, d_test, K, mesh, diam), want, atol=0.02)
    behind = pose_gt.copy()
    behind[2, 3] += 0.04
    errs = tar.vsd(behind, pose_gt, d_test, K, mesh, diam)
    fail = tar.VSD_TAUS * diam < 0.04
    assert fail.sum() == 5 and (errs[fail] > 0.95).all()


def test_visib_mask_est_matches_jax():
    from ossid_code_tpu.render.visib import estimate_visib_mask_est, estimate_visib_mask_gt

    from ossid_code_torch.render import visib as tvisib

    rng = np.random.default_rng(2)
    d_test = np.where(rng.uniform(0, 1, (40, 50)) > 0.1, rng.uniform(0.3, 0.6, (40, 50)), 0.0).astype(np.float32)
    d_gt = np.where(rng.uniform(0, 1, (40, 50)) > 0.4, rng.uniform(0.3, 0.6, (40, 50)), 0.0).astype(np.float32)
    d_est = np.where(rng.uniform(0, 1, (40, 50)) > 0.4, rng.uniform(0.3, 0.6, (40, 50)), 0.0).astype(np.float32)
    vg = estimate_visib_mask_gt(d_test, d_gt, 0.015)
    np.testing.assert_array_equal(tvisib.estimate_visib_mask_gt(d_test, d_gt, 0.015), vg)
    np.testing.assert_array_equal(tvisib.estimate_visib_mask_est(d_test, d_est, vg, 0.015),
                                  estimate_visib_mask_est(d_test, d_est, vg, 0.015))
