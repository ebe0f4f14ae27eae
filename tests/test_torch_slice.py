"""The port's serving slice end to end against the JAX package, on the CPU,
plus the port's hygiene rules.

One random scene goes through DTOID detection, then FakeHypoGen around the
winning box, then Zephyr scoring, in both packages, with the same weights.
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from ossid_code_torch.core.config import default_config as t_default_config
from ossid_code_torch.hypo.fake import FakeHypoGen as TFakeHypoGen
from ossid_code_torch.models.dtoid.jax_import import dtoid_from_jax
from ossid_code_torch.models.dtoid.module import DtoidModel as TDtoidModel
from ossid_code_torch.models.zephyr.jax_import import pointnet2_from_jax
from ossid_code_torch.models.zephyr.module import ZephyrModel as TZephyrModel

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
H, W, T = 128, 160, 3


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), jax.device_get(tree))


def _scene(rng):
    fx = 150.0
    k = np.array([[fx, 0, W / 2], [0, fx, H / 2], [0, 0, 1]], np.float32)
    pts = rng.normal(0, 0.04, (400, 3)).astype(np.float32)
    nrm = rng.normal(0, 1, (400, 3))
    return {
        "img": rng.integers(0, 256, (H, W, 3), dtype=np.uint8),
        "depth": (rng.uniform(0.7, 1.1, (H, W)) * 1000).astype(np.uint16),
        "cam_K": k,
        "model_points": pts,
        "model_colors": rng.uniform(0, 1, (400, 3)).astype(np.float32),
        "model_normals": (nrm / np.linalg.norm(nrm, axis=1, keepdims=True)).astype(np.float32),
        "limg": rng.uniform(0, 1, (T, 124, 124, 3)).astype(np.float32),
        "lmask": (rng.uniform(0, 1, (T, 124, 124)) > 0.4).astype(np.float32),
        "obj_id": 5,
    }


def _serve(dtoid, zephyr, gen_cls, scene):
    """detect -> hypotheses around the top box at 0.9 m -> score."""
    det = dtoid.forward_test_time(scene)
    x1, y1, x2, y2 = det["pred_bbox"][0]
    k = scene["cam_K"]
    z = 0.9
    anchor = np.eye(4)
    anchor[:3, 3] = ((x1 + x2) / 2 - k[0, 2]) * z / k[0, 0], ((y1 + y2) / 2 - k[1, 2]) * z / k[1, 1], z
    gen = gen_cls(n_hypos=40, seed=6)
    gen.set_anchor(anchor)
    poses, _, _ = gen.find_surface_model(np.zeros((0, 3)))
    scored = zephyr.score_hypotheses(dict(scene, pose_hypos=poses), obj_id=scene["obj_id"])
    return det, poses, scored


def test_serving_slice_matches_jax():
    from ossid_code_tpu.core.config import default_config
    from ossid_code_tpu.hypo.fake import FakeHypoGen
    from ossid_code_tpu.models.dtoid.module import DtoidModel
    from ossid_code_tpu.models.zephyr.module import ZephyrModel

    jcfg, tcfg = default_config(), t_default_config()
    for cfg in (jcfg, tcfg):
        cfg.model.img_h, cfg.model.img_w = H, W
        cfg.model.densenet_blocks = (2, 2, 2)
    rng = np.random.default_rng(60)
    jd = DtoidModel(jcfg, seed=1)
    params = _np_tree(jd.params)
    for head, std in (("classification", 0.05), ("regression", 0.01)):
        node = params[head]["output"]
        node["kernel"] = rng.normal(0, std, node["kernel"].shape).astype(np.float32)
    stats = _np_tree(jd.batch_stats)
    jd.load_state_dict({"params": params, "batch_stats": stats})
    td = TDtoidModel(tcfg, seed=1, device="cpu")
    td.load_state_dict(dtoid_from_jax(params, stats))

    jz = ZephyrModel(num_points=128, seed=2, need_uv=False)
    tz = TZephyrModel(num_points=128, seed=2, need_uv=False, device="cpu")
    tz.load_state_dict(pointnet2_from_jax(_np_tree(jz.params), _np_tree(jz.batch_stats)))

    scene = _scene(rng)
    jdet, jposes, jscore = _serve(jd, jz, FakeHypoGen, scene)
    tdet, tposes, tscore = _serve(td, tz, TFakeHypoGen, scene)

    assert tdet["valid"].sum() == jdet["valid"].sum()
    np.testing.assert_allclose(tdet["pred_scores"][:1], jdet["pred_scores"][:1], atol=1e-4)
    np.testing.assert_allclose(tdet["pred_bbox"][0], jdet["pred_bbox"][0], atol=2e-2)
    np.testing.assert_allclose(tdet["heat_map"], jdet["heat_map"], rtol=2e-3, atol=1e-3)
    np.testing.assert_allclose(tposes, jposes, atol=1e-4)
    np.testing.assert_allclose(tscore["scores"], jscore["scores"], rtol=2e-4, atol=2e-4)
    assert tscore["pred_idx"] == jscore["pred_idx"]


# JAX and the JAX package, and the image, table and log libraries the card's
# machine lacks
_BANNED = {"jax", "jaxlib", "flax", "optax", "ossid_code_tpu", "cv2", "imageio", "PIL", "pandas", "matplotlib",
           "torchvision", "h5py", "tensorboard"}


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


_PORT_FILES = sorted(
    str(p.relative_to(ROOT)) for p in [*(ROOT / "ossid_code_torch").rglob("*.py"), ROOT / "chip_smoke.py"])


@pytest.mark.parametrize("rel", _PORT_FILES)
def test_port_imports_nothing_of_jax(rel):
    bad = [m for m in _imports(ROOT / rel) if m.split(".")[0] in _BANNED]
    assert not bad, f"{rel} imports {bad}"


def test_import_scan_covers_the_training_and_script_modules():
    """The scan above reaches the trainers, the demo script, the CLI and the
    modules they brought (SIFT among them: no cv2), and the legacy
    families' models, data and host utilities (JPEG: no imageio or PIL),
    the figures (no matplotlib), the render family (HDF5: no h5py), and
    the scale-out modules (the mesh, the launcher, the multi-stream loop,
    global-batch BatchNorm), and the measuring tools (profiling, probes, the
    log readers and their event-file reader: no pandas, no tensorboard;
    the roofline and the A/B scripts)."""
    for rel in ("ossid_code_torch/train/offline.py", "ossid_code_torch/train/zephyr_offline.py",
                "ossid_code_torch/scripts/demo_e2e.py", "ossid_code_torch/core/checkpoint.py",
                "ossid_code_torch/eval/bop_ar.py", "ossid_code_torch/hypo/icp.py",
                "ossid_code_torch/ops/pointcloud.py", "ossid_code_torch/scripts/online_learning.py",
                "ossid_code_torch/ops/sift.py", "ossid_code_torch/hypo/sift.py",
                "ossid_code_torch/eval/bop_csv.py", "ossid_code_torch/eval/detection_map.py",
                "ossid_code_torch/models/fewshot_seg.py", "ossid_code_torch/models/matcher.py",
                "ossid_code_torch/models/layers.py", "ossid_code_torch/models/jax_import.py",
                "ossid_code_torch/models/dtoid/wrapper.py", "ossid_code_torch/data/fewshot.py",
                "ossid_code_torch/data/ycbv_sift.py", "ossid_code_torch/utils/jpeg.py",
                "ossid_code_torch/utils/metrics.py", "ossid_code_torch/utils/homographies.py",
                "ossid_code_torch/utils/augmentation.py", "ossid_code_torch/utils/sphere_sampling.py",
                "ossid_code_torch/ops/warp.py", "ossid_code_torch/utils/vis.py", "ossid_code_torch/utils/hdf5.py",
                "ossid_code_torch/data/hdf5_render.py", "ossid_code_torch/scripts/index_render_dataset.py",
                "ossid_code_torch/parallel/mesh.py", "ossid_code_torch/parallel/launch.py",
                "ossid_code_torch/parallel/__init__.py", "ossid_code_torch/loop/multi_stream.py",
                "ossid_code_torch/models/batchnorm.py", "ossid_code_torch/utils/profiling.py",
                "ossid_code_torch/utils/probe.py", "ossid_code_torch/utils/timing.py",
                "ossid_code_torch/utils/logging.py", "ossid_code_torch/utils/event_file.py",
                "ossid_code_torch/scripts/roofline.py", "ossid_code_torch/scripts/ab_templates.py",
                "ossid_code_torch/scripts/ab_scorer.py", "ossid_code_torch/scripts/ab_finetune.py",
                "ossid_code_torch/scripts/ab_rank_blend.py", "ossid_code_torch/scripts/file_copy.py"):
        assert rel in _PORT_FILES, rel


def test_entry_points_raise_without_cuda():
    """device=None means cuda; without CUDA the entry points raise instead of
    falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: nothing to refuse")
    from ossid_code_torch import resolve_device

    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    cfg = t_default_config()
    cfg.model.img_h, cfg.model.img_w, cfg.model.densenet_blocks = 64, 64, (1, 1, 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        TDtoidModel(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        TZephyrModel(num_points=64)
    from ossid_code_torch.models.dtoid.wrapper import DTOIDWrapper
    from ossid_code_torch.models.fewshot_seg import FewshotSegModel
    from ossid_code_torch.models.matcher import SiftMatcher

    legacy = t_default_config().merged({"model": {"width": 8, "dim": 16, "n_layers": 1}, "dataset": {"n_kpts": 8}})
    with pytest.raises(RuntimeError, match="CUDA"):
        FewshotSegModel(legacy)
    with pytest.raises(RuntimeError, match="CUDA"):
        SiftMatcher(legacy)
    with pytest.raises(RuntimeError, match="CUDA"):
        DTOIDWrapper(None, str(ROOT), [], cfg=cfg)
    assert resolve_device("cpu").type == "cpu"


def test_config_is_a_copy(tmp_path):
    """The port's Config and DTOID model defaults equal the JAX package's:
    attribute access, nesting, merge and the YAML round trip. The port's
    model group names the two bf16 switches that the JAX package reads with
    `m.get(..., False)`, at that default."""
    from ossid_code_tpu.core.config import Config, default_config

    from ossid_code_torch.core.config import Config as TConfig

    bf16 = ("bf16_finetune", "bf16_infer")
    tmodel, jmodel = t_default_config().model, default_config().model
    assert {k: v for k, v in tmodel.items() if k not in bf16} == jmodel
    assert all(tmodel[k] is jmodel.get(k, False) is False for k in bf16)
    over = {"model": {"img_h": 128, "densenet_blocks": [2, 2, 2]}, "seed": 3}
    jm = Config(model=dict(default_config().model, **{k: False for k in bf16})).merged(over)
    tm = TConfig(model=dict(t_default_config().model)).merged(over)
    assert tm == jm and tm.model.img_h == 128 and isinstance(tm.model, TConfig)
    tm.save(str(tmp_path / "t.yaml"))
    jm.save(str(tmp_path / "j.yaml"))
    assert (tmp_path / "t.yaml").read_text() == (tmp_path / "j.yaml").read_text()
    assert TConfig.load(str(tmp_path / "t.yaml")).to_dict() == Config.load(str(tmp_path / "j.yaml")).to_dict()
