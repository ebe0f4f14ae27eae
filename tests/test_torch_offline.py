"""The port's offline DTOID trainer and checkpoints against the JAX
package's, on the CPU: OfflineTrainer steps against JAX's
`OfflineTrainer(n_devices=1)` (128x160, DenseNet (2, 2, 2), batch 2), the
multistep schedule and the decay-then-amsgrad order against optax, the
checkpoint round trips (port -> port, JAX pickle -> port, port file -> JAX
`load_checkpoint`), and a resume from `restore_trainer_state`.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ossid_code_torch.core.checkpoint import load_checkpoint, save_checkpoint
from ossid_code_torch.core.config import default_config as t_default_config
from ossid_code_torch.models.dtoid.jax_import import dtoid_from_jax, dtoid_to_jax
from ossid_code_torch.models.dtoid.module import DtoidModel as TDtoidModel
from ossid_code_torch.train.offline import OfflineTrainer as TOfflineTrainer
from ossid_code_torch.train.offline import make_multistep_schedule
from test_torch_loop import fresh_model

torch.set_num_threads(2)

H, W, B = 128, 160, 2
REL = 1e-4


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), jax.device_get(tree))


def _annotations(rng, b, g, n_valid):
    ann = np.full((b, g, 5), -1.0, np.float32)
    for i in range(b):
        for j in range(n_valid[i]):
            x1, y1 = rng.uniform(0, W - 40), rng.uniform(0, H - 40)
            ann[i, j] = [x1, y1, x1 + rng.uniform(16, 40), y1 + rng.uniform(16, 40), rng.integers(0, 2)]
    return ann


def _batch(rng):
    """tests/test_torch_train.py's batches, drawn in the same order."""
    return {
        "img": rng.uniform(0, 1, (B, H, W, 3)).astype(np.float32),
        "limg": rng.uniform(0, 1, (B, 124, 124, 3)).astype(np.float32),
        "lmask": (rng.uniform(0, 1, (B, 124, 124, 1)) > 0.4).astype(np.float32),
        "gimg": rng.uniform(0, 1, (B, 124, 124, 3)).astype(np.float32),
        "gmask": (rng.uniform(0, 1, (B, 124, 124, 1)) > 0.4).astype(np.float32),
        "bbox_gt": _annotations(rng, B, 1, [1, 1]),
        "heatmap": rng.uniform(0, 1, (B, H // 16 - 1, W // 16 - 1, 1)).astype(np.float32),
        "mask": (rng.uniform(0, 1, (B, H, W, 1)) > 0.7).astype(np.float32),
    }


def _close_rel(got, want, rel, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{what}: max abs err {err:.3g} > {rel} x {scale:.3g}"


@pytest.fixture(scope="module")
def models():
    """Configs at lr 1e-5 and one set of weights (output convs and
    BatchNorm statistics moved off their init), as tests/test_torch_train.py
    sets them up."""
    from ossid_code_tpu.core.config import default_config
    from ossid_code_tpu.models.dtoid.module import DtoidModel

    jcfg, tcfg = default_config(), t_default_config()
    for cfg in (jcfg, tcfg):
        cfg.model.img_h, cfg.model.img_w = H, W
        cfg.model.densenet_blocks = (2, 2, 2)
        cfg.model.learning_rate = 1e-5
        cfg.train.batch_size = B
    rng = np.random.default_rng(3)
    jd = DtoidModel(jcfg, seed=1)
    params = _np_tree(jd.params)
    for head, std in (("classification", 0.05), ("regression", 0.01)):
        node = params[head]["output"]
        node["kernel"] = rng.normal(0, std, node["kernel"].shape).astype(np.float32)
    stats = jax.tree_util.tree_map(
        lambda a: (a + rng.uniform(0.5, 1.5, a.shape)).astype(np.float32), _np_tree(jd.batch_stats))
    return jcfg, tcfg, params, stats, jd


def test_offline_trainer_steps_match_jax(models):
    """Three one-batch epochs on each side from the same weights, held to
    tests/test_torch_train.py::test_train_steps_match_jax's limits: the
    first step's losses and statistics within 1e-4, later losses 3e-3,
    statistics 5e-3 after the third, parameters at most 2 lr a step apart
    and within 1e-4 of their leaf's largest magnitude on all but 0.5% of the
    elements. The finetune optimizer of the port's model is left untouched."""
    from ossid_code_tpu.train.offline import OfflineTrainer

    jcfg, tcfg, params, stats, jd = models
    jd.load_state_dict({"params": params, "batch_stats": stats})
    td = fresh_model(TDtoidModel, tcfg, seed=1, device="cpu")
    td.load_state_dict(dtoid_from_jax(params, stats))
    jt, tt = OfflineTrainer(jd, jcfg, n_devices=1), TOfflineTrainer(td, tcfg, n_devices=1)
    rng = np.random.default_rng(4)
    for step in range(3):
        batch = _batch(rng)
        jm, tm = jt.train_epoch([batch]), tt.train_epoch([batch])
        assert set(jm) == set(tm)
        for k in jm:
            _close_rel(tm[k], jm[k], REL if step == 0 else 30 * REL, f"step {step} {k}")
        if step == 0:
            for w, g in zip(jax.tree_util.tree_leaves(_np_tree(jd.batch_stats)),
                            jax.tree_util.tree_leaves(dtoid_to_jax(td.state_dict())[1])):
                _close_rel(g, w, REL, "statistics after step 1")
    for w, g in zip(jax.tree_util.tree_leaves(_np_tree(jd.batch_stats)),
                    jax.tree_util.tree_leaves(dtoid_to_jax(td.state_dict())[1])):
        _close_rel(g, w, 50 * REL, "statistics after step 3")
    lr = tcfg.model.learning_rate
    n_far = n_all = 0
    for w, g in zip(jax.tree_util.tree_leaves(_np_tree(jd.params)), jax.tree_util.tree_leaves(dtoid_to_jax(td.state_dict())[0])):
        d = np.abs(g - w)
        assert d.max() <= 3 * 2 * lr * 1.001
        n_far += int((d > REL * max(float(np.abs(w).max()), 1e-12)).sum())
        n_all += d.size
    assert n_far <= 0.005 * n_all, (n_far, n_all)
    assert not td.optimizer.state  # the finetune optimizer never stepped
    # two devices train in two processes of one group (tests/test_torch_dp.py);
    # without a group the trainer names the launcher
    with pytest.raises(RuntimeError, match="spawn"):
        TOfflineTrainer(td, tcfg, n_devices=2)


def test_schedule_and_decay_order_match_optax():
    """chain(add_decayed_weights(wd), amsgrad(multistep schedule)) across
    both milestones (3 steps an epoch), 9 steps at a base lr of 1e-4 (as
    tests/test_torch_train.py::test_optimizer_matches_optax), within 1e-7."""
    import optax

    from ossid_code_tpu.train.offline import make_multistep_schedule as jschedule

    from ossid_code_torch.core.optim import OptaxAmsgrad

    jsched, tsched = jschedule(1e-4, 3, milestones=(1, 2)), make_multistep_schedule(1e-4, 3, milestones=(1, 2))
    for count in range(9):
        assert abs(tsched(count) - float(jsched(count))) <= 1e-7 * 1e-4
    assert tsched(8) < tsched(5) < tsched(2)
    rng = np.random.default_rng(1)
    p0 = rng.normal(0, 1, (5, 4)).astype(np.float32)
    tx = optax.chain(optax.add_decayed_weights(1e-2), optax.amsgrad(jsched))
    jp = jnp.asarray(p0)
    state = tx.init(jp)
    tp = torch.tensor(p0, requires_grad=True)
    opt = OptaxAmsgrad([tp], lr=tsched, weight_decay=1e-2)
    for _ in range(9):
        g = rng.normal(0, 1, (5, 4)).astype(np.float32)
        upd, state = tx.update(jnp.asarray(g), state, jp)
        jp = optax.apply_updates(jp, upd)
        tp.grad = torch.from_numpy(g)
        opt.step()
        np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp), rtol=0, atol=1e-7)


def _assert_same_tree(a, b):
    fa, fb = jax.tree_util.tree_flatten_with_path(a)[0], jax.tree_util.tree_flatten_with_path(b)[0]
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (path, x), (_, y) in zip(fa, fb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=jax.tree_util.keystr(path))


def test_checkpoint_round_trips(models, tmp_path):
    """Exact in three directions, for DTOID and for the scorer. JAX's torch
    import expects DenseNet-121's full depth, so the port file it reads is
    of a (12, 24, 16) model."""
    from ossid_code_tpu.core.checkpoint import load_checkpoint as jload
    from ossid_code_tpu.core.checkpoint import save_checkpoint as jsave
    from ossid_code_tpu.models.zephyr.module import ZephyrModel

    from ossid_code_torch.models.zephyr.jax_import import pointnet2_from_jax
    from ossid_code_torch.models.zephyr.module import ZephyrModel as TZephyrModel

    _, tcfg, params, stats, _ = models
    td = fresh_model(TDtoidModel, tcfg, seed=1, device="cpu")
    td.load_state_dict(dtoid_from_jax(params, stats))
    # port -> port
    save_checkpoint(str(tmp_path / "dtoid.ckpt"), td.state_dict(), extra={"epoch": 3})
    got = load_checkpoint(str(tmp_path / "dtoid.ckpt"))
    assert set(got) == set(td.state_dict())
    for k, v in td.state_dict().items():
        assert torch.equal(got[k], v), k
    TDtoidModel(tcfg, seed=2, device="cpu").load_state_dict(got)
    # JAX pickle -> port
    jsave(str(tmp_path / "dtoid.pkl"), {"params": params, "batch_stats": stats})
    want = dtoid_from_jax(params, stats)
    got = load_checkpoint(str(tmp_path / "dtoid.pkl"))
    assert set(got) == set(want) and all(torch.equal(got[k], want[k]) for k in want)
    # port file -> JAX load_checkpoint
    full = TDtoidModel(tcfg.merged({"model": {"densenet_blocks": (12, 24, 16)}}), seed=1, device="cpu")
    save_checkpoint(str(tmp_path / "dtoid121.ckpt"), full.state_dict())
    jstate = jload(str(tmp_path / "dtoid121.ckpt"))
    p, s = dtoid_to_jax(full.state_dict())
    _assert_same_tree(jstate["params"], p)
    _assert_same_tree(jstate["batch_stats"], s)

    jz = ZephyrModel(num_points=64, seed=0)
    zsd = _np_tree(jz.state_dict())
    tz = TZephyrModel(num_points=64, seed=1, device="cpu")
    tz.load_state_dict(pointnet2_from_jax(zsd["params"], zsd["batch_stats"]))
    save_checkpoint(str(tmp_path / "z.ckpt"), tz.state_dict())
    got = load_checkpoint(str(tmp_path / "z.ckpt"))
    assert all(torch.equal(got[k], v) for k, v in tz.state_dict().items())
    jsave(str(tmp_path / "z.pkl"), zsd)
    got = load_checkpoint(str(tmp_path / "z.pkl"))
    want = pointnet2_from_jax(zsd["params"], zsd["batch_stats"])
    assert all(torch.equal(got[k], want[k]) for k in want)
    jstate = jload(str(tmp_path / "z.ckpt"))
    _assert_same_tree(jstate["params"], zsd["params"])
    _assert_same_tree(jstate["batch_stats"], zsd["batch_stats"])
    # a scorer file without the alignment head loads into an align_feats scorer
    za = TZephyrModel(num_points=64, seed=1, align_feats=True, device="cpu")
    za.load_state_dict(load_checkpoint(str(tmp_path / "z.ckpt"), align_feats=True))
    assert not za.net.align_head.weight.any()


def test_restore_trainer_state_resumes_identically(models, tmp_path):
    """Two epochs straight, against one epoch, a restore of the rolling
    checkpoint into a fresh model and trainer, and the second epoch: the
    same weights, statistics and optimizer moments, bit for bit."""
    _, tcfg, params, stats, _ = models
    rng = np.random.default_rng(5)
    batches = [_batch(rng), _batch(rng)]

    def fresh(ckpt_dir=None):
        td = fresh_model(TDtoidModel, tcfg, seed=1, device="cpu")
        td.load_state_dict(dtoid_from_jax(params, stats))
        return TOfflineTrainer(td, tcfg, n_devices=1, ckpt_dir=ckpt_dir)

    straight = fresh()
    for b in batches:
        straight.train_epoch([b])
    first = fresh(str(tmp_path))
    first.train_epoch([batches[0]])
    resumed = fresh()
    assert resumed.restore_trainer_state(str(tmp_path / "last.ckpt"))
    assert resumed.epoch == 1
    resumed.train_epoch([batches[1]])
    got = resumed.model.state_dict()
    for k, v in straight.model.state_dict().items():
        assert torch.equal(got[k], v), k
    for p, q in zip(straight.optimizer.param_groups[0]["params"], resumed.optimizer.param_groups[0]["params"]):
        for key in ("mu", "nu", "nu_max"):
            assert torch.equal(straight.optimizer.state[p][key], resumed.optimizer.state[q][key])
        assert straight.optimizer.state[p]["count"] == resumed.optimizer.state[q]["count"] == 2
