"""The port's data-parallel offline training against the JAX package's
`OfflineTrainer(n_devices=2)`, on the CPU.

Two gloo processes joined through a FileStore (parallel/launch.py::spawn)
take one DTOID step at batch 2 (128x160, DenseNet (2, 2, 2)): each trains
on its half of the batch with global-batch BatchNorm and gradients summed
over the group. The step is held against JAX's step on two of the
conftest's virtual CPU devices and against the port's one-process step on
the joined batch: loss terms, parameters after the step and the BatchNorm
running statistics, at tests/test_torch_offline.py's REL = 1e-4 rule. The
train CLI with `train.dp_devices=2 device=cpu` is held against
`train.dp_devices=1` on one world (the one-device CLI is held against JAX's
in tests/test_torch_train_cli.py).
"""

import hashlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

H, W, B = 128, 160, 2
REL = 1e-4


def _configure(cfg):
    cfg.model.img_h, cfg.model.img_w = H, W
    cfg.model.densenet_blocks = (2, 2, 2)
    cfg.model.learning_rate = 1e-5
    cfg.train.batch_size = B
    return cfg


def _close_rel(got, want, rel, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{what}: max abs err {err:.3g} > {rel} x {scale:.3g}"


def _batch(rng):
    ann = np.full((B, 1, 5), -1.0, np.float32)
    for i in range(B):
        x1, y1 = rng.uniform(0, W - 40), rng.uniform(0, H - 40)
        ann[i, 0] = [x1, y1, x1 + rng.uniform(16, 40), y1 + rng.uniform(16, 40), rng.integers(0, 2)]
    return {
        "img": rng.uniform(0, 1, (B, H, W, 3)).astype(np.float32),
        "limg": rng.uniform(0, 1, (B, 124, 124, 3)).astype(np.float32),
        "lmask": (rng.uniform(0, 1, (B, 124, 124, 1)) > 0.4).astype(np.float32),
        "gimg": rng.uniform(0, 1, (B, 124, 124, 3)).astype(np.float32),
        "gmask": (rng.uniform(0, 1, (B, 124, 124, 1)) > 0.4).astype(np.float32),
        "bbox_gt": ann,
        "heatmap": rng.uniform(0, 1, (B, H // 16 - 1, W // 16 - 1, 1)).astype(np.float32),
        "mask": (rng.uniform(0, 1, (B, H, W, 1)) > 0.7).astype(np.float32),
    }


def _port_step(state_dict, batch, n_devices):
    """One OfflineTrainer epoch of one batch from `state_dict`: (metrics,
    the state dict after it as numpy)."""
    from ossid_code_torch.core.config import default_config
    from ossid_code_torch.models.dtoid.module import DtoidModel
    from ossid_code_torch.train.offline import OfflineTrainer

    cfg = _configure(default_config())
    model = DtoidModel(cfg, seed=1, device="cpu")
    model.load_state_dict(state_dict)
    metrics = OfflineTrainer(model, cfg, n_devices=n_devices).train_epoch([batch])
    return metrics, {k: v.numpy() for k, v in model.state_dict().items()}


def _rank_step(rank, world, state_dict, batch):
    """Rank 0 returns its metrics and state, the others their metrics and a
    digest of their state (one copy of the weights travels back)."""
    metrics, state = _port_step(state_dict, batch, n_devices=world)
    return (metrics, state) if rank == 0 else (metrics, _digest(state))


def _digest(state: dict) -> str:
    h = hashlib.sha1()
    for k, v in state.items():
        h.update(k.encode())
        h.update(np.ascontiguousarray(v).tobytes())
    return h.hexdigest()


@pytest.fixture(scope="module")
def stepped():
    """JAX's two-device step, the port's one-process step on the joined
    batch and its two-process step, from one set of weights."""
    import jax

    from ossid_code_tpu.core.config import default_config
    from ossid_code_tpu.models.dtoid.module import DtoidModel
    from ossid_code_tpu.train.offline import OfflineTrainer

    from ossid_code_torch.models.dtoid.jax_import import dtoid_from_jax, dtoid_to_jax
    from ossid_code_torch.parallel.launch import spawn

    def np_tree(tree):
        return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), jax.device_get(tree))

    rng = np.random.default_rng(3)
    jd = DtoidModel(_configure(default_config()), seed=1)
    params = np_tree(jd.params)
    for head, std in (("classification", 0.05), ("regression", 0.01)):
        node = params[head]["output"]
        node["kernel"] = rng.normal(0, std, node["kernel"].shape).astype(np.float32)
    stats = jax.tree_util.tree_map(lambda a: (a + rng.uniform(0.5, 1.5, a.shape)).astype(np.float32),
                                   np_tree(jd.batch_stats))
    jd.load_state_dict({"params": params, "batch_stats": stats})
    batch = _batch(rng)
    sd = dtoid_from_jax(params, stats)
    # the two processes run while this one takes JAX's step and the port's
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(spawn, _rank_step, 2, "gloo", (sd, batch))
        jt = OfflineTrainer(jd, jd.cfg, n_devices=2)
        assert jt.mesh.devices.size == 2
        jm = jt.train_epoch([batch])
        one = _port_step(sd, batch, n_devices=1)
        two = ranks.result()
    jax_state = [np_tree(jd.params), np_tree(jd.batch_stats)]
    to_jax = lambda s: dtoid_to_jax({k: torch.from_numpy(v) for k, v in s.items()})
    return jm, jax_state, one, two, to_jax


def test_dp_ranks_hold_one_replica(stepped):
    """Both ranks end the step with the same weights, statistics and metrics."""
    _, _, _, two, _ = stepped
    (m0, s0), (m1, d1) = two
    assert m0 == m1
    assert _digest(s0) == d1


def _close_params(got_leaves, want_leaves, lr):
    """tests/test_torch_offline.py's rule for parameters after a step:
    amsgrad moves a weight by up to the rate whatever its gradient's size,
    so where a gradient is near zero its float32 rounding decides the sign:
    at most 2 lr apart (plus the float32 spacing of the weight), and within
    REL of the leaf's largest magnitude on all but 0.5% of the elements."""
    n_far = n_all = 0
    for g, w in zip(got_leaves, want_leaves):
        w = np.asarray(w, np.float64)
        d = np.abs(np.asarray(g, np.float64) - w)
        assert (d <= 2 * lr * 1.001 + 2 * np.spacing(np.abs(w).astype(np.float32))).all()
        n_far += int((d > REL * max(float(np.abs(w).max()), 1e-12)).sum())
        n_all += d.size
    assert n_far <= 0.005 * n_all, (n_far, n_all)


@pytest.mark.parametrize("reference", ["joined_batch", "jax_two_devices"])
def test_dp_step_matches(stepped, reference):
    """The two-process step against the port's one-process step on the
    joined batch and against JAX's two-device step: loss terms and BatchNorm
    running statistics within REL of their largest magnitude, parameters
    after the step by tests/test_torch_offline.py's rule (_close_params)."""
    import jax

    jm, jax_state, one, two, to_jax = stepped
    got_metrics, got_state = two[0]
    if reference == "joined_batch":
        want_metrics, want_state = one
        is_stat = [k.endswith(("running_mean", "running_var", "num_batches_tracked")) for k in got_state]
        trees = [[v for v, st in zip(state.values(), is_stat) if st == stat] for state in (got_state, want_state)
                 for stat in (False, True)]
        got_params, got_stats, want_params, want_stats = trees
    else:
        want_metrics = jm
        leaves = [[leaf for leaf in jax.tree_util.tree_leaves(tree)] for tree in (*to_jax(got_state), *jax_state)]
        got_params, got_stats, want_params, want_stats = leaves
    assert set(got_metrics) == set(want_metrics)
    for k in want_metrics:
        _close_rel(got_metrics[k], want_metrics[k], REL, k)
    assert len(got_stats) == len(want_stats) and len(got_params) == len(want_params)
    for i, (g, w) in enumerate(zip(got_stats, want_stats)):
        _close_rel(g, w, REL, f"statistics leaf {i}")
    _close_params(got_params, want_params, lr=1e-5)
