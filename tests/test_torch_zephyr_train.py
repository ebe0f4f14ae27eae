"""The port's Zephyr scorer training against the JAX package's, on the CPU.

In-graph grouping (FPS, ball query), the train step (loss, gradients leaf by
leaf, BatchNorm running statistics over three steps), plain Adam against
optax, and the offline trainer's hypothesis sets and alignment-head
calibration on a synthetic world, with a 128-point scorer. JAX's dropout
stream cannot be reproduced, so each step's two dropout masks are read from
JAX's forward (`capture_intermediates`: the mask is where the Dropout output
is non-zero; a relu zero has gradient 0 either way) and the test puts
modules that apply them in place of the port instance's dropouts.
"""

import functools
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ossid_code_torch.models.zephyr.jax_import import pointnet2_from_jax
from ossid_code_torch.models.zephyr.module import ZephyrModel as TZephyrModel
from ossid_code_torch.ops import pointcloud as tpc

torch.set_num_threads(2)

N, M = 128, 16
# The first step's loss, relative. JAX's float32 forward rounds further from
# a float64 evaluation than the port's (logits 3.1e-4 against 1.9e-5 of the
# largest, at these inputs), so the port reads 1.3e-5 from JAX.
LOSS_TOL = 5e-5
# Gradients leaf by leaf, the L2 norm of the difference over JAX's (as
# tests/test_torch_train.py holds DTOID's)
GRAD_TOL = 0.03
STAT_TOL = 1e-4
# bf16 scores against JAX's bf16 scorer, relative to the set's largest
# magnitude (see test_bf16_scorer_with_trained_weights_matches_jax)
BF16_SCORE_TOL = 0.03


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), jax.device_get(tree))


@pytest.mark.parametrize("n,s,radius", [(128, 64, 0.2), (256, 128, 0.4)])
def test_fps_and_ball_query_match_exactly(n, s, radius):
    from ossid_code_tpu.ops import pointcloud as jpc

    x = np.random.default_rng(n).normal(0, 0.1, (4, n, 3)).astype(np.float32)
    want = np.asarray(jpc.farthest_point_sample(jnp.asarray(x), s))
    got = tpc.farthest_point_sample(torch.from_numpy(x), s).numpy()
    np.testing.assert_array_equal(got, want)
    c = x[np.arange(4)[:, None], want]
    want = np.asarray(jpc.ball_query(jnp.asarray(c), jnp.asarray(x), radius, 64))
    got = tpc.ball_query(torch.from_numpy(c), torch.from_numpy(x), radius, 64).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tpc.gather_points(torch.from_numpy(x), torch.from_numpy(want).long()).numpy(),
                                  np.asarray(jpc.gather_points(jnp.asarray(x), jnp.asarray(want))))


def _features(rng, m=M):
    """Point features with the columns alignment_fractions reads in range."""
    px = rng.normal(0, 0.1, (m, N, 11)).astype(np.float32)
    px[..., 3] = np.abs(px[..., 3])
    px[..., 10] = rng.uniform(0, 1, (m, N)) > 0.3
    labels = (rng.uniform(0, 1, m) > 0.7).astype(np.float32)
    labels[0] = 1.0
    return px, labels, np.ones(m, bool)


class _MaskDropout(torch.nn.Module):
    def __init__(self, mask):
        super().__init__()
        self.mask = torch.from_numpy(mask)

    def forward(self, x, generator=None):
        return torch.where(self.mask, x / 0.5, torch.zeros_like(x))


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grad(net):
    """JAX ZephyrModel's train loss (module.py:233-276) and its gradient,
    jitted once, with the dropout outputs captured: f(params, batch_stats,
    px, labels, valid, rng, rank_weight) -> ((loss, [dropout outputs]),
    grads). rank_weight is traced, so one program serves every weight; its
    listwise term is added times the weight where JAX's adds it only for a
    weight above 0, which at weight 0 adds exactly 0 (the term is finite)."""
    import flax.linen as nn
    import optax

    def loss_fn(p, batch_stats, px, labels, valid, rng, rank_weight):
        logits, mutated = net.apply(
            {"params": p, "batch_stats": batch_stats}, px, train=True,
            mutable=["batch_stats", "intermediates"], rngs={"dropout": rng},
            capture_intermediates=lambda mdl, _: isinstance(mdl, nn.Dropout))
        losses = optax.sigmoid_binary_cross_entropy(logits, labels)
        pos, neg = (labels > 0.5) & valid, (labels <= 0.5) & valid
        loss = 0.5 * (jnp.where(pos, losses, 0.0).sum() / jnp.clip(pos.sum(), 1)
                      + jnp.where(neg, losses, 0.0).sum() / jnp.clip(neg.sum(), 1))
        masked = jnp.where(valid, logits, -1e9)
        logz = jax.scipy.special.logsumexp(masked)
        npos = pos.sum()
        rank = -(pos / jnp.clip(npos, 1) * (masked - logz)).sum() - jnp.log(jnp.clip(npos.astype(jnp.float32), 1.0))
        loss = loss + rank_weight * jnp.where((npos > 0) & (npos < valid.sum()), rank, 0.0)
        drops = mutated["intermediates"]
        return loss, [drops[k]["__call__"][0] for k in ("Dropout_0", "Dropout_1")]

    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))


@pytest.fixture(scope="module")
def jax_model():
    """One JAX scorer for the whole module, with its initial state: each
    ZephyrModel jits its own programs, so a model per test would compile
    them again."""
    from ossid_code_tpu.models.zephyr.module import ZephyrModel

    jz = ZephyrModel(num_points=N, seed=0, align_feats=True)
    return jz, (jz.params, jz.batch_stats, jz.opt_state)


def _pair(jax_model, rank_weight=1.0):
    """The JAX scorer reset to its initial state, and a port scorer on the
    same weights with `rank_weight`."""
    jz, (params, stats, opt_state) = jax_model
    jz.params, jz.batch_stats, jz.opt_state = params, stats, opt_state
    tz = TZephyrModel(num_points=N, seed=0, align_feats=True, device="cpu", rank_weight=rank_weight)
    tz.load_state_dict(pointnet2_from_jax(_np_tree(params), _np_tree(stats)))
    return jz, tz


def _step_both(jz, tz, px, labels, valid, seed):
    """One step on each side with JAX's dropout masks; returns (JAX loss,
    port loss, JAX gradients, JAX loss of the replicated loss function).
    The replicated loss and the gradients are at the port scorer's
    rank_weight; JAX's train_step, at its own (1.0), runs only where the
    two weights are one (else its loss is None)."""
    (loss_ref, drops), grads = _jax_loss_and_grad(jz.net)(
        jz.params, jz.batch_stats, jnp.asarray(px), jnp.asarray(labels), jnp.asarray(valid),
        jax.random.PRNGKey(seed), jnp.float32(tz.rank_weight))
    for idx, out in zip((1, 3), drops):
        tz.net.FC_layer[idx] = _MaskDropout(np.asarray(out) != 0)
    lj = jz.train_step(px, labels, valid, seed=seed) if tz.rank_weight == jz.rank_weight else None
    lt = tz.train_step(px, labels, valid, seed=seed)
    return lj, lt, grads, float(loss_ref)


@pytest.mark.parametrize("rank_weight", [0.0, 0.5, 1.0])
def test_first_train_step_matches_jax(jax_model, rank_weight):
    """Loss and gradients leaf by leaf against jax.grad of JAX's train loss
    (module.py:233-276) at `rank_weight` (0: class-balanced BCE alone),
    dropout masks shared; at JAX's default 1.0 the replicated loss is JAX
    ZephyrModel.train_step's own. The alignment head gets no gradient on
    either side."""
    jz, tz = _pair(jax_model, rank_weight)
    px, labels, valid = _features(np.random.default_rng(0))
    lj, lt, grads, lref = _step_both(jz, tz, px, labels, valid, 3)
    if lj is not None:
        assert abs(lref - lj) <= 1e-6 * abs(lj)  # the replicated loss function is JAX's
    assert abs(lt - lref) <= LOSS_TOL * abs(lref), (lt, lref)
    g = _np_tree(grads)
    assert not np.any(g["align_head"]["kernel"]) and tz.net.align_head.weight.grad is None
    want = pointnet2_from_jax(g, _np_tree(jz.batch_stats))
    errs = {}
    for name, p in tz.net.named_parameters():
        if name.startswith("align_head."):
            continue
        ref = want[name].double()
        errs[name] = float((p.grad.double() - ref).norm() / ref.norm())
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_TOL, (worst, errs[worst])


def test_three_train_steps_batchnorm_statistics_match_jax(jax_model):
    """Three steps on three hypothesis sets. Adam's first steps move every
    weight by about lr times the sign of its gradient, so a gradient that
    sits at rounding level on one side flips its weight: at these inputs
    JAX's loss after one step is 0.7% from a float64 run of the port's, the
    port's float32 0.04%. So each step starts the port from JAX's current
    weights; the running statistics are never synchronised, and after three
    steps they must be JAX's to STAT_TOL of each leaf's largest magnitude."""
    jz, tz = _pair(jax_model)
    rng = np.random.default_rng(1)
    for seed in range(3):
        sd = tz.state_dict()
        sd.update({k: v for k, v in pointnet2_from_jax(_np_tree(jz.params), _np_tree(jz.batch_stats)).items()
                   if not k.endswith(("running_mean", "running_var"))})
        tz.load_state_dict(sd)
        px, labels, valid = _features(rng)
        lj, lt, _, _ = _step_both(jz, tz, px, labels, valid, seed)
        assert abs(lt - lj) <= LOSS_TOL * abs(lj), (seed, lt, lj)
    want = pointnet2_from_jax(_np_tree(jz.params), _np_tree(jz.batch_stats))
    sd = tz.state_dict()
    errs = {}
    for name in want:
        if name.endswith(("running_mean", "running_var")):
            w = want[name].double()
            errs[name] = float((sd[name].double() - w).abs().max() / w.abs().max())
    worst = max(errs, key=errs.get)
    print("worst statistic", worst, errs[worst])
    assert errs[worst] <= STAT_TOL, (worst, errs[worst])


def test_adam_matches_optax():
    import optax

    from ossid_code_torch.core.optim import OptaxAdam

    rng = np.random.default_rng(2)
    p0 = rng.normal(0, 1, (6, 5)).astype(np.float32)
    grads = [rng.normal(0, 1, (6, 5)).astype(np.float32) * s for s in (1.0, 0.1, 3.0, 0.01, 1.0)]
    tx = optax.adam(1e-3)
    jp = jnp.asarray(p0)
    state = tx.init(jp)
    tp = torch.tensor(p0, requires_grad=True)
    opt = OptaxAdam([tp], lr=1e-3)
    for g in grads:
        upd, state = tx.update(jnp.asarray(g), state, jp)
        jp = optax.apply_updates(jp, upd)
        tp.grad = torch.from_numpy(g)
        opt.step()
        np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp), rtol=0, atol=1e-7)


# ------------------------------------------------------------------ trainer
@pytest.fixture(scope="module", autouse=True)
def jax_native_libraries():
    """The JAX package's PPF library from native/ (built as its own tests
    build it); without it JAX would fall back to fake hypotheses."""
    subprocess.run(["make", "-C", str(Path(__file__).resolve().parents[1] / "native"), "-s"], check=True)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    from ossid_code_tpu.data.bop import BopDataset, BopDatasetArgs
    from ossid_code_tpu.data.synthetic import make_synthetic_bop
    from ossid_code_tpu.loop.online_learning import model_cloud_from_ply
    from ossid_code_tpu.render.mesh import load_ply

    root = str(tmp_path_factory.mktemp("zworld"))
    make_synthetic_bop(root, n_frames=2, img_h=128, img_w=160)
    bop = BopDataset(BopDatasetArgs(bop_root=root, dataset_name="synth"))
    clouds = {oid: model_cloud_from_ply(load_ply(bop.getObjPath(oid)), n_points=512) for oid in bop.obj_ids}
    return root, clouds


@pytest.fixture(scope="module")
def gens(world):
    """Both sides' PPF generators of the world's objects, built once."""
    from ossid_code_tpu.data.bop import BopDataset, BopDatasetArgs
    from ossid_code_tpu.hypo.ppf import PPFModelMeters

    from ossid_code_torch.hypo.ppf import PPFModelMeters as TPPFModelMeters

    bop = BopDataset(BopDatasetArgs(bop_root=world[0], dataset_name="synth"))
    kw = dict(ModelSamplingDist=0.04, scene_sampling_dist=0.04, ref_pt_rate=0.3, refine_top=4, max_poses=24)
    return ({o: PPFModelMeters(bop.getObjPath(o), **kw) for o in bop.obj_ids},
            {o: TPPFModelMeters(bop.getObjPath(o), **kw) for o in bop.obj_ids})


def _trainers(world, gens, jax_model, hypos: bool):
    from ossid_code_tpu.data.bop import BopDataset, BopDatasetArgs
    from ossid_code_tpu.train.zephyr_offline import ZephyrOfflineTrainer

    from ossid_code_torch.data.bop import BopDataset as TBopDataset
    from ossid_code_torch.data.bop import BopDatasetArgs as TBopDatasetArgs
    from ossid_code_torch.train.zephyr_offline import ZephyrOfflineTrainer as TZephyrOfflineTrainer

    root, clouds = world
    jbop = BopDataset(BopDatasetArgs(bop_root=root, dataset_name="synth"))
    tbop = TBopDataset(TBopDatasetArgs(bop_root=root, dataset_name="synth"))
    jg, tg = gens if hypos else (None, None)
    jz, tz = _pair(jax_model)
    return (ZephyrOfflineTrainer(jz, jbop, clouds, hypo_gens=jg, n_hypos=32, seed=0),
            TZephyrOfflineTrainer(tz, tbop, clouds, hypo_gens=tg, n_hypos=32, seed=0))


@pytest.mark.parametrize("hypos", [False, True], ids=["perturbations", "ppf"])
def test_make_training_batch_matches_jax(world, gens, jax_model, hypos):
    """The same seed consumes the numpy generator in the same order: the same
    labels, and point_x within 1e-5, but for the hue difference (channel 3),
    which divides by the pixel's chroma: on these frames 7-12 of a frame's
    4096 hue elements read up to 1.1e-4 apart, so hue is held to 1e-5 on 99%
    of its elements and to 5e-4 everywhere."""
    jt, tt = _trainers(world, gens, jax_model, hypos)
    for t in jt.bop.targets:
        jx, jl, jv = jt.make_training_batch(t)
        tx, tl, tv = tt.make_training_batch(t)
        np.testing.assert_array_equal(tl, jl)
        np.testing.assert_array_equal(tv, jv)
        tx, jx = tx.numpy(), np.asarray(jx)
        rest = [c for c in range(tx.shape[-1]) if c != 3]
        np.testing.assert_allclose(tx[..., rest], jx[..., rest], rtol=0, atol=1e-5)
        hue = np.abs(tx[..., 3] - jx[..., 3])
        assert np.mean(hue > 1e-5) <= 1e-2 and hue.max() <= 5e-4, (np.mean(hue > 1e-5), hue.max())
    assert jt.rng.bit_generator.state == tt.rng.bit_generator.state


@pytest.fixture(scope="module")
def trained(world, gens, jax_model):
    """Scorer weights JAX trained on two frames, each leaf then moved by half
    its spread so the scores spread too (the statistics as trained)."""
    jt, _ = _trainers(world, gens, jax_model, True)
    jt.train_epoch(max_frames=2, seed=0)
    rng = np.random.default_rng(4)
    sd = _np_tree(jt.model.state_dict())
    params = jax.tree_util.tree_map(lambda a: a + 0.5 * a.std() * rng.normal(size=a.shape).astype(np.float32),
                                    sd["params"])
    return {"params": params, "batch_stats": sd["batch_stats"]}


@pytest.fixture(scope="module")
def calibrated(world, gens, jax_model, trained):
    """JAX's calibration of the alignment head on the trained weights: its
    result, its top-1 pick rate after it, and the calibrated weights."""
    jt, _ = _trainers(world, gens, jax_model, True)
    jt.model.load_state_dict(trained)
    want = jt.calibrate_align_head()
    return want, jt.eval_top1(), _np_tree(jt.model.state_dict())


def test_calibrate_align_head_matches_jax(world, gens, jax_model, trained, calibrated):
    """On the same trained weights the calibrations pick the same cell and
    weight, the head is written as flax's kernel.T, and the pick rates
    agree."""
    want, want_top1, sd = calibrated
    _, tt = _trainers(world, gens, jax_model, True)
    tt.model.load_state_dict(pointnet2_from_jax(trained["params"], trained["batch_stats"]))
    got = tt.calibrate_align_head()
    assert (got["cell"], got["weight"]) == (want["cell"], want["weight"])
    assert got["pick"] == want["pick"]
    np.testing.assert_allclose(got["bias"], want["bias"], rtol=1e-5, atol=1e-6)
    head = sd["params"]["align_head"]
    np.testing.assert_allclose(tt.model.net.align_head.weight.detach().numpy(), np.asarray(head["kernel"]).T,
                               rtol=1e-6)
    assert tt.eval_top1() == want_top1


def test_bf16_scorer_with_trained_weights_matches_jax(world, gens, jax_model, calibrated, monkeypatch):
    """The bf16 scorer on trained weights (`trained`, with the alignment head
    calibrated): on the real PPF sets of the world, the port's
    ZephyrModel(bf16=True) against JAX's OSSID_BF16_SCORER scorer on the same
    weights. JAX's bf16 scorer with the alignment head runs flax's bf16
    forward (BatchNorm in bf16), the port's folds BatchNorm in float32 as
    JAX's fused bf16 scorer does, so the two round differently. Readings
    over the 4 frames: scores 0.0085-0.0155 of the set's largest magnitude
    apart, and the port's pick 0-0.0070 of it below JAX's pick under JAX's
    scores (one frame of four picks another of two near-equal hypotheses).
    Limits: BF16_SCORE_TOL, and two bf16 steps (2^-6) for the pick. Whether
    the bf16 pick is ADD-correct where the float32 pick is, chip_smoke.py
    reads on the demo's trained scorer."""
    from ossid_code_tpu.models.zephyr.module import ZephyrModel

    jt, tt = _trainers(world, gens, jax_model, True)
    sd = calibrated[2]
    monkeypatch.setenv("OSSID_BF16_SCORER", "1")
    jz16 = ZephyrModel(num_points=N, seed=0, align_feats=True)
    monkeypatch.delenv("OSSID_BF16_SCORER")
    jz16.load_state_dict(sd)
    tz16 = TZephyrModel(num_points=N, seed=0, align_feats=True, bf16=True, device="cpu")
    tz16.load_state_dict(pointnet2_from_jax(sd["params"], sd["batch_stats"]))
    jt.model, tt.model = jz16, tz16
    for m in (jz16, tz16):
        for oid, (pts, cols, nrms) in jt.model_clouds.items():
            m.prepare_object(oid, pts, cols, nrms)
    head = np.asarray(sd["params"]["align_head"]["kernel"])[:, 0], float(sd["params"]["align_head"]["bias"][0])
    want, got = jt._collect_real_sets(jt.bop.targets), tt._collect_real_sets(tt.bop.targets)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        sg, sw = g["scores"] + g["stats9"] @ head[0] + head[1], w["scores"] + w["stats9"] @ head[0] + head[1]
        scale = np.abs(sw).max()
        assert np.abs(sg - sw).max() <= BF16_SCORE_TOL * scale, np.abs(sg - sw).max() / scale
        np.testing.assert_array_equal(g["errs"], w["errs"])
        # the port's pick, under JAX's bf16 scorer, within two bf16 steps of JAX's pick
        assert sw.max() - sw[np.argmax(sg)] <= 2 * 2.0 ** -7 * scale
