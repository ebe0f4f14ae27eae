"""Parity of the PyTorch port's ops with the JAX package's, on the CPU.

The same numpy inputs (from a seeded generator) go through the JAX function
and its port. Where the JAX function is a Pallas kernel, it runs in interpret
mode, as the JAX package's own tests run it. The CUDA kernels themselves run
only on the card: tests/test_torch_cuda.py.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ossid_code_torch.ops import color as tcolor
from ossid_code_torch.ops import conv as tconv
from ossid_code_torch.ops import nms as tnms
from ossid_code_torch.ops import resize as tresize
from ossid_code_torch.ops import sa_fused as tsa

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _pallas_dw_corr(x, k):
    """ossid_code_tpu's _dw_corr_kernel in interpret mode (as
    tests/test_pallas_kernels.py runs it)."""
    from jax.experimental import pallas as pl
    from ossid_code_tpu.ops import pallas_kernels as pk

    b, h, w, c = x.shape
    xp = jnp.pad(jnp.asarray(x), ((0, 0), (1, 1), (1, 1), (0, 0)))
    return np.asarray(pl.pallas_call(
        functools.partial(pk._dw_corr_kernel, h, w),
        grid=(b,),
        in_specs=[pl.BlockSpec((1, h + 2, w + 2, c), lambda i: (i, 0, 0, 0)),
                  pl.BlockSpec((1, 3, 3, c), lambda i: (i, 0, 0, 0))],
        out_specs=pl.BlockSpec((1, h, w, c), lambda i: (i, 0, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((b, h, w, c), jnp.float32),
        interpret=True,
    )(xp, jnp.asarray(k)))


@pytest.mark.parametrize("pattern", ["per_sample", "broadcast_kernel", "broadcast_image"])
def test_depthwise_corr_matches_jax_and_pallas(pattern):
    from ossid_code_tpu.ops.conv import depthwise_corr

    rng = np.random.default_rng(0)
    b, h, w, c = 3, 7, 9, 16
    x = rng.normal(size=(b, h, w, c)).astype(np.float32)
    k = rng.normal(size=(b, 3, 3, c)).astype(np.float32)
    xt, kt = _t(x), _t(k)
    if pattern == "broadcast_kernel":  # the image-encoder stem (network.py:119)
        k = np.broadcast_to(k[:1], k.shape).copy()
        kt = _t(k[:1]).expand(b, 3, 3, c)
    elif pattern == "broadcast_image":  # the correlation head (network.py:388)
        x = np.broadcast_to(x[:1], x.shape).copy()
        xt = _t(x[:1]).expand(b, h, w, c)
    got = tconv.depthwise_corr(xt, kt, padding=1).numpy()
    want = np.asarray(depthwise_corr(jnp.asarray(x), jnp.asarray(k), padding=1))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, _pallas_dw_corr(x, k), rtol=1e-5, atol=1e-5)


def test_depthwise_corr_other_padding_matches_jax():
    from ossid_code_tpu.ops.conv import depthwise_corr

    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 8, 6, 8)).astype(np.float32)
    k = rng.normal(size=(2, 3, 3, 8)).astype(np.float32)
    got = tconv.depthwise_corr(_t(x), _t(k), padding=0).numpy()
    want = np.asarray(depthwise_corr(jnp.asarray(x), jnp.asarray(k), padding=0))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _sa_inputs(rng, m, n, cf, s, k):
    pts = rng.normal(0, 0.3, (m, n, 3 + cf)).astype(np.float32)
    cidx = rng.choice(n, s, replace=False).astype(np.int32)
    gidx = rng.integers(0, n, (s, k)).astype(np.int32)
    return pts, cidx, gidx


@pytest.mark.parametrize("k", [8, 64])
def test_sa_mlp_max_matches_pallas_interpret(k):
    """The port's SA stage (gather + folded chain + max) against the JAX
    package's `mlp_max` Pallas kernel in interpret mode on the same grouped
    tensor, with weights folded by both packages' fold_bn."""
    from jax.experimental.pallas import tpu as pltpu
    from ossid_code_tpu.ops.sa_fused import fold_bn, mlp_max

    rng = np.random.default_rng(2)
    m, n, cf, s = 2, 40, 8, 16
    pts, cidx, gidx = _sa_inputs(rng, m, n, cf, s, k)
    widths = (11, 64, 64, 128)
    raw = [(rng.normal(0, 0.3, (widths[i], widths[i + 1])).astype(np.float32),
            rng.uniform(0.5, 1.5, widths[i + 1]).astype(np.float32),
            rng.normal(0, 0.3, widths[i + 1]).astype(np.float32),
            rng.normal(0, 0.3, widths[i + 1]).astype(np.float32),
            rng.uniform(0.3, 1.5, widths[i + 1]).astype(np.float32)) for i in range(3)]
    jw = [fold_bn(*map(jnp.asarray, r), jnp.float32) for r in raw]
    tw = [tsa.fold_bn(*map(_t, r)) for r in raw]
    for (jW, jb), (tW, tb) in zip(jw, tw):
        np.testing.assert_allclose(tW.numpy(), np.asarray(jW), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-6, atol=1e-6)

    xyz, feats = pts[..., :3], pts[..., 3:]
    grouped = np.concatenate([xyz[:, gidx] - xyz[:, cidx][:, :, None, :], feats[:, gidx]], -1)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(mlp_max(jnp.asarray(grouped), tuple(w for w, _ in jw),
                                  tuple(b for _, b in jw), use_pallas=True, block_groups=32))
    ptsT = _t(pts)
    got = tsa.sa_mlp_max(ptsT[..., :3], ptsT[..., 3:], _t(cidx), _t(gidx),
                         [w for w, _ in tw], [b for _, b in tw]).numpy()
    assert got.shape == (m, s, 128)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_resize_ops_match_jax():
    from ossid_code_tpu.ops import resize as jresize

    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 15, 15, 5)).astype(np.float32)
    np.testing.assert_allclose(
        tresize.resize_bilinear(_t(x), (7, 7)).numpy(),
        np.asarray(jresize.resize_bilinear(jnp.asarray(x), (7, 7))), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(
        tresize.upsample_nearest(_t(x), 2).numpy(),
        np.asarray(jresize.upsample_nearest(jnp.asarray(x), 2)))
    for hw in ((32, 40), (60, 80), (29, 39)):
        np.testing.assert_array_equal(
            tresize.resize_nearest(_t(x), hw).numpy(),
            np.asarray(jresize.resize_nearest(jnp.asarray(x), hw)))


@pytest.mark.parametrize("size", [61, 30, 15, 64])
def test_pools_match_jax(size):
    from ossid_code_tpu.ops import conv as jconv

    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, size, size + 3, 4)).astype(np.float32)
    np.testing.assert_array_equal(
        tconv.max_pool_ceil(_t(x), 3, 2, ceil_mode=True).numpy(),
        np.asarray(jconv.max_pool_ceil(jnp.asarray(x), 3, 2, ceil_mode=True)))
    for k, s in ((2, 2), (2, 1), (7, 7)):
        if k > size:
            continue
        np.testing.assert_allclose(
            tconv.avg_pool(_t(x), k, s).numpy(),
            np.asarray(jconv.avg_pool(jnp.asarray(x), k, s)), rtol=1e-6, atol=1e-6)


def test_rgb_to_hsv_matches_jax():
    from ossid_code_tpu.ops.color import rgb_to_hsv

    rng = np.random.default_rng(5)
    rgb = rng.uniform(0, 1, (64, 3)).astype(np.float32)
    rgb[:4] = [[0, 0, 0], [0.5, 0.5, 0.5], [1, 1, 0], [0.2, 0.9, 0.9]]  # gray, ties
    np.testing.assert_allclose(tcolor.rgb_to_hsv(_t(rgb)).numpy(),
                               np.asarray(rgb_to_hsv(jnp.asarray(rgb))), rtol=1e-6, atol=1e-6)


def _boxes_with_ties(rng, n):
    xy = rng.uniform(0, 60, (n, 2))
    wh = rng.uniform(5, 30, (n, 2))
    boxes = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    scores = rng.choice(np.linspace(0.1, 0.9, 9), n).astype(np.float32)  # many ties
    boxes[5] = boxes[3]  # identical boxes with identical scores
    scores[5] = scores[3]
    return boxes, scores


def test_nms_and_topk_match_jax_with_ties():
    from ossid_code_tpu.ops import nms as jnms

    rng = np.random.default_rng(6)
    boxes, scores = _boxes_with_ties(rng, 120)
    np.testing.assert_allclose(
        tnms.batched_iou(_t(boxes), _t(boxes)).numpy(),
        np.asarray(jnms.batched_iou(jnp.asarray(boxes), jnp.asarray(boxes))), rtol=1e-6, atol=1e-7)
    valid = rng.uniform(size=120) > 0.1
    for v in (None, valid):
        keep = tnms.nms_fixed(_t(boxes), _t(scores), 0.5, None if v is None else _t(v)).numpy()
        want = np.asarray(jnms.nms_fixed(jnp.asarray(boxes), jnp.asarray(scores), 0.5,
                                         None if v is None else jnp.asarray(v)))
        np.testing.assert_array_equal(keep, want)
    for topk in (20, 200):
        got = [a.numpy() for a in tnms.nms_topk(_t(boxes), _t(scores), 0.5, topk)]
        want = [np.asarray(a) for a in jnms.nms_topk(jnp.asarray(boxes), jnp.asarray(scores), 0.5, topk)]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    vals, idx = tnms.topk_stable(_t(scores), 50)
    jv, ji = jax.lax.top_k(jnp.asarray(scores), 50)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))
