"""The port's CUDA kernels against their plain PyTorch versions, on the card.

This file imports no JAX, so it runs on a machine with PyTorch and CUDA
alone (without the JAX-side conftest):

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tests marked `cuda` skip without a card: a CUDA kernel has no CPU mode.
"""

import pickle

import numpy as np
import pytest
import torch

from chip_smoke import STEP_GRAD_NOISE, ZERO_GRAD_TOL
from ossid_code_torch.ops import conv as tconv
from ossid_code_torch.ops import sa_fused as tsa

torch.set_num_threads(2)
# The largest relative size of one bf16 rounding step (8 significant bits): a
# bf16 kernel and its plain version sum in float32 in other orders, so a sum
# near a rounding midpoint may round to either neighbour.
BF16_STEP = 2.0 ** -7


def _sa_inputs(rng, m, n, cf, s, k):
    pts = rng.normal(0, 0.3, (m, n, 3 + cf)).astype(np.float32)
    cidx = rng.choice(n, s, replace=False).astype(np.int32)
    gidx = rng.integers(0, n, (s, k)).astype(np.int32)
    return pts, cidx, gidx


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def test_kernel_wrappers_refuse_cpu_tensors():
    """The CUDA wrappers launch or raise; the CPU path is chosen by the
    dispatcher from the tensor's device only."""
    x = torch.zeros(1, 4, 4, 8)
    with pytest.raises(ValueError):
        tconv.dw_corr3x3_cuda(x, torch.zeros(1, 3, 3, 8))
    with pytest.raises(ValueError):
        tsa.sa_mlp_max_cuda(torch.zeros(1, 8, 3), torch.zeros(1, 8, 8),
                            torch.zeros(2, dtype=torch.int32), torch.zeros(2, 4, dtype=torch.int32),
                            [torch.zeros(11, 64), torch.zeros(64, 64), torch.zeros(64, 128)],
                            [torch.zeros(64), torch.zeros(64), torch.zeros(128)])


def test_dtype_mix_raises():
    """Both dw-corr operands share one dtype, float32 or bf16; the SA stage
    takes float32 throughout, or bf16 points, features and weights with
    float32 biases. A mix raises before any device check, on the CPU path
    too: there is no quiet cast."""
    f32, bf = torch.zeros(1, 4, 4, 8), torch.zeros(1, 4, 4, 8, dtype=torch.bfloat16)
    k32, kbf = torch.zeros(1, 3, 3, 8), torch.zeros(1, 3, 3, 8, dtype=torch.bfloat16)
    for call in (lambda: tconv.dw_corr3x3_cuda(f32, kbf), lambda: tconv.dw_corr3x3_cuda(bf, k32),
                 lambda: tconv.dw_corr3x3_dk_cuda(bf, f32), lambda: tconv.depthwise_corr(f32, kbf, 1),
                 lambda: tconv.dw_corr3x3_dk_plain(bf, f32), lambda: tconv.dw_corr3x3_cuda(f32.double(), k32.double())):
        with pytest.raises(TypeError):
            call()
    dims = (11, 64, 64, 128)
    Ws = [torch.zeros(dims[i], dims[i + 1]) for i in range(3)]
    bs = [torch.zeros(dims[i + 1]) for i in range(3)]
    idx = (torch.zeros(2, dtype=torch.int32), torch.zeros(2, 4, dtype=torch.int32))
    p16 = torch.zeros(1, 8, 11, dtype=torch.bfloat16)
    for fn in (tsa.sa_mlp_max_cuda, tsa.sa_mlp_max):
        with pytest.raises(TypeError):  # bf16 points, float32 weights
            fn(p16[..., :3], p16[..., 3:], *idx, Ws, bs)
        with pytest.raises(TypeError):  # bf16 biases
            fn(p16[..., :3], p16[..., 3:], *idx, [w.bfloat16() for w in Ws], [b.bfloat16() for b in bs])


# dk launch plans: the finetune's shapes, the end-to-end demo's training
# shapes (batch 4 at 240x320) and edges, each in float32 (4 channels a
# vector) and bf16 (8), planned for an H100's 132 SMs without and with a
# cluster capacity (one that falls as clusters grow)
_dk_plan_shape = pytest.mark.parametrize("shape", [
    (8, 29, 39, 640), (8, 240, 320, 64), (4, 14, 19, 640), (4, 120, 160, 64), (1, 5, 7, 8), (3, 6, 13, 16),
    (4, 6, 39, 64), (16, 12, 21, 80), (16, 12, 21, 160), (2, 1, 1, 8)])
_dk_plan_vec = pytest.mark.parametrize("vec", [4, 8])
_dk_plan_fits = pytest.mark.parametrize("fits", [None, lambda cs, bands: 264 // (bands + 1)], ids=["any", "one wave"])
_H100_SMS = 132


@_dk_plan_shape
@_dk_plan_vec
@_dk_plan_fits
def test_dk_plan_covers_every_row_column_and_channel_once(shape, vec, fits):
    """Kernel 3's launch plan (ops/conv.py::dw_corr3x3_dk_plan), walked as
    the kernel walks it: block (band, slice) of a sample takes rows [band *
    BH, band * BH + BH) within H and column tiles [t * TW, t * TW + TW)
    within W; its thread i owns, in every tile, column i // L and the 4
    channels of lane i % L, L = CS * vec / 4 lanes a column, vector slice *
    CS + (i % L) // (vec / 4). Every (row, column, 4 channels) is summed
    exactly once; slices, bands and clusters stay within what the kernel
    takes (a power of two of at most 32 vectors and 128 channels a slice,
    256 threads a tile, 8 bands a cluster, no empty band or tile). The
    finetune's shapes keep every SM busy: at least 128 blocks. With `fits`
    (how many clusters of a plan a card holds at once; here one whose
    capacity falls as clusters grow), every cluster fits one wave."""
    b, h, w, c = shape
    plan = tconv.dw_corr3x3_dk_plan(b, h, w, c, vec, _H100_SMS, fits)
    cs, slices, bh, bands, tw, tiles = plan
    lanes, nquads = cs * vec // 4, c // 4
    assert cs in (1, 2, 4, 8, 16, 32) and cs * vec <= 128 and tw * lanes == 256
    assert slices == -(-(c // vec) // cs) and 1 <= bands <= 8 and bh * bands >= h and bh * (bands - 1) < h
    assert tiles * tw >= w and tw * (tiles - 1) < w
    seen = np.zeros((h, w, slices * lanes), np.int32)
    for band in range(bands):
        rows = slice(band * bh, min(h, band * bh + bh))
        for sl in range(slices):
            for t in range(tiles):
                for i in range(256):
                    col = t * tw + i // lanes
                    if col < w:
                        seen[rows, col, sl * lanes + i % lanes] += 1
    assert (seen[..., :nquads] == 1).all()
    if shape in ((8, 29, 39, 640), (8, 240, 320, 64)):
        assert b * slices * bands >= 128
    if fits is not None and b * slices <= fits(cs, 1):
        assert b * slices <= fits(cs, bands)


@pytest.mark.cuda
@_dk_plan_shape
@_dk_plan_vec
@_dk_plan_fits
def test_dk_kernel_takes_every_plan_the_cpu_test_walks(cuda, shape, vec, fits):
    """Kernels 3 / 3b launched directly with each plan that
    test_dk_plan_covers_every_row_column_and_channel_once walks: the kernel
    accepts it (its own copy of the geometry agrees with ops/conv.py's) and
    sums every row, column and channel, against the plain version (float32:
    1e-4 of the largest magnitude; bf16: one bf16 step of it, at least
    1e-4)."""
    b, h, w, c = shape
    dtype = torch.float32 if vec == 4 else torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn(b, h, w, c, device="cuda", generator=g).to(dtype)
    dout = torch.randn(b, h, w, c, device="cuda", generator=g).to(dtype)
    plan = tconv.dw_corr3x3_dk_plan(b, h, w, c, vec, _H100_SMS, fits)
    dk = torch.empty((b, 3, 3, c), device="cuda", dtype=dtype)
    lib = tconv.library("dw_corr3x3_bwd", tconv._BWD_SIGNATURES)
    err = getattr(lib, f"dw_corr3x3_dk_{tconv._SUFFIX[dtype]}")(
        x.data_ptr(), dout.data_ptr(), dk.data_ptr(), b, h, w, c, x.stride(0),
        plan.slice_vectors, plan.band_rows, plan.bands, torch.cuda.current_stream().cuda_stream)
    assert err == 0, plan
    want = tconv.dw_corr3x3_dk_plain(x.float(), dout.float())
    scale = want.abs().max().item()
    tol = 1e-4 * scale if vec == 4 else max(BF16_STEP * scale, 1e-4)
    assert (dk.float() - want).abs().max().item() <= tol, plan


@pytest.mark.cuda
def test_sa_layout_is_the_kernels(cuda):
    """The packed layout that the wrapper and the CPU tests use is the one
    the library's kernel instances read; other widths have no instance."""
    lib = tsa._lib()
    for widths, layout in tsa.SA_LAYOUT.items():
        assert tsa._layout(lib, widths) == layout
    assert tsa._layout(lib, (32, 32, 64)) is None
    lib16 = tsa._lib_bf16()
    for widths, k1 in tsa.SA_LAYOUT_BF16.items():
        assert tsa._layout_bf16(lib16, widths) == k1
    assert tsa._layout_bf16(lib16, (32, 32, 64)) is None


@pytest.mark.cuda
@pytest.mark.parametrize("shape,k_broadcast", [((10, 29, 39, 640), False), ((1, 240, 320, 64), False),
                                               ((6, 14, 19, 640), False), ((1, 120, 160, 64), False),
                                               ((3, 5, 7, 12), False), ((4, 6, 322, 64), True),
                                               ((3, 4, 1, 4), True)])
def test_dw_corr3x3_cuda_matches_plain(cuda, shape, k_broadcast):
    """x broadcast over B (stride 0) as at the correlation head; k per sample
    or broadcast (stride 0) as at the stem; W = 39, 7, 322, 1 are not
    multiples of the kernel's run length 4."""
    b, h, w, c = shape
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(1, h, w, c, device="cuda", generator=g).expand(b, h, w, c)
    if k_broadcast:
        k = torch.randn(1, 3, 3, c, device="cuda", generator=g).expand(b, 3, 3, c)
    else:
        k = torch.randn(b, 3, 3, c, device="cuda", generator=g)
    with torch.inference_mode():
        got = tconv.dw_corr3x3_cuda(x, k)
        want = tconv.depthwise_corr_plain(x, k, 1)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("f,t,h,w,c", [(1, 7, 29, 39, 640), (2, 10, 29, 39, 640), (3, 7, 29, 39, 640),
                                       (2, 5, 6, 13, 16), (3, 3, 4, 1, 8)])
def test_dw_corr3x3_frames_matches_plain(cuda, dtype, f, t, h, w, c):
    """Kernel 1 (1b) over F frames x T templates in one launch (cross=True:
    sample f * T + t is frame f against template t), T odd or not a
    multiple of the float32 instance's 2 templates a block, against the
    plain version: exact in float32, one bf16 step in bf16; one launch
    counted. x is a strided view (frames of a larger batch)."""
    g = torch.Generator(device="cuda").manual_seed(f * 100 + t)
    x = torch.randn(2 * f, h, w, c, device="cuda", generator=g).to(dtype)[::2]
    k = torch.randn(t, 3, 3, c, device="cuda", generator=g).to(dtype)
    counter = "launches_bf16" if dtype == torch.bfloat16 else "launches"
    before = getattr(tconv.dw_corr3x3_cuda, counter)
    with torch.inference_mode():
        got = tconv.dw_corr3x3_cuda(x, k, cross=True)
        want = tconv.depthwise_corr_plain(x, k, 1, cross=True)
    torch.cuda.synchronize()
    assert got.shape == (f * t, h, w, c) and getattr(tconv.dw_corr3x3_cuda, counter) == before + 1
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    else:
        _bf16_agree(got, want, steps=1.0)
    with pytest.raises(ValueError, match="fit"):
        tconv.dw_corr3x3_cuda(x, k[:, :2], cross=True)


def _dw_plain_grads(x, k, dout):
    """dx, dk of the plain version by PyTorch's autograd (x and k expanded
    to dout's batch: a broadcast input gets its gradient summed over B)."""
    b, h, w, c = dout.shape
    xl = x.detach().clone().requires_grad_(True)
    kl = k.detach().clone().requires_grad_(True)
    out = tconv.depthwise_corr_plain(xl.expand(b, h, w, c), kl.expand(b, 3, 3, c), 1)
    return torch.autograd.grad(out, (xl, kl), dout)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,x_broadcast,k_broadcast", [
    ((8, 29, 39, 640), False, False),    # finetune: correlation head
    ((8, 240, 320, 64), False, False),   # finetune: image-encoder stem
    ((4, 14, 19, 640), False, False),    # the demo's training steps at 240x320: head
    ((4, 120, 160, 64), False, False),   # and stem
    ((1, 5, 7, 4), False, False),        # B = 1, C = 4
    ((3, 6, 13, 12), False, True),       # W = 13, not a multiple of the run length 8; k broadcast
    ((4, 6, 39, 64), True, False),       # x broadcast (as at detect's correlation head)
    ((16, 12, 21, 80), False, False),    # dk: a partly filled last channel slice, 6-band clusters
])
def test_dw_corr3x3_backward_matches_plain(cuda, shape, x_broadcast, k_broadcast):
    """depthwise_corr's gradients on the card (kernel 1 for dx, kernel 3 for
    dk) against the plain version's autograd, relative to the reference's
    largest magnitude: 1e-5 for dx (9-term sums), 1e-4 for dk (H*W-term sums
    in another order). A broadcast input's gradient is the sum over B."""
    b, h, w, c = shape
    g = torch.Generator(device="cuda").manual_seed(4)
    x = torch.randn(1 if x_broadcast else b, h, w, c, device="cuda", generator=g)
    k = torch.randn(1 if k_broadcast else b, 3, 3, c, device="cuda", generator=g)
    dout = torch.randn(b, h, w, c, device="cuda", generator=g)
    xg = x.clone().requires_grad_(True)
    kg = k.clone().requires_grad_(True)
    before = (tconv.dw_corr3x3_dx_cuda.launches, tconv.dw_corr3x3_dk_cuda.launches)
    out = tconv.depthwise_corr(xg.expand(b, h, w, c), kg.expand(b, 3, 3, c), 1)
    dx, dk = torch.autograd.grad(out, (xg, kg), dout)
    assert (tconv.dw_corr3x3_dx_cuda.launches - before[0], tconv.dw_corr3x3_dk_cuda.launches - before[1]) == (1, 1)
    want_dx, want_dk = _dw_plain_grads(x, k, dout)
    torch.cuda.synchronize()
    assert float((dx - want_dx).abs().max()) <= 1e-5 * float(want_dx.abs().max())
    assert float((dk - want_dk).abs().max()) <= 1e-4 * float(want_dk.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 240, 320, 64), (8, 29, 39, 640)])
def test_dw_corr3x3_dk_is_bitwise_repeatable(cuda, shape):
    """Kernel 3 reduces in a fixed order without atomics (the finetune's
    stem and head shapes)."""
    g = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn(*shape, device="cuda", generator=g)
    dout = torch.randn(*shape, device="cuda", generator=g)
    first = tconv.dw_corr3x3_dk_cuda(x, dout)
    for _ in range(3):
        assert torch.equal(tconv.dw_corr3x3_dk_cuda(x, dout), first)


@pytest.mark.cuda
@pytest.mark.parametrize("widths,cf,m,n,s,k,w3,b3", [
    ((64, 64, 128), 8, 3, 200, 37, 64, 0.0, 0.0),          # 111 groups: a partial last tile
    ((128, 128, 256), 128, 3, 200, 37, 64, 0.0, 0.0),
    ((64, 64, 128), 8, 3, 200, 37, 13, 0.0, 0.0),          # k = 13: padding rows
    ((64, 64, 128), 8, 128, 512, 512, 64, 0.0, 0.0),       # SA1 at the scorer's size
    ((128, 128, 256), 128, 128, 512, 128, 64, 0.0, 0.0),   # SA2 at the scorer's size
    ((64, 64, 128), 8, 256, 512, 512, 64, 0.0, 0.0),       # SA1 at the gating bucket M = 256
    ((128, 128, 256), 128, 256, 512, 128, 64, 0.0, 0.0),   # SA2 at M = 256
    ((64, 64, 128), 8, 256, 256, 256, 64, 0.0, 0.0),       # SA1 of the demo's 256-point scorer, M = 256
    ((64, 64, 128), 8, 3, 200, 37, 13, -0.1, 0.3),         # layer 3 mostly negative
    ((128, 128, 256), 128, 5, 301, 301, 29, -0.05, 0.3),
])
def test_sa_mlp_max_cuda_matches_plain(cuda, widths, cf, m, n, s, k, w3, b3):
    """The 3xTF32 tensor-core kernel against the float32 plain version. With
    W3 shifted down and b3 up, relu zeroes most real rows of layer 3 while a
    padding row (relu of the biases through the chain) would win the max
    somewhere if it were not masked."""
    rng = np.random.default_rng(7)
    pts, cidx, gidx = _sa_inputs(rng, m, n, cf, s, k)
    dims = (3 + cf,) + widths
    Ws = [torch.from_numpy(rng.normal(w3 * (i == 2), 0.2, (dims[i], dims[i + 1])).astype(np.float32)).cuda()
          for i in range(3)]
    bs = [torch.from_numpy(rng.normal(b3 * (i == 2), 0.2, dims[i + 1]).astype(np.float32)).cuda()
          for i in range(3)]
    p = torch.from_numpy(pts).cuda()
    args = (p[..., :3], p[..., 3:], torch.from_numpy(cidx).cuda(), torch.from_numpy(gidx).cuda(), Ws, bs)
    with torch.inference_mode():
        got = tsa.sa_mlp_max_cuda(*args)
        want = tsa.sa_mlp_max_plain(*args)
        if w3:
            pad = torch.zeros(dims[0], device="cuda")
            for w, b in zip(Ws, bs):
                pad = torch.relu(pad @ w + b)
            assert (pad > want).any()
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_serving_path_launches_the_kernels(cuda):
    """A small DtoidModel detect launches kernel 1 twice (stem, correlation
    head); a ZephyrModel score call launches kernel 2 twice (SA1, SA2); the
    results agree with the same models on the CPU."""
    from ossid_code_torch.core.config import default_config
    from ossid_code_torch.models.dtoid.module import DtoidModel
    from ossid_code_torch.models.zephyr.module import ZephyrModel

    cfg = default_config()
    cfg.model.img_h, cfg.model.img_w, cfg.model.densenet_blocks = 128, 160, (2, 2, 2)
    rng = np.random.default_rng(8)
    batch = {"img": rng.integers(0, 256, (128, 160, 3), dtype=np.uint8), "obj_id": 1,
             "limg": rng.uniform(0, 1, (4, 124, 124, 3)).astype(np.float32),
             "lmask": (rng.uniform(0, 1, (4, 124, 124)) > 0.5).astype(np.float32)}
    gpu, cpu = DtoidModel(cfg, seed=0, device=cuda), DtoidModel(cfg, seed=0, device="cpu")
    before = tconv.dw_corr3x3_cuda.launches
    det = gpu.forward_test_time(batch)
    assert tconv.dw_corr3x3_cuda.launches - before == 2
    np.testing.assert_allclose(det["heat_map"], cpu.forward_test_time(batch)["heat_map"],
                               rtol=1e-3, atol=1e-3)

    pts = rng.normal(0, 0.05, (300, 3)).astype(np.float32)
    poses = np.tile(np.eye(4, dtype=np.float32), (20, 1, 1))
    poses[:, 2, 3] = rng.uniform(0.8, 1.2, 20)
    data = {"img": batch["img"], "depth": (rng.uniform(0.8, 1.3, (128, 160)) * 1000).astype(np.uint16),
            "cam_K": np.array([[150.0, 0, 80], [0, 150.0, 64], [0, 0, 1]], np.float32),
            "model_points": pts, "model_colors": rng.uniform(0, 1, (300, 3)).astype(np.float32),
            "model_normals": np.tile(np.array([[0, 0, -1.0]], np.float32), (300, 1)),
            "pose_hypos": poses}
    zg = ZephyrModel(num_points=512, seed=0, need_uv=False, device=cuda)
    zc = ZephyrModel(num_points=512, seed=0, need_uv=False, device="cpu")
    before = tsa.sa_mlp_max_cuda.launches
    got = zg.score_hypotheses(data, obj_id=1)
    assert tsa.sa_mlp_max_cuda.launches - before == 2
    np.testing.assert_allclose(got["scores"], zc.score_hypotheses(data, obj_id=1)["scores"],
                               rtol=1e-4, atol=1e-4)


def _bf16_agree(got, want, share=0.01, steps=2.0, floor=0.0):
    """bf16 results against their plain version: every element within
    `steps` bf16 steps of the largest magnitude (plus `floor` of it), and at
    most `share` of the elements more than one step of their own magnitude
    apart."""
    g, w = got.float(), want.float()
    err, scale = (g - w).abs(), float(w.abs().max())
    assert float(err.max()) <= (steps * BF16_STEP + floor) * scale, float(err.max()) / scale
    assert float((err > BF16_STEP * w.abs() + floor * scale).float().mean()) <= share


@pytest.mark.cuda
@pytest.mark.parametrize("shape,x_broadcast,k_broadcast", [
    ((10, 29, 39, 640), True, False),   # correlation head: x broadcast over T
    ((1, 240, 320, 64), False, False),  # image-encoder stem
    ((4, 6, 322, 64), False, True),     # W = 322, k broadcast
    ((3, 5, 7, 16), False, False),      # W = 7, not a multiple of the run length 4
    ((3, 4, 1, 8), True, True),         # W = 1, C = 8 (one vector)
])
def test_dw_corr3x3_bf16_matches_plain(cuda, shape, x_broadcast, k_broadcast):
    """Kernel 1b against the plain bf16 version (the float32 sums rounded
    once), at one bf16 step (BF16_STEP)."""
    b, h, w, c = shape
    g = torch.Generator(device="cuda").manual_seed(10)
    x = torch.randn(1 if x_broadcast else b, h, w, c, device="cuda", generator=g).bfloat16().expand(b, h, w, c)
    k = torch.randn(1 if k_broadcast else b, 3, 3, c, device="cuda", generator=g).bfloat16().expand(b, 3, 3, c)
    before = tconv.dw_corr3x3_cuda.launches_bf16
    with torch.inference_mode():
        got = tconv.dw_corr3x3_cuda(x, k)
        want = tconv.depthwise_corr_plain(x, k, 1)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and tconv.dw_corr3x3_cuda.launches_bf16 == before + 1
    _bf16_agree(got, want, steps=1.0)


def _widened(t):
    """t in float32; a stride-0 broadcast over the batch stays a broadcast."""
    return t[:1].float().expand(t.shape) if t.shape[0] > 1 and t.stride(0) == 0 else t.float()


# 1b's kernels and shapes besides its choice, (kernel, a, b, c): the tile (1:
# slice vectors, rows, templates a block), the row walk (2: templates, runs a
# block, rows a thread) and the row walk with 2 templates a thread (3:
# template pairs, runs, rows); 0 for the choice's
_DW16_SHAPES = [(0, 0, 0, 0), (1, 0, 1, 4), (1, 0, 3, 3), (1, 2, 2, 2), (2, 1, 4, 2), (2, 2, 2, 4),
                (2, 4, 1, 8), (2, 1, 1, 16), (3, 1, 2, 4), (3, 2, 1, 16)]


@pytest.mark.cuda
@pytest.mark.parametrize("f,t,h,w,c,cross,k_broadcast", [
    (1, 10, 29, 39, 640, False, False),   # serving's head: x stride 0 over T = 10, W ragged
    (1, 160, 29, 39, 640, False, False),  # configuration 1's head, T = 160
    (8, 1, 29, 39, 640, False, False),    # the step's head forward (and dx), batch 8
    (8, 1, 240, 320, 64, False, False),   # the step's stem forward (and dx), batch 8
    (1, 1, 240, 320, 64, False, False),   # serving's stem
    (2, 1, 240, 320, 64, False, True),    # the farm's stem: taps stride 0
    (3, 7, 29, 39, 640, True, False),     # the farm's 3 x 7: T odd, a partial template block
    (1, 13, 40, 21, 16, False, False),    # T = 13 over one x, C = 16, W 21 ragged
    (2, 5, 30, 12, 8, True, False),       # C = 8 (one 16-byte vector), 2 x 5
    (1, 3, 1, 45, 64, True, False),       # H = 1
])
def test_dw_corr3x3_bf16_is_kernel1_rounded_once(cuda, f, t, h, w, c, cross, k_broadcast):
    """Kernel 1b bit for bit equal to bf16(kernel 1 on the widened
    operands): 1b runs kernel 1's float32 chain and rounds once. Under its
    choice and under each of _DW16_SHAPES (a shape that does not fit the
    call is the choice's), and, for a per-sample call, as dx (the taps read
    turned by 180 degrees) against kernel 1 on the turned taps."""
    g = torch.Generator(device="cuda").manual_seed(f * 1000 + t * 10 + c)
    r = lambda *s: torch.randn(*s, device="cuda", generator=g).bfloat16()
    if cross:
        x, k = r(f, h, w, c), r(t, 3, 3, c)
    elif t > 1:  # one x over T templates: a per-sample call with x stride 0
        x, k = r(1, h, w, c).expand(t, h, w, c), r(t, 3, 3, c)
    else:
        x = r(f, h, w, c)
        k = r(1, 3, 3, c).expand(f, 3, 3, c) if k_broadcast else r(f, 3, 3, c)
    with torch.inference_mode():
        want = tconv.dw_corr3x3_cuda(_widened(x), _widened(k), cross=cross).bfloat16().view(torch.int16)
        for shape in _DW16_SHAPES:
            got = tconv._launch_dw_corr3x3(x, k, "test", cross, shape=shape).view(torch.int16)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (shape, int((got != want).sum()))
        if not cross:
            want = tconv.dw_corr3x3_cuda(_widened(x), _widened(k).flip(1, 2)).bfloat16().view(torch.int16)
            got = tconv.dw_corr3x3_dx_cuda(x, k).view(torch.int16)
            torch.cuda.synchronize()
            assert torch.equal(got, want), int((got != want).sum())
    plan = tconv.dw_corr3x3_bf16_plan(x, k, cross)
    assert plan["kernel"] in ("tile", "rows", "rows2") and plan["blocks_per_sm"] >= 1


@pytest.mark.cuda
@pytest.mark.parametrize("shape,x_broadcast,k_broadcast", [
    ((8, 29, 39, 640), False, False),    # finetune: correlation head
    ((8, 240, 320, 64), False, False),   # finetune: image-encoder stem
    ((1, 5, 7, 8), False, False),        # B = 1, C = 8
    ((3, 6, 13, 16), False, True),       # W = 13; k broadcast
    ((4, 6, 39, 64), True, False),       # x broadcast
    ((16, 12, 21, 160), False, False),   # dk: a partly filled last channel slice, 6-band clusters
])
def test_dw_corr3x3_bf16_backward_matches_plain(cuda, shape, x_broadcast, k_broadcast):
    """depthwise_corr's bf16 gradients on the card (kernel 1b for dx,
    kernel 3b for dk) against the plain version's autograd (float32 sums
    rounded once): within one bf16 step, dk's H*W-term sums also within
    1e-4 of its largest magnitude for their float32 order."""
    b, h, w, c = shape
    g = torch.Generator(device="cuda").manual_seed(11)
    x = torch.randn(1 if x_broadcast else b, h, w, c, device="cuda", generator=g).bfloat16()
    k = torch.randn(1 if k_broadcast else b, 3, 3, c, device="cuda", generator=g).bfloat16()
    dout = torch.randn(b, h, w, c, device="cuda", generator=g).bfloat16()
    xg, kg = x.clone().requires_grad_(True), k.clone().requires_grad_(True)
    before = (tconv.dw_corr3x3_dx_cuda.launches_bf16, tconv.dw_corr3x3_dk_cuda.launches_bf16)
    out = tconv.depthwise_corr(xg.expand(b, h, w, c), kg.expand(b, 3, 3, c), 1)
    dx, dk = torch.autograd.grad(out, (xg, kg), dout)
    after = (tconv.dw_corr3x3_dx_cuda.launches_bf16, tconv.dw_corr3x3_dk_cuda.launches_bf16)
    assert (after[0] - before[0], after[1] - before[1]) == (1, 1)
    want_dx, want_dk = _dw_plain_grads(x, k, dout)
    torch.cuda.synchronize()
    assert dx.dtype == dk.dtype == torch.bfloat16
    if not x_broadcast:  # a broadcast x's gradient is autograd's bf16 sum over B
        _bf16_agree(dx, want_dx, steps=1.0)
    if not k_broadcast:
        _bf16_agree(dk, want_dk, steps=1.0, floor=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 240, 320, 64), (8, 29, 39, 640)])
def test_dw_corr3x3_dk_bf16_is_bitwise_repeatable(cuda, shape):
    """Kernel 3b keeps kernel 3's fixed reduction order."""
    g = torch.Generator(device="cuda").manual_seed(12)
    x = torch.randn(*shape, device="cuda", generator=g).bfloat16()
    dout = torch.randn(*shape, device="cuda", generator=g).bfloat16()
    first = tconv.dw_corr3x3_dk_cuda(x, dout)
    for _ in range(3):
        assert torch.equal(tconv.dw_corr3x3_dk_cuda(x, dout), first)


@pytest.mark.cuda
@pytest.mark.parametrize("widths,cf,m,n,s,k,w3,b3", [
    ((64, 64, 128), 8, 3, 200, 37, 64, 0.0, 0.0),          # 111 groups: a partial last tile
    ((128, 128, 256), 128, 3, 200, 37, 64, 0.0, 0.0),
    ((64, 64, 128), 8, 3, 200, 37, 13, 0.0, 0.0),          # k = 13: padding rows
    ((64, 64, 128), 8, 128, 512, 512, 64, 0.0, 0.0),       # SA1 at the scorer's size
    ((128, 128, 256), 128, 128, 512, 128, 64, 0.0, 0.0),   # SA2 at the scorer's size
    ((128, 128, 256), 128, 256, 512, 128, 64, 0.0, 0.0),   # SA2 at the gating bucket M = 256
    ((64, 64, 128), 8, 3, 200, 37, 13, -0.1, 0.3),         # layer 3 mostly negative
    ((128, 128, 256), 128, 5, 301, 301, 29, -0.05, 0.3),
    ((64, 64, 128), 8, 1, 1, 1, 1, 0.0, 0.0),              # one group of one row: fewer groups than warpgroups
    ((64, 64, 128), 8, 16, 301, 301, 13, 0.0, 0.0),        # k = 13, several groups a warpgroup: the next
    ((128, 128, 256), 128, 8, 301, 301, 13, 0.0, 0.0),     # group's gather in flight
])
@pytest.mark.parametrize("aligned", [False, True])
def test_sa_mlp_max_bf16_matches_plain(cuda, widths, cf, m, n, s, k, w3, b3, aligned):
    """Kernel 2b (one bf16 pass of wgmma) against the plain bf16 version
    (float32 sums, float32 bias, relu, a round to bf16 per layer): a
    layer's float32 sum in another order may round to the other bf16
    neighbour and move the next layers by a step; two steps of the largest
    magnitude, 1% of the elements beyond one step of their own. Features
    as a view into the point rows (2-byte aligned: gathered through
    registers) or in rows of their own (16-byte aligned: cp.async)."""
    rng = np.random.default_rng(13)
    pts, cidx, gidx = _sa_inputs(rng, m, n, cf, s, k)
    dims = (3 + cf,) + widths
    Ws = [torch.from_numpy(rng.normal(w3 * (i == 2), 0.2, (dims[i], dims[i + 1])).astype(np.float32)).cuda()
          .bfloat16() for i in range(3)]
    bs = [torch.from_numpy(rng.normal(b3 * (i == 2), 0.2, dims[i + 1]).astype(np.float32)).cuda()
          for i in range(3)]
    p = torch.from_numpy(pts).cuda().bfloat16()
    feats = p[..., 3:].contiguous() if aligned else p[..., 3:]
    args = (p[..., :3], feats, torch.from_numpy(cidx).cuda(), torch.from_numpy(gidx).cuda(), Ws, bs)
    before = tsa.sa_mlp_max_cuda.launches_bf16
    with torch.inference_mode():
        got = tsa.sa_mlp_max_cuda(*args)
        want = tsa.sa_mlp_max_plain(*args)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and tsa.sa_mlp_max_cuda.launches_bf16 == before + 1
    _bf16_agree(got, want)


@pytest.mark.cuda
def test_bf16_paths_launch_the_bf16_kernels(cuda):
    """A small DtoidModel with bf16_infer launches kernel 1b twice a detect
    and detects within the JAX package's bf16 criteria of the float32
    model; a ZephyrModel(bf16=True) score call launches kernel 2b twice; a
    bf16_finetune step launches 1b twice forward, and 1b (dx) and 3b (dk)
    twice backward, and keeps its weights float32."""
    from ossid_code_torch.core.config import default_config
    from ossid_code_torch.models.dtoid.module import DtoidModel
    from ossid_code_torch.models.zephyr.module import ZephyrModel

    cfg = default_config()
    cfg.model.img_h, cfg.model.img_w, cfg.model.densenet_blocks = 128, 160, (2, 2, 2)
    rng = np.random.default_rng(14)
    batch = {"img": rng.integers(0, 256, (128, 160, 3), dtype=np.uint8), "obj_id": 1,
             "limg": rng.uniform(0, 1, (4, 124, 124, 3)).astype(np.float32),
             "lmask": (rng.uniform(0, 1, (4, 124, 124)) > 0.5).astype(np.float32)}
    m32 = DtoidModel(cfg, seed=0, device=cuda)
    m16 = DtoidModel(cfg.merged({"model": {"bf16_infer": True, "bf16_finetune": True}}), seed=0, device=cuda)
    counters = (tconv.dw_corr3x3_cuda, tconv.dw_corr3x3_dx_cuda, tconv.dw_corr3x3_dk_cuda)
    before = [c.launches_bf16 for c in counters]
    o16, o32 = m16.forward_test_time(batch), m32.forward_test_time(batch)
    assert tconv.dw_corr3x3_cuda.launches_bf16 - before[0] == 2
    assert np.abs(o16["pred_scores"][:10] - o32["pred_scores"][:10]).max() <= 0.05
    assert np.mean((o16["segmentation"] > 0.5) == (o32["segmentation"] > 0.5)) > 0.98

    b = 2
    ann = np.array([[[20, 30, 80, 90, 1]]] * b, np.float32)
    feed = {"img": rng.uniform(0, 1, (b, 128, 160, 3)).astype(np.float32),
            "limg": rng.uniform(0, 1, (b, 124, 124, 3)).astype(np.float32),
            "lmask": (rng.uniform(0, 1, (b, 124, 124, 1)) > 0.4).astype(np.float32),
            "gimg": rng.uniform(0, 1, (b, 124, 124, 3)).astype(np.float32),
            "gmask": (rng.uniform(0, 1, (b, 124, 124, 1)) > 0.4).astype(np.float32),
            "bbox_gt": ann, "heatmap": rng.uniform(0, 1, (b, 7, 9, 1)).astype(np.float32),
            "mask": (rng.uniform(0, 1, (b, 128, 160, 1)) > 0.8).astype(np.float32)}
    before = [c.launches_bf16 for c in counters]
    loss = float(m16.train_step(feed)["loss"])
    assert [c.launches_bf16 - n for c, n in zip(counters, before)] == [2, 2, 2]
    assert np.isfinite(loss)
    assert all(t.dtype == torch.float32 for t in m16.state_dict().values() if t.is_floating_point())

    pts = rng.normal(0, 0.05, (300, 3)).astype(np.float32)
    poses = np.tile(np.eye(4, dtype=np.float32), (20, 1, 1))
    poses[:, 2, 3] = rng.uniform(0.8, 1.2, 20)
    data = {"img": batch["img"], "depth": (rng.uniform(0.8, 1.3, (128, 160)) * 1000).astype(np.uint16),
            "cam_K": np.array([[150.0, 0, 80], [0, 150.0, 64], [0, 0, 1]], np.float32),
            "model_points": pts, "model_colors": rng.uniform(0, 1, (300, 3)).astype(np.float32),
            "model_normals": np.tile(np.array([[0, 0, -1.0]], np.float32), (300, 1)),
            "pose_hypos": poses}
    z16 = ZephyrModel(num_points=512, seed=0, need_uv=False, bf16=True, device=cuda)
    before = tsa.sa_mlp_max_cuda.launches_bf16
    got = z16.score_hypotheses(data, obj_id=1)
    assert tsa.sa_mlp_max_cuda.launches_bf16 - before == 2
    assert np.isfinite(got["scores"]).all()


@pytest.mark.cuda
def test_scorer_train_step_matches_cpu(cuda):
    """One scorer train step (ZephyrModel.train_step: in-graph grouping,
    flax-rule BatchNorm, dropout masks from a seeded generator, Adam) on the
    card against the CPU from the same weights. The dropout generators of
    the two devices draw different masks, so both run without dropout (the
    test puts identity modules in their place). Loss within 1e-4 relative;
    gradients leaf by leaf within 0.1 relative L2, as chip_smoke.py holds
    DTOID's step."""
    from ossid_code_torch.models.zephyr.module import ZephyrModel

    rng = np.random.default_rng(8)
    px = rng.normal(0, 0.1, (64, 256, 11)).astype(np.float32)
    px[..., 3] = np.abs(px[..., 3])
    px[..., 10] = rng.uniform(0, 1, (64, 256)) > 0.3
    labels = (rng.uniform(0, 1, 64) > 0.8).astype(np.float32)
    labels[0] = 1.0
    class NoDropout(torch.nn.Module):
        def forward(self, x, generator=None):
            return x

    models = [ZephyrModel(num_points=256, seed=0, align_feats=True, device=d) for d in ("cuda", "cpu")]
    models[1].load_state_dict({k: v.cpu() for k, v in models[0].state_dict().items()})
    losses = []
    for m in models:
        m.net.FC_layer[1] = m.net.FC_layer[3] = NoDropout()
        losses.append(m.train_step(px, labels, np.ones(64, bool), seed=0))
    assert abs(losses[0] - losses[1]) <= 1e-4 * abs(losses[1]), losses
    grads = [{n: p.grad.double().cpu() for n, p in m.net.named_parameters() if p.grad is not None} for m in models]
    assert set(grads[0]) == set(grads[1]) and "align_head.weight" not in grads[0]
    for name, want in grads[1].items():
        assert float((grads[0][name] - want).norm() / want.norm()) <= 0.1, name


def _sift_image(rng, h, w):
    img = rng.uniform(0, 255, (h // 4, w // 4)).astype(np.float32)
    img = torch.nn.functional.interpolate(torch.from_numpy(img)[None, None], size=(h, w), mode="bicubic")[0, 0]
    return (img.clamp(0, 255) + torch.from_numpy(rng.normal(0, 4, (h, w)).astype(np.float32))).clamp(0, 255).to(
        torch.uint8)


@pytest.mark.cuda
@pytest.mark.parametrize("hw,nfeatures", [((480, 640), 500), ((124, 124), 200)])
def test_sift_on_card_matches_cpu(cuda, hw, nfeatures):
    """The port's SIFT on the card against the CPU, held to chip_smoke.py's
    limits (SIFT_MATCH_SHARE, SIFT_DESC_TOL, where the reasons stand)."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from chip_smoke import SIFT_DESC_TOL, SIFT_MATCH_SHARE, compare_sift_runs
    from ossid_code_torch.ops import sift

    rng = np.random.default_rng(3)
    gray = _sift_image(rng, *hw)
    mask = torch.zeros(hw, dtype=torch.bool)
    mask[hw[0] // 8:, hw[1] // 6:] = True
    cpu = sift.detect_and_compute(gray, mask, nfeatures)
    gpu = sift.detect_and_compute(gray.to(cuda), mask.to(cuda), nfeatures)
    cmp = compare_sift_runs(cpu, gpu)
    assert cmp["n_a"] > 50, cmp
    assert cmp["matched"] >= SIFT_MATCH_SHARE * cmp["n_a"] and abs(cmp["n_b"] - cmp["n_a"]) <= 0.02 * cmp["n_a"], cmp
    assert cmp["same_angle"] >= SIFT_MATCH_SHARE * cmp["matched"], cmp
    assert cmp["max_desc_diff"] <= SIFT_DESC_TOL, cmp


@pytest.mark.cuda
def test_cli_on_card(cuda, tmp_path, monkeypatch):
    """The CLI's main on the card on a small synthetic world (2 textured
    objects x 2 frames of 128x160, DenseNet (2, 2, 2), SIFT and fake
    hypotheses, device ICP of the top 4, a finetune every 2 targets): a row
    a target, finite AR and mAP, the kernels launched."""
    from ossid_code_torch.core.config import Config
    from ossid_code_torch.data.bop import BopDataset, BopDatasetArgs
    from ossid_code_torch.data.synthetic import make_synthetic_bop, make_template_grid, make_zephyr_results_pkl
    from ossid_code_torch.render.mesh import make_wedge_mesh, texture_mesh
    from ossid_code_torch.scripts.online_learning import build_parser, main

    root = str(tmp_path / "bop")
    objects = {1: texture_mesh(make_wedge_mesh(85, 62, 45), amp=0.3, subdiv=3, seed=1),
               2: texture_mesh(make_wedge_mesh(70, 48, 55, taper=0.4, shear=-0.25), amp=0.3, subdiv=3, seed=2)}
    make_synthetic_bop(root, n_frames=2, img_h=128, img_w=160, objects=objects)
    make_template_grid(str(tmp_path / "bop" / "grid"), objects, n_views=8)
    make_zephyr_results_pkl(str(tmp_path / "bop" / "synth_zephyr_results.pkl"),
                            BopDataset(BopDatasetArgs(bop_root=root, dataset_name="synth")), score=50.0)
    Config(model={"densenet_blocks": [2, 2, 2]}).save(str(tmp_path / "conf.yaml"))
    for k, v in (("OSSID_ROOT", tmp_path), ("BOP_DATASETS_ROOT", root), ("OSSID_CKPT_ROOT", tmp_path / "ckpts")):
        monkeypatch.setenv(k, str(v))
    before = (tconv.dw_corr3x3_cuda.launches, tsa.sa_mlp_max_cuda.launches)
    out = main(build_parser().parse_args([
        "--dataset_name", "synth", "--exp_name", "card", "--conf_path", str(tmp_path / "conf.yaml"),
        "--hypo_backend", "fake", "--n_fake_hypos", "8", "--use_sift_hypos", "--always_dtoid_mask",
        "--use_oracle_gt", "--n_local_test", "4", "--finetune_interval", "2", "--finetune_batch_size", "2",
        "--refine_device", "--refine_top", "4"]))
    rows = out["loop"].test_loader.dataset.bop_dataset.targets
    with open(out["results_path"], "rb") as f:
        saved = pickle.load(f)
    assert len(saved["test_results"]) == len(rows) == 4
    assert all(np.isfinite(out[k]) for k in ("AR", "AR_vsd", "AR_mssd", "AR_mspd", "mAP"))
    assert len(saved["finetune_logs"]) == 2
    assert any(r["time_sift"] for r in saved["test_results"])
    assert tconv.dw_corr3x3_cuda.launches - before[0] >= 2 * len(rows)
    assert tsa.sa_mlp_max_cuda.launches - before[1] == 2 * len(rows)


def _maskrcnn_pair(n_classes=3, hw=(128, 160), seed=5):
    """The class-conditional detector on the card and a CPU copy of its
    weights, output convs perturbed (segmentation bias 0)."""
    from ossid_code_torch.core.config import default_config
    from ossid_code_torch.models.maskrcnn import MaskRCNN

    cfg = default_config()
    cfg.dataset.n_classes = n_classes
    cfg.dataset.img_h, cfg.dataset.img_w = hw
    gpu = MaskRCNN(cfg, seed=seed, device="cuda")
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for conv, std in ((gpu.net.classification.output, 0.05), (gpu.net.regression.output, 0.01),
                          (gpu.net.seg_final, 0.1)):
            conv.weight.copy_((torch.randn(conv.weight.shape, generator=g) * std).cuda())
        gpu.net.seg_final.bias.zero_()
    cpu = MaskRCNN(cfg, seed=seed, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    return gpu, cpu


@pytest.mark.cuda
def test_maskrcnn_frame_matches_cpu(cuda):
    """One frame of the class-conditional detector (full DenseNet-121 at
    128x160) on the card against the CPU, as chip_smoke.py phase 10 holds
    it at 480x640: the top score within 1e-3 and 98% of the detections
    matched (score 1e-3, box 0.05 px), the segmentation within 1e-3 and its
    threshold on all but 1e-3 of the pixels. No dw-corr kernel runs."""
    gpu, cpu = _maskrcnn_pair()
    rng = np.random.default_rng(3)
    data = {"img": rng.integers(0, 256, (128, 160, 3), dtype=np.uint8), "obj_id": 2}
    before = tconv.dw_corr3x3_cuda.launches
    det, ref = gpu.forward_test_time(data), cpu.forward_test_time(data)
    assert tconv.dw_corr3x3_cuda.launches == before
    s, b, cs, cb = det["final_score"][0], det["final_bbox"][0], ref["final_score"][0], ref["final_bbox"][0]
    assert abs(float(s[0] - cs[0])) <= 1e-3
    matched = sum(any(np.abs(cb[j] - bb).max() <= 0.05 for j in np.nonzero(np.abs(cs - ss) <= 1e-3)[0])
                  for ss, bb in zip(s, b))
    assert matched >= 0.98 * len(s)
    assert np.abs(det["segmentation"] - ref["segmentation"]).max() <= 1e-3
    assert ((det["segmentation"] > 0.5) != (ref["segmentation"] > 0.5)).mean() <= 1e-3


@pytest.mark.cuda
def test_maskrcnn_train_step_matches_cpu(cuda):
    """One train step of the class-conditional detector (batch 2 at
    128x160, a row with an unlabelled class) on the card against the CPU
    from the same weights: the loss within 1e-4 relative, the gradients
    leaf by leaf within 0.1 relative L2 where a leaf's largest CPU gradient
    is above 1e-6 of the largest (chip_smoke.py's STEP_* limits). The
    stem's first BatchNorm scale is held to its own limit there, and the
    card's and the CPU's float32 gradients of it against a float64 CPU
    gradient of the same weights and batch (chip_smoke.py's
    MASKRCNN_STEM_SCALE_TOL, where the reason stands)."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from chip_smoke import MASKRCNN_STEM_SCALE, MASKRCNN_STEM_SCALE_TOL, maskrcnn_gradients

    gpu, cpu = _maskrcnn_pair(seed=7)
    rng = np.random.default_rng(9)
    masks = np.zeros((2, 128, 160, 3), np.float32)
    masks[0, 20:80, 30:90, 1] = masks[1, 40:100, 60:140, 2] = 1.0
    batch = {"img": rng.uniform(0, 1, (2, 128, 160, 3)).astype(np.float32),
             "bbox_gt": np.array([[[30, 20, 90, 80, 1]], [[60, 40, 140, 100, 2]]], np.float32),
             "masks": masks, "cls_valid": np.array([[1, 1, 1], [1, 1, 0]], np.float32)}
    want64 = maskrcnn_gradients(cpu, batch, torch.float64)[MASKRCNN_STEM_SCALE]
    losses = [float(m.train_step(batch)["loss"]) for m in (gpu, cpu)]
    assert abs(losses[0] - losses[1]) <= 1e-4 * abs(losses[1]), losses
    grads = [{n: p.grad.double().cpu() for n, p in m.net.named_parameters()} for m in (gpu, cpu)]
    scale = max(float(g.abs().max()) for g in grads[1].values())
    for name, want in grads[1].items():
        if float(want.abs().max()) >= 1e-6 * scale:
            tol = MASKRCNN_STEM_SCALE_TOL if name == MASKRCNN_STEM_SCALE else 0.1
            assert float((grads[0][name] - want).norm() / want.norm()) <= tol, name
    for g in grads:
        assert float((g[MASKRCNN_STEM_SCALE] - want64).norm() / want64.norm()) <= MASKRCNN_STEM_SCALE_TOL


@pytest.mark.cuda
def test_train_cli_detect_on_card(cuda, tmp_path, monkeypatch):
    """`scripts/train.py dataset=detect` on the card (2 objects x 5 frames of
    128x160, 2 epochs at batch 2): its run's files, finite moving losses,
    the detector on the card, and no dw-corr kernel launched."""
    import json

    from ossid_code_torch.data.synthetic import make_synthetic_bop
    from ossid_code_torch.scripts import train

    root = str(tmp_path / "bop")
    make_synthetic_bop(root, n_frames=5, img_h=128, img_w=160)
    monkeypatch.setenv("OSSID_RESULT_ROOT", str(tmp_path / "results"))
    before = tconv.dw_corr3x3_cuda.launches
    assert train.main(["dataset=detect", "dataset.n_classes=2", "dataset.img_h=128", "dataset.img_w=160",
                       f"dataset.bop_root={root}", "dataset.test_dataset_name=synth", "dataset.shorter_length=128",
                       "train.batch_size=2", "model.max_epochs=2", "exp_name=card"]) == 0
    assert tconv.dw_corr3x3_cuda.launches == before
    exp = tmp_path / "results" / "train" / "card"
    rows = [json.loads(line) for line in (exp / "metrics_v0.jsonl").read_text().splitlines() if line.strip()]
    assert len(rows) == 2 and all(np.isfinite(r["loss"]) for r in rows) and rows[0]["loss"] != rows[1]["loss"]
    assert all((exp / n).exists() for n in ("config_v0.yaml", "last.ckpt", "best.ckpt"))


@pytest.mark.cuda
def test_host_copy_waits_on_its_event(cuda):
    """HostCopy starts its copies into pinned memory behind queued work and
    a wait on another thread returns the values once they have landed; the
    YUV 4:2:0 upload gives, on the card, the CPU's unpack within 1."""
    from concurrent.futures import ThreadPoolExecutor

    from ossid_code_torch.ops.yuv import pack_i420, ship_rgb_yuv420, unpack_i420
    from ossid_code_torch.utils.host_copy import HostCopy, to_device

    x = torch.arange(1 << 20, dtype=torch.float32, device=cuda)
    torch.cuda._sleep(50_000_000)
    copy = HostCopy({"x": x * 2, "pair": (x[:5], None)})
    assert all(t.is_pinned() for t in (copy._tree["x"], copy._tree["pair"][0]))
    with ThreadPoolExecutor(1) as pool:
        out = pool.submit(copy.wait).result()
    np.testing.assert_array_equal(out["x"], np.arange(1 << 20, dtype=np.float32) * 2)
    assert out["pair"][1] is None and out["pair"][0].tolist() == [0, 1, 2, 3, 4]
    img = np.random.default_rng(0).integers(0, 256, (480, 640, 3), np.uint8)
    card = ship_rgb_yuv420(img, cuda)
    assert card.shape == (480, 640, 3) and card.dtype == torch.uint8 and card.is_cuda
    cpu = unpack_i420(torch.from_numpy(pack_i420(img)))
    assert int((card.cpu().int() - cpu.int()).abs().max()) <= 1
    assert torch.equal(to_device(img, cuda).cpu(), torch.from_numpy(img))


@pytest.mark.cuda
def test_pipelined_loop_on_card(cuda, tmp_path):
    """The pipelined loop on the card (2 objects x 2 frames of 128x160,
    DenseNet (2, 2, 2), a 64-point scorer, 8 fake hypotheses with device ICP
    of the top 4, a finetune every 2 targets at batch 2, the YUV transport
    and a 96-px depth crop, cuDNN's deterministic algorithms) against the
    synchronous loop from the same weights: the same gates, finetune
    schedule and hypothesis counts, and scores and poses no further from
    the synchronous run than a second synchronous run is."""
    import argparse
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    from ossid_code_torch.core.config import default_config
    from ossid_code_torch.data.bop import BopDataset, BopDatasetArgs
    from ossid_code_torch.data.dtoid_bop import get_dataloaders
    from ossid_code_torch.data.synthetic import (
        default_objects, make_synthetic_bop, make_template_grid, make_zephyr_results_pkl,
    )
    from ossid_code_torch.hypo.fake import FakeHypoGen
    from ossid_code_torch.loop.online_learning import OnlineLearningLoop
    from ossid_code_torch.models.dtoid.module import DtoidModel
    from ossid_code_torch.models.zephyr.module import ZephyrModel

    root = str(tmp_path / "bop")
    make_synthetic_bop(root, n_frames=2, img_h=128, img_w=160)
    make_template_grid(str(tmp_path / "bop" / "grid"), default_objects(), n_views=8)
    bop = BopDataset(BopDatasetArgs(bop_root=root, dataset_name="synth"))
    make_zephyr_results_pkl(str(tmp_path / "zr.pkl"), bop, score=50.0)
    cfg = default_config()
    d = cfg.dataset
    d.bop_root, d.test_dataset_name, d.grid_root = root, "synth", str(tmp_path / "bop" / "grid")
    d.shorter_length, d.heatmap_shorter_length, d.n_local_test = 128, 7, 4
    d.load_zephyr_result, d.zephyr_result_path = True, str(tmp_path / "zr.pkl")
    cfg.model.img_h, cfg.model.img_w, cfg.model.heatmap_h, cfg.model.heatmap_w = 128, 160, 7, 9
    cfg.model.densenet_blocks = (2, 2, 2)
    with open(d.zephyr_result_path, "rb") as f:
        zr_list = pickle.load(f)
    dtoid = DtoidModel(cfg, seed=0, device=cuda)
    zephyr = ZephyrModel(num_points=64, inconst_ratio_th=100.0, seed=0, need_uv=False, refine_top=4, device=cuda)
    sd = dtoid.state_dict()
    args = argparse.Namespace(
        dataset_name="synth", exp_name="card", use_dtoid_segmask=False, ignore_dtoid_mask=False,
        always_dtoid_mask=True, use_oracle_gt=True, use_sift_hypos=False, use_maskrcnn=False,
        finetune_interval=2, finetune_warmup=0, finetune_epochs=1, finetune_reset=False,
        finetune_batch_size=2, non_cum=False, save_each=False, raw_dtoid=False, no_finetune=False,
        fast=True, zephyr_depth_crop=96, yuv_transfer=True)

    def run(pipelined):
        dtoid.load_state_dict(sd)
        dtoid.reset_optimizer()
        train_loader, _, test_loader = get_dataloaders(cfg, zr_list)
        test_loader.dataset.sortTargets()
        train_ds = train_loader.dataset
        train_ds.clearTargets()
        zr = {(r["obj_id"], r["scene_id"], r["im_id"]): dict(r) for r in zr_list}
        train_ds.zephyr_results = dict(zr)
        loop = OnlineLearningLoop(args, cfg, dtoid, bop, train_ds, test_loader, zr, zephyr_model=zephyr,
                                  hypo_gens={o: FakeHypoGen(n_hypos=8, seed=o) for o in bop.obj_ids},
                                  pipeline_scoring=pipelined)
        return loop.run(progress=False)

    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        sync, pipe, sync2 = run(False), run(True), run(False)
    finally:
        torch.backends.cudnn.deterministic = det
    assert len(pipe) == 4 and sum(r["finetune"] for r in pipe) == 2
    for key in chip_smoke.PIPE_KEYS:
        assert [r[key] for r in pipe] == [r[key] for r in sync] == [r[key] for r in sync2], key
    spread, cross = chip_smoke.run_spread(sync, sync2), chip_smoke.run_spread(pipe, sync)
    assert all(cross[k] <= spread[k] for k in cross), (cross, spread)


def _legacy_pair(name, devices=("cuda", "cpu")):
    """A legacy model at a small size on the card and on the CPU (or on
    `devices`) from the same weights, and a batch: the few-shot model at
    width 16 on 64x80 queries (its zero seg_final perturbed), the matcher at
    dim 64, one layer, 32 keypoints."""
    from ossid_code_torch.core.config import default_config
    from ossid_code_torch.models.fewshot_seg import FewshotSegModel
    from ossid_code_torch.models.matcher import SiftMatcher

    rng = np.random.default_rng(5)
    if name == "fewshot_seg":
        cfg = default_config().merged({"model": {"img_h": 64, "img_w": 80, "width": 16},
                                       "dataset": {"template_size": 32}})
        pair = [FewshotSegModel(cfg, device=d) for d in devices]
        with torch.no_grad():
            pair[0].net.seg_final.weight.normal_(0, 0.3)
            pair[0].net.seg_final.bias.zero_()
        batch = {"img": rng.uniform(0, 1, (2, 64, 80, 3)).astype(np.float32),
                 "mask": (rng.uniform(size=(2, 64, 80, 1)) > 0.6).astype(np.float32),
                 "simg": rng.uniform(0, 1, (2, 1, 32, 32, 3)).astype(np.float32),
                 "smask": (rng.uniform(size=(2, 1, 32, 32, 1)) > 0.5).astype(np.float32)}
    else:
        cfg = default_config().merged({"model": {"dim": 64, "n_layers": 1}, "dataset": {"n_kpts": 32}})
        pair = [SiftMatcher(cfg, device=d) for d in devices]
        M = np.zeros((2, 33, 33), np.float32)
        for i in range(2):
            M[i, np.arange(20), rng.permutation(32)[:20]] = 1.0
            M[i, :32, -1] = 1.0 - M[i, :32, :-1].sum(1)
            M[i, -1, :32] = 1.0 - M[i, :-1, :32].sum(0)
        batch = {"obs_desc": rng.uniform(0, 160, (2, 32, 128)).astype(np.float32),
                 "obs_uv": rng.uniform(0, 640, (2, 32, 2)).astype(np.float32),
                 "model_desc": rng.uniform(0, 160, (2, 32, 128)).astype(np.float32),
                 "model_pts": rng.normal(0, 0.05, (2, 32, 3)).astype(np.float32), "matches": M}
    pair[1].load_state_dict({k: v.cpu() for k, v in pair[0].state_dict().items()})
    return pair, batch


# A leaf whose exact gradient is zero (a bias that a training-mode BatchNorm's
# batch mean removes) holds only rounding on each device, so it is held by its
# size: at most ZERO_GRAD_TOL of that device's largest gradient (chip_smoke.py's
# rule). Every other leaf above STEP_GRAD_NOISE of the largest is held by
# relative L2.
# The leaves that rule names in each legacy model (biases_before_batchnorm
# finds them from a forward; the test checks the two agree).
LEGACY_ZERO_LEAVES = {
    "fewshot_seg": [f"{trunk}.conv{i}{b}.bias" for trunk in ("query_trunk", "support_trunk")
                    for i in range(3) for b in ("", "b")] + ["d1.bias", "d2.bias", "d3.bias"],
    "matcher": [],
}
LEGACY_GRAD_TOL = {"fewshot_seg": 0.1, "matcher": 0.03}
# a forward in training mode, the one the train step runs
LEGACY_TRAIN_FORWARD = {"fewshot_seg": lambda m, feed: m.forward(feed, train=True),
                        "matcher": lambda m, feed: m.forward(feed)}


def biases_before_batchnorm(net, forward):
    """The names of the conv biases of `net` whose output goes straight into
    a BatchNorm in training mode, traced through one call of `forward` by
    tensor identity: the batch mean takes such a bias out again, so its
    exact gradient is zero. The call's updates of the running statistics
    are undone."""
    made, fed = {}, set()
    state, training = {k: v.clone() for k, v in net.state_dict().items()}, net.training
    names = {m: n for n, m in net.named_modules()}

    def conv_out(mod, args, out):
        made[id(out)] = (mod, out)  # the tensor is kept, so its id is not reused

    def bn_in(mod, args):
        if mod.training and id(args[0]) in made:
            fed.add(names[made[id(args[0])][0]])

    convs = (torch.nn.Conv1d, torch.nn.Conv2d, torch.nn.Conv3d)
    hooks = [m.register_forward_hook(conv_out) for m in net.modules() if isinstance(m, convs) and m.bias is not None]
    hooks += [m.register_forward_pre_hook(bn_in) for m in net.modules()
              if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)]
    try:
        with torch.no_grad():
            forward()
    finally:
        for h in hooks:
            h.remove()
        net.load_state_dict(state)
        net.train(training)
    return sorted(f"{n}.bias" for n in fed)


def legacy_grad_faults(got, want, zero_leaves, tol):
    """The leaves of two gradient dicts (name -> tensor) that disagree: a leaf
    in `zero_leaves` above ZERO_GRAD_TOL of its own dict's largest gradient in
    either dict, any other leaf above STEP_GRAD_NOISE of the largest beyond
    `tol` relative L2. Returns [(name, reading)]."""
    scales = [max(float(g.abs().max()) for g in d.values()) for d in (got, want)]
    faults = []
    for n, w in want.items():
        if n in zero_leaves:
            size = max(float(d[n].abs().max()) / s for d, s in zip((got, want), scales))
            if size > ZERO_GRAD_TOL:
                faults.append((n, size))
        elif float(w.abs().max()) >= STEP_GRAD_NOISE * scales[1]:
            rel = float((got[n] - w).norm() / w.norm())
            if rel > tol:
                faults.append((n, rel))
    return faults


def plant_grad_faults(got, zero_leaves, held_leaf, tol):
    """Two copies of `got`, each with one planted fault: the first zero leaf
    scaled up to 10 ZERO_GRAD_TOL of the largest gradient (none if there is no
    zero leaf), and `held_leaf` scaled by 1 + 2 tol."""
    scale = max(float(g.abs().max()) for g in got.values())
    planted = []
    if zero_leaves:
        z = zero_leaves[0]
        g = got[z]
        size = float(g.abs().max())
        big = g * (10 * ZERO_GRAD_TOL * scale / size) if size > 0 else torch.full_like(g, 10 * ZERO_GRAD_TOL * scale)
        planted.append((z, {**got, z: big}))
    planted.append((held_leaf, {**got, held_leaf: got[held_leaf] * (1 + 2 * tol)}))
    return planted


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["fewshot_seg", "matcher"])
def test_legacy_models_match_cpu(cuda, name):
    """The few-shot model and the matcher on the card against the CPU from
    the same weights: the forward within 1e-4 of the largest magnitude (the
    matcher's log assignment within its CPU test's 2e-5), one train step's
    loss within 1e-4 relative and its gradients leaf by leaf within 0.1
    relative L2 (0.03 for the matcher, its CPU test's) above the 1e-6
    noise rule, but the conv biases before a training-mode BatchNorm
    (LEGACY_ZERO_LEAVES), each held by its size on each device; a planted
    fault on a zero leaf and on a held leaf fails that check; no kernel of
    the port launched."""
    (gpu, cpu), batch = _legacy_pair(name)
    before = tconv.dw_corr3x3_cuda.launches + tsa.sa_mlp_max_cuda.launches
    zero = LEGACY_ZERO_LEAVES[name]
    assert biases_before_batchnorm(cpu.net, lambda: LEGACY_TRAIN_FORWARD[name](cpu, cpu._feed(batch))) == sorted(zero)
    with torch.no_grad():
        out = [m.forward(m._feed(batch)).cpu().numpy() for m in (gpu, cpu)]
    err = np.abs(out[0] - out[1]).max()
    assert err <= (2e-5 if name == "matcher" else 1e-4 * np.abs(out[1]).max()), err
    losses = [float(m.train_step(batch)["loss"]) for m in (gpu, cpu)]
    assert abs(losses[0] - losses[1]) <= 1e-4 * abs(losses[1]), losses
    grads = [{n: p.grad.double().cpu() for n, p in m.net.named_parameters()} for m in (gpu, cpu)]
    tol = LEGACY_GRAD_TOL[name]
    assert legacy_grad_faults(grads[0], grads[1], zero, tol) == []
    held = "d1.weight" if name == "fewshot_seg" else "final_obs.weight"
    for leaf, planted in plant_grad_faults(grads[0], zero, held, tol):
        assert [n for n, _ in legacy_grad_faults(planted, grads[1], zero, tol)] == [leaf]
    assert tconv.dw_corr3x3_cuda.launches + tsa.sa_mlp_max_cuda.launches == before


@pytest.mark.cuda
def test_dtoid_wrapper_launches_kernel_1_twice_a_call(cuda, tmp_path):
    """DTOIDWrapper on the card (DenseNet (2, 2, 2) at 128x160, 3 of a
    6-view grid): 2 launches of kernel 1 a call, no other kernel, and the
    detections of the CPU wrapper from the same checkpoint (top score within
    1e-3, heat map within 1e-3)."""
    from ossid_code_torch.core.checkpoint import save_checkpoint
    from ossid_code_torch.core.config import default_config
    from ossid_code_torch.data.synthetic import default_objects, make_template_grid
    from ossid_code_torch.models.dtoid.module import DtoidModel
    from ossid_code_torch.models.dtoid.wrapper import DTOIDWrapper

    cfg = default_config().merged({"model": {"img_h": 128, "img_w": 160, "densenet_blocks": [2, 2, 2]}})
    m = DtoidModel(cfg, seed=2, device="cpu")
    with torch.no_grad():
        m.net.classification.output.weight.normal_(0, 0.05)
    save_checkpoint(str(tmp_path / "d.ckpt"), m.state_dict())
    make_template_grid(str(tmp_path / "grid"), default_objects(), n_views=6)
    img = np.random.default_rng(6).integers(0, 256, (128, 160, 3), dtype=np.uint8)
    wrappers = [DTOIDWrapper(str(tmp_path / "d.ckpt"), str(tmp_path / "grid"), [1, 2], n_local=3, cfg=cfg.merged({}),
                             device=d) for d in (None, "cpu")]
    wrappers[0](img, 1)
    counters = (tconv.dw_corr3x3_cuda, tconv.dw_corr3x3_dx_cuda, tconv.dw_corr3x3_dk_cuda, tsa.sa_mlp_max_cuda)
    for c in counters:
        c.launches = c.launches_bf16 = 0
    det = [wrappers[0](img, oid) for oid in (1, 2)]
    assert tconv.dw_corr3x3_cuda.launches == 4
    assert sum(c.launches + c.launches_bf16 for c in counters) == 4
    ref = wrappers[1](img, 1)
    assert abs(float(det[0]["pred_scores"][0] - ref["pred_scores"][0])) <= 1e-3
    assert np.abs(det[0]["heat_map"] - ref["heat_map"]).max() <= 1e-3
