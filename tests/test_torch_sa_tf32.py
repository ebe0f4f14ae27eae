"""Why the port's SA kernel (csrc/sa_mlp_max.cu) takes three TF32 passes, and
that the weights it reads are the folded weights, on the CPU.

The kernel splits each float32 operand a into hi = rna_tf32(a) and
lo = rna_tf32(a - hi) and sums a_hi b_hi + a_hi b_lo + a_lo b_hi on the
tensor cores. Here that arithmetic is emulated in plain torch, TF32 rounding
done by integer ops on the bit pattern, at both width sets of the scorer,
and held against `sa_mlp_max_plain`; and `pack_sa_weights`' layout is read
back the way the kernel reads it.
"""

import numpy as np
import pytest
import torch

from ossid_code_torch.ops import sa_fused as tsa

torch.set_num_threads(2)
WIDTHS = [((64, 64, 128), 8), ((128, 128, 256), 128)]  # SA1, SA2 of the scorer
# (K1, KS) the wrapper packs for; tests/test_torch_cuda.py checks on the card
# that the kernel's instances read the same
LAYOUT = tsa.SA_LAYOUT


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32: to nearest, ties away from zero, low 13
    mantissa bits cleared (integer ops on the bit pattern)."""
    bits = x.contiguous().view(torch.int32).to(torch.int64)
    mag = ((bits & 0x7FFFFFFF) + 0x1000) & 0x7FFFE000
    out = torch.where(bits < 0, mag | -0x80000000, mag).to(torch.int32)
    return out.view(torch.float32)


def _stage(rng, widths, cf, m=2, n=96, s=24, k=64):
    """Inputs as tests/test_torch_cuda.py draws them: N(0, 0.3) points,
    N(0, 0.2) weights and biases."""
    pts = torch.from_numpy(rng.normal(0, 0.3, (m, n, 3 + cf)).astype(np.float32))
    cidx = torch.from_numpy(rng.choice(n, s, replace=False).astype(np.int32))
    gidx = torch.from_numpy(rng.integers(0, n, (s, k)).astype(np.int32))
    dims = (3 + cf,) + widths
    Ws = [torch.from_numpy(rng.normal(0, 0.2, (dims[i], dims[i + 1])).astype(np.float32))
          for i in range(3)]
    bs = [torch.from_numpy(rng.normal(0, 0.2, dims[i + 1]).astype(np.float32)) for i in range(3)]
    return pts[..., :3], pts[..., 3:], cidx, gidx, Ws, bs


def _emulate(xyz, feats, cidx, gidx, Ws, bs, passes):
    """One SA stage with every product taken in TF32: 3 passes (hi hi +
    hi lo + lo hi) or 1 (hi hi), sums in float32."""
    x = tsa._grouped(xyz, feats, cidx, gidx)
    for w, b in zip(Ws, bs):
        xh, wh = _tf32(x), _tf32(w)
        y = torch.matmul(xh, wh)
        if passes == 3:
            y = y + torch.matmul(xh, _tf32(w - wh)) + torch.matmul(_tf32(x - xh), wh)
        x = torch.relu(y + b)
    return x.amax(dim=2)


def test_tf32_round_is_rna():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -12, -(1.0 + 2 ** -11), 1.0 + 2 ** -12,
                      -(1.0 + 2 ** -12), 0.0, 3.0e-39])
    want = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -10, -(1.0 + 2 ** -10), 1.0, -1.0, 0.0,
                         3.0e-39])
    got = _tf32(x)
    assert torch.equal(got.view(torch.int32) & 0x1FFF, torch.zeros(8, dtype=torch.int32))
    assert torch.equal(got[:7], want[:7])
    # the package's rounding (used to pack the weights) is the same function
    r = torch.from_numpy(np.random.default_rng(0).normal(0, 3, 4096).astype(np.float32))
    assert torch.equal(tsa.tf32_round(r), _tf32(r))
    assert ((r - _tf32(r)).abs() <= r.abs() * 2 ** -11).all()


@pytest.mark.parametrize("widths,cf", WIDTHS)
def test_three_tf32_passes_hold_float32(widths, cf):
    """3 passes stay within 1e-5 of float32; 1 pass does not stay within the
    kernel's 1e-4 tolerance."""
    args = _stage(np.random.default_rng(11), widths, cf)
    want = tsa.sa_mlp_max_plain(*args)
    err3 = (_emulate(*args, passes=3) - want).abs().max().item()
    err1 = (_emulate(*args, passes=1) - want).abs().max().item()
    assert err3 <= 1e-5, err3
    assert err1 > 1e-4, err1


def _unpack(packed, widths, cf):
    """Read the packed buffer back as the kernel's descriptors address it:
    per slice a hi and a lo block, element (n, k) of a rows x kc block at
    ((n // 8) * (kc // 4) + k // 4) * 32 + (n % 8) * 4 + k % 4. Returns per
    layer (hi, lo) W^T in the packed (logical) K order."""
    k1, ks = LAYOUT[widths]
    depth = (k1,) + widths[:2]
    out = [[torch.zeros(c, d) for _ in range(2)] for c, d in zip(widths, depth)]
    n_, k_ = torch.meshgrid(torch.arange(128), torch.arange(max(ks, 64)), indexing="ij")
    off = 0
    for layer, n0, rows, k0, kc in tsa.sa_slices(widths, k1, ks):
        n, k = n_[:rows, :kc], k_[:rows, :kc]
        pos = ((n // 8) * (kc // 4) + k // 4) * 32 + (n % 8) * 4 + k % 4
        for half in range(2):
            out[layer][half][n0:n0 + rows, k0:k0 + kc] = packed[off + pos]
            off += rows * kc
    assert off == packed.numel()
    return out


@pytest.mark.parametrize("widths,cf", WIDTHS)
def test_pack_sa_weights_round_trip(widths, cf):
    """hi + lo gives back W within 2^-21 relative, hi and lo are TF32 values,
    the pad rows are exactly zero, and the K orders are the kernel's:
    [feats, xyz - centre, 0...] for layer 1, PERM within each 8 after."""
    _, _, _, _, Ws, _ = _stage(np.random.default_rng(3), widths, cf)
    layers = _unpack(tsa.pack_sa_weights(Ws, cf, *LAYOUT[widths]), widths, cf)
    perm = torch.from_numpy(8 * (np.arange(128) // 8) + np.array([0, 2, 4, 6, 1, 3, 5, 7])[np.arange(128) % 8])
    for i, ((hi, lo), w) in enumerate(zip(layers, Ws)):
        for t in (hi, lo):
            assert torch.equal(t.view(torch.int32) & 0x1FFF, torch.zeros_like(t, dtype=torch.int32))
        if i == 0:
            order = list(range(3, 3 + cf)) + [0, 1, 2]
            assert torch.equal(hi[:, len(order):], torch.zeros_like(hi[:, len(order):]))
            assert torch.equal(lo[:, len(order):], torch.zeros_like(lo[:, len(order):]))
            hi, lo, wt = hi[:, :len(order)], lo[:, :len(order)], w[order].T
        else:
            wt = w[perm[: w.shape[0]]].T
        assert ((hi + lo - wt).abs() <= wt.abs() * 2 ** -21).all()
        assert torch.equal(hi, _tf32(wt))


@pytest.mark.parametrize("widths,cf,k", [(*WIDTHS[0], 64), (*WIDTHS[1], 64), (*WIDTHS[0], 13)])
def test_kernel_dataflow_matches_plain(widths, cf, k):
    """The kernel's data flow at matrix level: gathered rows in the packed
    layer-1 order, each layer's A fragment taken from the previous
    accumulator in the PERM order, 3 passes over the unpacked hi / lo
    weights, rows >= k masked out of the max."""
    xyz, feats, cidx, gidx, Ws, bs = _stage(np.random.default_rng(5), widths, cf, k=k)
    layers = _unpack(tsa.pack_sa_weights(Ws, cf, *LAYOUT[widths]), widths, cf)
    k1 = LAYOUT[widths][0]
    g = tsa._grouped(xyz, feats, cidx, gidx)
    x = torch.cat([g[..., 3:], g[..., :3], g.new_zeros(*g.shape[:3], k1 - 3 - cf)], -1)
    perm = torch.from_numpy(8 * (np.arange(128) // 8) + np.array([0, 2, 4, 6, 1, 3, 5, 7])[np.arange(128) % 8])
    for i, ((hi, lo), b) in enumerate(zip(layers, bs)):
        if i:
            x = x[..., perm[: x.shape[-1]]]
        xh = _tf32(x)
        x = torch.relu(b + torch.matmul(xh, lo.T) + torch.matmul(_tf32(x - xh), hi.T)
                       + torch.matmul(xh, hi.T))
    got = x.amax(dim=2)
    torch.testing.assert_close(got, tsa.sa_mlp_max_plain(xyz, feats, cidx, gidx, Ws, bs),
                               rtol=1e-5, atol=1e-5)
