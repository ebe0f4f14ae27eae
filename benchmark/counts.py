"""The yardstick's operation and byte counts, and the card's peaks.

Model FLOPs are counted on the reference's plain networks (`reference/`) on
meta tensors, under PyTorch's `FlopCounterMode` (convolutions and matrix
products), so that they read the same work whatever kernel computes it:

  * `detect_flops`: one frame's trunk and heads over T templates, and the
    segmentation decoder of the winning template (the template features
    are cached and not counted);
  * `score_flops`: the scorer network over m hypotheses (the ones a call
    scores, not its padded bucket);
  * `step_flops`: one finetune step's forward and backward at a batch.

A grouped convolution's weight gradient counts as the forward's
multiply-adds, not `groups` times over (the counter's own formula).

The hand-written kernels' bounds come from their shapes, as the port's
chip_smoke.py reckons them (`bound_s`, `unique_bytes`, `sa_flops`): the least
time the call's distinct bytes need at the card's bandwidth, or its
operations at the peak rate, whichever is longer.
"""

from __future__ import annotations

import functools

import torch
from torch.utils.flop_counter import FlopCounterMode, conv_flop_count

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
PEAKS = {"hbm_bytes_per_s": 3.35e12, "fp32_flops": 67e12, "tf32_flops": 495e12, "bf16_flops": 989e12}


def _conv_backward_flop(grad_out_shape, x_shape, w_shape, _bias, _stride, _padding, _dilation, transposed,
                        _output_padding, _groups, output_mask, out_shape=None, **kwargs) -> int:
    forward = conv_flop_count(x_shape, w_shape, grad_out_shape, transposed)
    return forward * (int(output_mask[0]) + int(output_mask[1]))


def _counted(fn) -> float:
    with FlopCounterMode(display=False,
                         custom_mapping={torch.ops.aten.convolution_backward: _conv_backward_flop}) as fc:
        fn()
    return float(fc.get_total_flops())


def _meta_dtoid(img_hw, blocks):
    from benchmark.reference.network import DtoidNetwork

    with torch.device("meta"):
        return DtoidNetwork(tuple(img_hw), tuple(blocks)).eval()


@functools.lru_cache(maxsize=None)
def detect_flops(img_hw: tuple, blocks: tuple, templates: int, template_size: int = 124) -> float:
    """FLOPs of one detect over `templates` templates."""
    from benchmark.reference.network import imagenet_normalize

    net = _meta_dtoid(img_hw, blocks)
    h, w = img_hw
    with torch.device("meta"), torch.no_grad():
        t4 = torch.empty(templates, template_size, template_size, 4)
        local = net.compute_template_local(t4)
        glob = net.compute_template_global(t4[:1])
        image = imagenet_normalize(torch.empty(1, h, w, 3))

        def run():
            xcors, _, _, _ = net._heads(image, local, glob)
            net.correlation_model.decode_seg(xcors[:1])
        return _counted(run)


@functools.lru_cache(maxsize=None)
def step_flops(img_hw: tuple, blocks: tuple, batch: int, template_size: int = 124) -> float:
    """FLOPs of one finetune step's forward and backward at `batch`."""
    net = _meta_dtoid(img_hw, blocks).train()
    h, w = img_hw
    ts = template_size
    with torch.device("meta"):
        args = (torch.empty(batch, h, w, 3), torch.empty(batch, ts, ts, 3), torch.empty(batch, ts, ts, 1),
                torch.empty(batch, ts, ts, 3), torch.empty(batch, ts, ts, 1))

        def run():
            out = net(*args)
            sum(v.sum() for v in out.values()).backward()
        return _counted(run)


@functools.lru_cache(maxsize=None)
def score_flops(num_points: int, m: int) -> float:
    """FLOPs of the scorer network over m hypotheses of `num_points` points."""
    from benchmark.reference.features import DIM_POINT
    from benchmark.reference.pointnet2 import PointNet2SSG

    if m <= 0:
        return 0.0
    with torch.device("meta"):
        net = PointNet2SSG(num_class=1, dim_point=DIM_POINT).eval()
    s1 = min(512, num_points)
    s2 = min(128, s1)
    with torch.device("meta"), torch.no_grad():
        idx = {"sa1": (torch.empty(s1, dtype=torch.int32), torch.empty(s1, min(64, num_points), dtype=torch.int32)),
               "sa2": (torch.empty(s2, dtype=torch.int32), torch.empty(s2, 64, dtype=torch.int32))}
        x = torch.empty(m, num_points, DIM_POINT)
        return _counted(lambda: net(x, idx))


def bound_s(nbytes: float, flops: float, flops_per_s: float) -> tuple:
    """(least seconds, "bytes" or "operations")."""
    t_bytes, t_ops = nbytes / PEAKS["hbm_bytes_per_s"], flops / flops_per_s
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def unique_bytes(shape, strides, element_size: int) -> int:
    """Bytes a tensor's distinct elements occupy (a stride-0 broadcast counts once)."""
    n = 1
    for size, stride in zip(shape, strides):
        if stride != 0:
            n *= size
    return n * element_size


def dw_corr3x3_bound_s(x_shape, x_strides, k_shape, k_strides, element_size: int = 4) -> float:
    """Kernel 1: x (B, H, W, C) against per-sample 3x3 taps, padding 1: the
    distinct bytes of x and the taps, the output written once; 18 operations
    an output element. Bound by the bytes at every main-path shape."""
    out = x_shape[0] * x_shape[1] * x_shape[2] * x_shape[3]
    nbytes = (unique_bytes(x_shape, x_strides, element_size) + unique_bytes(k_shape, k_strides, element_size)
              + out * element_size)
    return bound_s(nbytes, 18.0 * out, PEAKS["fp32_flops"])[0]


def sa_flops(m: int, s: int, k: int, dims) -> float:
    return 2.0 * m * s * k * sum(dims[i] * dims[i + 1] for i in range(3))


def sa_mlp_max_bound_s(m: int, s: int, k: int, dims, nbytes: float) -> float:
    """Kernel 2 over m hypotheses: three layers on every grouped point at the
    TF32 tensor-core rate (one pass: the kernel's three passes of 3xTF32
    are its own cost), or its bytes, whichever is longer."""
    return bound_s(nbytes, sa_flops(m, s, k, dims), PEAKS["tf32_flops"])[0]
