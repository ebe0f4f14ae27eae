"""The port's roofline (ossid_code_torch/scripts/roofline.py) on the CPU: its
FLOP count against a count made here from the layer shapes, XLA's count of
the JAX programs beside it, and the table's rows at a small configuration.

On the CPU the hand-written kernels' plain versions run (a grouped
convolution, matrix products), which PyTorch's FLOP counter sees and the
kernel wrappers' tallies do not: the count here is the count the card gives
for the same program at the same shapes (chip_smoke.py phase 15a holds the
two equal at full width).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ossid_code_torch.core.config import default_config as t_default_config
from ossid_code_torch.models.dtoid import network as tnetwork
from ossid_code_torch.models.dtoid.module import DtoidModel as TDtoidModel
from ossid_code_torch.models.zephyr.module import ZephyrModel as TZephyrModel
from ossid_code_torch.ops import nms as tnms
from ossid_code_torch.scripts import roofline

torch.set_num_threads(2)
H, W, T, M, NUM_POINTS = 128, 160, 4, 8, 128
# the port's count over XLA's cost model on the JAX package's programs,
# measured on this CPU: detect 1.137 (128x160, T=4) and 1.092 (160x224,
# T=2); score 0.980 (128 points, M=8) and 0.977 (256 points, M=16). The two
# are different quantities: XLA leaves out a convolution's products with its
# zero padding and counts element-wise work (BatchNorm, relu, sampling,
# HSV), which the port's count (convolutions and matrix products) leaves out.
DETECT_XLA_BAND = (1.05, 1.20)
SCORE_XLA_BAND = (0.95, 1.00)


def _small_cfg(cfg):
    cfg.model.img_h, cfg.model.img_w = H, W
    cfg.model.heatmap_h, cfg.model.heatmap_w = H // 16 - 1, W // 16 - 1
    cfg.model.densenet_blocks = (2, 2, 2)
    return cfg


def _nms_sweeps(boxes, scores, iou_threshold, valid):
    """The sweeps ops/nms.py::nms_fixed runs to its fixed point on these
    boxes: its iteration, re-run here with a counter (the products in numpy,
    out of the FLOP counter's sight)."""
    adj = (tnms.batched_iou(boxes, boxes) > iou_threshold)
    order = torch.argsort(torch.argsort(-scores, stable=True), stable=True)
    adj = adj & (order[:, None] < order[None, :])
    if valid is not None:
        adj = adj & valid[:, None]
    adj = adj.numpy().astype(np.float32)
    keep, sweeps = np.ones(boxes.shape[0], dtype=bool), 0
    while True:
        prev = keep
        for _ in range(tnms._SWEEPS_PER_CHECK):
            keep = ~((keep.astype(np.float32) @ adj) > 0.5)
            sweeps += 1
        if np.array_equal(keep, prev):
            return sweeps


def test_detect_flops_equal_the_layer_count(monkeypatch):
    """program_flops of a small detect = 2 * MACs of every Conv2d (from its
    weight and output shapes) + 2 * 9 * B * H * W * C of each depthwise
    correlation + 2 * K^2 a sweep of the NMS fixed point (the data decide
    the sweeps): exactly."""
    model = TDtoidModel(_small_cfg(t_default_config()), seed=0, device="cpu")
    fn, args = roofline.detect_program(model, np.random.default_rng(0), T)
    counted = []

    def conv_hook(m, inp, out):
        counted.append(2 * out.numel() * (m.in_channels // m.groups) * m.kernel_size[0] * m.kernel_size[1])

    corr = tnetwork.depthwise_corr

    def counted_corr(x, kernel, padding=0, cross=False):
        out = corr(x, kernel, padding, cross)
        counted.append(2 * kernel.shape[1] * kernel.shape[2] * out.numel())
        return out

    nms_fixed = tnms.nms_fixed

    def counted_nms(boxes, scores, iou_threshold, valid=None):
        counted.append(2 * boxes.shape[0] ** 2 * _nms_sweeps(boxes, scores, iou_threshold, valid))
        return nms_fixed(boxes, scores, iou_threshold, valid)

    monkeypatch.setattr(tnetwork, "depthwise_corr", counted_corr)
    monkeypatch.setattr(tnms, "nms_fixed", counted_nms)
    hooks = [m.register_forward_hook(conv_hook) for m in model.net.modules() if isinstance(m, torch.nn.Conv2d)]
    try:
        breakdown = roofline.flop_breakdown(fn, *args)
    finally:
        for h in hooks:
            h.remove()
    assert breakdown["hand-written kernels"] == 0  # the plain versions ran
    assert sum(breakdown.values()) == sum(counted), (breakdown, sum(counted))

    # XLA's count of the JAX package's detect program, printed beside
    from ossid_code_tpu.core.config import default_config
    from ossid_code_tpu.models.dtoid.module import DtoidModel
    from ossid_code_tpu.scripts.roofline import program_flops

    jd = DtoidModel(_small_cfg(default_config()), seed=0)
    rng = np.random.default_rng(0)
    img = jnp.asarray(rng.integers(0, 255, (1, H, W, 3), dtype=np.uint8))
    local, glob = jd.get_template_features(1, rng.uniform(0, 1, (T, 124, 124, 3)).astype(np.float32),
                                           np.ones((T, 124, 124, 1), np.float32))
    xla = program_flops(jd._infer, *jd._infer_vars(), img, local, glob)
    ratio = sum(counted) / xla
    print(f"detect {H}x{W} T={T}: port {sum(counted)} FLOP, XLA {xla:.0f}, ratio {ratio:.4f}")
    assert DETECT_XLA_BAND[0] <= ratio <= DETECT_XLA_BAND[1]


def _score_layer_count(zm, m: int) -> int:
    """2 * the score program's multiply-adds, from the network's weight
    shapes and the object's grouping: SA1 and SA2 on M x S x k rows, SA3 on
    M x S2 rows, the FC head on M rows, and the features' two rotations of
    the N model points and normals (3 x 3 a point)."""
    net = zm.net
    pts, _, _, sa1c, sa1g, sa2c, sa2g, *_ = zm._objects[1]

    def mlp(sa):
        return sum(layer.conv.weight.shape[0] * layer.conv.weight.shape[1] for layer in sa.mlps[0].children())

    sa1, sa2, sa3 = net.SA_modules
    fc = sum(layer.fc.weight.numel() for layer in net.FC_layer if hasattr(layer, "fc"))
    macs = (m * sa1g.shape[0] * sa1g.shape[1] * mlp(sa1) + m * sa2g.shape[0] * sa2g.shape[1] * mlp(sa2)
            + m * sa2c.shape[0] * mlp(sa3) + m * fc + 2 * m * pts.shape[0] * 9)
    return 2 * macs


@pytest.mark.parametrize("bf16", [False, True])
def test_score_flops_equal_the_layer_count(bf16):
    zm = TZephyrModel(num_points=NUM_POINTS, inconst_ratio_th=100.0, seed=0, need_uv=False, bf16=bf16,
                      device="cpu")
    inputs = roofline.score_inputs(np.random.default_rng(0), (H, W))
    fn, args = roofline.score_program(zm, inputs, M)
    breakdown = roofline.flop_breakdown(fn, *args)
    assert breakdown["hand-written kernels"] == 0
    assert sum(breakdown.values()) == _score_layer_count(zm, M), breakdown
    if bf16:
        return

    from ossid_code_tpu.models.zephyr.module import ZephyrModel
    from ossid_code_tpu.scripts.roofline import program_flops

    jz = ZephyrModel(num_points=NUM_POINTS, inconst_ratio_th=100.0, seed=0, need_uv=False)
    prep = jz.prepare_object(1, inputs["pts"], inputs["cols"], inputs["nrms"])
    poses = np.tile(np.eye(4, dtype=np.float32), (M, 1, 1))
    poses[:, 2, 3] = 0.6
    sargs = (*jz._score_vars(), *map(jnp.asarray, (inputs["img"], inputs["depth"], inputs["origin"], inputs["K"])),
             *prep, jnp.asarray(poses), jnp.ones((M,), bool))
    xla = program_flops(jz._score, *sargs)
    ratio = sum(breakdown.values()) / xla
    print(f"score {NUM_POINTS} points M={M}: port {sum(breakdown.values())} FLOP, XLA {xla:.0f}, ratio {ratio:.4f}")
    assert SCORE_XLA_BAND[0] <= ratio <= SCORE_XLA_BAND[1]


def test_grouped_conv_backward_counts_the_forward_twice():
    """A depthwise correlation's backward (the finetune step's dx and dk on
    the CPU) counts 2 x its forward, not PyTorch's formula's groups x over
    for the weight gradient; the card's dx and dk tallies are one forward
    each."""
    b, c, h, w = 2, 8, 5, 6
    x = torch.randn(1, b * c, h, w, requires_grad=True)
    k = torch.randn(b * c, 1, 3, 3, requires_grad=True)

    def step():
        torch.nn.functional.conv2d(x, k, groups=b * c, padding=1).sum().backward()

    breakdown = roofline.flop_breakdown(step)
    fwd = 2 * 9 * b * c * h * w
    assert breakdown["aten.convolution"] == fwd
    assert breakdown["aten.convolution_backward"] == 2 * fwd


def test_rows_name_the_cpu(monkeypatch):
    """The table's rows at a small configuration on the CPU: JAX's keys, the
    peak used, and the device 'cpu' in every row; the float32 peak follows
    cuDNN's TF32 flag, and the overrides win."""
    rows = roofline.rows(_small_cfg(t_default_config()), hypos=(M,), iters=1, device="cpu",
                         num_points=NUM_POINTS, img_hw=(H, W))
    assert [r["program"] for r in rows] == ["detect t=10 f32", "finetune b=8 f32", f"score M={M} f32",
                                            f"score M={M} bf16"]
    for r in rows:
        assert {"program", "gflops", "ms", "tflops", "mfu_pct", "peak_tflops", "device"} <= set(r)
        assert r["device"] == "cpu" and r["gflops"] > 0 and r["ms"] > 0
    assert rows[-1]["peak_tflops"] == 989.0
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    assert roofline.peaks()["f32"] == 67e12
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    assert roofline.peaks()["f32"] == 495e12
    monkeypatch.setenv("OSSID_PEAK_TFLOPS_F32", "100")
    monkeypatch.setenv("OSSID_PEAK_TFLOPS_BF16", "200")
    assert roofline.peaks()["f32"] == 100e12 and roofline.peaks()["bf16"] == 200e12


def test_main_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: nothing to refuse")
    with pytest.raises(RuntimeError, match="CUDA"):
        roofline.main(["--hypos", "8"])
