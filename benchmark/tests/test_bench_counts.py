"""The yardstick's counts at fixed shapes: model FLOPs against the port's
roofline script (scripts/roofline.py) and the kernels' bounds against the
bound column of PERF.md's kernel table."""

import numpy as np
import pytest

from benchmark import counts


def _strides(shape, broadcast0=False):
    st = [1] * len(shape)
    for i in range(len(shape) - 2, -1, -1):
        st[i] = st[i + 1] * shape[i + 1]
    if broadcast0:
        st[0] = 0
    return tuple(st)


def test_detect_flops_match_the_roofline_scripts_count():
    """Detection over 10 templates at 128x160 (DenseNet 2/2/2): the frozen
    count on meta tensors against scripts/roofline.py's count of the port's
    detect program on the CPU, its convolutions. The script also counts the
    NMS's pairwise product over the 1,000 boxes before it (2 x 1000 x 1000
    x 20 = 0.04 GFLOP, 0.01% of a full-size detect), which the frozen count
    leaves out."""
    from ossid_code_torch.core.config import default_config
    from ossid_code_torch.models.dtoid.module import DtoidModel
    from ossid_code_torch.scripts import roofline

    cfg = default_config().merged({"model": {"img_h": 128, "img_w": 160, "densenet_blocks": (2, 2, 2)}})
    model = DtoidModel(cfg, seed=0, device="cpu")
    fn, args = roofline.detect_program(model, np.random.default_rng(0), t_count=10)
    by_op = roofline.flop_breakdown(fn, *args)
    assert set(by_op) == {"aten.convolution", "aten.mm", "hand-written kernels"}
    assert by_op["aten.mm"] == 2 * 1000 * 1000 * 20
    assert counts.detect_flops((128, 160), (2, 2, 2), 10) == by_op["aten.convolution"]


@pytest.mark.parametrize("what,gflop", [("detect_t10", 377.2), ("step_b8", 2055.1), ("score_m128", 271.0)])
def test_full_size_flops_match_the_recorded_roofline(what, gflop):
    """The roofline script's counts at the main path's shapes, as PERF.md
    records them (`chip_smoke.py` phase 15a)."""
    got = {"detect_t10": lambda: counts.detect_flops((480, 640), (12, 24, 16), 10),
           "step_b8": lambda: counts.step_flops((480, 640), (12, 24, 16), 8),
           "score_m128": lambda: counts.score_flops(512, 128)}[what]()
    assert got / 1e9 == pytest.approx(gflop, abs=0.15)


@pytest.mark.parametrize("x,bcast,bound_ms", [
    ((10, 29, 39, 640), True, 0.0096), ((1, 240, 320, 64), False, 0.0117), ((160, 29, 39, 640), True, 0.1403),
    ((8, 29, 39, 640), False, 0.0139), ((8, 240, 320, 64), False, 0.0939)])
def test_kernel1_bounds_match_the_kernel_table(x, bcast, bound_ms):
    k = (x[0], 3, 3, x[3])
    got = counts.dw_corr3x3_bound_s(x, _strides(x, bcast), k, _strides(k)) * 1e3
    assert got == pytest.approx(bound_ms, abs=5e-5)


@pytest.mark.parametrize("m,s,dims,bound_ms", [
    (128, 512, (11, 64, 64, 128), 0.220), (128, 128, (131, 128, 128, 256), 0.279),
    (256, 512, (11, 64, 64, 128), 0.440), (256, 128, (131, 128, 128, 256), 0.559)])
def test_kernel2_bounds_match_the_kernel_table(m, s, dims, bound_ms):
    assert counts.sa_mlp_max_bound_s(m, s, 64, dims, 0.0) * 1e3 == pytest.approx(bound_ms, abs=5e-4)
