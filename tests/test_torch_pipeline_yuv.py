"""The port's pipelined loop against its synchronous loop with the YUV 4:2:0
frame transport and a 96-px depth crop, on the CPU: part (a) of
tests/test_torch_pipeline.py (its world, weights and criteria) with the
bench's transport flags, at the default knobs and with every other value
of each knob.
"""

import pytest

from test_torch_loop import jax_native_libraries, world  # noqa: F401
from test_torch_pipeline import KNOBS_BY_FLAGS, check_pipelined_against_sync, port_weights  # noqa: F401


@pytest.mark.parametrize("knobs", KNOBS_BY_FLAGS["yuv"])
def test_pipelined_rows_equal_synchronous(world, port_weights, monkeypatch, knobs):  # noqa: F811
    check_pipelined_against_sync(world, port_weights, monkeypatch, "yuv", knobs)
