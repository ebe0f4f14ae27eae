"""The port's driver entry points (`ossid_code_torch/entry.py`) against the
JAX package's (`__graft_entry__.py`), on the CPU.

`entry()`: the port's all-templates forward at the JAX entry's shapes
(128x160, heat map 7x9, 4 templates) with the JAX entry's weights carried
across by `dtoid_from_jax`, held to `tests/test_torch_dtoid.py`'s tolerance
on the example arguments and on seeded random ones. Both sides run
DenseNet (2, 2, 2) (the JAX entry reads `default_config`, patched here):
the full DenseNet-121 build costs about 40 s in JAX here. The heads' output
convs and the BatchNorm terms are perturbed on both sides, as
test_torch_dtoid.py does, so that the outputs differ between anchors.

`dryrun_multidevice(2)`: the mesh's serving helpers on two CPU devices and
one data-parallel step in two gloo processes, to a finite loss.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_dtoid import TOL, _perturb, _to_np

torch.set_num_threads(2)

BLOCKS = (2, 2, 2)


@pytest.fixture(scope="module")
def entries():
    """(JAX fn, port fn) on the same perturbed weights, and the JAX example
    arguments."""
    import __graft_entry__
    import ossid_code_tpu.core.config as jconfig

    from ossid_code_torch.entry import entry
    from ossid_code_torch.models.dtoid.jax_import import dtoid_from_jax

    default = jconfig.default_config

    def small():
        cfg = default()
        cfg.model.densenet_blocks = BLOCKS
        return cfg

    jconfig.default_config = small
    try:
        jfn, jargs = __graft_entry__.entry()
    finally:
        jconfig.default_config = default
    cells = dict(zip(jfn.__code__.co_freevars, jfn.__closure__))
    params, stats = _perturb(_to_np(cells["params"].cell_contents), _to_np(cells["batch_stats"].cell_contents),
                             np.random.default_rng(21))
    cells["params"].cell_contents, cells["batch_stats"].cell_contents = params, stats
    tfn, targs = entry(device="cpu", densenet_blocks=BLOCKS)
    tfn.model.net.load_state_dict(dtoid_from_jax(params, stats), strict=True)
    for j, t in zip(jargs, targs):
        assert tuple(t.shape) == j.shape and t.device.type == "cpu"
    return jax.jit(jfn), tfn, jargs


@pytest.mark.parametrize("inputs", ["example", "random"])
def test_entry_matches_jax(entries, inputs):
    jfn, tfn, jargs = entries
    if inputs == "random":
        rng = np.random.default_rng(5)
        jargs = (rng.uniform(0, 1, jargs[0].shape).astype(np.float32),
                 rng.normal(0, 1, jargs[1].shape).astype(np.float32),
                 rng.normal(0, 1, jargs[2].shape).astype(np.float32))
    want = jfn(*(jnp.asarray(a) for a in jargs))
    got = tfn(*(torch.from_numpy(np.asarray(a)) for a in jargs))
    assert len(got) == len(want) == 4
    for name, g, w in zip(("cls", "reg", "heatmap"), got[:3], want[:3]):
        assert tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name, **TOL)
    assert float(np.asarray(want[0]).std()) > 0  # the perturbed heads tell anchors apart
    seg_t, seg_j = got[3].numpy() > 0.5, np.asarray(want[3]) > 0.5
    assert seg_t.shape == seg_j.shape and (seg_t != seg_j).mean() <= 1e-3


def test_dryrun_multidevice_on_two_cpu_devices():
    from ossid_code_torch.entry import dryrun_multidevice

    out = dryrun_multidevice(2, device="cpu")
    assert out["template_parallel_cls"][0] == 2 and out["farm_mesh"] == [1, 2]
    assert out["hypothesis_parallel_scores"] == [4]
    assert len(out["dp_losses"]) == 2 and all(np.isfinite(out["dp_losses"]))
