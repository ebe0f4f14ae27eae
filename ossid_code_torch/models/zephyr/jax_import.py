"""Carry Zephyr scorer weights from the JAX package into the port.

`pointnet2_from_jax(params, batch_stats)` takes the JAX package's PointNet2SSG
nested dicts of numpy arrays and returns a state_dict, under the zephyr /
Pointnet2_PyTorch key names, that the port's `PointNet2SSG` loads with
strict=True: 1x1 conv kernels (1, 1, in, out) -> (out, in, 1, 1), Dense
(in, out) -> Linear (out, in), BatchNorm scale/bias/mean/var ->
weight/bias/running_mean/running_var. The residual `align_head`, which the
JAX package's torch export leaves out, is carried too when present.
"""

from __future__ import annotations

import numpy as np
import torch

_SA_NAMES = ("sa1", "sa2", "sa3")
_FC = (("0", "fc1", "bn_fc1"), ("2", "fc2", "bn_fc2"), ("4", "fc3", None))


def _t(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32))


def _bn(sd: dict, prefix: str, scale_bias: dict, stats: dict) -> None:
    sd[f"{prefix}.weight"] = _t(scale_bias["scale"])
    sd[f"{prefix}.bias"] = _t(scale_bias["bias"])
    sd[f"{prefix}.running_mean"] = _t(stats["mean"])
    sd[f"{prefix}.running_var"] = _t(stats["var"])


def pointnet2_from_jax(params: dict, batch_stats: dict) -> dict:
    """JAX PointNet2SSG params + batch_stats (numpy) -> port state_dict."""
    sd = {}
    for i, name in enumerate(_SA_NAMES):
        mod, smod = params[name], batch_stats[name]
        j = 0
        while f"mlp{j}" in mod:
            base = f"SA_modules.{i}.mlps.0.layer{j}"
            sd[f"{base}.conv.weight"] = _t(np.transpose(np.asarray(mod[f"mlp{j}"]["kernel"]), (3, 2, 0, 1)))
            _bn(sd, f"{base}.bn.bn", mod[f"bn{j}"], smod[f"bn{j}"])
            j += 1
    for idx, dense, bn in _FC:
        base = f"FC_layer.{idx}"
        sd[f"{base}.fc.weight"] = _t(np.asarray(params[dense]["kernel"]).T)
        if "bias" in params[dense]:
            sd[f"{base}.fc.bias"] = _t(params[dense]["bias"])
        if bn is not None:
            _bn(sd, f"{base}.bn.bn", params[bn], batch_stats[bn])
    if "align_head" in params:
        sd["align_head.weight"] = _t(np.asarray(params["align_head"]["kernel"]).T)
        sd["align_head.bias"] = _t(params["align_head"]["bias"])
    return sd
