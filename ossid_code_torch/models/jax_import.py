"""Carry weights between the JAX package's flax trees and the port's modules
whose names are the flax module names (models/layers.py,
models/fewshot_seg.py, models/matcher.py).

`flax_to_state_dict(params, batch_stats)` walks the flax tree: a node with a
4-D `kernel` is a conv (HWIO -> OIHW), with a 2-D `kernel` a Dense (in, out)
-> Linear (out, in), with a `scale` a BatchNorm (scale, bias and the
batch_stats node's mean and var -> weight, bias, running_mean,
running_var; torch's BatchNorm fills in num_batches_tracked when it loads);
a bare array is a parameter of its own (the matcher's `dustbin`).
`state_dict_to_flax` is the inverse, to numpy, for holding the port's
parameters or gradients against JAX's leaf by leaf.
"""

from __future__ import annotations

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32))


def flax_to_state_dict(params: dict, batch_stats: dict | None = None, prefix: str = "") -> dict:
    """flax params (+ batch_stats) of numpy arrays -> the port's state_dict."""
    sd = {}
    for name, node in params.items():
        key = f"{prefix}{name}"
        if not isinstance(node, dict):
            sd[key] = _t(node)
        elif "kernel" in node:
            k = np.asarray(node["kernel"])
            sd[f"{key}.weight"] = _t(np.transpose(k, (3, 2, 0, 1)) if k.ndim == 4 else k.T)
            if "bias" in node:
                sd[f"{key}.bias"] = _t(node["bias"])
        elif "scale" in node:
            stats = batch_stats[name]
            sd.update({f"{key}.weight": _t(node["scale"]), f"{key}.bias": _t(node["bias"]),
                       f"{key}.running_mean": _t(stats["mean"]), f"{key}.running_var": _t(stats["var"])})
        else:
            sd.update(flax_to_state_dict(node, (batch_stats or {}).get(name), f"{key}."))
    return sd


def state_dict_to_flax(sd: dict, bn_modules=None) -> tuple[dict, dict]:
    """The port's state_dict, or a dict of gradients under the parameter
    names, -> (params, batch_stats), nested dicts of float32 numpy arrays in
    the flax layout. A BatchNorm is known by its running_mean entry; for
    gradients, which have none, name the BatchNorm modules in
    `bn_modules`."""
    params: dict = {}
    stats: dict = {}
    arrays = {k: v.detach().cpu().numpy().astype(np.float32) for k, v in sd.items()
              if not k.endswith("num_batches_tracked")}
    bns = set(bn_modules or ()) | {k[:-len(".running_mean")] for k in arrays if k.endswith(".running_mean")}

    def put(tree, path, leaf, value):
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = value

    for key, a in arrays.items():
        parts = key.split(".")
        if len(parts) == 1:
            params[key] = a
            continue
        mod, leaf = ".".join(parts[:-1]), parts[-1]
        path = parts[:-1]
        if mod in bns:
            if leaf in ("running_mean", "running_var"):
                put(stats, path, leaf[len("running_"):], a)
            else:
                put(params, path, "scale" if leaf == "weight" else leaf, a)
        elif leaf == "weight":
            put(params, path, "kernel", np.transpose(a, (2, 3, 1, 0)) if a.ndim == 4 else a.T)
        else:
            put(params, path, leaf, a)
    return params, stats
