"""Carry DTOID and MaskRCNN weights and BatchNorm statistics between the JAX
package and the port.

`dtoid_from_jax(params, batch_stats)` takes the JAX package's nested dicts of
numpy arrays (as `jax.device_get(model.params)` gives them) and returns a
state_dict, under the reference's torch key names, that `DtoidNetwork` loads
with strict=True; `dtoid_to_jax(state_dict)` is the inverse, to numpy, so a
trained port model can be compared with the JAX one leaf by leaf.
`maskrcnn_from_jax` / `maskrcnn_to_jax` do the same for the class-conditional
detector (`models/maskrcnn.py`), whose DenseNet trunk takes DTOID's entries
at the top level of its tree. Conversions: conv kernels HWIO <-> OIHW;
BatchNorm scale/bias/mean/var <-> weight/bias/running_mean/running_var
(flax momentum 0.9 is torch momentum 0.1; BatchNorm's num_batches_tracked is
filled in by the loader). The key
tables are this package's own copy of the JAX package's export tables, with
the DenseNet block repeats read from the tree.
"""

from __future__ import annotations

import numpy as np
import torch


def _n_layers(tree: dict, path: str) -> int:
    node = _get(tree, path)
    return sum(1 for k in node if k.startswith("denselayer"))


def _densenet_entries(n_layers, trunk=("stem", "early", "late"), j: str = ""):
    """The DenseNet trunk's entries: torch module prefixes of its stem, early
    and late parts, and the JAX path prefix `j` of its stem/early/late;
    n_layers(torch block prefix, JAX block path) -> number of dense layers."""
    stem, early, late = trunk
    out = [(f"{stem}.0", f"{j}stem/conv0", "conv"), (f"{early}.0", f"{j}early/norm0", "bn")]
    blocks = (
        (f"{early}.3", f"{j}early/denseblock1"),
        (f"{late}.1", f"{j}late/denseblock2"),
        (f"{late}.3", f"{j}late/denseblock3"),
        (f"{late}.5", f"{j}late/denseblock4"),
    )
    for tb, fb in blocks:
        for i in range(1, n_layers(tb, fb) + 1):
            for sub, kind in (("norm1", "bn"), ("conv1", "conv"), ("norm2", "bn"), ("conv2", "conv")):
                out.append((f"{tb}.denselayer{i}.{sub}", f"{fb}/denselayer{i}/{sub}", kind))
    for i in range(3):
        out.append((f"{late}.{2 * i}.norm", f"{j}late/transition{i + 1}/norm", "bn"))
        out.append((f"{late}.{2 * i}.conv", f"{j}late/transition{i + 1}/conv", "conv"))
    out.append((f"{late}.6", f"{j}late/norm5", "bn"))
    return out


def _dense_entries(n_layers):
    """DTOID's image encoder: the trunk, then its 1024 -> 640 conv and norm."""
    p = "image_feature_extractor"
    return _densenet_entries(n_layers, (f"{p}.backdense_0", f"{p}.backdense_1", f"{p}.backdense_2"),
                             f"{p}/") + [(f"{p}.c1", f"{p}/c1", "conv"), (f"{p}.n1", f"{p}/n1", "bn")]


def _squeeze_entries(name: str, with_global_head: bool):
    fires = {"fire2": "backbone_1.2", "fire3": "backbone_1.3",
             "fire4": "backbone_2.1", "fire5": "backbone_2.2",
             "fire6": "backbone_2.4", "fire7": "backbone_2.5",
             "fire8": "backbone_2.6", "fire9": "backbone_2.7"}
    out = [(f"{name}.backbone_0.0", f"{name}/stem/conv1", "conv")]
    for fname, tf in fires.items():
        stage = "early" if fname in ("fire2", "fire3") else "late"
        for sub in ("squeeze", "expand1x1", "expand3x3"):
            out.append((f"{name}.{tf}.{sub}", f"{name}/{stage}/{fname}/{sub}", "conv"))
    out.append((f"{name}.norm_1", f"{name}/norm_1", "bn"))
    out.append((f"{name}.norm_2", f"{name}/norm_2", "bn"))
    if with_global_head:
        for i in (1, 2):
            out.append((f"{name}.final_conv_{i}", f"{name}/final_conv_{i}", "conv"))
            out.append((f"{name}.final_norm_{i}", f"{name}/final_norm_{i}", "bn"))
    return out


def _correlation_entries():
    p = "correlation_model"
    out = []
    for c, n in (("c1", "n1"), ("c2", "n2")):
        out += [(f"{p}.{c}", f"{p}/{c}", "conv"), (f"{p}.{n}", f"{p}/{n}", "bn")]
    for name in ("dot", "dot3x3", "sub"):
        out += [(f"{p}.corr_conv_{name}", f"{p}/corr_conv_{name}", "conv"),
                (f"{p}.norm_corr_{name}", f"{p}/norm_corr_{name}", "bn")]
    out += [(f"{p}.cf", f"{p}/cf", "conv"), (f"{p}.nf", f"{p}/nf", "bn")]
    for i in range(1, 6):
        out += [(f"{p}.s{i}", f"{p}/s{i}", "conv"), (f"{p}.ns{i}", f"{p}/ns{i}", "bn")]
    out += [(f"{p}.seg_final", f"{p}/seg_final", "conv"),
            (f"{p}.corr_conv_heatmap", f"{p}/corr_conv_heatmap", "conv")]
    return out


def _head_entries():
    return [(f"{head}.{c}", f"{head}/{c}", "conv")
            for head in ("classification", "regression")
            for c in ("conv1", "conv2", "conv3", "conv4", "output")]


def _get(tree: dict, path: str):
    node = tree
    for p in path.split("/"):
        node = node[p]
    return node


def _t(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32))


def _entries(n_layers):
    return (_dense_entries(n_layers)
            + _squeeze_entries("template_feature_extractor_global", True)
            + _squeeze_entries("template_feature_extractor", False)
            + _correlation_entries() + _head_entries())


def _maskrcnn_entries(n_layers):
    """The class-conditional detector (JAX models/maskrcnn.py): the trunk at
    the top level, the neck, the two heads and the segmentation decoder."""
    out = _densenet_entries(n_layers) + [("neck", "neck", "conv"), ("neck_bn", "neck_bn", "bn")] + _head_entries()
    for i in (1, 2, 3):
        out += [(f"s{i}", f"s{i}", "conv"), (f"ns{i}", f"ns{i}", "bn")]
    return out + [("seg_final", "seg_final", "conv")]


def _from_jax(entries, params: dict, batch_stats: dict) -> dict:
    sd = {}
    for tkey, fpath, kind in entries(lambda tb, fb: _n_layers(params, fb)):
        node = _get(params, fpath)
        if kind == "bn":
            stats = _get(batch_stats, fpath)
            sd[f"{tkey}.weight"] = _t(node["scale"])
            sd[f"{tkey}.bias"] = _t(node["bias"])
            sd[f"{tkey}.running_mean"] = _t(stats["mean"])
            sd[f"{tkey}.running_var"] = _t(stats["var"])
        else:
            sd[f"{tkey}.weight"] = _t(np.transpose(np.asarray(node["kernel"]), (3, 2, 0, 1)))
            if "bias" in node:
                sd[f"{tkey}.bias"] = _t(node["bias"])
    return sd


def dtoid_from_jax(params: dict, batch_stats: dict) -> dict:
    """JAX DTOID params + batch_stats (numpy) -> port state_dict (torch, CPU)."""
    return _from_jax(_entries, params, batch_stats)


def maskrcnn_from_jax(params: dict, batch_stats: dict) -> dict:
    """JAX MaskRCNN params + batch_stats (numpy) -> the port's
    MaskRCNNNetwork state_dict (torch, CPU)."""
    return _from_jax(_maskrcnn_entries, params, batch_stats)


def _put(tree: dict, path: str, leaf: dict) -> None:
    node = tree
    for p in path.split("/"):
        node = node.setdefault(p, {})
    node.update(leaf)


def _to_jax(entries, sd: dict) -> tuple[dict, dict]:
    sd = {k: v.detach().cpu().numpy().astype(np.float32) for k, v in sd.items()}

    def n_layers(tb, fb):
        n = 0
        while f"{tb}.denselayer{n + 1}.norm1.weight" in sd:
            n += 1
        return n

    params, stats = {}, {}
    for tkey, fpath, kind in entries(n_layers):
        if kind == "bn":
            _put(params, fpath, {"scale": sd[f"{tkey}.weight"], "bias": sd[f"{tkey}.bias"]})
            _put(stats, fpath, {"mean": sd[f"{tkey}.running_mean"], "var": sd[f"{tkey}.running_var"]})
        else:
            leaf = {"kernel": np.transpose(sd[f"{tkey}.weight"], (2, 3, 1, 0))}
            if f"{tkey}.bias" in sd:
                leaf["bias"] = sd[f"{tkey}.bias"]
            _put(params, fpath, leaf)
    return params, stats


def dtoid_to_jax(sd: dict) -> tuple[dict, dict]:
    """Port DTOID state_dict -> (params, batch_stats), nested dicts of
    float32 numpy arrays in the JAX package's layout."""
    return _to_jax(_entries, sd)


def maskrcnn_to_jax(sd: dict) -> tuple[dict, dict]:
    """Port MaskRCNNNetwork state_dict -> the JAX MaskRCNN's (params,
    batch_stats), as dtoid_to_jax."""
    return _to_jax(_maskrcnn_entries, sd)
