"""Checkpoint save and load (the port's counterpart of
ossid_code_tpu/core/checkpoint.py).

The port writes torch files, `{'state_dict': {name: tensor}, **extra}`,
under the reference's key names, which are the port's module names: the
reference implementation and the JAX package's `load_checkpoint` read them.
`load_checkpoint` reads three formats and returns a state_dict the port's
networks load with strict=True:
  * torch files: the port's own, and the reference's `.ckpt` / `.pth`
    (their `state_dict` or `model_state_dict`, the Lightning `model.` prefix
    dropped), zip archives or the legacy (non-zip) format, such as the
    original author's `dtoid_pretrained_original.pth.tar`; a legacy file is
    known by its `.pth.tar` suffix or by not being a plain pickle, as in the
    JAX package;
  * the JAX package's pickles of numpy trees (`{'state': {'params',
    'batch_stats'}}`, plain `{'params', 'batch_stats'}`, or a `--save_each`
    snapshot's `model_state_dict`), carried by `dtoid_from_jax` /
    `pointnet2_from_jax`.
"""

from __future__ import annotations

import os
import pickle
import zipfile

import torch


def save_checkpoint(path: str, state_dict: dict, extra: dict | None = None) -> None:
    """Write `{'state_dict': <CPU tensors>, **extra}` atomically."""
    payload = {"state_dict": {k: v.detach().cpu() for k, v in state_dict.items()}}
    if extra:
        payload.update(extra)
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def _is_scorer(keys) -> bool:
    return any(k.startswith(("SA_modules.", "FC_layer.")) for k in keys)


def load_checkpoint(path: str, align_feats: bool = False) -> dict:
    """A checkpoint of any of the three formats -> the port's state_dict
    (CPU tensors). `align_feats`: a scorer file without the alignment head
    gets a zero head, which leaves its scores as they were."""
    if zipfile.is_zipfile(path) or path.endswith(".pth.tar"):
        return _load_torch(path, align_feats)
    with open(path, "rb") as f:
        try:
            payload = pickle.load(f)
        except pickle.UnpicklingError:
            return _load_torch(path, align_feats)
    if not isinstance(payload, dict):
        # a legacy torch file opens with a pickled magic number
        return _load_torch(path, align_feats)
    state = payload.get("state", payload.get("model_state_dict", payload))
    if not (isinstance(state, dict) and "params" in state):
        raise ValueError(f"unrecognized checkpoint format: {path}")
    if "sa1" in state["params"]:
        from ossid_code_torch.models.zephyr.jax_import import pointnet2_from_jax

        return pointnet2_from_jax(state["params"], state["batch_stats"])
    from ossid_code_torch.models.dtoid.jax_import import dtoid_from_jax

    return dtoid_from_jax(state["params"], state["batch_stats"])


def _load_torch(path: str, align_feats: bool) -> dict:
    payload = torch.load(path, map_location="cpu", weights_only=False)
    sd = payload.get("state_dict", payload.get("model_state_dict", payload))
    if any(k.startswith("model.") for k in sd):
        sd = {k[len("model."):]: v for k, v in sd.items() if k.startswith("model.")}
    sd = {k: torch.as_tensor(v) for k, v in sd.items()}
    if align_feats and _is_scorer(sd) and "align_head.weight" not in sd:
        sd["align_head.weight"] = torch.zeros((1, 12))
        sd["align_head.bias"] = torch.zeros((1,))
    return sd
