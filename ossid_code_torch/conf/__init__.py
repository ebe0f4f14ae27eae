"""YAML presets of the train CLI's config groups (the port's own copies of
ossid_code_tpu/conf/, for the families the port trains: datasets `detect`,
`dtoid`, `dtoid_bop`, `fewshot_bop`, `fss_1000` and `ycbv_sift`, models `dtoid`,
`maskrcnn`, `fewshot_seg`, `matcher` and its alias `superglue`).
`scripts/train.py` resolves `dataset=<name>` / `model=<name>` against these
files first, then against the defaults of core/config.py, and applies
`post_process_conf` to the merged tree."""

from __future__ import annotations

import os

import yaml

CONF_DIR = os.path.dirname(os.path.abspath(__file__))


def load_group(group: str, name: str) -> dict | None:
    """conf/<group>/<name>.yaml as a dict, or None where there is no such
    preset."""
    path = os.path.join(CONF_DIR, group, f"{name}.yaml")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return yaml.safe_load(f) or {}



def post_process_conf(config):
    """Fix-ups after merging (the JAX package's conf/__init__.py): the
    ycbv_sift family's keypoint counts default to `n_kpts`."""
    d = config.dataset
    if d.get("name") == "ycbv_sift":
        if d.get("n_kpts_model") is None:
            d.n_kpts_model = d.get("n_kpts", 128)
        if d.get("n_kpts_obs") is None:
            d.n_kpts_obs = d.get("n_kpts", 128)
    return config
