"""YAML presets of the train CLI's config groups (the port's own copies of
ossid_code_tpu/conf/, for the families the port trains: dataset `detect`
and `dtoid_bop`, model `dtoid` and `maskrcnn`). `scripts/train.py` resolves
`dataset=<name>` / `model=<name>` against these files first, then against
the defaults of core/config.py."""

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

