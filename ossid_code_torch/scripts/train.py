"""The offline training CLI on the card (the port of
ossid_code_tpu/scripts/train.py):

    python -m ossid_code_torch.scripts.train dataset=detect exp_name=run ...
    python -m ossid_code_torch.scripts.train dataset=dtoid_bop model.max_epochs=2 ...

Overrides are dotted key=value pairs on the default config tree, values
parsed as YAML; `dataset=<name>` / `model=<name>` select a group preset
(ossid_code_torch/conf/), and a dataset family with a model of its own
(`detect` -> `maskrcnn`) selects it when `model=` is not given. The run
lives in <OSSID_RESULT_ROOT>/train/<exp_name>: the config as
config_v<N>.yaml (N the first free version), the metrics as
metrics_v<N>.jsonl (TensorBoard events in tb/ where tensorboard imports),
last.ckpt after every epoch and best.ckpt at the best monitored metric.
The model comes from models/__init__.py::get_model (`dtoid`, `maskrcnn`;
another name raises ValueError), with `weights_path=` loaded;
`resume_path=` resumes from a last.ckpt. `OfflineTrainer` trains DTOID,
`GenericTrainer` the class-conditional detector.

The port's own key `device=cpu` runs on the CPU; without it the run is on
the card. Not ported, and raising NotImplementedError with their ROADMAP.md
item: the dataset families `dtoid` / `render` (h5py render data, item 7),
`fewshot_bop`, `fss_1000` and `ycbv_sift`, and the models `fewshot_seg`,
`matcher` and `superglue` (item 9); `train.dp_devices` other than 1 or -1
(the data-parallel mesh, item 7) raises in OfflineTrainer.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import yaml

from ossid_code_torch.conf import load_group
from ossid_code_torch.core.config import default_config, roots
from ossid_code_torch.utils.logging import MetricLogger

# what the port does not train, with the ROADMAP.md §1 item that ports it
_NOT_PORTED_DATASETS = {
    "dtoid": "item 7, the h5py render family",
    "render": "item 7, the h5py render family",
    "fewshot_bop": "item 9, the legacy families",
    "fss_1000": "item 9, the legacy families",
    "ycbv_sift": "item 9, the legacy families",
}
_NOT_PORTED_MODELS = {name: "item 9, the legacy families" for name in ("fewshot_seg", "matcher", "superglue")}

# the model a dataset family trains when `model=` is not given
_DEFAULT_MODEL = {"detect": "maskrcnn"}


def parse_overrides(argv) -> dict:
    """key=value pairs -> a nested dict; a group shortcut given before its
    dotted keys (`dataset=dtoid_bop dataset.bop_root=...`) becomes
    {'name': ...} so that both compose."""
    tree: dict = {}
    for arg in argv:
        if "=" not in arg:
            raise SystemExit(f"override must be key=value, got {arg!r}")
        key, value = arg.split("=", 1)
        value = yaml.safe_load(value)
        node = tree
        parts = key.split(".")
        for p in parts[:-1]:
            nxt = node.setdefault(p, {})
            if not isinstance(nxt, dict):
                nxt = {"name": nxt}
                node[p] = nxt
            node = nxt
        node[parts[-1]] = value
    return tree


def build_config(argv):
    """The run's config from the overrides in `argv`: group presets, the
    dataset family's default model, then the defaults."""
    overrides = parse_overrides([a for a in argv if "=" in a])
    for group in ("dataset", "model"):
        ov = overrides.get(group)
        if isinstance(ov, str):
            ov = {"name": ov}
        if isinstance(ov, dict) and "name" in ov:
            preset = load_group(group, ov["name"]) or {}
            merged = {**preset, **ov}
            merged["name"] = preset.get("name", ov["name"])
            overrides[group] = merged
    ds_name = (overrides.get("dataset") or {}).get("name")
    model_ov = overrides.get("model") or {}
    if "name" not in model_ov and ds_name in _DEFAULT_MODEL:
        mname = _DEFAULT_MODEL[ds_name]
        preset = load_group("model", mname) or {}
        preset["name"] = preset.get("name", mname)
        overrides["model"] = {**preset, **model_ov, "name": preset["name"]}
        print(f"dataset={ds_name}: selecting model={mname}")
    return default_config().merged(overrides)


def refuse_unported(cfg) -> None:
    """Raise for a dataset family or model the port does not train."""
    for kind, name, table in (("dataset", cfg.dataset.name, _NOT_PORTED_DATASETS),
                              ("model", cfg.model.get("name", "dtoid"), _NOT_PORTED_MODELS)):
        if name in table:
            raise NotImplementedError(f"{kind}={name} is not ported: ROADMAP.md §1, {table[name]}")


def build_dataloaders(cfg):
    """(train, valid, test) loaders of the dataset family."""
    name = cfg.dataset.name
    if name == "dtoid_bop":
        from ossid_code_torch.data.dtoid_bop import get_dataloaders

        return get_dataloaders(cfg)
    if name == "detect":
        from ossid_code_torch.data.detect import get_detect_dataloaders

        return get_detect_dataloaders(cfg)
    raise SystemExit(f"unknown dataset {name!r} (dtoid_bop, detect)")


def main(argv=None) -> int:
    from ossid_code_torch.models import get_model
    from ossid_code_torch.train.offline import GenericTrainer, OfflineTrainer

    argv = argv if argv is not None else sys.argv[1:]
    cfg = build_config(argv)
    refuse_unported(cfg)
    np.random.seed(cfg.seed)

    exp_root = os.path.join(roots().OSSID_RESULT_ROOT, "train", cfg.exp_name)
    os.makedirs(exp_root, exist_ok=True)
    version = 0
    while os.path.exists(os.path.join(exp_root, f"config_v{version}.yaml")):
        version += 1
    cfg.save(os.path.join(exp_root, f"config_v{version}.yaml"))
    print(f"experiment {cfg.exp_name} v{version} -> {exp_root}")

    train_loader, valid_loaders, _ = build_dataloaders(cfg)
    if not isinstance(valid_loaders, (list, tuple)):
        valid_loaders = [valid_loaders]

    model = get_model(cfg, seed=cfg.seed, device=cfg.get("device"))
    if cfg.get("weights_path"):
        print("loaded weights from", cfg.weights_path)
    if cfg.model.get("name", "dtoid") == "dtoid":
        n_dev = None if cfg.train.dp_devices in (-1, None) else cfg.train.dp_devices
        trainer = OfflineTrainer(model, cfg, n_devices=n_dev, ckpt_dir=exp_root)
    else:
        trainer = GenericTrainer(model, cfg, ckpt_dir=exp_root)
    if cfg.get("resume_path"):
        full = trainer.restore_trainer_state(cfg.resume_path)
        print(f"resumed from {cfg.resume_path} at epoch {trainer.epoch}"
              + ("" if full else " (weights only; no optimizer state in ckpt)"))
    logger = MetricLogger(os.path.join(exp_root, f"metrics_v{version}.jsonl"), tb_dir=os.path.join(exp_root, "tb"))

    monitor = cfg.model.get("monitor", "val_metric")
    try:
        for epoch in range(trainer.epoch, int(cfg.model.max_epochs)):
            metrics = trainer.train_epoch(train_loader)
            val = trainer.validate(valid_loaders[0], monitor=monitor)
            logger.log(epoch, **metrics, **{monitor: val})
            print(f"epoch {epoch}: loss={metrics.get('loss', float('nan')):.4f} "
                  f"{monitor}={val:.4f} (best {trainer.best_metric:.4f})")
    finally:
        logger.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
