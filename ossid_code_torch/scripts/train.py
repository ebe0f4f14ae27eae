"""The offline training CLI on the card (the port of
ossid_code_tpu/scripts/train.py):

    python -m ossid_code_torch.scripts.train dataset=detect exp_name=run ...
    python -m ossid_code_torch.scripts.train dataset=dtoid_bop model.max_epochs=2 ...
    python -m ossid_code_torch.scripts.train dataset=fewshot_bop|fss_1000|ycbv_sift [model=superglue] ...
    python -m ossid_code_torch.scripts.train dataset=render model=fewshot_seg dataset.dataset_root=... ...

Overrides are dotted key=value pairs on the default config tree, values
parsed as YAML; `dataset=<name>` / `model=<name>` select a group preset
(ossid_code_torch/conf/), and a dataset family with a model of its own
(`detect` -> `maskrcnn`, `fewshot_bop` / `fss_1000` -> `fewshot_seg`,
`ycbv_sift` -> `matcher`) selects it when `model=` is not given. The run
lives in <OSSID_RESULT_ROOT>/train/<exp_name>: the config as
config_v<N>.yaml (N the first free version), the metrics as
metrics_v<N>.jsonl (TensorBoard events in tb/ where tensorboard imports),
last.ckpt after every epoch and best.ckpt at the best monitored metric;
a trainer with `log_figures` (DTOID's) draws the prediction figures into
figures/ every `model.figure_interval` epochs and at the last.
`build_model` is the JAX CLI's dispatch (`dtoid`, `maskrcnn`,
`fewshot_seg`, `matcher` and its alias `superglue`), with `weights_path=`
loaded through core/checkpoint.py; `resume_path=` resumes from a
last.ckpt. `OfflineTrainer` trains DTOID, `GenericTrainer` the others.

`dataset=dtoid` and `dataset=render` both read BlenderProc HDF5 scenes
(data/hdf5_render.py) into few-shot episodes, as the JAX CLI does: so
`dataset=dtoid` with the DTOID model stops at its first batch with
KeyError 'limg', as JAX's does (ROADMAP.md, faults of the reference).

The port's own key `device=cpu` runs on the CPU; without it the run is on
the card. `train.dp_devices` (DTOID) is the data-parallel axis: -1 means
every visible device (the cards; one on the CPU), N means N. More than one
starts that many processes of one `torch.distributed` group
(parallel/launch.py::spawn): gloo processes with `device=cpu`, else one
NCCL process a card (N above the cards raises, as JAX's `make_mesh` does).
Each rank trains on its shard of every global batch (train/offline.py);
rank 0 writes the config, the metrics, the checkpoints and the figures.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch
import torch.distributed as dist
import yaml

from ossid_code_torch.conf import load_group, post_process_conf
from ossid_code_torch.core.config import default_config, roots
from ossid_code_torch.utils.logging import MetricLogger

# the model a dataset family trains when `model=` is not given
_DEFAULT_MODEL = {
    "fewshot_bop": "fewshot_seg",
    "fss_1000": "fewshot_seg",
    "detect": "maskrcnn",
    "ycbv_sift": "matcher",
}


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
    dataset family's default model, then the defaults and the fix-ups of
    conf/post_process_conf."""
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
    return post_process_conf(default_config().merged(overrides))


def build_dataloaders(cfg):
    """(train, valid, test) loaders of the dataset family."""
    name = cfg.dataset.name
    if name == "dtoid_bop":
        from ossid_code_torch.data.dtoid_bop import get_dataloaders

        return get_dataloaders(cfg)
    if name in ("dtoid", "render"):
        from ossid_code_torch.data.hdf5_render import get_render_dataloaders

        return get_render_dataloaders(cfg)
    if name == "fewshot_bop":
        from ossid_code_torch.data.fewshot import get_fewshot_dataloaders

        return get_fewshot_dataloaders(cfg)
    if name == "fss_1000":
        from ossid_code_torch.data.fewshot import get_fss1000_dataloaders

        return get_fss1000_dataloaders(cfg)
    if name == "detect":
        from ossid_code_torch.data.detect import get_detect_dataloaders

        return get_detect_dataloaders(cfg)
    if name == "ycbv_sift":
        from ossid_code_torch.data.ycbv_sift import get_ycbv_sift_dataloaders

        return get_ycbv_sift_dataloaders(cfg)
    raise SystemExit(f"unknown dataset {name!r} (dtoid_bop, dtoid, render, fewshot_bop, fss_1000, detect, ycbv_sift)")


def build_model(cfg):
    """The model of `cfg.model.name` on the config's device (None: the card),
    as the JAX CLI's dispatch; another name exits."""
    name, device = cfg.model.get("name", "dtoid"), cfg.get("device")
    if name == "dtoid":
        from ossid_code_torch.models.dtoid.module import DtoidModel

        return DtoidModel(cfg, seed=cfg.seed, device=device)
    if name == "maskrcnn":
        from ossid_code_torch.models.maskrcnn import MaskRCNN

        return MaskRCNN(cfg, seed=cfg.seed, device=device)
    if name == "fewshot_seg":
        from ossid_code_torch.models.fewshot_seg import FewshotSegModel

        return FewshotSegModel(cfg, seed=cfg.seed, device=device)
    if name in ("matcher", "superglue"):
        from ossid_code_torch.models.matcher import SiftMatcher

        return SiftMatcher(cfg, seed=cfg.seed, device=device)
    raise SystemExit(f"unknown model {name!r} (dtoid, maskrcnn, fewshot_seg, matcher)")


def _dp_devices(cfg) -> int:
    """The devices the DTOID trainer takes: of train.dp_devices (-1 or unset:
    every visible device, the cards, or one on the CPU), the largest count
    that divides train.batch_size (OfflineTrainer's rule)."""
    n = cfg.train.get("dp_devices", -1)
    if n in (-1, None):
        n = 1 if cfg.get("device") == "cpu" else max(torch.cuda.device_count(), 1)
    b = int(cfg.train.batch_size)
    return max(d for d in range(1, int(n) + 1) if b % d == 0)


def _rank_main(rank: int, world: int, argv: list) -> int:
    return main(argv)


def main(argv=None) -> int:
    from ossid_code_torch.core.checkpoint import load_checkpoint
    from ossid_code_torch.train.offline import GenericTrainer, OfflineTrainer

    argv = argv if argv is not None else sys.argv[1:]
    cfg = build_config(argv)
    grouped = dist.is_available() and dist.is_initialized()
    n_dp = _dp_devices(cfg) if cfg.model.get("name", "dtoid") == "dtoid" else 1
    if n_dp > 1 and not grouped:
        from ossid_code_torch.parallel.launch import spawn

        spawn(_rank_main, n_dp, "gloo" if cfg.get("device") == "cpu" else "nccl", args=(list(argv),))
        return 0
    rank = dist.get_rank() if grouped else 0
    np.random.seed(cfg.seed)

    exp_root = os.path.join(roots().OSSID_RESULT_ROOT, "train", cfg.exp_name)
    version = 0
    if rank == 0:
        os.makedirs(exp_root, exist_ok=True)
        while os.path.exists(os.path.join(exp_root, f"config_v{version}.yaml")):
            version += 1
        cfg.save(os.path.join(exp_root, f"config_v{version}.yaml"))
        print(f"experiment {cfg.exp_name} v{version} -> {exp_root}")

    train_loader, valid_loaders, _ = build_dataloaders(cfg)
    if not isinstance(valid_loaders, (list, tuple)):
        valid_loaders = [valid_loaders]

    model = build_model(cfg)
    if cfg.get("weights_path"):
        model.load_state_dict(load_checkpoint(cfg.weights_path))
        print("loaded weights from", cfg.weights_path)
    if cfg.model.get("name", "dtoid") == "dtoid":
        trainer = OfflineTrainer(model, cfg, n_devices=n_dp, ckpt_dir=exp_root)
    else:
        trainer = GenericTrainer(model, cfg, ckpt_dir=exp_root)
    if cfg.get("resume_path"):
        full = trainer.restore_trainer_state(cfg.resume_path)
        print(f"resumed from {cfg.resume_path} at epoch {trainer.epoch}"
              + ("" if full else " (weights only; no optimizer state in ckpt)"))
    logger = (MetricLogger(os.path.join(exp_root, f"metrics_v{version}.jsonl"), tb_dir=os.path.join(exp_root, "tb"))
              if rank == 0 else None)

    monitor = cfg.model.get("monitor", "val_metric")
    fig_interval = int(cfg.model.get("figure_interval", 0) or 0)
    max_epochs = int(cfg.model.max_epochs)
    try:
        for epoch in range(trainer.epoch, max_epochs):
            metrics = trainer.train_epoch(train_loader)
            val = trainer.validate(valid_loaders[0], monitor=monitor)
            if fig_interval and hasattr(trainer, "log_figures") and (
                    epoch % fig_interval == 0 or epoch == max_epochs - 1):
                trainer.log_figures(valid_loaders[0], exp_root, epoch)
            if logger is not None:
                logger.log(epoch, **metrics, **{monitor: val})
                print(f"epoch {epoch}: loss={metrics.get('loss', float('nan')):.4f} "
                      f"{monitor}={val:.4f} (best {trainer.best_metric:.4f})")
    finally:
        if logger is not None:
            logger.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
