"""Offline DTOID (pre)training on one device (the port's counterpart of
ossid_code_tpu/train/offline.py's `OfflineTrainer`).

Each step is `DtoidModel.train_step` (the forward in training mode and
`dtoid_losses`, in float32) with the trainer's own optimizer: optax's
`chain(add_decayed_weights(wd), amsgrad(schedule))` with the reference's
MultiStep learning-rate schedule (milestones [20, 40] epochs, gamma 0.1,
ref models/dtoid/__init__.py:258). The model's finetune optimizer is left
as it was. Checkpoints are torch files (core/checkpoint.py). The JAX
package's data-parallel mesh is not ported (ROADMAP.md, multi-device
families): `n_devices` other than 1 raises.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ossid_code_torch.core.checkpoint import save_checkpoint
from ossid_code_torch.core.optim import make_optimizer, piecewise_constant_schedule

FEED_KEYS = ("img", "limg", "lmask", "gimg", "gmask", "bbox_gt", "heatmap", "mask")


def make_multistep_schedule(base_lr: float, steps_per_epoch: int, milestones=(20, 40), gamma: float = 0.1):
    return piecewise_constant_schedule(base_lr, {int(m * steps_per_epoch): gamma for m in milestones})


class OfflineTrainer:
    """Epoch-driven trainer over NumpyLoader-style loaders."""

    def __init__(self, model, cfg, n_devices: int | None = 1, ckpt_dir: str | None = None):
        if n_devices not in (None, 1):
            raise NotImplementedError(
                "OfflineTrainer runs on one device; the data-parallel mesh is not ported: "
                "ROADMAP.md, 'Still to port', multi-device families")
        self.model = model
        self.cfg = cfg
        self.ckpt_dir = ckpt_dir
        sched = make_multistep_schedule(
            cfg.model.learning_rate, steps_per_epoch=max(cfg.train.get("steps_per_epoch", 1000), 1))
        self.optimizer = make_optimizer(model.net.parameters(), sched, cfg.model.weight_decay)
        self.history: list[dict] = []
        self.best_metric = -np.inf
        self.epoch = 0

    def train_epoch(self, loader, feed_keys=FEED_KEYS) -> dict:
        """One pass over `loader`, float32 steps; the epoch's mean of each loss
        term, fetched from the device once."""
        metrics = [self.model.train_step({k: batch[k] for k in feed_keys}, optimizer=self.optimizer, bf16=False)
                   for batch in loader]
        out = {}
        if metrics:
            keys = list(metrics[0])
            means = torch.stack([torch.stack([m[k] for m in metrics]).float().mean() for k in keys]).cpu()
            out = dict(zip(keys, means.tolist()))
        self.history.append(out)
        self.epoch += 1
        if self.ckpt_dir:
            # rolling resume point with the full trainer state
            self.save_trainer_state(os.path.join(self.ckpt_dir, "last.ckpt"))
        return out

    def save_trainer_state(self, path: str) -> None:
        """Checkpoint the model, the optimizer state (its moments and step
        counts; the schedule is the trainer's), the epoch and the best
        metric."""
        save_checkpoint(path, self.model.state_dict(), extra={
            "opt_state": self.optimizer.state_dict()["state"], "epoch": self.epoch,
            "best_metric": float(self.best_metric)})

    def restore_trainer_state(self, path: str) -> bool:
        """Restore a save_trainer_state checkpoint. Returns True if optimizer
        state was present (a full resume); a plain weights checkpoint
        restores only the model, and training restarts its schedule."""
        payload = torch.load(path, map_location="cpu", weights_only=False)
        self.model.load_state_dict({k: v.to(self.model.device) for k, v in payload["state_dict"].items()})
        if "opt_state" not in payload:
            return False
        sd = self.optimizer.state_dict()
        sd["state"] = payload["opt_state"]
        self.optimizer.load_state_dict(sd)
        self.epoch = int(payload.get("epoch", 0))
        self.best_metric = float(payload.get("best_metric", -np.inf))
        return True
