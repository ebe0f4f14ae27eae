"""Offline training on one device (the port of ossid_code_tpu/train/offline.py:
`OfflineTrainer` for DTOID, `GenericTrainer` for the other families).

Each step is `DtoidModel.train_step` (the forward in training mode and
`dtoid_losses`, in float32) with the trainer's own optimizer: optax's
`chain(add_decayed_weights(wd), amsgrad(schedule))` with the reference's
MultiStep learning-rate schedule (milestones [20, 40] epochs, gamma 0.1,
ref models/dtoid/__init__.py:258). The model's finetune optimizer is left
as it was. Checkpoints are torch files (core/checkpoint.py). `validate`
keeps `best.ckpt` by the monitored segmentation IoU; `log_figures` writes
the periodic prediction figures of utils/vis.py as PNGs.

Data parallelism (JAX `make_sharded_train_step` on a `dp` mesh) runs one
process a device in a `torch.distributed` group (parallel/launch.py): the
trainer uses `n_use` devices, the largest divisor of `train.batch_size` at
most `n_devices` (None: the group's size, else every visible device), and
under a group of `n_use` processes each rank reads the same global batches
and trains on its contiguous shard. Its loss is the shard's share of the
global-batch mean (the DTOID losses are per-sample means, then a batch
mean), BatchNorm takes global-batch statistics (models/batchnorm.py), and
the gradients are all-reduced by sum before the optimizer: the step on the
global batch, up to rounding. Metrics are all-reduced, so every rank holds
the global ones; rank 0 alone writes checkpoints and figures, and
`validate` gives every rank rank 0's number. `n_devices=1`, or no group
with one device, is the one-device trainer; more devices without a group
raises.

`GenericTrainer` drives any model with `train_step(batch)` (loss terms as
device scalars), `eval_metric(batch)` (a list of floats) and `state_dict()`:
the class-conditional detector on `dataset=detect`. Its `last.ckpt` holds
the weights, the epoch and the best metric (no optimizer state, as in the
JAX package); `best.ckpt` the weights at the best monitored metric.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from ossid_code_torch.core.checkpoint import save_checkpoint
from ossid_code_torch.core.optim import make_optimizer, piecewise_constant_schedule
from ossid_code_torch.models.batchnorm import global_batch
from ossid_code_torch.utils.png import write_png
from ossid_code_torch.utils.vis import vis_in_out

FEED_KEYS = ("img", "limg", "lmask", "gimg", "gmask", "bbox_gt", "heatmap", "mask")


def _epoch_means(metrics: list) -> dict:
    """[{name: device scalar}, ...] -> {name: mean}, fetched in one copy."""
    if not metrics:
        return {}
    keys = list(metrics[0])
    means = torch.stack([torch.stack([m[k] for m in metrics]).float().mean() for k in keys]).cpu()
    return dict(zip(keys, means.tolist()))


def _save_best(trainer, score: float, monitor: str) -> None:
    """best.ckpt when `score` beats the trainer's best metric."""
    if trainer.ckpt_dir and score > trainer.best_metric:
        trainer.best_metric = score
        os.makedirs(trainer.ckpt_dir, exist_ok=True)
        save_checkpoint(os.path.join(trainer.ckpt_dir, "best.ckpt"), trainer.model.state_dict(),
                        extra={"monitor": {monitor: score}})


class GenericTrainer:
    """Epoch trainer for the families other than DTOID (JAX
    train/offline.py:65-121), with OfflineTrainer's checkpoint layout."""

    def __init__(self, model, cfg, ckpt_dir: str | None = None):
        self.model = model
        self.cfg = cfg
        self.ckpt_dir = ckpt_dir
        self.history: list[dict] = []
        self.best_metric = -np.inf
        self.epoch = 0

    def train_epoch(self, loader) -> dict:
        out = _epoch_means([self.model.train_step(batch) for batch in loader])
        self.history.append(out)
        self.epoch += 1
        if self.ckpt_dir:
            save_checkpoint(os.path.join(self.ckpt_dir, "last.ckpt"), self.model.state_dict(),
                            extra={"epoch": self.epoch, "best_metric": float(self.best_metric)})
        return out

    def restore_trainer_state(self, path: str) -> bool:
        """Restore the weights, and the epoch and best metric where the file
        has them (a `last.ckpt`); True when it had the epoch."""
        payload = torch.load(path, map_location="cpu", weights_only=False)
        self.model.load_state_dict({k: v.to(self.model.device) for k, v in payload["state_dict"].items()})
        self.epoch = int(payload.get("epoch", 0))
        self.best_metric = float(payload.get("best_metric", -np.inf))
        return "epoch" in payload

    def validate(self, loader, monitor: str = "metric") -> float:
        scores = []
        for batch in loader:
            scores += list(self.model.eval_metric(batch))
        score = float(np.mean(scores)) if scores else 0.0
        _save_best(self, score, monitor)
        return score


def _all_reduce_grads(params) -> None:
    """Sum the parameters' gradients over the process group, in one
    all-reduce of a flat buffer."""
    grads = [p.grad for p in params if p.grad is not None]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.view_as(g))


def make_multistep_schedule(base_lr: float, steps_per_epoch: int, milestones=(20, 40), gamma: float = 0.1):
    return piecewise_constant_schedule(base_lr, {int(m * steps_per_epoch): gamma for m in milestones})


class OfflineTrainer:
    """Epoch-driven trainer over NumpyLoader-style loaders."""

    def __init__(self, model, cfg, n_devices: int | None = 1, ckpt_dir: str | None = None):
        grouped = dist.is_available() and dist.is_initialized()
        if n_devices:
            n_avail = n_devices
        elif grouped:
            n_avail = dist.get_world_size()
        else:
            n_avail = torch.cuda.device_count() if model.device.type == "cuda" else 1
        b = int(cfg.train.batch_size)
        # the dp axis must divide the global batch: the largest divisor
        self.n_use = max(d for d in range(1, n_avail + 1) if b % d == 0)
        # data parallel: a process group of n_use ranks (n_devices=1 opts out)
        self.dp = grouped and n_devices != 1
        if self.dp and dist.get_world_size() != self.n_use:
            raise ValueError(f"the trainer uses {self.n_use} devices at batch {b}; "
                             f"the process group has {dist.get_world_size()}")
        if not self.dp and self.n_use > 1:
            raise RuntimeError(f"{self.n_use} devices train in {self.n_use} processes of one group: "
                               "start them with parallel/launch.py::spawn (train.dp_devices in scripts/train.py)")
        self.rank = dist.get_rank() if self.dp else 0
        self.model = model
        self.cfg = cfg
        self.ckpt_dir = ckpt_dir if self.rank == 0 else None
        sched = make_multistep_schedule(
            cfg.model.learning_rate, steps_per_epoch=max(cfg.train.get("steps_per_epoch", 1000), 1))
        self.optimizer = make_optimizer(model.net.parameters(), sched, cfg.model.weight_decay)
        self.history: list[dict] = []
        self.best_metric = -np.inf
        self.epoch = 0

    def train_epoch(self, loader, feed_keys=FEED_KEYS) -> dict:
        """One pass over `loader`, float32 steps; the epoch's mean of each loss
        term, fetched from the device once."""
        step = self._dp_step if self.dp else self._step
        out = _epoch_means([step({k: batch[k] for k in feed_keys}) for batch in loader])
        self.history.append(out)
        self.epoch += 1
        if self.ckpt_dir:
            # rolling resume point with the full trainer state
            self.save_trainer_state(os.path.join(self.ckpt_dir, "last.ckpt"))
        return out

    def _step(self, batch: dict) -> dict:
        return self.model.train_step(batch, optimizer=self.optimizer, bf16=False)

    def _dp_step(self, batch: dict) -> dict:
        """This rank's part of the data-parallel step on the global `batch`:
        its contiguous shard (P("dp")), global-batch BatchNorm, its loss
        share, the gradients summed over the group; returns the global
        batch's loss terms."""
        world = dist.get_world_size()
        b = len(batch["img"])
        if b % world:
            raise ValueError(f"a batch of {b} does not split over {world} devices")
        per = b // world
        shard = {k: v[self.rank * per:(self.rank + 1) * per] for k, v in batch.items()}
        with global_batch():
            metrics = self.model.train_step(shard, optimizer=self.optimizer, bf16=False,
                                            loss_scale=per / b, reduce_grads=_all_reduce_grads)
        keys = list(metrics)
        total = torch.stack([metrics[k].float() for k in keys]) * (per / b)
        dist.all_reduce(total)
        return dict(zip(keys, total.unbind()))

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

    def _eval_forward(self, batch: dict) -> tuple[dict, dict]:
        """The eval-mode forward of `batch`, the first local template of an
        all-templates batch: (the batch with `limg` / `lmask` squeezed to
        one template, the network's outputs on the device)."""
        limg, lmask = np.asarray(batch["limg"]), np.asarray(batch["lmask"])
        if limg.ndim == 5:
            batch = {**batch, "limg": limg[:, 0], "lmask": lmask[:, 0]}
        feed = self.model._on_device({k: batch[k] for k in ("img", "limg", "lmask", "gimg", "gmask")})
        return batch, self.model.net(*(feed[k].float() for k in ("img", "limg", "lmask", "gimg", "gmask")))

    @torch.inference_mode()
    def log_figures(self, loader, out_dir: str, epoch: int, n: int = 2) -> None:
        """The first `n` samples of `loader` drawn by utils/vis.py::vis_in_out
        from the eval-mode forward, as <out_dir>/figures/epoch{epoch}_{i}.png
        (JAX train/offline.py:205-235); rank 0 alone draws."""
        if self.rank:
            return
        os.makedirs(os.path.join(out_dir, "figures"), exist_ok=True)
        done = 0
        for batch in loader:
            batch, out = self._eval_forward(batch)
            out = {k: v.float().cpu().numpy() for k, v in out.items()}
            for i in range(len(np.asarray(batch["img"]))):
                fig, _ = vis_in_out(batch, out, idx=i)
                write_png(os.path.join(out_dir, "figures", f"epoch{epoch}_{done}.png"), fig)
                done += 1
                if done >= n:
                    return

    @torch.inference_mode()
    def validate(self, loader, monitor: str = "seg_IoU") -> float:
        """The mean segmentation IoU of the eval-mode forward over `loader`
        (the first local template of an all-templates batch), best.ckpt when
        it is the best so far (JAX train/offline.py:237-267). Data parallel:
        rank 0 computes it and every rank returns rank 0's number."""
        ious = []
        for batch in (loader if self.rank == 0 else ()):
            _, out = self._eval_forward(batch)
            seg = (out["seg_logits"] > 0.0).cpu().numpy()
            gt = np.asarray(batch["mask"]) > 0.5
            inter = np.logical_and(seg, gt).sum(axis=(1, 2, 3))
            union = np.logical_or(seg, gt).sum(axis=(1, 2, 3))
            ious += list(inter / np.clip(union, 1, None))
        score = float(np.mean(ious)) if ious else 0.0
        if self.dp:
            box = [score]
            dist.broadcast_object_list(box, src=0)
            score = box[0]
        _save_best(self, score, monitor)
        return score
