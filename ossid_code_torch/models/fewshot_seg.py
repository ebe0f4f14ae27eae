"""Support-conditioned few-shot segmentation (the port of
ossid_code_tpu/models/fewshot_seg.py): the model family the train CLI's
`dataset=fewshot_bop` and `dataset=fss_1000` train.

The reference carries those datasets but not the model that consumed them;
the JAX package supplies this one: a shared-shape conv trunk encodes the
query; supports (RGB + mask, 4 channels) are encoded by a second trunk and
mask-pooled into a prototype vector that modulates the query features (FiLM
and a cosine-similarity channel), and a light decoder predicts the query
mask. Plain PyTorch on the card (no kernel of the port on this path): NCHW
convolutions under the flax module names (`query_trunk.conv0`,
`film_gamma`, `d1`, `seg_final`, ...), so models/jax_import.py carries JAX
weights with strict=True; BatchNorm by flax's rule (models/batchnorm.py);
the nearest resizes of ops/resize.py.

`FewshotSegModel` is the host wrapper with the JAX interface
(`train_feed_keys`, `train_step`, `eval_metric`, `reset_optimizer`,
`state_dict`, `load_state_dict`, which also takes a JAX tree): BCE on the
clipped sigmoid, optax's add_decayed_weights + amsgrad (core/optim.py),
flax's initialisation (lecun-normal kernels, zero biases; `seg_final` a
zero kernel and bias -2). It runs on the card unless `device="cpu"`.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ossid_code_torch.core.optim import make_optimizer
from ossid_code_torch.device import resolve_device
from ossid_code_torch.models.batchnorm import BatchNorm2d
from ossid_code_torch.models.dtoid.network import lecun_init_
from ossid_code_torch.models.jax_import import flax_to_state_dict
from ossid_code_torch.ops.resize import resize_nearest, upsample_nearest

SEG_BIAS = -2.0


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


class _Trunk(nn.Module):
    """3-stage stride-8 conv encoder: (B, cin, H, W) -> (B, 4 width, H/8, W/8)."""

    def __init__(self, cin: int, width: int = 64):
        super().__init__()
        for i, ch in enumerate((width, width * 2, width * 4)):
            self.add_module(f"conv{i}", nn.Conv2d(cin, ch, 3, 2, 1))
            self.add_module(f"bn{i}", BatchNorm2d(ch))
            self.add_module(f"conv{i}b", nn.Conv2d(ch, ch, 3, 1, 1))
            self.add_module(f"bn{i}b", BatchNorm2d(ch))
            cin = ch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(3):
            x = F.relu(getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(x)))
            x = F.relu(getattr(self, f"bn{i}b")(getattr(self, f"conv{i}b")(x)))
        return x


class FewshotSegNetwork(nn.Module):
    def __init__(self, img_size, width: int = 64):
        super().__init__()
        self.img_size = tuple(img_size)
        c = width * 4
        self.query_trunk = _Trunk(3, width)
        self.support_trunk = _Trunk(4, width)
        self.film_gamma = nn.Linear(c, c)
        self.film_beta = nn.Linear(c, c)
        self.d1, self.dn1 = nn.Conv2d(c + 1, 128, 3, 1, 1), BatchNorm2d(128)
        self.d2, self.dn2 = nn.Conv2d(128, 64, 3, 1, 1), BatchNorm2d(64)
        self.d3, self.dn3 = nn.Conv2d(64, 32, 3, 1, 1), BatchNorm2d(32)
        self.seg_final = nn.Conv2d(32, 1, 3, 1, 1)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's initialisation; seg_final a zero kernel and bias -2."""
        lecun_init_(self, generator)
        nn.init.zeros_(self.seg_final.weight)
        nn.init.constant_(self.seg_final.bias, SEG_BIAS)

    def forward(self, img, simg, smask):
        """img (B, H, W, 3); simg (B, K, h, w, 3); smask (B, K, h, w, 1) ->
        seg logits (B, H, W, 1)."""
        q = self.query_trunk(_nchw(img))  # (B, C, H8, W8)
        b, k = simg.shape[0], simg.shape[1]
        sup = torch.cat([simg, smask], dim=-1).reshape((b * k,) + tuple(simg.shape[2:4]) + (4,))
        sfeat = self.support_trunk(_nchw(sup))
        smask8 = _nchw(resize_nearest(smask.reshape((b * k,) + tuple(smask.shape[2:4]) + (1,)),
                                      tuple(sfeat.shape[2:4])))
        # masked global average pool -> a prototype a support, mean over k
        num = (sfeat * smask8).sum(dim=(2, 3))
        den = smask8.sum(dim=(2, 3)).clamp(min=1.0)
        proto = (num / den).reshape(b, k, -1).mean(dim=1)  # (B, C)

        # FiLM modulation and a cosine-similarity channel
        gamma = self.film_gamma(proto)[:, :, None, None]
        beta = self.film_beta(proto)[:, :, None, None]
        cos = (q * proto[:, :, None, None]).sum(dim=1, keepdim=True) / (
            torch.linalg.vector_norm(q, dim=1, keepdim=True)
            * torch.linalg.vector_norm(proto, dim=-1)[:, None, None, None] + 1e-6)
        x = torch.cat([q * (1 + gamma) + beta, cos], dim=1)

        x = F.relu(self.dn1(self.d1(x)))
        x = _nchw(upsample_nearest(_nhwc(x), 2))
        x = F.relu(self.dn2(self.d2(x)))
        x = _nchw(upsample_nearest(_nhwc(x), 2))
        x = F.relu(self.dn3(self.d3(x)))
        x = _nchw(resize_nearest(_nhwc(x), self.img_size))
        return _nhwc(self.seg_final(x))


def fewshot_seg_from_jax(params: dict, batch_stats: dict) -> dict:
    """JAX FewshotSegNetwork params + batch_stats (numpy) -> the port's
    FewshotSegNetwork state_dict (torch, CPU)."""
    return flax_to_state_dict(params, batch_stats)


def seg_bce(logits: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """The JAX model's loss: BCE on the sigmoid clipped to [1e-7, 1 - 1e-7]."""
    probs = torch.sigmoid(logits).clamp(1e-7, 1 - 1e-7)
    return -(gt * torch.log(probs) + (1 - gt) * torch.log(1 - probs)).mean()


class FewshotSegModel:
    """Host wrapper with the JAX FewshotSegModel's interface; runs on
    `device` (None -> cuda)."""

    train_feed_keys = ("img", "mask", "simg", "smask")

    def __init__(self, cfg, seed: int = 0, device: str | torch.device | None = None):
        self.device = resolve_device(device)
        self.cfg = cfg
        d = cfg.dataset
        if d.get("name") == "fss_1000":
            s = int(d.get("image_size", 224))
            h = w = sh = sw = s
        else:
            h, w = int(cfg.model.get("img_h", d.get("img_h", 480))), int(cfg.model.get("img_w", d.get("img_w", 640)))
            sh = sw = int(d.get("template_size", 128))
        self.img_size = (h, w)
        self.support_size = (sh, sw)
        self.net = FewshotSegNetwork(self.img_size, width=int(cfg.model.get("width", 64)))
        self.net.reset_parameters(torch.Generator().manual_seed(seed))
        self.net.to(self.device).eval()
        self.reset_optimizer()

    def reset_optimizer(self) -> None:
        m = self.cfg.model
        self.optimizer = make_optimizer(self.net.parameters(), m.get("learning_rate", 1e-4),
                                        m.get("weight_decay", 1e-6))

    def state_dict(self) -> dict:
        return {k: v.detach().clone() for k, v in self.net.state_dict().items()}

    def load_state_dict(self, sd: dict) -> None:
        """A port state_dict, or a JAX tree {'params', 'batch_stats'}."""
        if "params" in sd:
            sd = fewshot_seg_from_jax(sd["params"], sd["batch_stats"])
        self.net.load_state_dict(sd, strict=True)

    def _feed(self, batch: dict) -> dict:
        feed = {}
        for k in self.train_feed_keys:
            if k not in batch:
                continue
            v = batch[k] if isinstance(batch[k], torch.Tensor) else torch.from_numpy(np.asarray(batch[k]))
            v = v.to(self.device, torch.float32)
            if k in ("mask", "smask") and v.shape[-1] != 1:
                v = v[..., None]
            feed[k] = v
        return feed

    def forward(self, feed: dict, train: bool = False) -> torch.Tensor:
        self.net.train(train)
        try:
            return self.net(feed["img"], feed["simg"], feed["smask"])
        finally:
            self.net.eval()

    def train_step(self, batch: dict) -> dict:
        """One step on 'img', 'mask', 'simg', 'smask'; the loss as a device
        scalar (no host sync)."""
        feed = self._feed(batch)
        loss = seg_bce(self.forward(feed, train=True), feed["mask"])
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()
        return {"loss": loss.detach()}

    @torch.inference_mode()
    def eval_metric(self, batch: dict) -> list:
        """Per-sample segmentation IoU of `logits > 0` (the monitored metric)."""
        pred = (self.forward(self._feed(batch))[..., 0] > 0.0).cpu().numpy()
        gt = np.asarray(batch["mask"])[..., 0] > 0.5
        inter = np.logical_and(pred, gt).sum(axis=(1, 2))
        union = np.logical_or(pred, gt).sum(axis=(1, 2))
        return list(inter / np.clip(union, 1, None))
