"""Attentional SIFT-correspondence matcher (the port of
ossid_code_tpu/models/matcher.py): the model family the train CLI's
`dataset=ycbv_sift` trains (`model=matcher`, or the reference's name
`superglue`).

SuperGlue-style, as the JAX package supplies it: MLP keypoint encoders
(descriptor and position), alternating self and cross attention with both
sides updated together, and differentiable optimal transport with a learned
dustbin score (`log_optimal_transport`: Sinkhorn in log space, a fixed
number of `logsumexp` iterations in float32). The loss is the negative
log-likelihood of the GT assignment matrix; the monitored metric is match
recall by the row argmax. Plain PyTorch on the card (no kernel of the port
on this path): the attention is the JAX code's einsum and softmax, not a
fused library kernel. Modules carry the flax names (`obs_desc`,
`self_obs0.q`, `cross_model1.mlp2`, `final_obs`, `dustbin`, ...), so
models/jax_import.py carries JAX weights with strict=True; there are no
BatchNorm statistics.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ossid_code_torch.core.optim import make_optimizer
from ossid_code_torch.device import resolve_device
from ossid_code_torch.models.dtoid.network import lecun_init_
from ossid_code_torch.models.jax_import import flax_to_state_dict


def log_optimal_transport(scores: torch.Tensor, alpha: torch.Tensor, iters: int) -> torch.Tensor:
    """Sinkhorn in log space over the dustbin-augmented score matrix.

    scores (B, M, N); alpha the scalar dustbin score. Returns the log
    assignment (B, M+1, N+1), whose exp has row sums ~1 (plus dustbin mass)."""
    b, m, n = scores.shape
    dev = scores.device
    bins0 = alpha.expand(b, m, 1)
    bins1 = alpha.expand(b, 1, n)
    corner = alpha.expand(b, 1, 1)
    couplings = torch.cat([torch.cat([scores, bins0], -1), torch.cat([bins1, corner], -1)], 1)
    norm = -torch.log(torch.tensor(float(m + n), device=dev))
    log_mu = torch.cat([norm.expand(m), (torch.tensor(np.log(n), dtype=torch.float32, device=dev) + norm)[None]])
    log_nu = torch.cat([norm.expand(n), (torch.tensor(np.log(m), dtype=torch.float32, device=dev) + norm)[None]])
    u = torch.zeros((b, m + 1), device=dev)
    v = torch.zeros((b, n + 1), device=dev)
    for _ in range(iters):
        u = log_mu[None] - torch.logsumexp(couplings + v[:, None, :], dim=2)
        v = log_nu[None] - torch.logsumexp(couplings + u[:, :, None], dim=1)
    return couplings + u[:, :, None] + v[:, None, :] - norm


class _Attention(nn.Module):
    def __init__(self, dim: int, heads: int = 4):
        super().__init__()
        self.dim, self.heads = dim, heads
        for name in ("q", "k", "v", "merge"):
            self.add_module(name, nn.Linear(dim, dim))
        self.mlp1 = nn.Linear(2 * dim, 2 * dim)
        self.mlp2 = nn.Linear(2 * dim, dim)

    def forward(self, x: torch.Tensor, source: torch.Tensor) -> torch.Tensor:
        """x (B, M, D) attends to source (B, N, D); heads split the last
        axis as (h, d), h major, as flax's reshape does."""
        h, d = self.heads, self.dim // self.heads
        b = x.shape[0]
        q = self.q(x).reshape(b, -1, h, d)
        k = self.k(source).reshape(b, -1, h, d)
        v = self.v(source).reshape(b, -1, h, d)
        att = torch.softmax(torch.einsum("bmhd,bnhd->bhmn", q, k) / math.sqrt(d), dim=-1)
        out = torch.einsum("bhmn,bnhd->bmhd", att, v).reshape(b, -1, self.dim)
        y = self.mlp1(torch.cat([x, self.merge(out)], -1))
        return x + self.mlp2(F.relu(y))


class MatcherNetwork(nn.Module):
    def __init__(self, dim: int = 128, n_layers: int = 2, sinkhorn_iters: int = 30, desc_dim: int = 128):
        super().__init__()
        self.dim, self.n_layers, self.sinkhorn_iters = dim, n_layers, sinkhorn_iters
        for tag, pdim in (("obs", 2), ("model", 3)):
            self.add_module(f"{tag}_desc", nn.Linear(desc_dim, dim))
            self.add_module(f"{tag}_pos1", nn.Linear(pdim, 64))
            self.add_module(f"{tag}_pos2", nn.Linear(64, dim))
        for i in range(n_layers):
            for name in ("self_obs", "self_model", "cross_obs", "cross_model"):
                self.add_module(f"{name}{i}", _Attention(dim))
        self.final_obs = nn.Linear(dim, dim)
        self.final_model = nn.Linear(dim, dim)
        self.dustbin = nn.Parameter(torch.ones(()))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's initialisation; the dustbin score 1."""
        lecun_init_(self, generator)
        nn.init.ones_(self.dustbin)

    def _encode(self, desc, pos, tag):
        d = getattr(self, f"{tag}_desc")(desc / 512.0)
        return d + getattr(self, f"{tag}_pos2")(F.relu(getattr(self, f"{tag}_pos1")(pos)))

    def forward(self, obs_desc, obs_pos, model_desc, model_pos) -> torch.Tensor:
        fo = self._encode(obs_desc, obs_pos, "obs")
        fm = self._encode(model_desc, model_pos, "model")
        for i in range(self.n_layers):
            fo = getattr(self, f"self_obs{i}")(fo, fo)
            fm = getattr(self, f"self_model{i}")(fm, fm)
            # both sides update together
            fo, fm = getattr(self, f"cross_obs{i}")(fo, fm), getattr(self, f"cross_model{i}")(fm, fo)
        fo = self.final_obs(fo)
        fm = self.final_model(fm)
        scores = torch.einsum("bmd,bnd->bmn", fo, fm) / math.sqrt(self.dim)
        return log_optimal_transport(scores, self.dustbin, self.sinkhorn_iters)


def matcher_from_jax(params: dict) -> dict:
    """JAX MatcherNetwork params (numpy) -> the port's MatcherNetwork
    state_dict (torch, CPU)."""
    return flax_to_state_dict(params)


def match_nll(Z: torch.Tensor, M: torch.Tensor) -> torch.Tensor:
    """The JAX model's loss: -(M Z).sum() / max(M.sum(), 1)."""
    return -(M * Z).sum() / M.sum().clamp(min=1.0)


class SiftMatcher:
    """Host wrapper with the JAX SiftMatcher's interface; runs on `device`
    (None -> cuda)."""

    train_feed_keys = ("obs_desc", "obs_uv", "model_desc", "model_pts", "matches")

    def __init__(self, cfg, seed: int = 0, device: str | torch.device | None = None):
        self.device = resolve_device(device)
        self.cfg = cfg
        d = cfg.dataset
        self.n_obs = int(d.get("n_kpts_obs") or d.get("n_kpts", 128))
        self.n_model = int(d.get("n_kpts_model") or d.get("n_kpts", 128))
        self.net = MatcherNetwork(dim=int(cfg.model.get("dim", 128)), n_layers=int(cfg.model.get("n_layers", 2)),
                                  sinkhorn_iters=int(cfg.model.get("sinkhorn_iters", 30)))
        self.net.reset_parameters(torch.Generator().manual_seed(seed))
        self.net.to(self.device)
        self.reset_optimizer()

    def reset_optimizer(self) -> None:
        m = self.cfg.model
        self.optimizer = make_optimizer(self.net.parameters(), m.get("learning_rate", 1e-4),
                                        m.get("weight_decay", 1e-6))

    def state_dict(self) -> dict:
        return {k: v.detach().clone() for k, v in self.net.state_dict().items()}

    def load_state_dict(self, sd: dict) -> None:
        """A port state_dict, or a JAX tree {'params'}."""
        if "params" in sd:
            sd = matcher_from_jax(sd["params"])
        self.net.load_state_dict(sd, strict=True)

    def _feed(self, batch: dict) -> dict:
        return {k: (batch[k] if isinstance(batch[k], torch.Tensor) else torch.from_numpy(np.asarray(batch[k])))
                .to(self.device, torch.float32) for k in self.train_feed_keys}

    def forward(self, feed: dict) -> torch.Tensor:
        """The log assignment (B, M+1, N+1); pixel coordinates scaled to
        about [-1, 1], model points in meters as they are."""
        return self.net(feed["obs_desc"], feed["obs_uv"] / 320.0 - 1.0, feed["model_desc"], feed["model_pts"])

    def train_step(self, batch: dict) -> dict:
        feed = self._feed(batch)
        loss = match_nll(self.forward(feed), feed["matches"])
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()
        return {"loss": loss.detach()}

    @torch.inference_mode()
    def eval_metric(self, batch: dict) -> list:
        """Per-sample match recall: the share of GT (non-dustbin) matches
        whose row argmax of the predicted assignment is the GT column."""
        Z = self.forward(self._feed(batch)).cpu().numpy()
        M = np.asarray(batch["matches"])
        out = []
        for z, m in zip(Z, M):
            gt_r, gt_c = np.nonzero(m[:-1, :-1])
            if len(gt_r) == 0:
                out.append(1.0)
                continue
            pred_c = z[:-1, :].argmax(axis=1)
            out.append(float(np.mean(pred_c[gt_r] == gt_c)))
        return out
