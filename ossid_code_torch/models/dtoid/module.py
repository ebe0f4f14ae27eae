"""DtoidModel: the host-side DTOID wrapper (counterpart of
ossid_code_tpu/models/dtoid/module.py).

It holds the network, the anchor grid, the finetune optimizer and a
per-object template-feature cache that stays on the device. `detect_async`
launches the whole serving path for one frame (CUDA launches return before
the device finishes); `fetch_detections` copies the results to the host and
builds the reference-schema dict. `train_step` / `train_step_u8` run one
finetune step (forward in train mode, `dtoid_losses`, backward, the
optax-rule optimizer of core/optim.py); while spans are on, each part of
the step is a span (STEP_PARTS) in utils/rpc_stats.STATS.

The JAX package's three training and inference switches, read the same
way: the cfg key (`cfg.model.get(..., False)`) or its environment variable
set to "1" when the model is built, either one turns it on:
  * `bf16_finetune` (`OSSID_BF16_FINETUNE`): the mixed-precision step (JAX
    `train_step_mp`). The
    network runs on bf16 casts of the float32 parameters, on bf16 inputs,
    with the running statistics updated in float32 by flax's bf16 rule
    (models/batchnorm.py); the losses run on float32 upcasts of the outputs
    and the optimizer in float32. The casts are one pass a step: the float32
    parameters (and their gradients) are views of one flat float32 buffer,
    a persistent bf16 copy of the network (`_Bf16Step`) takes its
    parameters as views of one flat bf16 leaf, and shares the float32
    network's BatchNorm statistics, which it updates for all layers at
    once after the forward. Each step one `copy_` casts the flat float32
    buffer into the flat bf16 one, and after the backward one `copy_`
    upcasts the flat bf16 gradient into the float32 gradient views. The
    arithmetic is that of per-parameter casts: the same bf16 roundings of
    the same float32 values, float32 optimizer state.
  * `bf16_infer` (`OSSID_BF16_INFER`): detection in bf16 on a cast of the
    weights that is kept on the device and refreshed when `weights_version`
    changes (JAX `_infer_vars`); template features are computed and cached
    in float32 from the float32 weights and cast for each detect.
  * `seg_loss_half` (`OSSID_SEG_HALF`): every train step (float32, bf16,
    `train_step_u8`) decodes the seg logits at half resolution and holds
    them to the exact 2x2 mean of the mask (`dtoid_losses`); inference
    decodes at full resolution.
"""

from __future__ import annotations

import copy
import os
from typing import Any

import numpy as np
import torch

from ossid_code_torch.core.optim import make_optimizer
from ossid_code_torch.device import resolve_device
from ossid_code_torch.models.batchnorm import BatchNorm2d, bf16_running_update
from ossid_code_torch.models.dtoid.anchors import generate_anchor_grid
from ossid_code_torch.models.dtoid.losses import dtoid_losses
from ossid_code_torch.models.dtoid.network import DtoidNetwork, imagenet_normalize
from ossid_code_torch.utils.rpc_stats import STATS


# each parameter's chunk of the flat buffers starts at a multiple of this many
# elements (128 bytes in bf16): cuDNN takes its tensor-core kernels only for
# aligned weights, and falls back to slow ones for a misaligned pointer
_ALIGN = 64


def _chunk_sizes(params: list) -> list:
    """[n0, pad0, n1, pad1, ...]: each parameter's numel, then the padding
    that aligns the next chunk (zero-size pads left out)."""
    sizes = []
    for p in params:
        sizes.append(p.numel())
        if p.numel() % _ALIGN:
            sizes.append(_ALIGN - p.numel() % _ALIGN)
    return sizes


def _param_chunks(flat: torch.Tensor, params: list, sizes: list) -> list:
    """The parameters' chunks of `flat` split by `sizes` (padding dropped),
    each viewed with its parameter's shape and dense memory layout
    (channels_last stays channels_last)."""
    chunks = iter(flat.split(sizes))
    out = []
    for p in params:
        out.append(_dense_view(next(chunks), p))
        if p.numel() % _ALIGN:
            next(chunks)
    return out


def _dense_order(p: torch.Tensor) -> list:
    """p's dimensions from the largest stride to the smallest."""
    return sorted(range(p.dim()), key=lambda d: -p.stride(d))


def _dense_view(chunk: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """`chunk` (1-D, like.numel() elements) viewed with like's shape and
    dense stride order, by a view and a permute (no copy)."""
    if like.dim() == 1:
        return chunk
    if like.dim() == 0:
        return chunk.view(())
    order = _dense_order(like)
    t = chunk.view([like.shape[d] for d in order])
    return t.permute([order.index(d) for d in range(like.dim())])


class _Bf16Step:
    """The persistent bf16 network of the mixed-precision step.

    On construction the float32 network's parameters become views of one
    flat float32 buffer (the BatchNorm scales and biases first), their
    gradients views of another, and its BatchNorm running statistics and
    counters views of two more; each parameter's chunk starts aligned
    (_ALIGN). A copy of the network shares the float32 network's buffers and
    has no parameters of its own. Each step `cast` casts the flat float32
    buffer into a flat bf16 leaf in one `copy_`; `forward` splits the leaf
    into per-parameter views (the BatchNorm part upcast to float32 in one
    cast, as the layers use it) and runs the copy on them, its layers
    handing their batch statistics to `sink`, then updates every layer's
    running statistics with flax's bf16 rule in a few whole-buffer ops;
    `upcast_grads` writes the flat bf16 gradient into the float32 gradient
    views in one `copy_`. The arithmetic is that of per-parameter casts and
    per-layer updates."""

    def __init__(self, net: torch.nn.Module):
        bns = [m for m in net.modules() if isinstance(m, BatchNorm2d)]
        if len({m.momentum for m in bns}) > 1:
            raise ValueError("the bf16 step updates all BatchNorm layers with one momentum")
        self.momentum = bns[0].momentum if bns else 0.1
        self.bn_params = [p for m in bns for p in (m.weight, m.bias)]
        bn_ids = {id(p) for p in self.bn_params}
        self.rest = [p for p in net.parameters() if id(p) not in bn_ids]
        self.bn_sizes, self.rest_sizes = _chunk_sizes(self.bn_params), _chunk_sizes(self.rest)
        self.parts = [sum(self.bn_sizes), sum(self.rest_sizes)]
        dev = self.rest[0].device
        self.flat32 = torch.zeros(sum(self.parts), dtype=torch.float32, device=dev)
        self.grad32 = torch.zeros_like(self.flat32)
        chans = [m.num_features for m in bns]
        self.stats32 = torch.empty(2 * sum(chans), dtype=torch.float32, device=dev)
        self.counts = torch.empty(len(bns), dtype=torch.int64, device=dev)
        with torch.no_grad():
            for params, sizes, flat, grad in zip((self.bn_params, self.rest), (self.bn_sizes, self.rest_sizes),
                                                 self.flat32.split(self.parts), self.grad32.split(self.parts)):
                for p, v, g in zip(params, _param_chunks(flat, params, sizes), _param_chunks(grad, params, sizes)):
                    v.copy_(p)
                    p.data = v
                    p.grad = g
            off = 0
            for i, (m, c) in enumerate(zip(bns, chans)):
                for name, view in (("running_mean", self.stats32[off:off + c]),
                                   ("running_var", self.stats32[off + c:off + 2 * c])):
                    view.copy_(m._buffers[name])
                    m._buffers[name] = view
                self.counts[i] = m.num_batches_tracked
                m._buffers["num_batches_tracked"] = self.counts[i]
                off += 2 * c
        self.net16 = copy.deepcopy(net).train()
        owner = {}  # float32 parameter -> (module of the copy, name)
        for m16, m32 in zip(self.net16.modules(), net.modules()):
            for name, p in list(m16._parameters.items()):
                del m16._parameters[name]
                if p is None:
                    m16.__dict__[name] = None
                    continue
                key = id(getattr(m32, name))
                if key in owner:
                    raise RuntimeError("the bf16 step needs each parameter in one module only")
                owner[key] = (m16, name)
            for name in m32._buffers:
                m16._buffers[name] = m32._buffers[name]
        self.slots = [owner[id(p)] for p in self.bn_params + self.rest]
        self.bns16 = [m for m in self.net16.modules() if isinstance(m, BatchNorm2d)]
        self.sink: dict = {}
        for m in self.bns16:
            m.stats_sink = self.sink
        self.flat16 = torch.empty(self.flat32.shape, dtype=torch.bfloat16, device=dev)
        self.leaf = None

    def cast(self) -> None:
        with torch.no_grad():
            self.flat16.copy_(self.flat32)

    def forward(self, *inputs, **kwargs):
        self.leaf = self.flat16.detach().requires_grad_(True)
        bn16, rest16 = self.leaf.split(self.parts)
        views = (_param_chunks(bn16.float(), self.bn_params, self.bn_sizes)
                 + _param_chunks(rest16, self.rest, self.rest_sizes))
        for (module, name), view in zip(self.slots, views):
            module.__dict__[name] = view
        try:
            out = self.net16(*inputs, **kwargs)
            self._update_statistics()
        finally:
            self.sink.clear()
        return out

    @torch.no_grad()
    def _update_statistics(self) -> None:
        """Every layer that ran: flax's bf16 rule on its running statistics,
        in one update of the flat buffers when all layers ran."""
        if len(self.sink) == len(self.bns16):
            batch = torch.cat([t for m in self.bns16 for t in self.sink[m]])
            bf16_running_update(self.stats32, batch, self.momentum)
            self.counts.add_(1)
            return
        for m, (mean, var) in self.sink.items():
            bf16_running_update(m.running_mean, mean, m.momentum)
            bf16_running_update(m.running_var, var, m.momentum)
            m.num_batches_tracked.add_(1)

    def upcast_grads(self) -> None:
        with torch.no_grad():
            self.grad32.copy_(self.leaf.grad)
        self.leaf = None


# the parts of one train step, in order: child spans of the loop's
# `finetune.step` in the span log (utils/rpc_stats.py)
STEP_PARTS = ("step.feed", "step.cast", "step.forward", "step.losses", "step.backward", "step.upcast",
              "step.optimizer")


def _switch(m, key: str, env: str) -> bool:
    """cfg.model[key] or the environment variable `env` set to "1"."""
    return bool(m.get(key, False)) or os.environ.get(env) == "1"


class DtoidModel:
    """Network weights + template cache; runs on `device` (None -> cuda)."""

    def __init__(self, cfg, seed: int = 42, device: str | torch.device | None = None):
        self.device = resolve_device(device)
        self.cfg = cfg
        m = cfg.model
        self.img_size = (int(m.img_h), int(m.img_w))
        self.feat_size = (int(m.img_h) // 16 - 1, int(m.img_w) // 16 - 1)
        self.pre_nms_topk = int(m.get("topk_pre_nms", 1000))
        self.nms_iou = float(m.nms_iou_thresh)
        self._pack_seg = str(m.get("seg_transfer", "packed")) == "packed"

        self.bf16_finetune = _switch(m, "bf16_finetune", "OSSID_BF16_FINETUNE")
        self.bf16_infer = _switch(m, "bf16_infer", "OSSID_BF16_INFER")
        self.seg_half = _switch(m, "seg_loss_half", "OSSID_SEG_HALF")
        self.net = DtoidNetwork(self.img_size, tuple(m.get("densenet_blocks", (12, 24, 16))))
        self.net.reset_parameters(torch.Generator().manual_seed(seed))
        self.net.to(device=self.device, memory_format=torch.channels_last).eval()
        self.anchors = torch.from_numpy(generate_anchor_grid(*self.feat_size)).to(self.device)
        # the bf16 step's network, and the float32 parameters as views of one
        # buffer; before the optimizer takes the parameters
        self._bf16_step = _Bf16Step(self.net) if self.bf16_finetune else None
        self.optimizer = make_optimizer(self.net.parameters(), m.learning_rate, m.weight_decay)

        # per-object template features, device-resident
        self.template_feature_cache: dict[Any, tuple] = {}
        # bumped on every weight change
        self.weights_version = 0
        self._bf16_cache = None  # (weights_version, bf16 copy of the network)

    # ------------------------------------------------------------- weights
    def state_dict(self) -> dict:
        """A copy of the weights and BatchNorm statistics (the training step
        updates the live tensors in place)."""
        return {k: v.detach().clone() for k, v in self.net.state_dict().items()}

    def load_state_dict(self, sd: dict) -> None:
        self.net.load_state_dict(sd, strict=True)
        self.weights_version += 1
        self.clear_cache()

    # ------------------------------------------------------------ training
    def reset_optimizer(self) -> None:
        """Fresh optimizer state (ref online_learning.py:520-528)."""
        m = self.cfg.model
        self.optimizer = make_optimizer(self.net.parameters(), m.learning_rate, m.weight_decay)

    def _on_device(self, batch: dict) -> dict:
        return {k: (v if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v))).to(self.device)
                for k, v in batch.items()}

    def train_step(self, batch: dict, optimizer=None, bf16: bool | None = None,
                   loss_scale: float = 1.0, reduce_grads=None) -> dict:
        """One train step on a batch of float [0, 1] images: 'img'
        (B, H, W, 3), 'limg', 'lmask', 'gimg', 'gmask' (B, h, w, 3 | 1),
        'bbox_gt' (B, G, 5), 'heatmap' (B, fh, fw, 1), 'mask' (B, H, W, 1).
        With `bf16_finetune` (or `bf16=True`) the forward and backward run in
        bf16 (module doc); the parameters, statistics and optimizer state
        stay float32. With `seg_loss_half` the seg logits are decoded at
        half resolution against the 2x2-mean mask. `optimizer` defaults to the finetune optimizer (an
        offline trainer passes its own). The data-parallel trainer passes
        `loss_scale` (its shard's share of the global batch: the backward
        runs on loss * loss_scale) and `reduce_grads`, called on the
        parameters after the backward and before the optimizer. Returns the
        loss terms as device scalars (no host sync)."""
        bf16 = self.bf16_finetune if bf16 is None else bf16
        if bf16 and self._bf16_step is None:
            raise ValueError("a bf16 step needs DtoidModel built with model.bf16_finetune")
        opt = self.optimizer if optimizer is None else optimizer
        marks = [STATS.now()]
        b = {k: t.to(torch.float32) for k, t in self._on_device(batch).items()}
        m = self.cfg.model
        images = [b[k] for k in ("img", "limg", "lmask", "gimg", "gmask")]
        marks.append(STATS.now())
        self.net.train()
        try:
            if bf16:
                step = self._bf16_step
                step.cast()
                marks.append(STATS.now())
                out = step.forward(*(t.to(torch.bfloat16) for t in images), seg_half=self.seg_half)
                out = {k: v.float() for k, v in out.items()}
            else:
                marks.append(STATS.now())
                out = self.net(*images, seg_half=self.seg_half)
            marks.append(STATS.now())
            loss, metrics = dtoid_losses(out, b, self.anchors, lam_seg=m.lam_seg,
                                         lam_center=m.lam_center, lam_cls=m.lam_cls,
                                         lam_reg=m.lam_reg)
            marks.append(STATS.now())
            if not bf16:
                # the bf16 step's float32 gradients are views that stay set
                opt.zero_grad(set_to_none=self._bf16_step is None)
            (loss if loss_scale == 1.0 else loss * loss_scale).backward()
            marks.append(STATS.now())
            if bf16:
                step.upcast_grads()
            if reduce_grads is not None:
                reduce_grads(self.net.parameters())
            marks.append(STATS.now())
            opt.step()
            marks.append(STATS.now())
        finally:
            self.net.eval()
        if marks[0] is not None:
            for name, t0, t1 in zip(STEP_PARTS, marks, marks[1:]):
                STATS.add_span(name, t0, t1)
        self.weights_version += 1
        return {k: v.detach() for k, v in metrics.items()}

    def train_step_u8(self, batch: dict) -> dict:
        """train_step over compact inputs, expanded on the device: 'img_u8'
        (B, H, W, 3) uint8, 'mask_bits' (B, H*W/8) uint8 of little-endian
        bit-packed mask, 'limg_u8' / 'gimg_u8' uint8 templates, 'lmask_u8' /
        'gmask_u8' 0/1 uint8, 'bbox_gt', 'heatmap'. u8 / 255 is what the host
        path's process_data gives at native resolution; the bf16 step casts
        that float32 feed."""
        dev = self._on_device(batch)
        img_h, img_w = self.img_size
        img = dev["img_u8"].to(torch.float32) / 255.0
        shifts = torch.arange(8, dtype=torch.uint8, device=self.device)
        bits = (dev["mask_bits"][..., None] >> shifts) & 1
        return self.train_step({
            "img": img,
            "limg": dev["limg_u8"].to(torch.float32) / 255.0,
            "lmask": dev["lmask_u8"].to(torch.float32),
            "gimg": dev["gimg_u8"].to(torch.float32) / 255.0,
            "gmask": dev["gmask_u8"].to(torch.float32),
            "bbox_gt": dev["bbox_gt"],
            "heatmap": dev["heatmap"],
            "mask": bits.to(torch.float32).reshape(img.shape[0], img_h, img_w, 1),
        })

    # ----------------------------------------------------------- inference
    def clear_cache(self) -> None:
        self.template_feature_cache = {}

    def _tensor(self, a, dtype=torch.float32) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=dtype).to(self.device)

    @torch.inference_mode()
    def get_template_features(self, obj_id, limg: np.ndarray, lmask: np.ndarray):
        """Cache-or-compute the device template features of one object.
        limg (T, h, w, 3) float [0,1]; lmask (T, h, w) or (T, h, w, 1).
        The global feature comes from the first template."""
        if obj_id not in self.template_feature_cache:
            lmask = np.asarray(lmask)
            if lmask.ndim == 3:
                lmask = lmask[..., None]
            t4 = torch.cat([imagenet_normalize(self._tensor(limg)), self._tensor(lmask)], -1)
            local = self.net.compute_template_local(t4)
            glob = self.net.compute_template_global(t4[0:1])
            self.template_feature_cache[obj_id] = (local, glob)
        return self.template_feature_cache[obj_id]

    @torch.inference_mode()
    def detect_async(self, batch: dict, topk: int = 500) -> dict:
        """Launch detection for one frame without waiting; returns the dict of
        device tensors (see DtoidNetwork.detect)."""
        img = batch["img"]
        if isinstance(img, torch.Tensor):
            img = img.to(self.device)
        else:
            img = np.asarray(img)
            if img.dtype != np.uint8:
                img = (np.clip(img, 0.0, 1.0) * 255.0).round().astype(np.uint8)
            img = torch.from_numpy(np.ascontiguousarray(img)).to(self.device)
        if img.ndim == 3:
            img = img[None]
        if img.shape[0] != 1 or img.dtype != torch.uint8:
            raise ValueError(f"detect takes one uint8 frame, got {tuple(img.shape)} {img.dtype}")

        obj_id = batch["obj_id"]
        if hasattr(obj_id, "__len__"):
            obj_id = int(np.asarray(obj_id).reshape(-1)[0])
        local, glob = self.get_template_features(obj_id, batch["limg"], batch["lmask"])
        dtype = torch.bfloat16 if self.bf16_infer else torch.float32
        return self._infer_net().detect(img, local, glob, self.anchors,
                                        pre_nms_topk=self.pre_nms_topk, topk=topk,
                                        nms_iou=self.nms_iou, pack_seg=self._pack_seg,
                                        compute_dtype=dtype)

    def _infer_net(self) -> DtoidNetwork:
        """The network in the inference dtype: the float32 network itself, or
        with `bf16_infer` a bf16 copy on the device, recast from the float32
        weights and statistics when `weights_version` has changed."""
        if not self.bf16_infer:
            return self.net
        # plain tensors, not inference tensors: the copy is refreshed in place
        with torch.inference_mode(False), torch.no_grad():
            if self._bf16_cache is None:
                net16 = copy.deepcopy(self.net).to(torch.bfloat16).eval().requires_grad_(False)
                self._bf16_cache = (self.weights_version, net16)
            elif self._bf16_cache[0] != self.weights_version:
                net16 = self._bf16_cache[1]
                for dst, src in zip(net16.state_dict().values(), self.net.state_dict().values()):
                    dst.copy_(src)
                self._bf16_cache = (self.weights_version, net16)
        return self._bf16_cache[1]

    def fetch_detections(self, out_dev: dict, batch: dict | None = None,
                         fetched: dict | None = None) -> dict:
        """Copy a detect_async result to the host and build the
        reference-schema output dict; `fetched` injects host arrays that were
        already copied."""
        out = (dict(fetched) if fetched is not None
               else {k: v.cpu().numpy() for k, v in out_dev.items()})
        if "seg_packed" in out:
            packed = out.pop("seg_packed")
            bits = np.unpackbits(packed[..., None], axis=-1, bitorder="little")
            out["segmentation"] = bits.reshape(packed.shape[0], -1).astype(np.float32)
        else:
            out["segmentation"] = out.pop("seg_u8").astype(np.float32) / 255.0

        result = {
            "pred_bbox": out["pred_bbox"],
            "pred_scores": out["pred_scores"],
            "pred_template_ids": out["pred_template_ids"],
            "valid": out["valid"],
            "segmentation": out["segmentation"],
            "heat_map": out["heat_map"],
            # reference-compatible aliases (ref models/dtoid/__init__.py:152-160)
            "final_bbox": [out["pred_bbox"]],
            "final_score": [out["pred_scores"]],
        }
        if batch is not None and batch.get("mask") is not None:
            gt = np.asarray(batch["mask"]).squeeze() > 0.5
            pred = out["segmentation"] > 0.5
            union = np.logical_or(pred, gt).sum()
            iou = float(np.logical_and(pred, gt).sum() / union) if union > 0 else 1.0
            result["seg_IoU"] = iou
            result["seg_IoU_50"] = float(iou > 0.5)
        return result

    def forward_test_time(self, batch: dict, topk: int = 500) -> dict:
        """Zero-shot detection on one frame (ref models/dtoid/__init__.py:61-171).

        batch: 'img' (H, W, 3) or (1, H, W, 3), float [0,1] or uint8; 'obj_id';
        'limg' (T, h, w, 3); 'lmask' (T, h, w[, 1]); optional 'mask' GT for
        seg_IoU; optional 'template_z_values' for z-filtering."""
        out = self.fetch_detections(self.detect_async(batch, topk=topk), batch)
        if self.cfg.model.get("filter_z") and batch.get("template_z_values") is not None:
            out = self._filter_z(out, np.asarray(batch["template_z_values"]).reshape(-1))
        return out

    def _filter_z(self, out: dict, template_z_values: np.ndarray) -> dict:
        """Reject detections whose implied object distance is implausible: the
        124px template at distance |z_t| scales to the box's max dimension,
        implying z = 124 / max_dim * -z_t; keep 0.4 m < z < 2 m."""
        boxes = out["pred_bbox"]
        tids = out["pred_template_ids"].astype(int)
        zt = template_z_values[tids]
        max_dim = np.maximum(boxes[:, 2] - boxes[:, 0], boxes[:, 3] - boxes[:, 1])
        pred_z = (124.0 / np.clip(max_dim, 1e-6, None)) * -zt
        cond = (pred_z > 0.4) & (pred_z < 2.0) & out["valid"]
        ids = np.nonzero(cond)[0]
        if len(ids) == 0:
            ids = np.asarray([0])
        for k in ("pred_bbox", "pred_scores", "pred_template_ids", "valid"):
            out[k] = out[k][ids]
        out["final_bbox"] = [out["pred_bbox"]]
        out["final_score"] = [out["pred_scores"]]
        return out
