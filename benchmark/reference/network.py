"""DTOID: template-conditioned zero-shot instance detector, PyTorch
(counterpart of ossid_code_tpu/models/dtoid/network.py).

Public methods take and return NHWC tensors, as the JAX package's do; inside,
the convolutions run on NCHW tensors in `torch.channels_last`, whose storage
is NHWC, so the depthwise-correlation kernel reads them without a copy.
Module names follow the reference's torch modules, so the state_dict that
`export_dtoid_state_dict` emits (and `jax_import.dtoid_from_jax` builds)
loads with strict=True.

  * ImageEncoder — DenseNet121 trunk whose stem output is modulated by a 3x3
    depthwise correlation with the global-template kernel, then 1024 -> 640.
  * TemplateEncoderLocal — SqueezeNet1.1 on RGB+mask -> (7, 7, 640).
  * TemplateEncoderGlobal — the same trunk + two valid 3x3 convs -> (3, 3, 64).
  * CorrelationHead — global-average dot, 3x3 depthwise correlation and
    subtraction branches fused to 512 channels, a center heat map and a
    5-stage segmentation decoder.
  * ClassificationHead / RegressionHead — RetinaNet-style heads, 24 anchors.

`DtoidNetwork.forward` is the training forward (one local and one global
template per image); with the module in train mode its BatchNorms use batch
statistics and update their running statistics by flax's rule
(models/batchnorm.py).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from . import densenet, squeezenet
from .batchnorm import BatchNorm2d
from .conv import avg_pool, depthwise_corr
from .nms import nms_topk, topk_stable
from .resize import resize_bilinear, resize_nearest, upsample_nearest

PRIOR = 0.01
PRIOR_BIAS = -math.log((1.0 - PRIOR) / PRIOR)
BBOX_STD = (0.1, 0.1, 0.2, 0.2)
_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _cl(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous(memory_format=torch.channels_last)


def _dw_corr(x: torch.Tensor, k_nhwc: torch.Tensor) -> torch.Tensor:
    """3x3 / padding-1 depthwise correlation of a channels_last NCHW map with
    per-sample NHWC kernels (either may be a stride-0 broadcast over B)."""
    return _nchw(depthwise_corr(_nhwc(x), k_nhwc, padding=1))


def imagenet_normalize(img: torch.Tensor) -> torch.Tensor:
    """[0,1] RGB (..., 3) -> ImageNet-normalized."""
    mean = torch.tensor(_IMAGENET_MEAN, dtype=img.dtype, device=img.device)
    std = torch.tensor(_IMAGENET_STD, dtype=img.dtype, device=img.device)
    return (img - mean) / std


def _conv(cin: int, cout: int, k: int, padding: int = 0) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, padding=padding)


def lecun_init_(module: nn.Module, generator: torch.Generator) -> None:
    """flax's default initialisation: truncated-normal lecun kernels (std
    sqrt(1/fan_in), cut at 2 std), zero biases, unit BatchNorm scale."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            fan_in = m.weight[0].numel()
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            nn.init.trunc_normal_(m.weight, 0.0, std, -2.0 * std, 2.0 * std,
                                  generator=generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)


class TemplateEncoderLocal(nn.Module):
    """RGB+mask (B, 124, 124, 4) -> (B, 7, 7, 640)."""

    def __init__(self):
        super().__init__()
        self.backbone_0 = squeezenet.stem()
        self.backbone_1 = squeezenet.early()
        self.backbone_2 = squeezenet.late()
        self.norm_1 = BatchNorm2d(128)
        self.norm_2 = BatchNorm2d(512)

    def features(self, t4: torch.Tensor) -> torch.Tensor:
        x1 = self.backbone_1(self.backbone_0(t4))
        x2 = self.backbone_2(x1)
        x1d = _nchw(resize_bilinear(_nhwc(self.norm_1(x1)), tuple(x2.shape[2:])))
        return torch.cat([self.norm_2(x2), x1d], 1)

    def forward(self, t4: torch.Tensor) -> torch.Tensor:
        return _nhwc(self.features(_cl(_nchw(t4))))


class TemplateEncoderGlobal(TemplateEncoderLocal):
    """RGB+mask (B, 124, 124, 4) -> (B, 3, 3, 64) object-attention kernel."""

    def __init__(self):
        super().__init__()
        self.final_conv_1 = _conv(640, 128, 3)
        self.final_norm_1 = BatchNorm2d(128)
        self.final_conv_2 = _conv(128, 64, 3)
        self.final_norm_2 = BatchNorm2d(64)

    def features(self, t4: torch.Tensor) -> torch.Tensor:
        xf = super().features(t4)
        xf = self.final_norm_1(F.elu(self.final_conv_1(xf)))
        return self.final_norm_2(F.elu(self.final_conv_2(xf)))


class ImageEncoder(nn.Module):
    """Image (B, H, W, 3) + global kernel (B, 3, 3, 64) -> (B, H/16-1, W/16-1, 640)."""

    def __init__(self, densenet_blocks=(12, 24, 16)):
        super().__init__()
        self.backdense_0 = densenet.stem()
        self.backdense_1 = densenet.early()
        self.backdense_2 = densenet.late(densenet_blocks)
        self.c1 = _conv(self.backdense_2.out_channels, 640, 1)
        self.n1 = BatchNorm2d(640)

    def features(self, image: torch.Tensor, global_kernel: torch.Tensor) -> torch.Tensor:
        """image NCHW channels_last; global_kernel NHWC (1 or B, 3, 3, 64)."""
        x0 = _cl(self.backdense_0(image))
        gk = global_kernel.expand(x0.shape[0], *global_kernel.shape[1:])
        x0 = x0 + _dw_corr(x0, gk)  # object-attention modulation, residual
        x = self.backdense_2(self.backdense_1(x0))
        return self.n1(F.elu(self.c1(x)))

    def forward(self, image: torch.Tensor, global_kernel: torch.Tensor) -> torch.Tensor:
        return _nhwc(self.features(_cl(_nchw(image)), global_kernel))


class ClassificationHead(nn.Module):
    """(B, 512, h, w) -> per-anchor class probabilities (B, h*w*24, 2)."""

    def __init__(self, num_anchors: int = 24, num_classes: int = 2, feature_size: int = 256):
        super().__init__()
        self.num_classes = num_classes
        for i in range(1, 5):
            self.add_module(f"conv{i}", _conv(512 if i == 1 else feature_size, feature_size, 3, 1))
        self.output = _conv(feature_size, num_anchors * num_classes, 3, 1)

    def reset_output(self):
        nn.init.zeros_(self.output.weight)
        nn.init.constant_(self.output.bias, PRIOR_BIAS)

    def forward(self, x):
        for i in range(1, 5):
            x = F.elu(getattr(self, f"conv{i}")(x))
        out = torch.sigmoid(self.output(x))
        return _nhwc(out).reshape(out.shape[0], -1, self.num_classes)


class RegressionHead(nn.Module):
    """(B, 512, h, w) -> per-anchor box deltas (B, h*w*24, 4)."""

    def __init__(self, num_anchors: int = 24, feature_size: int = 256):
        super().__init__()
        for i in range(1, 5):
            self.add_module(f"conv{i}", _conv(512 if i == 1 else feature_size, feature_size, 3, 1))
        self.output = _conv(feature_size, num_anchors * 4, 3, 1)

    def reset_output(self):
        nn.init.zeros_(self.output.weight)
        nn.init.zeros_(self.output.bias)

    def forward(self, x):
        for i in range(1, 5):
            x = F.elu(getattr(self, f"conv{i}")(x))
        out = self.output(x)
        return _nhwc(out).reshape(out.shape[0], -1, 4)


class CorrelationHead(nn.Module):
    """Image feature x template feature -> (fused map (B, 512, h, w), heat map
    (B, 1, h, w)) via `correlate`, and seg logits (B, 1, H, W) via
    `decode_seg`, which serving runs for the winning template only."""

    def __init__(self, img_size=(480, 640)):
        super().__init__()
        self.img_size = tuple(img_size)
        self.c1, self.n1 = _conv(640, 640, 3), BatchNorm2d(640)
        self.c2, self.n2 = _conv(640, 640, 3), BatchNorm2d(640)
        for name in ("dot", "dot3x3", "sub"):
            self.add_module(f"corr_conv_{name}", _conv(640, 256, 3, 1))
            self.add_module(f"norm_corr_{name}", BatchNorm2d(256))
        self.cf, self.nf = _conv(768, 512, 3, 1), BatchNorm2d(512)
        self.corr_conv_heatmap = _conv(512, 1, 1)
        widths = (512, 256, 128, 64, 32, 16)
        for i in range(1, 6):
            self.add_module(f"s{i}", _conv(widths[i - 1], widths[i], 3, 1))
            self.add_module(f"ns{i}", BatchNorm2d(widths[i]))
        self.seg_final = _conv(16, 1, 3, 1)

    def reset_output(self):
        for conv in (self.corr_conv_heatmap, self.seg_final):
            nn.init.zeros_(conv.weight)
            nn.init.constant_(conv.bias, PRIOR_BIAS)

    def correlate(self, image_feat: torch.Tensor, template_feat: torch.Tensor, cross: bool = False):
        """image_feat (B, 640, h, w) channels_last (a stride-0 broadcast over B
        is read in place); template_feat (B, 640, 7, 7). `cross`: image_feat
        (F, ...) frames and template_feat (T, ...) templates, every frame
        against every template; the outputs hold F * T samples, sample
        f * T + t."""
        t1 = self.n1(F.elu(self.c1(template_feat)))
        t2 = self.n2(F.elu(self.c2(t1)))
        taps = _nhwc(t2).contiguous()
        avg = _nchw(avg_pool(_nhwc(template_feat), template_feat.shape[2]))  # (B, 640, 1, 1)
        if cross:
            dot3x3 = _nchw(depthwise_corr(_nhwc(image_feat), taps, padding=1, cross=True))
            frames = image_feat[:, None]
            dot = _cl((frames * avg[None]).flatten(0, 1))
            sub = _cl((frames - avg[None]).flatten(0, 1))
        else:
            dot3x3 = _dw_corr(image_feat, taps)
            dot = image_feat * avg
            sub = image_feat - avg

        dot_c = self.norm_corr_dot(F.elu(self.corr_conv_dot(dot)))
        dot3_c = self.norm_corr_dot3x3(F.elu(self.corr_conv_dot3x3(dot3x3)))
        sub_c = self.norm_corr_sub(F.elu(self.corr_conv_sub(sub)))
        # concat order matters for the weight layout: dot, sub, dot3x3
        x = torch.cat([dot_c, sub_c, dot3_c], 1)
        x2 = self.nf(F.elu(self.cf(x)))
        heatmap = torch.sigmoid(self.corr_conv_heatmap(x2))
        return x2, heatmap

    def decode_seg(self, x2: torch.Tensor, half: bool = False) -> torch.Tensor:
        """(B, 512, h, w) -> seg logits (B, 1, H, W), or (B, 1, H/2, W/2)
        with `half`: the train step's half-resolution seg supervision (cfg
        model.seg_loss_half), which leaves out most of the two
        full-resolution stages' work; inference decodes at full resolution."""

        def up(s):
            return _nchw(upsample_nearest(_nhwc(s), 2))

        out_hw = (self.img_size[0] // 2, self.img_size[1] // 2) if half else self.img_size
        s = up(self.ns1(F.elu(self.s1(x2))))
        s = up(self.ns2(F.elu(self.s2(s))))
        s = up(self.ns3(F.elu(self.s3(s))))
        s = _nchw(resize_nearest(_nhwc(self.ns4(F.elu(self.s4(s)))), out_hw))
        s = self.ns5(F.elu(self.s5(s)))
        return self.seg_final(s)


def decode_boxes(anchors: torch.Tensor, deltas: torch.Tensor) -> torch.Tensor:
    """Apply regression deltas to anchors. anchors (N, 4); deltas (..., N, 4)."""
    widths = anchors[:, 2] - anchors[:, 0]
    heights = anchors[:, 3] - anchors[:, 1]
    ctr_x = anchors[:, 0] + 0.5 * widths
    ctr_y = anchors[:, 1] + 0.5 * heights
    dx = deltas[..., 0] * BBOX_STD[0]
    dy = deltas[..., 1] * BBOX_STD[1]
    dw = deltas[..., 2] * BBOX_STD[2]
    dh = deltas[..., 3] * BBOX_STD[3]
    pred_ctr_x = ctr_x + dx * widths
    pred_ctr_y = ctr_y + dy * heights
    pred_w = torch.exp(dw) * widths
    pred_h = torch.exp(dh) * heights
    return torch.stack([pred_ctr_x - 0.5 * pred_w, pred_ctr_y - 0.5 * pred_h,
                        pred_ctr_x + 0.5 * pred_w, pred_ctr_y + 0.5 * pred_h], dim=-1)


def clip_boxes(boxes: torch.Tensor, img_h: int, img_w: int) -> torch.Tensor:
    """Clamp x1, y1 at 0 and x2, y2 at the image size."""
    return torch.stack([boxes[..., 0].clamp(min=0.0), boxes[..., 1].clamp(min=0.0),
                        boxes[..., 2].clamp(max=float(img_w)),
                        boxes[..., 3].clamp(max=float(img_h))], dim=-1)


class DtoidNetwork(nn.Module):
    """The full DTOID network with its all-templates inference entry points."""

    def __init__(self, img_size=(480, 640), densenet_blocks=(12, 24, 16)):
        super().__init__()
        self.img_size = tuple(img_size)
        self.template_feature_extractor_global = TemplateEncoderGlobal()
        self.template_feature_extractor = TemplateEncoderLocal()
        self.image_feature_extractor = ImageEncoder(tuple(densenet_blocks))
        self.correlation_model = CorrelationHead(self.img_size)
        self.classification = ClassificationHead()
        self.regression = RegressionHead()

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The JAX package's initialisation: lecun kernels, and zero output
        convs with the PRIOR_BIAS / zero biases on the heads."""
        lecun_init_(self, generator)
        for head in (self.classification, self.regression, self.correlation_model):
            head.reset_output()

    def forward(self, image: torch.Tensor, limg: torch.Tensor, lmask: torch.Tensor,
                gimg: torch.Tensor, gmask: torch.Tensor, seg_half: bool = False) -> dict:
        """The training forward. All images in [0, 1], NHWC: image (B, H, W, 3),
        limg (B, h, w, 3), lmask (B, h, w, 1), gimg / gmask likewise.
        Returns classifications (B, N, 2), regressions (B, N, 4), heat_map
        (B, fh, fw, 1) and seg_logits (B, H, W, 1), or (B, H/2, W/2, 1) with
        `seg_half` (CorrelationHead.decode_seg)."""
        l4 = torch.cat([imagenet_normalize(limg), lmask], -1)
        g4 = torch.cat([imagenet_normalize(gimg), gmask], -1)
        gfeat = self.template_feature_extractor_global(g4)
        feat = _cl(self.image_feature_extractor.features(_cl(_nchw(imagenet_normalize(image))), gfeat))
        lfeat = self.template_feature_extractor.features(_cl(_nchw(l4)))
        xcors, heatmap = self.correlation_model.correlate(feat, lfeat)
        seg_logits = self.correlation_model.decode_seg(xcors, half=seg_half)
        return {
            "classifications": self.classification(xcors),
            "regressions": self.regression(xcors),
            "heat_map": _nhwc(heatmap),
            "seg_logits": _nhwc(seg_logits),
        }

    def compute_template_local(self, t4: torch.Tensor) -> torch.Tensor:
        return self.template_feature_extractor(t4)

    def compute_template_global(self, t4: torch.Tensor) -> torch.Tensor:
        return self.template_feature_extractor_global(t4)

    def _heads(self, image_n, local_feats, global_feat):
        """Shared all-templates trunk: (image feature broadcast over T) x local
        templates -> (xcors, heatmap, cls, reg), NCHW maps."""
        feat = _cl(self.image_feature_extractor.features(_cl(_nchw(image_n)), global_feat))
        t = local_feats.shape[0]
        feat_t = feat.expand(t, -1, -1, -1)  # stride-0 broadcast, never copied
        xcors, heatmap = self.correlation_model.correlate(feat_t, _cl(_nchw(local_feats)))
        return xcors, heatmap, self.classification(xcors), self.regression(xcors)

    def detect(self, image_u8: torch.Tensor, local_feats: torch.Tensor,
               global_feat: torch.Tensor, anchors: torch.Tensor,
               pre_nms_topk: int = 1000, topk: int = 500, nms_iou: float = 0.5,
               pack_seg: bool = False, compute_dtype: torch.dtype = torch.float32) -> dict:
        """The serving path for one frame: uint8 image in, detections out.
        Every template is correlated in one batch, top-k and NMS run on the
        device, and the full-resolution segmentation decoder runs only for
        the winning template.

        image_u8 (1, H, W, 3) uint8; local_feats (T, 7, 7, 640);
        global_feat (1, 3, 3, 64); anchors (N, 4). compute_dtype bfloat16
        runs the trunk and the heads in bf16 (the caller holds the network's
        weights in bf16; the template features are cast here); scores and
        box deltas are upcast to float32 before ranking and decoding, so
        top-k, NMS and the boxes run in float32."""
        image = image_u8.to(compute_dtype) / 255.0
        xcors, heatmap, cls, reg = self._heads(imagenet_normalize(image), local_feats.to(compute_dtype),
                                               global_feat.to(compute_dtype))
        out = self._select(cls, reg, anchors, pre_nms_topk, topk, nms_iou)
        best = out["pred_template_ids"][:1].long()  # stays on the device: no host sync
        seg_logits = self.correlation_model.decode_seg(xcors.index_select(0, best))
        out["heat_map"] = heatmap.index_select(0, best)[0, 0].float()
        img_h, img_w = self.img_size
        logits = seg_logits[0, 0]
        if pack_seg:
            # threshold at 0.5 (logit 0), 8 px per byte, little-endian bits
            bits = (logits > 0.0).to(torch.int32).reshape(img_h, img_w // 8, 8)
            weights = 2 ** torch.arange(8, dtype=torch.int32, device=bits.device)
            out["seg_packed"] = (bits * weights).sum(-1).to(torch.uint8)
        else:
            out["seg_u8"] = (torch.sigmoid(logits) * 255.0).to(torch.uint8)
        return out

    def _select(self, cls, reg, anchors, pre_nms_topk, topk, nms_iou) -> dict:
        """One frame's detections from its T templates' head outputs, cls
        (T, N, 2) and reg (T, N, 4): top-k over every template's anchors,
        then NMS, in float32 on the device."""
        img_h, img_w = self.img_size
        t, n = cls.shape[0], cls.shape[1]
        scores_all = cls[..., 1].float().reshape(-1)
        boxes_all = clip_boxes(decode_boxes(anchors, reg.float()), img_h, img_w).reshape(-1, 4)
        top_scores, top_idx = topk_stable(scores_all, min(pre_nms_topk, t * n))
        top_boxes = boxes_all[top_idx]
        top_tids = torch.div(top_idx, n, rounding_mode="floor").to(torch.int32)
        sel_scores, sel_boxes, sel_idx, valid = nms_topk(top_boxes, top_scores, nms_iou, topk)
        return {"pred_scores": sel_scores, "pred_bbox": sel_boxes, "pred_template_ids": top_tids[sel_idx],
                "valid": valid}

    def heads_frames(self, image_n: torch.Tensor, local_feats: torch.Tensor, global_feat: torch.Tensor):
        """The all-templates trunk of F frames at once: image_n (F, H, W, 3)
        normalised; local_feats (T, 7, 7, 640); global_feat (1, 3, 3, 64).
        The trunk runs once on the F frames (the stem's correlation with the
        global kernel broadcast over them) and the heads on F * T samples,
        sample f * T + t (one correlation of every frame with every
        template). Returns (xcors, heatmap, cls, reg), NCHW maps."""
        feat = _cl(self.image_feature_extractor.features(_cl(_nchw(image_n)), global_feat))
        xcors, heatmap = self.correlation_model.correlate(feat, _cl(_nchw(local_feats)), cross=True)
        return xcors, heatmap, self.classification(xcors), self.regression(xcors)

    def detect_frames(self, images_u8: torch.Tensor, local_feats: torch.Tensor,
                      global_feat: torch.Tensor, anchors: torch.Tensor,
                      pre_nms_topk: int = 1000, topk: int = 500, nms_iou: float = 0.5,
                      compute_dtype: torch.dtype = torch.float32) -> dict:
        """`detect` for F frames of one object (the serving farm's detect):
        images_u8 (F, H, W, 3) uint8. The trunk and heads run once for all F
        (`heads_frames`: kernel 1 twice, whatever F is), top-k and NMS per
        frame, and the winning template's segmentation decoder once on the F
        winners. Returns `detect`'s keys (seg as `seg_u8`) stacked over the
        frames: pred_scores (F, topk), pred_bbox (F, topk, 4),
        pred_template_ids (F, topk), valid (F, topk), heat_map (F, fh, fw),
        seg_u8 (F, H, W)."""
        image = images_u8.to(compute_dtype) / 255.0
        heads = self.heads_frames(imagenet_normalize(image), local_feats.to(compute_dtype),
                                  global_feat.to(compute_dtype))
        return self.select_frames(*heads, images_u8.shape[0], anchors, pre_nms_topk, topk, nms_iou)

    def select_frames(self, xcors, heatmap, cls, reg, f: int, anchors: torch.Tensor,
                      pre_nms_topk: int = 1000, topk: int = 500, nms_iou: float = 0.5) -> dict:
        """The second half of `detect_frames`, on `heads_frames`' outputs of
        f frames (F * T samples, frame-major): per-frame top-k and NMS, then
        the winners' segmentation decode in one batch."""
        t = cls.shape[0] // f
        cls = cls.reshape(f, t, *cls.shape[1:])
        reg = reg.reshape(f, t, *reg.shape[1:])
        frames = [self._select(cls[i], reg[i], anchors, pre_nms_topk, topk, nms_iou) for i in range(f)]
        out = {k: torch.stack([o[k] for o in frames]) for k in frames[0]}
        best = out["pred_template_ids"][:, 0].long() + t * torch.arange(f, device=cls.device)
        seg_logits = self.correlation_model.decode_seg(xcors.index_select(0, best))
        out["heat_map"] = heatmap.index_select(0, best)[:, 0].float()
        out["seg_u8"] = (torch.sigmoid(seg_logits[:, 0]) * 255.0).to(torch.uint8)
        return out

    def forward_frames(self, images: torch.Tensor, local_feats: torch.Tensor, global_feat: torch.Tensor):
        """`forward_all_templates` of F frames at once (the serving farm's
        forward): images (F, H, W, 3) in [0,1]. Returns cls (F, T, N, 2),
        reg (F, T, N, 4), heatmap (F, T, fh, fw, 1), seg_probs (F, T, H, W)."""
        f, t = images.shape[0], local_feats.shape[0]
        xcors, heatmap, cls, reg = self.heads_frames(imagenet_normalize(images), local_feats, global_feat)
        seg = torch.sigmoid(self.correlation_model.decode_seg(xcors)[:, 0])
        return tuple(a.reshape(f, t, *a.shape[1:]) for a in (cls, reg, _nhwc(heatmap), seg))

    def forward_all_templates(self, image: torch.Tensor, local_feats: torch.Tensor,
                              global_feat: torch.Tensor):
        """image (1, H, W, 3) in [0,1]; local_feats (T, 7, 7, 640); global_feat
        (1, 3, 3, 64). Returns the raw per-template head outputs: cls (T, N, 2),
        reg (T, N, 4), heatmap (T, fh, fw, 1), seg_probs (T, H, W)."""
        xcors, heatmap, cls, reg = self._heads(imagenet_normalize(image), local_feats, global_feat)
        seg_logits = self.correlation_model.decode_seg(xcors)
        return cls, reg, _nhwc(heatmap), torch.sigmoid(seg_logits[:, 0])
