"""Residual blocks (the port of ossid_code_tpu/models/layers.py; the
reference's torchvision BasicBlock / Bottleneck copies, models/layers.py:9-122,
unused by DTOID but part of the model-family surface).

NCHW modules under the flax module names (`conv1`, `bn1`, ...,
`downsample_conv`, `downsample_bn`), so models/jax_import.py carries the
JAX blocks' weights with strict=True; BatchNorm by flax's rule
(models/batchnorm.py). flax infers the input width, so these take it as
`in_planes`; the projection shortcut exists where the JAX block makes one
(stride other than 1, or a width change).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ossid_code_torch.models.batchnorm import BatchNorm2d


class BasicBlock(nn.Module):
    def __init__(self, in_planes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_planes, planes, 3, stride, 1, bias=False)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm2d(planes)
        if stride != 1 or in_planes != planes:
            self.downsample_conv = nn.Conv2d(in_planes, planes, 1, stride, bias=False)
            self.downsample_bn = BatchNorm2d(planes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.bn2(self.conv2(F.relu(self.bn1(self.conv1(x)))))
        identity = self.downsample_bn(self.downsample_conv(x)) if hasattr(self, "downsample_conv") else x
        return F.relu(y + identity)


class Bottleneck(nn.Module):
    def __init__(self, in_planes: int, planes: int, stride: int = 1, expansion: int = 4):
        super().__init__()
        out_ch = planes * expansion
        self.conv1 = nn.Conv2d(in_planes, planes, 1, bias=False)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, out_ch, 1, bias=False)
        self.bn3 = BatchNorm2d(out_ch)
        if stride != 1 or in_planes != out_ch:
            self.downsample_conv = nn.Conv2d(in_planes, out_ch, 1, stride, bias=False)
            self.downsample_bn = BatchNorm2d(out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        identity = self.downsample_bn(self.downsample_conv(x)) if hasattr(self, "downsample_conv") else x
        return F.relu(y + identity)
