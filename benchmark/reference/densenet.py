"""DenseNet-121 feature trunk (counterpart of
ossid_code_tpu/models/backbones/densenet.py), NCHW inside.

Split where DTOID splits it, under the reference's module names so the
reference state_dict keys load unchanged:

  stem()   = backdense_0: conv0 (7x7/s2, 64ch, no bias)
  early()  = backdense_1: norm0, relu, 3x3/s2 max pool, denseblock1 -> 256ch
  late()   = backdense_2: transition1 ... denseblock4, norm5

with DTOID's surgery: transition3 pools 2x2 at stride 1, so the final stride
stays 16 and the map shrinks by one pixel (480x640 -> 29x39). Growth rate 32,
bn_size 4; transition widths 128/256/512 whatever the block repeats.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .batchnorm import BatchNorm2d

GROWTH = 32
BN_SIZE = 4


class DenseLayer(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.norm1 = BatchNorm2d(cin)
        self.conv1 = nn.Conv2d(cin, BN_SIZE * GROWTH, 1, bias=False)
        self.norm2 = BatchNorm2d(BN_SIZE * GROWTH)
        self.conv2 = nn.Conv2d(BN_SIZE * GROWTH, GROWTH, 3, padding=1, bias=False)

    def forward(self, x):
        y = self.conv1(F.relu(self.norm1(x)))
        y = self.conv2(F.relu(self.norm2(y)))
        return torch.cat([x, y], 1)


class DenseBlock(nn.Module):
    def __init__(self, cin: int, n_layers: int):
        super().__init__()
        for i in range(n_layers):
            self.add_module(f"denselayer{i + 1}", DenseLayer(cin + i * GROWTH))
        self.out_channels = cin + n_layers * GROWTH

    def forward(self, x):
        for layer in self.children():
            x = layer(x)
        return x


class Transition(nn.Module):
    def __init__(self, cin: int, cout: int, pool_stride: int = 2):
        super().__init__()
        self.norm = BatchNorm2d(cin)
        self.conv = nn.Conv2d(cin, cout, 1, bias=False)
        self.pool_stride = pool_stride

    def forward(self, x):
        return F.avg_pool2d(self.conv(F.relu(self.norm(x))), 2, self.pool_stride)


def stem() -> nn.Sequential:
    return nn.Sequential(nn.Conv2d(3, 64, 7, 2, 3, bias=False))


def early() -> nn.Sequential:
    return nn.Sequential(BatchNorm2d(64), nn.ReLU(), nn.MaxPool2d(3, 2, 1),
                         DenseBlock(64, 6))


def late(block_config: Sequence[int] = (12, 24, 16)) -> nn.Sequential:
    """transition1 ... denseblock4 + norm5; `.out_channels` is the width
    (1024 for densenet121's 12/24/16)."""
    layers, c = [], 64 + 6 * GROWTH
    for i, (n, width) in enumerate(zip(block_config, (128, 256, 512))):
        layers.append(Transition(c, width, pool_stride=1 if i == 2 else 2))
        block = DenseBlock(width, n)
        layers.append(block)
        c = block.out_channels
    layers.append(BatchNorm2d(c))
    seq = nn.Sequential(*layers)
    seq.out_channels = c
    return seq
