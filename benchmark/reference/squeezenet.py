"""SqueezeNet-1.1 feature trunk with a 4-channel stem (counterpart of
ossid_code_tpu/models/backbones/squeezenet.py), NCHW inside.

Split where DTOID splits it, under the reference's module names:

  stem()  = backbone_0: conv1 (4ch -> 64, 3x3/s2, valid)
  early() = backbone_1: relu, maxpool, fire2, fire3 -> 128ch
  late()  = backbone_2: maxpool, fire4, fire5, maxpool, fire6 ... fire9 -> 512ch

All max pools are 3x3/s2 with ceil_mode (124px templates: 61 -> 30 -> 15 -> 7).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


class Fire(nn.Module):
    def __init__(self, cin: int, squeeze: int, expand: int):
        super().__init__()
        self.squeeze = nn.Conv2d(cin, squeeze, 1)
        self.expand1x1 = nn.Conv2d(squeeze, expand, 1)
        self.expand3x3 = nn.Conv2d(squeeze, expand, 3, padding=1)

    def forward(self, x):
        x = F.relu(self.squeeze(x))
        return torch.cat([F.relu(self.expand1x1(x)), F.relu(self.expand3x3(x))], 1)


def _pool() -> nn.MaxPool2d:
    return nn.MaxPool2d(3, 2, ceil_mode=True)


def stem() -> nn.Sequential:
    return nn.Sequential(nn.Conv2d(4, 64, 3, 2))


def early() -> nn.Sequential:
    return nn.Sequential(nn.ReLU(), _pool(), Fire(64, 16, 64), Fire(128, 16, 64))


def late() -> nn.Sequential:
    return nn.Sequential(
        _pool(), Fire(128, 32, 128), Fire(256, 32, 128),
        _pool(), Fire(256, 48, 192), Fire(384, 48, 192),
        Fire(384, 64, 256), Fire(512, 64, 256),
    )
