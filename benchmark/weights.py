"""Random weights from the seed, made on the run's device in a few large
calls, for the program and the reference alike.

Every convolution and linear kernel gets flax's lecun scale (std
sqrt(1 / fan_in)) on a normal draw clipped at two standard deviations; biases
are zero and BatchNorm scales one, as the port's own initialisation leaves
them. The draws of one network come from one `torch.Generator` on the device
in one call. `perturb_heads` (frozen from the port's chip_smoke.py) then gives
DTOID's zero-initialised output convolutions nonzero weights: with zero heads
every anchor scores alike, and top-k and NMS turn into ties.
"""

from __future__ import annotations

import math

import torch


def _generator(device: torch.device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed) % (2**63))


@torch.no_grad()
def fill_lecun(net: torch.nn.Module, seed: int) -> None:
    """Overwrite every conv / linear kernel of `net` with clipped-normal
    lecun draws from `seed`, in one draw for the whole network."""
    layers = [m for m in net.modules() if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))]
    if not layers:
        return
    device = layers[0].weight.device
    sizes = [m.weight.numel() for m in layers]
    draw = torch.randn(sum(sizes), generator=_generator(device, seed), device=device).clamp_(-2.0, 2.0)
    for m, chunk in zip(layers, draw.split(sizes)):
        std = math.sqrt(1.0 / m.weight[0].numel()) / 0.87962566103423978
        m.weight.copy_(chunk.view_as(m.weight).mul_(std))
        if m.bias is not None:
            m.bias.zero_()


@torch.no_grad()
def perturb_heads(net: torch.nn.Module, seed: int) -> None:
    """Nonzero weights for DTOID's output convolutions, so that scores,
    boxes and masks differ between anchors."""
    heads = ((net.classification.output, 0.05, None),
             (net.regression.output, 0.01, None),
             (net.correlation_model.corr_conv_heatmap, 0.05, None),
             (net.correlation_model.seg_final, 0.1, 0.0))
    device = heads[0][0].weight.device
    sizes = [conv.weight.numel() for conv, _, _ in heads]
    draw = torch.randn(sum(sizes), generator=_generator(device, seed), device=device)
    for (conv, std, bias), chunk in zip(heads, draw.split(sizes)):
        conv.weight.copy_(chunk.view_as(conv.weight).mul_(std))
        if bias is not None:
            conv.bias.fill_(bias)


def dtoid_weights(net: torch.nn.Module, seed: int) -> None:
    fill_lecun(net, seed)
    for head in (net.classification, net.regression, net.correlation_model):
        head.reset_output()
    perturb_heads(net, seed + 1)


def zephyr_weights(net: torch.nn.Module, seed: int) -> None:
    fill_lecun(net, seed)
    if getattr(net, "align_head", None) is not None:
        torch.nn.init.zeros_(net.align_head.weight)
