"""Color-space conversion (counterpart of ossid_code_tpu/ops/color.py)."""

from __future__ import annotations

import torch


def rgb_to_hsv(rgb: torch.Tensor) -> torch.Tensor:
    """RGB [0,1] (..., 3) -> HSV with H in [0,1] (matplotlib/colorsys convention)."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    v = maxc
    delta = maxc - minc
    one = torch.ones_like(delta)
    safe_delta = torch.where(delta > 0, delta, one)
    s = torch.where(maxc > 0, delta / torch.where(maxc > 0, maxc, one), torch.zeros_like(delta))

    rc = (maxc - r) / safe_delta
    gc = (maxc - g) / safe_delta
    bc = (maxc - b) / safe_delta
    h = torch.where(maxc == r, bc - gc,
                    torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(delta > 0, torch.remainder(h / 6.0, 1.0), torch.zeros_like(h))
    return torch.stack([h, s, v], dim=-1)
