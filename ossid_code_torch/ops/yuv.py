"""YUV 4:2:0 frame transport (the port of ossid_code_tpu/ops/yuv.py).

`--yuv_transfer` ships each frame to the card as one I420 buffer, 1.5 bytes
a pixel (460,800 B at 480x640 against 921,600 B of RGB), and rebuilds the
(H, W, 3) uint8 RGB frame there, so detection, scoring and the replay buffer
read the same tensor they read after a direct upload.

The pack runs on the host in numpy with OpenCV's 20-bit fixed-point BT.601
limited-range arithmetic, which is `cv2.cvtColor(img, COLOR_RGB2YUV_I420)`
bit for bit (the port imports no cv2); chroma is sampled at the top-left
pixel of each 2x2 block. The unpack is plain torch on the frame's device:
float32 1.164 (y - 16) plus the chroma terms, chroma upsampled 2x by
nearest neighbour, rounded and clipped to uint8, as the JAX package's
`_unpack`.
"""

from __future__ import annotations

import numpy as np
import torch

from ossid_code_torch.utils.host_copy import to_device

# OpenCV's BT.601 RGB -> YUV coefficients, fixed point with 20 fraction bits
_SHIFT = 20
_CRY, _CGY, _CBY = 269484, 528482, 102760
_CRU, _CGU, _CBU = -155188, -305135, 460324
_CGV, _CBV = -385875, -74448


def _check_even(h: int, w: int) -> None:
    if h % 2 or w % 2:
        raise ValueError(f"YUV 4:2:0 needs an even height and width, got {h}x{w}")


def pack_yuv420(img_rgb_u8: np.ndarray):
    """(H, W, 3) uint8 RGB -> (y (H, W), u (H/2, W/2), v (H/2, W/2)) uint8."""
    h, w = img_rgb_u8.shape[:2]
    _check_even(h, w)
    # int32 holds every sum: at most 255 * 900726 + (128 << 20) + (1 << 19) < 2**31
    rgb = np.asarray(img_rgb_u8).astype(np.int32)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    half = 1 << (_SHIFT - 1)
    y = (_CRY * r + _CGY * g + _CBY * b + half + (16 << _SHIFT)) >> _SHIFT
    rd, gd, bd = r[0::2, 0::2], g[0::2, 0::2], b[0::2, 0::2]
    u = (_CRU * rd + _CGU * gd + _CBU * bd + half + (128 << _SHIFT)) >> _SHIFT
    v = (_CBU * rd + _CGV * gd + _CBV * bd + half + (128 << _SHIFT)) >> _SHIFT
    return tuple(np.clip(p, 0, 255).astype(np.uint8) for p in (y, u, v))


def pack_i420(img_rgb_u8: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 RGB -> (3H/2, W) uint8 I420 buffer: the y plane, then
    u, then v, each row-major (cv2's cvtColor layout)."""
    h, w = img_rgb_u8.shape[:2]
    y, u, v = pack_yuv420(img_rgb_u8)
    return np.concatenate([y.ravel(), u.ravel(), v.ravel()]).reshape(3 * h // 2, w)


def unpack_yuv420_rgb(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """uint8 planes y (H, W), u and v (H/2, W/2) -> (H, W, 3) uint8 RGB, on
    the planes' device (BT.601 limited-range inverse, cv2's I420)."""
    yf = 1.164 * (y.to(torch.float32) - 16.0)
    uf = u.to(torch.float32).repeat_interleave(2, 0).repeat_interleave(2, 1) - 128.0
    vf = v.to(torch.float32).repeat_interleave(2, 0).repeat_interleave(2, 1) - 128.0
    r = yf + 1.596 * vf
    g = yf - 0.392 * uf - 0.813 * vf
    b = yf + 2.017 * uf
    return torch.stack([r, g, b], -1).round().clamp(0.0, 255.0).to(torch.uint8)


def unpack_i420(buf: torch.Tensor) -> torch.Tensor:
    """(3H/2, W) uint8 I420 buffer -> (H, W, 3) uint8 RGB on its device."""
    if buf.shape[0] % 3:
        raise ValueError(f"an I420 buffer has 3H/2 rows, got {buf.shape[0]}")
    h, w = buf.shape[0] * 2 // 3, buf.shape[1]
    _check_even(h, w)
    flat = buf.reshape(-1)
    n, q = h * w, h * w // 4
    return unpack_yuv420_rgb(flat[:n].view(h, w), flat[n:n + q].view(h // 2, w // 2),
                             flat[n + q:].view(h // 2, w // 2))


def ship_rgb_yuv420(img_rgb_u8: np.ndarray, device) -> torch.Tensor:
    """Host RGB frame -> (H, W, 3) uint8 RGB tensor on `device` through the
    1.5 B/px I420 buffer: packed on the host, one upload (from pinned
    memory, without waiting, on a CUDA device), unpacked there. The result
    has the shape and dtype of a direct upload."""
    return unpack_i420(to_device(pack_i420(img_rgb_u8), device))
