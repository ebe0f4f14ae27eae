"""Zephyr score-feature assembly on the device (counterpart of
ossid_code_tpu/models/zephyr/features.py).

For each pose hypothesis the sampled model cloud is projected into the
observed RGB-D frame and what the model predicts is compared with what the
camera saw ("HSVD_diff_uv_norm"). Per point features (DIM_POINT = 11), the
first 3 are centered camera-frame xyz:

  [0:3]  model point in camera frame, centered per hypothesis
  [3]    hue difference (circular, in [0, 0.5])
  [4]    saturation difference
  [5]    value difference
  [6]    depth difference (observed - projected), clipped to [-0.1, 0.1] m
  [7:9]  normalized image coordinates (u/W - 0.5, v/H - 0.5)
  [9]    cos(angle) between transformed normal and the viewing ray
  [10]   validity (inside image and observed depth > 0)
"""

from __future__ import annotations

import torch

from .color import rgb_to_hsv

DIM_POINT = 11


def _taps(h: int, w: int, u: torch.Tensor, v: torch.Tensor):
    u0 = torch.clamp(torch.floor(u), 0, w - 2).to(torch.int64)
    v0 = torch.clamp(torch.floor(v), 0, h - 2).to(torch.int64)
    du = torch.clamp(u - u0, 0.0, 1.0)[..., None]
    dv = torch.clamp(v - v0, 0.0, 1.0)[..., None]
    return u0, v0, du, dv


def _blend(p00, p01, p10, p11, du, dv):
    return p00 * (1 - du) * (1 - dv) + p01 * du * (1 - dv) + p10 * (1 - du) * dv + p11 * du * dv


def bilinear_sample(img: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """img (H, W, C); u, v float pixel coords (...,) -> (..., C)."""
    h, w = img.shape[0], img.shape[1]
    u0, v0, du, dv = _taps(h, w, u, v)
    return _blend(img[v0, u0], img[v0, u0 + 1], img[v0 + 1, u0], img[v0 + 1, u0 + 1], du, dv)


def bilinear_sample_packed(img: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Bitwise-equal to `bilinear_sample`, as one gather of a (H, W, 4C) stack
    of the 2x2 tap neighbourhood (edge-padded) instead of four gathers."""
    h, w, c = img.shape
    p = torch.cat([img, img[-1:]], 0)
    p = torch.cat([p, p[:, -1:]], 1)
    packed = torch.cat([p[:-1, :-1], p[:-1, 1:], p[1:, :-1], p[1:, 1:]], dim=-1)
    u0, v0, du, dv = _taps(h, w, u, v)
    q = packed[v0, u0]
    return _blend(q[..., :c], q[..., c:2 * c], q[..., 2 * c:3 * c], q[..., 3 * c:], du, dv)


def filter_hypos_by_mask(model_points, cam_K, pose_hypos, mask, th: float = 0.5):
    """Keep hypotheses that project more than `th` of their model points
    inside `mask`: a (M,) bool numpy array (host helper, interface of ref
    utils/zephyr_utils.py:49-71)."""
    import numpy as np

    poses = np.asarray(pose_hypos, np.float64)
    pts = np.asarray(model_points, np.float64)
    K = np.asarray(cam_K, np.float64)
    cam = np.einsum("mij,nj->mni", poses[:, :3, :3], pts) + poses[:, None, :3, 3]
    z = np.clip(cam[..., 2], 1e-9, None)
    u = (K[0, 0] * cam[..., 0] / z + K[0, 2]).round().astype(int)
    v = (K[1, 1] * cam[..., 1] / z + K[1, 2]).round().astype(int)
    h, w = mask.shape
    invalid = (u < 0) | (u >= w) | (v < 0) | (v >= h)
    u = np.clip(u, 0, w - 1)
    v = np.clip(v, 0, h - 1)
    inmask = np.asarray(mask, bool)[v, u]
    inmask[invalid] = False
    return inmask.mean(axis=1) > th


def assemble_score_features(img, depth, cam_K, model_points, model_colors, model_normals,
                            poses, depth_margin: float = 0.02, return_uv: bool = True,
                            depth_origin: torch.Tensor | None = None,
                            packed_sample: bool = False):
    """img (H, W, 3) RGB [0,1] (pre-blurred); depth (H, W) meters, or an
    (S, S) crop whose top-left corner is `depth_origin` [y0, x0]; cam_K (3, 3);
    model_points / colors / normals (N, 3); poses (M, 4, 4) object -> camera.

    Returns (point_x (M, N, DIM_POINT), uv (M, N, 2) or None,
    inconst_ratio (M,) percent of valid points violating observed free space).
    """
    h, w = img.shape[0], img.shape[1]
    R = poses[:, :3, :3]
    t = poses[:, :3, 3]
    p_cam = torch.einsum("mij,nj->mni", R, model_points) + t[:, None, :]
    n_cam = torch.einsum("mij,nj->mni", R, model_normals)

    z = p_cam[..., 2]
    safe_z = torch.where(z > 1e-6, z, torch.ones_like(z))
    u = cam_K[0, 0] * p_cam[..., 0] / safe_z + cam_K[0, 2]
    v = cam_K[1, 1] * p_cam[..., 1] / safe_z + cam_K[1, 2]

    inside = (u >= 0) & (u <= w - 1) & (v >= 0) & (v <= h - 1) & (z > 1e-6)
    uc = torch.clamp(u, 0.0, w - 1.001)
    vc = torch.clamp(v, 0.0, h - 1.001)

    sample = bilinear_sample_packed if packed_sample else bilinear_sample
    obs_rgb = sample(img, uc, vc)

    ch, cw = depth.shape
    if depth_origin is None:
        ud, vd = uc, vc
    else:
        y0 = depth_origin[0].to(uc.dtype)
        x0 = depth_origin[1].to(uc.dtype)
        inside = inside & (uc >= x0) & (uc <= x0 + (cw - 1)) & (vc >= y0) & (vc <= y0 + (ch - 1))
        ud = torch.clamp(uc - x0, 0.0, cw - 1.001)
        vd = torch.clamp(vc - y0, 0.0, ch - 1.001)
    obs_depth = sample(depth[..., None], ud, vd)[..., 0]

    obs_hsv = rgb_to_hsv(obs_rgb)
    mdl_hsv = rgb_to_hsv(model_colors.expand(p_cam.shape))

    dh = torch.abs(obs_hsv[..., 0] - mdl_hsv[..., 0])
    dh = torch.minimum(dh, 1.0 - dh)
    ds = torch.abs(obs_hsv[..., 1] - mdl_hsv[..., 1])
    dv_ = torch.abs(obs_hsv[..., 2] - mdl_hsv[..., 2])

    valid = inside & (obs_depth > 1e-6)
    ddiff = torch.clamp(obs_depth - z, -0.1, 0.1)

    view = -p_cam / torch.linalg.norm(p_cam, dim=-1, keepdim=True).clamp(min=1e-6)
    cos_n = torch.sum(view * n_cam, dim=-1)

    xyz_centered = p_cam - p_cam.mean(dim=1, keepdim=True)
    validf = valid.to(torch.float32)
    point_x = torch.cat([
        xyz_centered,
        dh[..., None], ds[..., None], dv_[..., None],
        torch.where(valid, ddiff, torch.zeros_like(ddiff))[..., None],
        (u / w - 0.5)[..., None], (v / h - 0.5)[..., None],
        cos_n[..., None],
        validf[..., None],
    ], dim=-1)

    violate = valid & (z < obs_depth - depth_margin)
    n_valid = valid.sum(dim=1).to(torch.float32).clamp(min=1.0)
    inconst_ratio = 100.0 * violate.sum(dim=1).to(torch.float32) / n_valid

    uv = torch.stack([u, v], dim=-1) if return_uv else None
    return point_x, uv, inconst_ratio
