"""Batched point-to-point ICP on the device (counterpart of
ossid_code_tpu/ops/icp_device.py: `kabsch_batched`, `batched_icp`,
`batched_icp_plane`, `sample_valid_points`, `unproject_depth_grid`).

All K hypotheses refine together in fixed shapes: correspondences come from a
dense (K, P, S) distance matrix (one batched matmul and an argmin), invalid
scene points are pushed to 1e9 so they never win, and each hypothesis'
weighted Kabsch solve is a batched (K, 3, 3) SVD (`torch.linalg.svd`, a
library call). Hypotheses with fewer than `min_corr` gated correspondences
keep their pose for that iteration. Plain PyTorch: the JAX side is XLA with
no Pallas kernel here.
"""

from __future__ import annotations

import torch

from .nms import topk_stable

_BIG = 1e9
_KNUTH = 2654435761


def kabsch_batched(P: torch.Tensor, Q: torch.Tensor, w: torch.Tensor, min_corr: int = 4):
    """Weighted rigid alignment P -> Q. P, Q (K, N, 3); w (K, N) in [0, 1].
    Returns (R (K, 3, 3), t (K, 3), ok (K,)); R, t are identity / zero where
    fewer than `min_corr` points carry weight."""
    wsum = w.sum(-1, keepdim=True).clamp(min=1e-6)
    mu_p = (P * w[..., None]).sum(1) / wsum
    mu_q = (Q * w[..., None]).sum(1) / wsum
    Pc = (P - mu_p[:, None]) * w[..., None]
    Qc = Q - mu_q[:, None]
    H = torch.einsum("kni,knj->kij", Pc, Qc)
    U, _, Vt = torch.linalg.svd(H)
    V = Vt.transpose(-1, -2)
    UT = U.transpose(-1, -2)
    d = torch.linalg.det(V @ UT)
    D = torch.stack([torch.ones_like(d), torch.ones_like(d), d], -1)
    R = (V * D[:, None, :]) @ UT
    t = mu_q - torch.einsum("kij,kj->ki", R, mu_p)
    ok = w.sum(-1) >= min_corr
    eye = torch.eye(3, dtype=R.dtype, device=R.device).expand_as(R)
    R = torch.where(ok[:, None, None], R, eye)
    t = torch.where(ok[:, None], t, torch.zeros_like(t))
    return R, t, ok


def icp_gates(max_dist: float, iters: int, device=None) -> torch.Tensor:
    """The annealed correspondence gates, 2x -> 1x max_dist, in float32."""
    return torch.linspace(2.0 * max_dist, max_dist, iters, dtype=torch.float32, device=device)


def batched_icp(poses: torch.Tensor, model_pts: torch.Tensor, scene_pts: torch.Tensor,
                scene_valid: torch.Tensor, max_dist: float = 0.01, iters: int = 8,
                model_normals: torch.Tensor | None = None) -> torch.Tensor:
    """Refine K pose hypotheses (K, 4, 4) against one scene cloud.

    model_pts (P, 3) object frame; scene_pts (S, 3) camera frame with
    scene_valid (S,) masking holes; model_normals (P, 3), when given, drops
    back-facing model points from the solve. Returns refined poses (K, 4, 4)."""
    sp = torch.where(scene_valid[:, None], scene_pts, torch.full_like(scene_pts, _BIG))
    sp2 = (sp * sp).sum(-1)
    for gate in icp_gates(max_dist, iters, poses.device):
        R = poses[:, :3, :3]
        t = poses[:, :3, 3]
        p = torch.einsum("kij,nj->kni", R, model_pts) + t[:, None]
        d2 = (p * p).sum(-1)[..., None] + sp2[None, None, :] - 2.0 * torch.einsum("kni,si->kns", p, sp)
        nn = torch.argmin(d2, dim=-1)
        dmin = torch.gather(d2, -1, nn[..., None])[..., 0]
        q = sp[nn]
        w = (dmin < gate * gate).to(p.dtype)
        if model_normals is not None:
            n_cam = torch.einsum("kij,nj->kni", R, model_normals)
            w = w * ((n_cam * p).sum(-1) < 0.0).to(p.dtype)
        Rd, td, ok = kabsch_batched(p, q, w)
        R_new = Rd @ R
        t_new = torch.einsum("kij,kj->ki", Rd, t) + td
        new = poses.clone()
        new[:, :3, :3] = torch.where(ok[:, None, None], R_new, R)
        new[:, :3, 3] = torch.where(ok[:, None], t_new, t)
        poses = new
    return poses


def _rodrigues(omega: torch.Tensor) -> torch.Tensor:
    """(K, 3) axis-angle -> (K, 3, 3) rotation matrices."""
    theta = torch.linalg.norm(omega, dim=-1, keepdim=True).clamp(min=1e-12)
    ax = omega / theta
    th = theta[..., None]
    zeros = torch.zeros_like(ax[..., 0])
    Kx = torch.stack([
        torch.stack([zeros, -ax[..., 2], ax[..., 1]], -1),
        torch.stack([ax[..., 2], zeros, -ax[..., 0]], -1),
        torch.stack([-ax[..., 1], ax[..., 0], zeros], -1),
    ], -2)
    eye = torch.eye(3, dtype=omega.dtype, device=omega.device).expand_as(Kx)
    return eye + torch.sin(th) * Kx + (1 - torch.cos(th)) * (Kx @ Kx)


def batched_icp_plane(poses: torch.Tensor, model_pts: torch.Tensor, scene_pts: torch.Tensor,
                      scene_normals: torch.Tensor, scene_valid: torch.Tensor, max_dist: float = 0.01,
                      iters: int = 8, model_normals: torch.Tensor | None = None) -> torch.Tensor:
    """Point-to-PLANE variant of batched_icp: each iteration solves the
    linearized 6x6 normal equations per hypothesis (Levenberg-damped, the
    step capped at 0.2 rad / 20 mm), which converges below the depth-pixel
    footprint where point-to-point stalls. scene_normals (S, 3):
    camera-facing surface normals; other arguments as batched_icp. Runs on
    the tensors' device; the 6x6 solves are `torch.linalg.solve`."""
    sp = torch.where(scene_valid[:, None], scene_pts, torch.full_like(scene_pts, _BIG))
    sp2 = (sp * sp).sum(-1)
    eye6 = torch.eye(6, dtype=poses.dtype, device=poses.device)
    for gate in icp_gates(max_dist, iters, poses.device):
        R = poses[:, :3, :3]
        t = poses[:, :3, 3]
        p = torch.einsum("kij,nj->kni", R, model_pts) + t[:, None]
        d2 = (p * p).sum(-1)[..., None] + sp2[None, None, :] - 2.0 * torch.einsum("kni,si->kns", p, sp)
        nn = torch.argmin(d2, dim=-1)
        dmin = torch.gather(d2, -1, nn[..., None])[..., 0]
        q = sp[nn]
        nq = scene_normals[nn]
        w = (dmin < gate * gate).to(p.dtype)
        if model_normals is not None:
            n_cam = torch.einsum("kij,nj->kni", R, model_normals)
            w = w * ((n_cam * p).sum(-1) < 0.0).to(p.dtype)
        resid = (nq * (p - q)).sum(-1)  # (K, N)
        A = torch.cat([torch.linalg.cross(p, nq), nq], -1)  # (K, N, 6)
        Aw = A * w[..., None]
        AtA = torch.einsum("kni,knj->kij", Aw, A)
        # Levenberg damping: near-planar correspondence sets leave sliding
        # directions unconstrained and the raw solve steps unboundedly
        diag = torch.diagonal(AtA, dim1=-2, dim2=-1).mean(-1)
        AtA = AtA + (1e-3 * diag + 1e-9)[:, None, None] * eye6
        Atb = torch.einsum("kni,kn->ki", Aw, -resid)
        x = torch.linalg.solve(AtA, Atb[..., None])[..., 0]  # (K, 6): [omega, v]
        # trust region: cap the per-iteration step (0.2 rad / 20 mm)
        wn = torch.linalg.norm(x[:, :3], dim=-1)
        vn = torch.linalg.norm(x[:, 3:], dim=-1)
        s = torch.minimum(torch.ones_like(wn), torch.minimum(0.2 / wn.clamp(min=1e-12), 0.02 / vn.clamp(min=1e-12)))
        x = x * s[:, None]
        ok = w.sum(-1) >= 6
        Rd = _rodrigues(x[:, :3])
        R_new = torch.einsum("kij,kjl->kil", Rd, R)
        t_new = torch.einsum("kij,kj->ki", Rd, t) + x[:, 3:]
        new = poses.clone()
        new[:, :3, :3] = torch.where(ok[:, None, None], R_new, R)
        new[:, :3, 3] = torch.where(ok[:, None], t_new, t)
        poses = new
    return poses


def unproject_depth_grid(depth: torch.Tensor, cam_K: torch.Tensor, origin: torch.Tensor | None = None,
                         stride: int = 1):
    """Depth map or crop (H, W) in meters -> camera-frame points (S, 3) and
    valid (S,). cam_K are the full-frame intrinsics; origin (2,) = [y0, x0] of
    the crop in full-frame pixels (None = full frame)."""
    d = depth[::stride, ::stride]
    h, w = d.shape
    yy, xx = torch.meshgrid(torch.arange(h, dtype=d.dtype, device=d.device) * stride,
                            torch.arange(w, dtype=d.dtype, device=d.device) * stride, indexing="ij")
    if origin is not None:
        yy = yy + origin[0].to(d.dtype)
        xx = xx + origin[1].to(d.dtype)
    z = d
    X = (xx - cam_K[0, 2]) * z / cam_K[0, 0]
    Y = (yy - cam_K[1, 2]) * z / cam_K[1, 1]
    return torch.stack([X, Y, z], -1).reshape(-1, 3), (z > 1e-6).reshape(-1)


def valid_point_order(ok: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k highest of score = ok + r, r a 24-bit Knuth hash of
    the pixel index in [0, 1): valid pixels first, each group in a fixed
    pseudo-random order. Equal scores would keep the lower index first, as
    `lax.top_k` does (`topk_stable`; `torch.topk` promises no order among
    ties)."""
    n = ok.shape[0]
    h = (torch.arange(n, dtype=torch.int64, device=ok.device) * _KNUTH) & 0xFFFFFFFF
    r = (h >> 8).to(torch.float32) / float(1 << 24)
    score = torch.where(ok, 1.0 + r, r)
    return topk_stable(score, min(k, n))[1]


def sample_valid_points(depth: torch.Tensor, cam_K: torch.Tensor, origin: torch.Tensor | None = None,
                        k: int = 4096):
    """k camera-frame points picked pseudo-randomly among the valid
    (depth > 0) pixels at full resolution: (points (k, 3), valid (k,))."""
    pts, ok = unproject_depth_grid(depth, cam_K, origin=origin, stride=1)
    idx = valid_point_order(ok, k)
    return pts[idx], ok[idx]
