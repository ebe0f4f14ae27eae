"""SIFT keypoints and descriptors in PyTorch, on the tensor's device.

What `cv2.SIFT_create(nfeatures=n).detectAndCompute(gray, mask)` computes
(OpenCV's defaults: 3 layers an octave, contrast threshold 0.04, edge
threshold 10, sigma 1.6), written for batched tensors so that it runs on the
card in the online loop and on the CPU in the tests; the matcher that reads
the descriptors (hypo/sift.py) was tuned on OpenCV's. The steps follow
OpenCV's sift implementation:

  * base image: the 8-bit gray image on the 0-255 scale, upscaled 2x
    (bilinear, octave -1) and blurred from an assumed 0.5 (so 1.0 after the
    upscale) to sigma 1.6; octaves until the short side is about 4 px;
  * Gaussian pyramid of 6 layers an octave (float32 sums of shifted slices
    in a fixed order, so the card and the CPU build the same pyramid: no
    convolution library and no TF32), the next octave's first layer every
    second pixel of layer 3; difference-of-Gaussian layers;
  * extrema over 3x3x3 neighbourhoods (max / min pooling) above OpenCV's
    integer pre-threshold floor(0.5 * 0.04 / 3 * 255) = 1, 5 px from the
    border; up to 5 quadratic refinement steps, all candidates at once with
    a done mask (Cramer's rule in float32, as OpenCV's 3x3 solve); contrast
    and edge-ratio tests;
  * orientation: a 36-bin histogram at 1.5 sigma within 4.5 sigma, smoothed,
    every peak at 0.8 of the maximum or more (parabolic interpolation) gives
    a keypoint; angles from OpenCV's polynomial atan2;
  * descriptor: 4x4 cells of 8 orientation bins, trilinear binning,
    normalised, clipped at 0.2, renormalised, scaled by 512 and rounded and
    saturated to 0-255;
  * selection: exact duplicates dropped, the `nfeatures` strongest by
    response kept (ties at the boundary kept, as OpenCV does), then the mask
    read at each keypoint's rounded position (after the selection, as
    OpenCV does).

`describe(gray, keypoints)` computes descriptors at given keypoints (for
instance OpenCV's, in the tests). Failures of SIFT itself raise `SiftError`.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

N_LAYERS = 3
SIGMA = 1.6
INIT_SIGMA = 0.5
CONTRAST_TH = 0.04
EDGE_TH = 10.0
IMG_BORDER = 5
MAX_INTERP_STEPS = 5
ORI_BINS = 36
ORI_SIG_FCTR = 1.5
ORI_RADIUS = 3 * ORI_SIG_FCTR
ORI_PEAK_RATIO = 0.8
DESCR_WIDTH = 4
DESCR_BINS = 8
DESCR_SCL_FCTR = 3.0
DESCR_MAG_THR = 0.2
INT_DESCR_FCTR = 512.0
FLT_EPSILON = float(np.finfo(np.float32).eps)
# keypoints a chunk of the orientation and descriptor passes (memory bound)
CHUNK = 256

_f32 = lambda v: float(np.float32(v))  # noqa: E731  a float32 constant
IMG_SCALE = _f32(np.float32(1.0) / np.float32(255.0))
DERIV_SCALE = _f32(np.float32(IMG_SCALE) * np.float32(0.5))
CROSS_SCALE = _f32(np.float32(IMG_SCALE) * np.float32(0.25))
# OpenCV's fastAtan2 polynomial (degrees)
_ATAN_P = [_f32(np.float32(c) * np.float32(180 / math.pi)) for c in
           (0.9997878412794807, -0.3258083974640975, 0.1555786518463281, -0.04432655554792128)]
_DBL_EPS_F32 = _f32(np.finfo(np.float64).eps)


class SiftError(ValueError):
    """SIFT found no features, too few correspondences or no consistent pose."""


class Keypoints(NamedTuple):
    """OpenCV's KeyPoint fields as arrays: pt (N, 2) (x, y), size, angle
    (degrees), response, and octave packed as OpenCV packs it (octave in the
    low byte, signed; layer in the second; the layer offset in the third)."""
    pt: np.ndarray
    size: np.ndarray
    angle: np.ndarray
    response: np.ndarray
    octave: np.ndarray

    @property
    def count(self) -> int:
        return len(self.size)


def rgb_to_gray(img_u8: torch.Tensor) -> torch.Tensor:
    """(H, W, 3) uint8 RGB -> (H, W) uint8, OpenCV's fixed-point
    COLOR_RGB2GRAY ((9798 R + 19235 G + 3735 B + 16384) >> 15)."""
    x = img_u8.to(torch.int32)
    y = x[..., 0] * 9798 + x[..., 1] * 19235 + x[..., 2] * 3735 + 16384
    return (y >> 15).to(torch.uint8)


def fast_atan2(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """OpenCV's fastAtan2 in float32: degrees in [0, 360)."""
    ax, ay = x.abs(), y.abs()
    steep = ax < ay
    c = torch.where(steep, ax / (ay + _DBL_EPS_F32), ay / (ax + _DBL_EPS_F32))
    c2 = c * c
    p1, p3, p5, p7 = _ATAN_P
    a = (((c2 * p7 + p5) * c2 + p3) * c2 + p1) * c
    a = torch.where(steep, 90.0 - a, a)
    a = torch.where(x < 0, 180.0 - a, a)
    return torch.where(y < 0, 360.0 - a, a)


def _reflect101(n_out: int, pad: int, size: int) -> np.ndarray:
    """Source indices of positions -pad .. size + pad - 1 under OpenCV's
    BORDER_REFLECT_101, reflected as often as needed."""
    p = np.arange(-pad, n_out + pad)
    if size == 1:
        return np.zeros_like(p)
    for _ in range(64):
        p = np.where(p < 0, -p, p)
        p = np.where(p >= size, 2 * size - p - 2, p)
        if ((p >= 0) & (p < size)).all():
            return p
    raise AssertionError("reflection did not converge")


def gaussian_kernel(sigma: float) -> np.ndarray:
    """OpenCV's GaussianBlur kernel for a float image: size
    round(8 sigma + 1) | 1, weights computed in float64 and stored in
    float32."""
    n = int(np.rint(sigma * 4 * 2 + 1)) | 1
    x = np.arange(n) - (n - 1) * 0.5
    w = np.exp(-0.5 / (sigma * sigma) * x * x)
    return (w * (1.0 / w.sum())).astype(np.float32)


def _blur_axis(img: torch.Tensor, w: np.ndarray, dim: int) -> torch.Tensor:
    """One separable pass along axis `dim` (-1 or -2) of a symmetric kernel, in
    float32 with reflect-101 borders: the taps at equal distance are added
    and weighted all at once (elementwise), then summed one distance after
    another in a fixed order, so every device rounds alike."""
    n = len(w)
    r = n // 2
    size = img.shape[dim]
    idx = torch.as_tensor(_reflect101(size, r, size), device=img.device)
    # win: the 2r + 1 shifted slices along axis dim - 1, each slice's
    # positions last
    win = img.index_select(dim, idx).unfold(dim, size, 1)
    kdim = dim - 1
    w_t = torch.as_tensor(w[:r], device=img.device).reshape([r] + [1] * (-kdim - 1))
    pairs = (win.narrow(kdim, 0, r) + win.narrow(kdim, r + 1, r).flip(kdim)) * w_t
    out = win.select(kdim, r) * float(w[r])
    for k in range(r):
        out = out + pairs.select(kdim, k)
    return out.movedim(-1, dim)


def gaussian_blur(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """OpenCV's GaussianBlur(img, Size(), sigma, sigma) on float32: rows,
    then columns."""
    w = gaussian_kernel(sigma)
    return _blur_axis(_blur_axis(img, w, -1), w, -2)


def upscale2x(img: torch.Tensor) -> torch.Tensor:
    """OpenCV's bilinear resize of a float image to twice its size: output
    2i takes 0.25 of input i-1 and 0.75 of input i, output 2i+1 0.75 of i
    and 0.25 of i+1, the first and last outputs the edge inputs; rows, then
    columns."""
    def axis(x, dim):
        n = x.shape[dim]
        lo = torch.as_tensor(np.clip(np.arange(n) - 1, 0, n - 1), device=x.device)
        hi = torch.as_tensor(np.clip(np.arange(n) + 1, 0, n - 1), device=x.device)
        even = x.index_select(dim, lo) * 0.25 + x * 0.75
        odd = x * 0.75 + x.index_select(dim, hi) * 0.25
        even.narrow(dim, 0, 1).copy_(x.narrow(dim, 0, 1))
        odd.narrow(dim, n - 1, 1).copy_(x.narrow(dim, n - 1, 1))
        shape = list(x.shape)
        shape[dim] = 2 * n
        return torch.stack([even, odd], dim=dim + 1).reshape(shape)

    return axis(axis(img, img.dim() - 1), img.dim() - 2)


def n_octaves(h: int, w: int, first_octave: int = -1) -> int:
    """OpenCV's octave count for a base image of h x w (already upscaled)."""
    return int(np.rint(math.log(min(h, w)) / math.log(2.0) - 2)) - first_octave


def layer_sigmas() -> list[float]:
    """The incremental blur of each layer of an octave."""
    sig = [SIGMA]
    k = 2.0 ** (1.0 / N_LAYERS)
    for i in range(1, N_LAYERS + 3):
        prev = k ** (i - 1) * SIGMA
        total = prev * k
        sig.append(math.sqrt(total * total - prev * prev))
    return sig


def gaussian_pyramid(gray: torch.Tensor, first_octave: int = -1, octaves: int | None = None) -> list:
    """(H, W) uint8 -> one (N_LAYERS + 3, h, w) float32 tensor an octave."""
    img = gray.to(torch.float32)
    # the base blur's sigma is a float32 in OpenCV
    f = np.float32
    if first_octave < 0:
        sig_diff = float(np.sqrt(max(f(SIGMA) * f(SIGMA) - f(INIT_SIGMA) * f(INIT_SIGMA) * f(4), f(0.01))))
        img = upscale2x(img)
    else:
        sig_diff = float(np.sqrt(max(f(SIGMA) * f(SIGMA) - f(INIT_SIGMA) * f(INIT_SIGMA), f(0.01))))
    base = gaussian_blur(img, sig_diff)
    if octaves is None:
        octaves = n_octaves(base.shape[0], base.shape[1], first_octave)
    sig = layer_sigmas()
    pyr = []
    for o in range(octaves):
        if o == 0:
            layers = [base]
        else:
            prev = pyr[-1][N_LAYERS]
            h, w = prev.shape
            layers = [prev[0:2 * (h // 2):2, 0:2 * (w // 2):2]]
        for i in range(1, N_LAYERS + 3):
            layers.append(gaussian_blur(layers[-1], sig[i]))
        pyr.append(torch.stack(layers))
    return pyr


def _max3(x: torch.Tensor) -> torch.Tensor:
    """Maximum over each 3x3x3 neighbourhood of an (L, h, w) volume (one
    axis at a time; the volume's edges see fewer neighbours)."""
    for dim in range(3):
        n = x.shape[dim]
        m = x.clone()
        if n > 1:
            m.narrow(dim, 1, n - 1).copy_(torch.maximum(m.narrow(dim, 1, n - 1), x.narrow(dim, 0, n - 1)))
            m.narrow(dim, 0, n - 1).copy_(torch.maximum(m.narrow(dim, 0, n - 1), x.narrow(dim, 1, n - 1)))
        x = m
    return x


def _solve3(h, b):
    """Cramer's rule for a batch of 3x3 systems in float32 (OpenCV's 3x3
    Matx solve); a zero determinant gives 0. h: 9 tensors (row major), b: 3."""
    a00, a01, a02, a10, a11, a12, a20, a21, a22 = h
    b0, b1, b2 = b
    det = a00 * (a11 * a22 - a21 * a12) - a01 * (a10 * a22 - a20 * a12) + a02 * (a10 * a21 - a20 * a11)
    ok = det != 0
    d = 1.0 / torch.where(ok, det, torch.ones_like(det))
    x0 = d * (b0 * (a11 * a22 - a12 * a21) - a01 * (b1 * a22 - a12 * b2) + a02 * (b1 * a21 - a11 * b2))
    x1 = d * (a00 * (b1 * a22 - a12 * b2) - b0 * (a10 * a22 - a12 * a20) + a02 * (a10 * b2 - b1 * a20))
    x2 = d * (a00 * (a11 * b2 - b1 * a21) - a01 * (a10 * b2 - b1 * a20) + b0 * (a10 * a21 - a11 * a20))
    zero = torch.zeros_like(det)
    return [torch.where(ok, x, zero) for x in (x0, x1, x2)]


class _Flat(NamedTuple):
    """Volumes of every octave, (L, h, w) each, in one flat tensor, with
    each octave's offset and size: one gather serves all octaves."""
    data: torch.Tensor
    base: torch.Tensor
    h: torch.Tensor
    w: torch.Tensor

    @classmethod
    def of(cls, vols: list) -> "_Flat":
        dev = vols[0].device
        sizes = np.cumsum([0] + [v.numel() for v in vols])[:-1]
        as_t = lambda v: torch.as_tensor(np.asarray(v, np.int64), device=dev)  # noqa: E731
        return cls(torch.cat([v.reshape(-1) for v in vols]), as_t(sizes), as_t([v.shape[1] for v in vols]),
                   as_t([v.shape[2] for v in vols]))

    def index(self, o, layer, r, c):
        """Flat index of (layer, r, c) of octave o, and that octave's h, w."""
        h, w = self.h[o], self.w[o]
        return self.base[o] + (layer * h + r) * w + c, h, w


# the DoG neighbours that refinement reads, (layer, row, column) offsets
_NB = [(0, 0, 0), (0, 0, 1), (0, 0, -1), (0, 1, 0), (0, -1, 0), (1, 0, 0), (-1, 0, 0),
       (0, 1, 1), (0, 1, -1), (0, -1, 1), (0, -1, -1), (1, 0, 1), (1, 0, -1), (-1, 0, 1), (-1, 0, -1),
       (1, 1, 0), (1, -1, 0), (-1, 1, 0), (-1, -1, 0)]


def _derivatives(dog: _Flat, o, layer, r, c):
    """DoG value, gradient and Hessian at (layer, r, c) of octave o, scaled
    as OpenCV scales them; one gather of the 19 neighbours."""
    ci, h, w = dog.index(o, layer, r, c)
    dl, dr, dc = (torch.as_tensor([n[i] for n in _NB], device=ci.device) for i in range(3))
    v = dog.data[ci[:, None] + dl * (h * w)[:, None] + dr * w[:, None] + dc]
    at = lambda *n: v[:, _NB.index(n)]  # noqa: E731
    v0 = at(0, 0, 0)
    v2 = v0 * 2
    g = [(at(0, 0, 1) - at(0, 0, -1)) * DERIV_SCALE,
         (at(0, 1, 0) - at(0, -1, 0)) * DERIV_SCALE,
         (at(1, 0, 0) - at(-1, 0, 0)) * DERIV_SCALE]
    dxx = (at(0, 0, 1) + at(0, 0, -1) - v2) * IMG_SCALE
    dyy = (at(0, 1, 0) + at(0, -1, 0) - v2) * IMG_SCALE
    dss = (at(1, 0, 0) + at(-1, 0, 0) - v2) * IMG_SCALE
    dxy = (at(0, 1, 1) - at(0, 1, -1) - at(0, -1, 1) + at(0, -1, -1)) * CROSS_SCALE
    dxs = (at(1, 0, 1) - at(1, 0, -1) - at(-1, 0, 1) + at(-1, 0, -1)) * CROSS_SCALE
    dys = (at(1, 1, 0) - at(1, -1, 0) - at(-1, 1, 0) + at(-1, -1, 0)) * CROSS_SCALE
    return v0, g, (dxx, dxy, dxs, dxy, dyy, dys, dxs, dys, dss)


def _candidates(dogs: list, dog: _Flat):
    """Extrema of every octave's DoG layers (N_LAYERS + 2, h, w): (octave,
    layer, row, column) of each, octave by octave."""
    threshold = math.floor(0.5 * CONTRAST_TH / N_LAYERS * 255)
    masks = []
    for d in dogs:
        _, h, w = d.shape
        mx, mn = _max3(d), -_max3(-d)
        cand = (d.abs() > threshold) & (((d > 0) & (d == mx)) | ((d < 0) & (d == mn)))
        inner = torch.zeros_like(cand)
        if h > 2 * IMG_BORDER and w > 2 * IMG_BORDER:
            sl = np.s_[1:N_LAYERS + 1, IMG_BORDER:h - IMG_BORDER, IMG_BORDER:w - IMG_BORDER]
            inner[sl] = cand[sl]
        masks.append(inner.reshape(-1))
    idx = torch.cat(masks).nonzero(as_tuple=True)[0]
    o = torch.searchsorted(dog.base, idx, right=True) - 1
    local = idx - dog.base[o]
    h, w = dog.h[o], dog.w[o]
    return o, local // (h * w), local % (h * w) // w, local % w


def _refine(dog: _Flat, o, layer, r, c) -> dict:
    """OpenCV's adjustLocalExtrema for all candidates at once: up to
    MAX_INTERP_STEPS quadratic steps (a candidate moves to the nearest pixel
    and layer of its offset while that exceeds half a pixel), then the
    contrast and edge-ratio tests. Positions stay in their octave's pixels."""
    n = len(o)
    dev = dog.data.device
    h, w = dog.h[o], dog.w[o]
    active = torch.ones(n, dtype=torch.bool, device=dev)
    done = torch.zeros(n, dtype=torch.bool, device=dev)
    xi = xr = xc = torch.zeros(n, device=dev)
    lim = float(np.float32(2 ** 31 - 1) // 3)
    for _ in range(MAX_INTERP_STEPS):
        _, g, hes = _derivatives(dog, o, layer, r, c)
        x0, x1, x2 = _solve3(hes, g)
        sc, sr, si = -x0, -x1, -x2
        conv = active & (si.abs() < 0.5) & (sr.abs() < 0.5) & (sc.abs() < 0.5)
        xi, xr, xc = (torch.where(conv, a, b) for a, b in ((si, xi), (sr, xr), (sc, xc)))
        done |= conv
        active &= ~conv & (si.abs() <= lim) & (sr.abs() <= lim) & (sc.abs() <= lim)
        step = lambda v: torch.where(active, v.round().to(torch.int64), torch.zeros_like(layer))  # noqa: E731
        c, r, layer = c + step(sc), r + step(sr), layer + step(si)
        inside = ((layer >= 1) & (layer <= N_LAYERS) & (c >= IMG_BORDER) & (c < w - IMG_BORDER)
                  & (r >= IMG_BORDER) & (r < h - IMG_BORDER))
        active &= inside
        # dropped candidates keep gathering in range until the loop ends
        layer = torch.where(inside, layer, torch.ones_like(layer))
        r = torch.where(inside, r, torch.full_like(r, IMG_BORDER))
        c = torch.where(inside, c, torch.full_like(c, IMG_BORDER))
    v, g, hes = _derivatives(dog, o, layer, r, c)
    contr = v * IMG_SCALE + (g[0] * xc + g[1] * xr + g[2] * xi) * 0.5
    dxx, dxy, dyy = hes[0], hes[1], hes[4]
    tr = dxx + dyy
    det = dxx * dyy - dxy * dxy
    keep = (done & (contr.abs() * N_LAYERS >= CONTRAST_TH) & (det > 0)
            & (tr * tr * EDGE_TH < (EDGE_TH + 1) ** 2 * det)).nonzero(as_tuple=True)[0]
    kp = {"o": o, "layer": layer, "r": r, "c": c, "xi": xi, "xr": xr, "xc": xc, "response": contr.abs()}
    kp = {k: v[keep] for k, v in kp.items()}
    # two extrema refined to one point are one keypoint
    first = _first_of_each(dog.index(kp["o"], kp["layer"], kp["r"], kp["c"])[0])
    kp = {k: v[first] for k, v in kp.items()}
    scale = _pow2(kp["o"])
    kp["size"] = SIGMA * torch.pow(2.0, (kp["layer"].to(torch.float32) + kp["xi"]) / N_LAYERS) * scale * 2
    return kp


def _pow2(o: torch.Tensor) -> torch.Tensor:
    """2**o as float32, exact (octave scales)."""
    return (2 ** o).to(torch.float32)


def _first_of_each(key: torch.Tensor) -> torch.Tensor:
    """The index of the first occurrence of each distinct key (row)."""
    _, inv = torch.unique(key, dim=0, return_inverse=True)
    first = torch.full((int(inv.max()) + 1 if len(inv) else 0,), len(key), dtype=torch.int64, device=key.device)
    first.scatter_reduce_(0, inv, torch.arange(len(key), device=key.device), "amin")
    return first


def _window(radius: int, device):
    i = torch.arange(-radius, radius + 1, device=device)
    return i.repeat_interleave(2 * radius + 1), i.repeat(2 * radius + 1)


def _gradients(gauss: _Flat, o, layer, y, x):
    """dx, dy of Gaussian layers at integer points (K, S) of keypoints in
    octaves o (dy points up, as OpenCV's); points are clamped inside, the
    caller masks those outside."""
    base, h, w = (t[:, None] for t in gauss.index(o, layer, 0, 0))
    yc, xc = torch.minimum(y.clamp(min=1), h - 2), torch.minimum(x.clamp(min=1), w - 2)
    at = base + yc * w + xc
    dx = gauss.data[at + 1] - gauss.data[at - 1]
    dy = gauss.data[at - w] - gauss.data[at + w]
    return dx, dy, (y > 0) & (y < h - 1) & (x > 0) & (x < w - 1)


def _orientations(gauss: _Flat, o, layer, r, c, scl_octv):
    """The smoothed 36-bin orientation histograms (K, 36) of keypoints at
    integer (r, c) of Gaussian layers."""
    dev = gauss.data.device
    radius = (scl_octv * ORI_RADIUS).round().to(torch.int64)
    sigma = scl_octv * ORI_SIG_FCTR
    expf_scale = -1.0 / (2.0 * sigma * sigma)
    di, dj = _window(int(radius.max()), dev)
    dx, dy, ok = _gradients(gauss, o, layer, r[:, None] + di, c[:, None] + dj)
    ok &= (di.abs() <= radius[:, None]) & (dj.abs() <= radius[:, None])
    wgt = torch.exp((di * di + dj * dj).to(torch.float32) * expf_scale[:, None])
    ori = fast_atan2(dy, dx)
    mag = torch.sqrt(dx * dx + dy * dy)
    b = (ori * (ORI_BINS / 360.0)).round().to(torch.int64)
    b = torch.where(b >= ORI_BINS, b - ORI_BINS, b)
    b = torch.where(b < 0, b + ORI_BINS, b)
    val = torch.where(ok, wgt * mag, torch.zeros_like(mag))
    k = len(r)
    hist = torch.zeros(k * ORI_BINS, device=dev)
    hist.index_add_(0, (torch.arange(k, device=dev)[:, None] * ORI_BINS + b).reshape(-1), val.reshape(-1))
    t = hist.view(k, ORI_BINS)
    roll = lambda s: torch.roll(t, s, dims=1)  # noqa: E731  roll(s)[i] = t[i - s]
    return (roll(2) + roll(-2)) * (1.0 / 16.0) + (roll(1) + roll(-1)) * (4.0 / 16.0) + t * (6.0 / 16.0)


def _peaks(hist: torch.Tensor):
    """Every peak of the smoothed histograms at 0.8 of the maximum or more:
    (keypoint index, angle in degrees)."""
    n = ORI_BINS
    left, right = torch.roll(hist, 1, dims=1), torch.roll(hist, -1, dims=1)
    omax = hist.max(dim=1, keepdim=True).values
    is_peak = (hist > left) & (hist > right) & (hist >= omax * ORI_PEAK_RATIO)
    kidx, j = is_peak.nonzero(as_tuple=True)
    hl, hc, hr = left[kidx, j], hist[kidx, j], right[kidx, j]
    bin_ = j.to(torch.float32) + 0.5 * (hl - hr) / (hl - 2 * hc + hr)
    bin_ = torch.where(bin_ < 0, n + bin_, torch.where(bin_ >= n, bin_ - n, bin_))
    angle = 360.0 - (360.0 / n) * bin_
    angle = torch.where((angle - 360.0).abs() < FLT_EPSILON, torch.zeros_like(angle), angle)
    return kidx, angle


def _descriptors(gauss: _Flat, o, layer, ptx, pty, angle, scl) -> torch.Tensor:
    """OpenCV's calcSIFTDescriptor: (K, 128) float32 holding integers 0-255.
    ptx, pty: the keypoints in their octave's pixels; angle: OpenCV's
    keypoint angle; scl: half the size in the octave's pixels."""
    d, n = DESCR_WIDTH, DESCR_BINS
    dev = gauss.data.device
    k = len(ptx)
    h, w = gauss.h[o], gauss.w[o]
    ori = 360.0 - angle
    ori = torch.where((ori - 360.0).abs() < FLT_EPSILON, torch.zeros_like(ori), ori)
    px, py = ptx.round().to(torch.int64), pty.round().to(torch.int64)
    rad = ori * float(np.float32(math.pi / 180))
    hist_width = scl * DESCR_SCL_FCTR
    cos_t, sin_t = torch.cos(rad) / hist_width, torch.sin(rad) / hist_width
    radius = (hist_width * 1.4142135623730951 * (d + 1) * 0.5).round().to(torch.int64)
    radius = torch.minimum(radius, torch.sqrt((w * w + h * h).to(torch.float64)).to(torch.int64))
    di, dj = _window(int(radius.max()), dev)
    di_f, dj_f = di.to(torch.float32), dj.to(torch.float32)
    c_rot = dj_f * cos_t[:, None] - di_f * sin_t[:, None]
    r_rot = dj_f * sin_t[:, None] + di_f * cos_t[:, None]
    rbin = r_rot + d // 2 - 0.5
    cbin = c_rot + d // 2 - 0.5
    dx, dy, ok = _gradients(gauss, o, layer, py[:, None] + di, px[:, None] + dj)
    ok &= ((di.abs() <= radius[:, None]) & (dj.abs() <= radius[:, None])
           & (rbin > -1) & (rbin < d) & (cbin > -1) & (cbin < d))
    wgt = torch.exp((c_rot * c_rot + r_rot * r_rot) * (-1.0 / (d * d * 0.5)))
    obin = (fast_atan2(dy, dx) - ori[:, None]) * (n / 360.0)
    mag = torch.where(ok, torch.sqrt(dx * dx + dy * dy) * wgt, torch.zeros_like(wgt))
    r0, c0, o0 = rbin.floor(), cbin.floor(), obin.floor()
    fr, fc, fo = rbin - r0, cbin - c0, obin - o0
    zero = torch.zeros_like(di)
    r0 = torch.where(ok, r0.to(torch.int64), zero)
    c0 = torch.where(ok, c0.to(torch.int64), zero)
    o0 = o0.to(torch.int64)
    o0 = torch.where(ok, torch.where(o0 < 0, o0 + n, torch.where(o0 >= n, o0 - n, o0)), zero)
    v_r1 = mag * fr
    v_r0 = mag - v_r1
    v_rc11 = v_r1 * fc
    v_rc10 = v_r1 - v_rc11
    v_rc01 = v_r0 * fc
    v_rc00 = v_r0 - v_rc01
    hl = (d + 2) * (d + 2) * (n + 2)
    cell = torch.arange(k, device=dev)[:, None] * hl + ((r0 + 1) * (d + 2) + c0 + 1) * (n + 2) + o0
    idx, vals = [], []
    for v_rc, off in ((v_rc00, 0), (v_rc01, n + 2), (v_rc10, (d + 2) * (n + 2)), (v_rc11, (d + 3) * (n + 2))):
        v1 = v_rc * fo
        idx += [cell + off, cell + off + 1]
        vals += [v_rc - v1, v1]
    hist = torch.zeros(k * hl, device=dev)
    hist.index_add_(0, torch.cat(idx).reshape(-1), torch.cat(vals).reshape(-1))
    hist = hist.view(k, d + 2, d + 2, n + 2)[:, 1:d + 1, 1:d + 1]
    desc = hist[..., :n].clone()
    desc[..., 0] += hist[..., n]
    desc[..., 1] += hist[..., n + 1]
    desc = desc.reshape(k, d * d * n)
    thr = torch.sqrt((desc * desc).sum(1, keepdim=True)) * DESCR_MAG_THR
    desc = torch.minimum(desc, thr)
    nrm = INT_DESCR_FCTR / torch.sqrt((desc * desc).sum(1, keepdim=True)).clamp(min=FLT_EPSILON)
    return (desc * nrm).round().clamp(0, 255)


def _chunked(fn, gauss: _Flat, *args) -> torch.Tensor:
    """fn(gauss, ...) over slices of CHUNK keypoints of the (K, ...)
    arguments, taken in the order of their last argument (the scale), so a
    chunk's windows are of similar size; rows in the arguments' order."""
    order = torch.argsort(args[-1])
    out = torch.cat([fn(gauss, *(a[order[i:i + CHUNK]] for a in args)) for i in range(0, len(order), CHUNK)])
    return out[torch.argsort(order)]


def detect_and_compute(gray: torch.Tensor, mask: torch.Tensor | None = None, nfeatures: int = 0):
    """SIFT keypoints and descriptors of an (H, W) uint8 image, as OpenCV's
    `SIFT_create(nfeatures).detectAndCompute(gray, mask)`. Returns
    (Keypoints of numpy arrays, (N, 128) float32 tensor on the image's
    device), strongest first."""
    pyr = gaussian_pyramid(gray)
    dogs = [g[1:] - g[:-1] for g in pyr]
    dog, gauss = _Flat.of(dogs), _Flat.of(pyr)
    kp = _refine(dog, *_candidates(dogs, dog))
    if nfeatures > 0 and len(kp["o"]) > nfeatures:
        # a keypoint weaker than the nfeatures-th extremum cannot be kept:
        # more orientations only add keypoints of the same responses
        keep = kp["response"] >= torch.topk(kp["response"], nfeatures).values[-1]
        kp = {k: v[keep] for k, v in kp.items()}
    if not len(kp["o"]):
        return _empty(gray.device)
    scl_octv = kp["size"] * 0.5 / _pow2(kp["o"])
    kidx, angle = _peaks(_chunked(_orientations, gauss, kp["o"], kp["layer"], kp["r"], kp["c"], scl_octv))
    kp = {k: v[kidx] for k, v in kp.items()}
    scale = _pow2(kp["o"])
    ptx = (kp["c"].to(torch.float32) + kp["xc"]) * scale
    pty = (kp["r"].to(torch.float32) + kp["xr"]) * scale
    # exact duplicates (one point, size and angle) are one keypoint
    keep = _first_of_each(torch.stack([ptx, pty, kp["size"], angle], 1))
    if nfeatures > 0 and len(keep) > nfeatures:
        resp = kp["response"][keep]
        keep = keep[resp >= torch.topk(resp, nfeatures).values[-1]]
    # strongest first; ties in the order of position, size and angle
    keep = keep[_stable_order(kp["response"][keep], ptx[keep], pty[keep], kp["size"][keep], angle[keep])]
    # octave -1: back to the input image's pixels
    ptx, pty, size, angle = ptx[keep] * 0.5, pty[keep] * 0.5, kp["size"][keep] * 0.5, angle[keep]
    kp = {k: v[keep] for k, v in kp.items()}
    if mask is not None:
        h, w = mask.shape
        inside = mask.reshape(-1)[(pty + 0.5).to(torch.int64).clamp(0, h - 1) * w
                                  + (ptx + 0.5).to(torch.int64).clamp(0, w - 1)] != 0
        sel = inside.nonzero(as_tuple=True)[0]
        ptx, pty, size, angle = ptx[sel], pty[sel], size[sel], angle[sel]
        kp = {k: v[sel] for k, v in kp.items()}
    if not len(ptx):
        return _empty(gray.device)
    packed = ((kp["o"] - 1) & 255 | (kp["layer"] << 8)
              | (((kp["xi"] + 0.5) * 255).round().to(torch.int64) << 16))
    desc = _chunked(_descriptors, gauss, kp["o"], kp["layer"], kp["c"].to(torch.float32) + kp["xc"],
                    kp["r"].to(torch.float32) + kp["xr"], angle,
                    size * 2.0 / _pow2(kp["o"]) * 0.5)
    kps = Keypoints(pt=torch.stack([ptx, pty], 1).cpu().numpy(), size=size.cpu().numpy(),
                    angle=angle.cpu().numpy(), response=kp["response"].cpu().numpy(),
                    octave=packed.to(torch.int32).cpu().numpy())
    return kps, desc


def _empty(device):
    z = np.zeros(0, np.float32)
    return (Keypoints(pt=np.zeros((0, 2), np.float32), size=z, angle=z, response=z,
                      octave=np.zeros(0, np.int32)), torch.zeros((0, 128), device=device))


def _stable_order(response, x, y, size, angle) -> torch.Tensor:
    """Indices by response (descending), then x, y, size (descending) and
    angle: OpenCV's keypoint order breaks the ties."""
    order = torch.arange(len(response), device=response.device)
    for v, desc in ((angle, False), (size, True), (y, False), (x, False), (response, True)):
        order = order[torch.sort(v[order], descending=desc, stable=True).indices]
    return order


def unpack_octave(octave: np.ndarray):
    """OpenCV's packed keypoint octave -> (octave, layer): octave -1 is the
    upscaled image."""
    octave = np.asarray(octave, np.int64)
    o = octave & 255
    return np.where(o < 128, o, o - 256), (octave >> 8) & 255


def describe(gray: torch.Tensor, keypoints: Keypoints) -> torch.Tensor:
    """Descriptors of an (H, W) uint8 image at given keypoints (OpenCV's
    `compute`): (N, 128) float32 on the image's device."""
    octv, layer = unpack_octave(keypoints.octave)
    if not len(octv):
        return torch.zeros((0, 128), device=gray.device)
    first = min(int(octv.min()), 0)
    pyr = gaussian_pyramid(gray, first_octave=first, octaves=int(octv.max()) - first + 1)
    dev = gray.device
    scale = torch.as_tensor(np.ldexp(1.0, -octv).astype(np.float32), device=dev)
    t = lambda a, dt=torch.float32: torch.as_tensor(np.asarray(a), dtype=dt, device=dev)  # noqa: E731
    pt = t(keypoints.pt)
    return _chunked(_descriptors, _Flat.of(pyr), t(octv - first, torch.int64), t(layer, torch.int64),
                    pt[:, 0] * scale, pt[:, 1] * scale, t(keypoints.angle), t(keypoints.size) * scale * 0.5)
