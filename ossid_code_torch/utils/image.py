"""Host-side image preprocessing (numpy; the port's copy of
ossid_code_tpu/utils/image.py, with cv2's resizes written in numpy).

Reimplements the behavior of the reference's `processData` (ref
utils/data.py:7-115) and image normalization (utils/__init__.py:52-61),
producing HWC float32 arrays.
"""

from __future__ import annotations

import numpy as np

from ossid_code_torch.utils.geometry import depth2xyz

def _linear_taps(n_src: int, n_dst: int):
    """cv2 INTER_LINEAR's source taps along one axis: half-pixel centres,
    the coordinate clamped at 0 and the upper tap at the last pixel."""
    x = (np.arange(n_dst, dtype=np.float64) + 0.5) * (n_src / n_dst) - 0.5
    x = np.maximum(x, 0.0)
    x0 = np.floor(x).astype(np.int64)
    frac = x - x0
    x0 = np.minimum(x0, n_src - 1)
    return x0, np.minimum(x0 + 1, n_src - 1), frac


def resize_linear(a: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """cv2.resize(a, (w, h)) with INTER_LINEAR (half-pixel centres). Float
    input is interpolated in float64 and returned in its dtype; uint8 input
    is rounded to nearest, where cv2's 11-bit fixed-point weights may differ
    by 1 LSB."""
    w, h = size
    x0, x1, fx = _linear_taps(a.shape[1], w)
    y0, y1, fy = _linear_taps(a.shape[0], h)
    af = a.astype(np.float64)
    ex = (slice(None),) + (None,) * (a.ndim - 1)
    rows = af[y0] * (1.0 - fy)[ex] + af[y1] * fy[ex]
    ex = (None, slice(None)) + (None,) * (a.ndim - 2)
    out = rows[:, x0] * (1.0 - fx)[ex] + rows[:, x1] * fx[ex]
    if a.dtype == np.uint8:
        return np.clip(np.floor(out + 0.5), 0, 255).astype(np.uint8)
    return out.astype(a.dtype)


def resize_nearest(a: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """cv2.resize(a, (w, h), interpolation=cv2.INTER_NEAREST): source index
    floor(dst * src / dst_size), not centre-based, clamped to the last pixel."""
    w, h = size
    ys = np.minimum(np.floor(np.arange(h) * (a.shape[0] / h)).astype(np.int64), a.shape[0] - 1)
    xs = np.minimum(np.floor(np.arange(w) * (a.shape[1] / w)).astype(np.int64), a.shape[1] - 1)
    return a[ys][:, xs]


def normalize_image(img: np.ndarray) -> np.ndarray:
    """uint8 (H, W, 3) -> float32 [0, 1] (ref utils/__init__.py:52-61)."""
    return img.astype(np.float32) / 255.0


IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], dtype=np.float32)


def normalize_image_range(img: np.ndarray) -> np.ndarray:
    """[0,1] float RGB (..., 3 last axis) -> ImageNet-normalized
    (ref utils/__init__.py:33-39; applied channel-last here)."""
    return (img - IMAGENET_MEAN) / IMAGENET_STD


def denormalize_image_range(img: np.ndarray) -> np.ndarray:
    """The inverse of normalize_image_range."""
    return img * IMAGENET_STD + IMAGENET_MEAN


def process_data(
    img: np.ndarray,
    mask: np.ndarray,
    depth: np.ndarray,
    cam_K: np.ndarray,
    crop: bool = False,
    zoom_factor: float = 2.0,
    crop_shift: bool = False,
    keep_aspect_ratio: bool = False,
    shorter_length: int = 224,
    rng: np.random.Generator | None = None,
    compute_xyz: bool = True,
) -> dict:
    """Resize + normalize one RGB-D frame for the detector.

    img: (H, W, 3) uint8; mask: (H, W) in [0, 1]; depth: (H, W) float (meters);
    cam_K: (3, 3).

    Returns dict with 'img' (H', W', 3) float32 in [0,1], 'mask' (H', W', 1),
    'xyz' (H', W', 3), 'cam_K' rescaled. With keep_aspect_ratio, output dims are
    the 8-aligned rescale of the original (ref utils/data.py:38-48); otherwise a
    square (shorter_length, shorter_length).
    """
    assert img.dtype == np.uint8 and img.ndim == 3 and img.shape[2] == 3
    assert mask.ndim == 2 and depth.ndim == 2
    assert float(mask.max(initial=0.0)) <= 1.0 and float(mask.min(initial=0.0)) >= 0.0

    H_ori, W_ori, _ = img.shape
    # the dense XYZ map costs ~15ms/frame on host and is unused by the
    # detection path; build it only when asked
    xyz = depth2xyz(depth, cam_K) if (compute_xyz or crop) else None

    if crop:
        img, mask, xyz = crop_around_mask(img, mask, xyz, zoom_factor, shift=crop_shift, rng=rng)

    if keep_aspect_ratio:
        scale = float(shorter_length) / min(H_ori, W_ori)
        H_resize = int(round(H_ori * scale // 8) * 8)
        W_resize = int(round(W_ori * scale // 8) * 8)
    else:
        H_resize = W_resize = int(shorter_length)

    if (H_resize, W_resize) != (img.shape[0], img.shape[1]):
        img = resize_linear(img, (W_resize, H_resize))
        mask = resize_linear(mask.astype(np.float32), (W_resize, H_resize))
        if xyz is not None:
            xyz = resize_linear(xyz, (W_resize, H_resize))

    cam_K = cam_K.copy()
    cam_K[1] *= float(H_resize) / H_ori
    cam_K[0] *= float(W_resize) / W_ori

    return {
        "img": normalize_image(img),
        "mask": np.asarray(mask, np.float32)[..., None],
        "xyz": None if xyz is None else xyz.astype(np.float32),
        "cam_K": cam_K.astype(np.float32),
    }


def crop_around_mask(
    img_in: np.ndarray,
    mask_in: np.ndarray,
    xyz_in: np.ndarray,
    zoom_factor: float = 1.0,
    shift: bool = False,
    rng: np.random.Generator | None = None,
):
    """Square crop around the mask's bounding box, optionally with a random
    shift, padding the frame first so the crop never leaves the image
    (ref utils/data.py:85-115)."""
    rng = rng or np.random.default_rng()
    h, w = img_in.shape[:2]
    img = np.pad(img_in, ((h, h), (w, w), (0, 0)), mode="constant", constant_values=img_in.min())
    mask = np.pad(mask_in, ((h, h), (w, w)), mode="constant")
    xyz = np.pad(xyz_in, ((h, h), (w, w), (0, 0)), mode="constant")

    ys, xs = mask.nonzero()
    if ys.size == 0:
        return img_in, mask_in, xyz_in
    min_y, max_y = ys.min(), ys.max()
    min_x, max_x = xs.min(), xs.max()
    cy, cx = (min_y + max_y) // 2, (min_x + max_x) // 2
    r = int(zoom_factor * (max(max_y - min_y, max_x - min_x) // 2))
    r = max(r, 1)

    if shift:
        cy = int(np.clip(cy + int(rng.random() * r - r / 2.0), 1.2 * h, 1.8 * h))
        cx = int(np.clip(cx + int(rng.random() * r - r / 2.0), 1.2 * w, 1.8 * w))

    return (
        img[cy - r : cy + r, cx - r : cx + r],
        mask[cy - r : cy + r, cx - r : cx + r],
        xyz[cy - r : cy + r, cx - r : cx + r],
    )
