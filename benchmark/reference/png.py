"""A small PNG codec on the standard library's zlib and numpy.

The port reads and writes the BOP dataset's PNGs (8-bit RGB / RGBA / gray
frames and masks, 16-bit gray depth) without cv2, imageio or PIL. Reading
takes colour types 0 (gray), 2 (RGB), 4 (gray + alpha) and 6 (RGBA) at bit
depth 8 or 16, non-interlaced, with any of the five row filters. Writing
emits filter 0 (none) rows, one IDAT chunk. Pixels come back as numpy arrays
shaped like imageio's: (H, W) for gray, (H, W, C) otherwise, uint8 or
big-endian-decoded uint16.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _unfilter(raw: np.ndarray, h: int, w: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters. raw (h, 1 + w * bpp) uint8 -> (h, w, bpp).

    Filters 0-2 need only the row above and a running sum along the row, so
    such images decode row by row. Filters 3 (average) and 4 (Paeth) make
    pixel (y, x) depend on (y, x-1), (y-1, x) and (y-1, x-1); those images
    decode along anti-diagonals, every pixel of one diagonal at once."""
    ftype = raw[:, 0].astype(np.int32)
    if ftype.max(initial=0) > 4:
        raise ValueError(f"PNG: unknown row filter {ftype.max()}")
    fx = raw[:, 1:].reshape(h, w, bpp).astype(np.int32)
    if ftype.max(initial=0) <= 2:
        out = np.zeros((h, w, bpp), np.int32)
        prev = np.zeros((w, bpp), np.int32)
        for y in range(h):
            if ftype[y] == 1:
                cur = np.cumsum(fx[y], axis=0) & 0xFF
            elif ftype[y] == 2:
                cur = (fx[y] + prev) & 0xFF
            else:
                cur = fx[y]
            out[y] = prev = cur
        return out.astype(np.uint8)
    # out[y + 1, x + 1] holds pixel (y, x); row 0 and column 0 are the zero border
    out = np.zeros((h + 1, w + 1, bpp), np.int32)
    for d in range(h + w - 1):
        ys = np.arange(max(0, d - w + 1), min(h - 1, d) + 1)
        xs = d - ys
        a, b, c = out[ys + 1, xs], out[ys, xs + 1], out[ys, xs]
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        ft = ftype[ys][:, None]
        pred = np.select([ft == 1, ft == 2, ft == 3, ft == 4], [a, b, (a + b) >> 1, paeth], 0)
        out[ys + 1, xs + 1] = (fx[ys, xs] + pred) & 0xFF
    return out[1:, 1:].astype(np.uint8)


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, header = len(_SIGNATURE), [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = header
    if ctype not in _CHANNELS or depth not in (8, 16) or interlace:
        raise ValueError(f"{path}: PNG colour type {ctype}, depth {depth}, interlace "
                         f"{interlace} is not supported")
    ch = _CHANNELS[ctype]
    bpp = ch * depth // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, 1 + w * bpp)
    px = _unfilter(raw, h, w, bpp)
    if depth == 16:
        px = px.reshape(h, w * ch, 2)
        px = (px[..., 0].astype(np.uint16) << 8) | px[..., 1]
    px = px.reshape(h, w, ch)
    return px[..., 0] if ch == 1 else px


def write_png(path: str, img: np.ndarray, level: int = 6) -> None:
    """img (H, W) or (H, W, 1 | 3 | 4), uint8 or uint16 (uint16 gray only)."""
    img = np.asarray(img)
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    h, w = img.shape[:2]
    ch = 1 if img.ndim == 2 else img.shape[2]
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[ch]
    if img.dtype == np.uint8:
        depth, rows = 8, img.reshape(h, w * ch)
    elif img.dtype == np.uint16:
        depth, rows = 16, img.astype(">u2").reshape(h, w * ch).view(np.uint8)
    else:
        raise TypeError(f"write_png takes uint8 or uint16, got {img.dtype}")
    rows = np.concatenate([np.zeros((h, 1), np.uint8), rows], 1)
    png = (_SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, 0))
           + _chunk(b"IDAT", zlib.compress(rows.tobytes(), level)) + _chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(png)
