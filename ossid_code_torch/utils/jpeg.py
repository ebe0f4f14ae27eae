"""Baseline JPEG read and write in numpy (the port's own: the card's machine
has no cv2, imageio or PIL, and FSS-1000 ships its images as .jpg).

`read_jpeg` decodes baseline sequential Huffman-coded files with 8-bit
samples (SOF0, or SOF1 with 8-bit samples), one component (grey) or three
(YCbCr), sampled 4:4:4, 4:2:2 or 4:2:0, in one
interleaved scan or one scan a component, with restart markers. It decodes
as libjpeg does by default, so its output can equal cv2.imread's and
imageio's: the integer "islow" IDCT (jidctint.c) with its output range
table, "fancy" upsampling of the chroma (triangle filters with edge
replication, jdsample.c) and the YCbCr table of jdcolor.c. Progressive,
lossless, hierarchical and arithmetic-coded files, 12-bit samples, RGB-coded
files (an Adobe marker's transform 0) and other samplings raise ValueError
naming the file; it does not guess.

`write_jpeg` encodes baseline files with the standard tables of ITU T.81
Annex K (quantisation scaled by the IJG quality rule, the typical Huffman
tables), 4:4:4 or 4:2:0; it writes test data and synthetic worlds where cv2
is absent.
"""

from __future__ import annotations

import struct

import numpy as np

# zigzag position k -> natural (row-major) index in the 8x8 block
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])

_SOF_UNSUPPORTED = {0xC2: "progressive", 0xC3: "lossless", 0xC5: "hierarchical", 0xC6: "hierarchical",
                    0xC7: "hierarchical", 0xC9: "arithmetic-coded", 0xCA: "arithmetic-coded progressive",
                    0xCB: "arithmetic-coded lossless", 0xCD: "arithmetic-coded hierarchical",
                    0xCE: "arithmetic-coded hierarchical", 0xCF: "arithmetic-coded hierarchical"}


class _Huffman:
    """A 16-bit lookahead table: the next 16 bits -> (symbol, code length)."""

    def __init__(self, counts, symbols):
        sym = np.zeros(1 << 16, np.int64)
        size = np.zeros(1 << 16, np.int64)
        code, k = 0, 0
        for length in range(1, 17):
            for _ in range(counts[length - 1]):
                lo = code << (16 - length)
                hi = (code + 1) << (16 - length)
                sym[lo:hi], size[lo:hi] = symbols[k], length
                code += 1
                k += 1
            code <<= 1
        self.sym, self.size = sym.tolist(), size.tolist()


def _decode_blocks(data: bytes, blocks, dc_tables, ac_tables, coef, path):
    """Entropy-decode one restart interval: `blocks` is the list of
    (component, block index) in stream order; coefficients go to
    coef[component][block index] in natural order (not dequantised)."""
    buf = data + b"\x00" * 8  # past the data, libjpeg reads zeros
    nbits = 8 * len(data)
    pred = {}
    p = 0
    zz = ZIGZAG.tolist()
    frm = int.from_bytes
    for comp, bi in blocks:
        dc, ac = dc_tables[comp], ac_tables[comp]
        out = coef[comp][bi]
        w = frm(buf[p >> 3:(p >> 3) + 4], "big") << (p & 7)
        look = (w >> 16) & 0xFFFF
        n = dc.size[look]
        if n == 0:
            raise ValueError(f"{path}: corrupt JPEG data (bad Huffman code)")
        s = dc.sym[look]
        p += n
        diff = 0
        if s:
            v = (frm(buf[p >> 3:(p >> 3) + 4], "big") >> (32 - s - (p & 7))) & ((1 << s) - 1)
            p += s
            diff = v if v >> (s - 1) else v - (1 << s) + 1
        pred[comp] = pred.get(comp, 0) + diff
        out[0] = pred[comp]
        k = 1
        while k < 64:
            look = ((frm(buf[p >> 3:(p >> 3) + 4], "big") << (p & 7)) >> 16) & 0xFFFF
            n = ac.size[look]
            if n == 0:
                raise ValueError(f"{path}: corrupt JPEG data (bad Huffman code)")
            rs = ac.sym[look]
            p += n
            r, s = rs >> 4, rs & 15
            if s:
                k += r
                if k > 63:
                    raise ValueError(f"{path}: corrupt JPEG data (coefficient index past 63)")
                v = (frm(buf[p >> 3:(p >> 3) + 4], "big") >> (32 - s - (p & 7))) & ((1 << s) - 1)
                p += s
                out[zz[k]] = v if v >> (s - 1) else v - (1 << s) + 1
                k += 1
            elif r == 15:
                k += 16
            else:
                break
        if p > nbits + 64:
            raise ValueError(f"{path}: corrupt JPEG data (the scan ends early)")


# jidctint.c, CONST_BITS 13, PASS1_BITS 2
_FIX = dict(f0298=2446, f0390=3196, f0541=4433, f0765=6270, f0899=7373, f1175=9633, f1501=12299,
            f1847=15137, f1961=16069, f2053=16819, f2562=20995, f3072=25172)


def _idct_1d(x, shift: int):
    """One pass of jpeg_idct_islow over axis 1 of x (N, 8, M) int64:
    returns the 8 outputs descaled by `shift` bits, rounding to nearest."""
    f = _FIX
    z2, z3 = x[:, 2], x[:, 6]
    z1 = (z2 + z3) * f["f0541"]
    tmp2 = z1 + z3 * -f["f1847"]
    tmp3 = z1 + z2 * f["f0765"]
    tmp0 = (x[:, 0] + x[:, 4]) << 13
    tmp1 = (x[:, 0] - x[:, 4]) << 13
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = x[:, 7], x[:, 5], x[:, 3], x[:, 1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * f["f1175"]
    t0, t1, t2, t3 = t0 * f["f0298"], t1 * f["f2053"], t2 * f["f3072"], t3 * f["f1501"]
    z1, z2 = z1 * -f["f0899"], z2 * -f["f2562"]
    z3, z4 = z3 * -f["f1961"] + z5, z4 * -f["f0390"] + z5
    t0 = t0 + z1 + z3
    t1 = t1 + z2 + z4
    t2 = t2 + z2 + z3
    t3 = t3 + z1 + z4
    out = np.stack([tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
                    tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3], axis=1)
    return (out + (1 << (shift - 1))) >> shift


def _range_limit() -> np.ndarray:
    """libjpeg's post-IDCT range table (jdmaster.c), indexed by x & 1023:
    x + 128 clamped to [0, 255] for |x| < 512, as its wrap-around gives."""
    x = np.arange(1024)
    x = np.where(x >= 512, x - 1024, x)
    return np.clip(x + 128, 0, 255).astype(np.uint8)


_RANGE = _range_limit()


def idct_islow(coef: np.ndarray, qt: np.ndarray) -> np.ndarray:
    """(N, 64) natural-order coefficients, (64,) natural-order quantiser ->
    (N, 8, 8) uint8 samples, as libjpeg's jpeg_idct_islow."""
    x = (coef.astype(np.int64) * qt.astype(np.int64)).reshape(-1, 8, 8)
    ws = _idct_1d(x, 13 - 2)                                   # columns: (N, 8 rows, 8 cols)
    out = _idct_1d(ws.transpose(0, 2, 1), 13 + 2 + 3)          # rows: (N, 8 cols, 8 rows)
    return _RANGE[out.transpose(0, 2, 1) & 1023]


def _fancy_h2(plane: np.ndarray) -> np.ndarray:
    """h2v1_fancy_upsample: (H, w) int -> (H, 2w) with the 3/4-1/4 filter;
    as libjpeg, pixel duplication where w <= 2."""
    h, w = plane.shape
    if w <= 2:
        return plane.repeat(2, axis=1)
    out = np.empty((h, 2 * w), np.int64)
    left = np.concatenate([plane[:, :1], plane[:, :-1]], 1)
    right = np.concatenate([plane[:, 1:], plane[:, -1:]], 1)
    out[:, 0::2] = (plane * 3 + left + 1) >> 2
    out[:, 1::2] = (plane * 3 + right + 2) >> 2
    out[:, 0], out[:, -1] = plane[:, 0], plane[:, -1]
    return out


def _fancy_h2v2(plane: np.ndarray) -> np.ndarray:
    """h2v2_fancy_upsample: (h, w) int -> (2h, 2w), the rows above and below
    the plane its first and last rows repeated; as libjpeg, pixel
    duplication where w <= 2."""
    h, w = plane.shape
    if w <= 2:
        return plane.repeat(2, axis=0).repeat(2, axis=1)
    above = np.concatenate([plane[:1], plane[:-1]], 0)
    below = np.concatenate([plane[1:], plane[-1:]], 0)
    out = np.empty((2 * h, 2 * w), np.int64)
    for v, near in ((0, above), (1, below)):
        col = plane * 3 + near  # column sums
        last = np.concatenate([col[:, :1], col[:, :-1]], 1)
        nxt = np.concatenate([col[:, 1:], col[:, -1:]], 1)
        rows = out[v::2]
        rows[:, 0::2] = (col * 3 + last + 8) >> 4
        rows[:, 1::2] = (col * 3 + nxt + 7) >> 4
        rows[:, 0] = (col[:, 0] * 4 + 8) >> 4
        rows[:, -1] = (col[:, -1] * 4 + 7) >> 4
    return out


def _ycc_to_rgb(y, cb, cr) -> np.ndarray:
    """jdcolor.c's ycc_rgb_convert with its tables (SCALEBITS 16)."""
    one_half = 1 << 15
    fix = lambda v: int(v * 65536 + 0.5)  # noqa: E731
    cbx, crx = cb - 128, cr - 128
    r = y + ((fix(1.40200) * crx + one_half) >> 16)
    g = y + ((-fix(0.34414) * cbx + one_half + -fix(0.71414) * crx) >> 16)
    b = y + ((fix(1.77200) * cbx + one_half) >> 16)
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


def read_jpeg(path: str) -> np.ndarray:
    """A baseline JPEG -> (H, W, 3) uint8 RGB, or (H, W) uint8 for grey."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] != b"\xff\xd8":
        raise ValueError(f"{path}: not a JPEG file")
    qts, dcs, acs = {}, {}, {}
    frame, restart = None, 0
    coef = None
    pos = 2
    while True:
        while pos < len(data) and data[pos] != 0xFF:
            pos += 1
        while pos < len(data) and data[pos] == 0xFF:
            pos += 1
        if pos >= len(data):
            raise ValueError(f"{path}: JPEG data ends without EOI")
        marker = data[pos]
        pos += 1
        if marker == 0xD9:
            break
        if 0xD0 <= marker <= 0xD7 or marker == 0x01:
            continue
        (n,) = struct.unpack(">H", data[pos:pos + 2])
        seg = data[pos + 2:pos + n]
        pos += n
        if marker in _SOF_UNSUPPORTED:
            raise ValueError(f"{path}: {_SOF_UNSUPPORTED[marker]} JPEG is not supported (baseline only)")
        if marker in (0xC0, 0xC1):
            prec, h, w, nc = struct.unpack(">BHHB", seg[:6])
            if prec != 8:
                raise ValueError(f"{path}: {prec}-bit JPEG samples are not supported")
            if h == 0:
                raise ValueError(f"{path}: JPEG with a DNL-defined height is not supported")
            comps = [(seg[6 + 3 * i], seg[7 + 3 * i] >> 4, seg[7 + 3 * i] & 15, seg[8 + 3 * i]) for i in range(nc)]
            frame = (h, w, comps)
        elif marker == 0xC4:
            i = 0
            while i < len(seg):
                tc, th = seg[i] >> 4, seg[i] & 15
                counts = list(seg[i + 1:i + 17])
                syms = list(seg[i + 17:i + 17 + sum(counts)])
                (dcs if tc == 0 else acs)[th] = _Huffman(counts, syms)
                i += 17 + sum(counts)
        elif marker == 0xDB:
            i = 0
            while i < len(seg):
                pq, tq = seg[i] >> 4, seg[i] & 15
                if pq:
                    vals = np.frombuffer(seg[i + 1:i + 129], ">u2").astype(np.int64)
                    i += 129
                else:
                    vals = np.frombuffer(seg[i + 1:i + 65], np.uint8).astype(np.int64)
                    i += 65
                qt = np.zeros(64, np.int64)
                qt[ZIGZAG] = vals
                qts[tq] = qt
        elif marker == 0xDD:
            (restart,) = struct.unpack(">H", seg[:2])
        elif marker == 0xEE and seg[:5] == b"Adobe" and len(seg) >= 12 and seg[11] == 0:
            raise ValueError(f"{path}: RGB-coded JPEG (Adobe transform 0) is not supported")
        elif marker == 0xDA:
            if frame is None:
                raise ValueError(f"{path}: JPEG scan before its frame header")
            h, w, comps = frame
            hmax = max(c[1] for c in comps)
            vmax = max(c[2] for c in comps)
            mcux, mcuy = -(-w // (8 * hmax)), -(-h // (8 * vmax))
            if coef is None:
                coef = {c[0]: np.zeros((mcuy * c[2] * mcux * c[1], 64), np.int64) for c in comps}
            ns = seg[0]
            scan = [(seg[1 + 2 * i], seg[2 + 2 * i] >> 4, seg[2 + 2 * i] & 15) for i in range(ns)]
            ss, se, ahal = seg[1 + 2 * ns], seg[2 + 2 * ns], seg[3 + 2 * ns]
            if (ss, se, ahal) != (0, 63, 0):
                raise ValueError(f"{path}: progressive JPEG scan is not supported (baseline only)")
            byid = {c[0]: c for c in comps}
            units = []  # the blocks of each MCU, in stream order
            if ns == 1:
                cid = scan[0][0]
                _, hi, vi, _ = byid[cid]
                bw = -(-(-(-w * hi // hmax)) // 8)
                bh = -(-(-(-h * vi // vmax)) // 8)
                stride = mcux * hi
                units = [[(cid, by * stride + bx)] for by in range(bh) for bx in range(bw)]
            else:
                for my in range(mcuy):
                    for mx in range(mcux):
                        mcu = []
                        for cid, _, _ in scan:
                            _, hi, vi, _ = byid[cid]
                            for v in range(vi):
                                for u in range(hi):
                                    mcu.append((cid, (my * vi + v) * mcux * hi + mx * hi + u))
                        units.append(mcu)
            dct = {cid: dcs[td] for cid, td, _ in scan}
            act = {cid: acs[ta] for cid, _, ta in scan}
            # the entropy-coded data up to the next marker other than RSTn
            chunks, start, i = [], pos, pos
            while True:
                j = data.find(b"\xff", i)
                if j < 0:
                    raise ValueError(f"{path}: JPEG scan without an end")
                nxt = data[j + 1]
                if nxt == 0x00:
                    i = j + 2
                elif nxt == 0xFF:
                    i = j + 1
                elif 0xD0 <= nxt <= 0xD7:
                    chunks.append(data[start:j])
                    start = i = j + 2
                else:
                    chunks.append(data[start:j])
                    pos = j
                    break
            per = restart or len(units)
            groups = [units[k:k + per] for k in range(0, len(units), per)]
            if len(chunks) < len(groups):
                raise ValueError(f"{path}: JPEG scan has {len(chunks)} restart intervals, expected {len(groups)}")
            for chunk, group in zip(chunks, groups):
                chunk = chunk.rstrip(b"\xff").replace(b"\xff\x00", b"\xff")
                _decode_blocks(chunk, [b for mcu in group for b in mcu], dct, act, coef, path)
    if frame is None or coef is None:
        raise ValueError(f"{path}: JPEG without a frame or a scan")
    h, w, comps = frame
    hmax = max(c[1] for c in comps)
    vmax = max(c[2] for c in comps)
    mcux = -(-w // (8 * hmax))
    planes = []
    for cid, hi, vi, tq in comps:
        samples = idct_islow(coef[cid], qts[tq])
        bw = mcux * hi
        plane = samples.reshape(-1, bw, 8, 8).transpose(0, 2, 1, 3).reshape(-1, bw * 8).astype(np.int64)
        plane = plane[:-(-h * vi // vmax), :-(-w * hi // hmax)]
        if (hi, vi) == (hmax, vmax):
            pass
        elif (2 * hi, vi) == (hmax, vmax):
            plane = _fancy_h2(plane)
        elif (2 * hi, 2 * vi) == (hmax, vmax):
            plane = _fancy_h2v2(plane)
        else:
            raise ValueError(f"{path}: JPEG sampling {[(c[1], c[2]) for c in comps]} is not supported "
                             "(4:4:4, 4:2:2 and 4:2:0 only)")
        planes.append(plane[:h, :w])
    if len(planes) == 1:
        return planes[0].astype(np.uint8)
    if len(planes) != 3:
        raise ValueError(f"{path}: JPEG with {len(planes)} components is not supported")
    return _ycc_to_rgb(*planes)


# ---------------------------------------------------------------- writing
_STD_LUMA_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55, 14, 13, 16, 24, 40, 57, 69, 56,
    14, 17, 22, 29, 51, 87, 80, 62, 18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
_STD_CHROMA_Q = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99, 24, 26, 56, 99, 99, 99, 99, 99,
    47, 66, 99, 99, 99, 99, 99, 99] + [99] * 32)
# Annex K.3: (BITS, HUFFVAL) of the typical tables
_DC_LUMA = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12)))
_DC_CHROMA = ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0], list(range(12)))
_AC_LUMA = ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D], bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f02433627282090a161718191a25262728292a"
    "3435363738393a434445464748494a535455565758595a636465666768696a737475767778797a838485868788898a929394"
    "95969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8"
    "e9eaf1f2f3f4f5f6f7f8f9fa"))
_AC_CHROMA = ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77], bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0156272d10a162434e125f11718191a262728"
    "292a35363738393a434445464748494a535455565758595a636465666768696a737475767778797a82838485868788898a92"
    "939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7"
    "e8e9eaf2f3f4f5f6f7f8f9fa"))


def _quality_table(std: np.ndarray, quality: int) -> np.ndarray:
    """The IJG quality rule (jcparam.c): natural-order quantiser."""
    quality = min(max(int(quality), 1), 100)
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return np.clip((std * scale + 50) // 100, 1, 255).astype(np.int64)


def _codes(bits, vals) -> dict:
    """symbol -> (code, length) of a canonical Huffman table."""
    out, code, k = {}, 0, 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            out[vals[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return out


def _fdct_matrix() -> np.ndarray:
    c = np.array([[np.sqrt((1 if u == 0 else 2) / 8) * np.cos((2 * x + 1) * u * np.pi / 16) for x in range(8)]
                  for u in range(8)])
    return c


def _plane_blocks(plane: np.ndarray, bh: int, bw: int) -> np.ndarray:
    """A plane padded by edge replication to (8 bh, 8 bw) -> (bh, bw, 8, 8)."""
    h, w = plane.shape
    p = np.pad(plane, ((0, 8 * bh - h), (0, 8 * bw - w)), mode="edge")
    return p.reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3)


def write_jpeg(path: str, img: np.ndarray, quality: int = 95, subsampling: str = "4:2:0") -> None:
    """img (H, W, 3) RGB or (H, W) grey, uint8 -> a baseline JFIF file."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or (img.ndim == 3 and img.shape[2] != 3):
        raise ValueError("write_jpeg takes an (H, W) or (H, W, 3) uint8 image")
    if subsampling not in ("4:2:0", "4:4:4"):
        raise ValueError(f"subsampling {subsampling!r}: 4:2:0 or 4:4:4")
    h, w = img.shape[:2]
    qt = [_quality_table(_STD_LUMA_Q, quality), _quality_table(_STD_CHROMA_Q, quality)]
    if img.ndim == 2:
        comps = [(img.astype(np.float64), 1, 1, 0)]
    else:
        f = img.astype(np.float64)
        r, g, b = f[..., 0], f[..., 1], f[..., 2]
        y = 0.299 * r + 0.587 * g + 0.114 * b
        cb = -0.168735892 * r - 0.331264108 * g + 0.5 * b + 128.0
        cr = 0.5 * r - 0.418687589 * g - 0.081312411 * b + 128.0
        s = 2 if subsampling == "4:2:0" else 1
        comps = [(y, s, s, 0)]
        for c in (cb, cr):
            if s == 2:
                c = np.pad(c, ((0, h % 2), (0, w % 2)), mode="edge")
                c = c.reshape(c.shape[0] // 2, 2, c.shape[1] // 2, 2).mean(axis=(1, 3))
            comps.append((c, 1, 1, 1))
    hmax = max(c[1] for c in comps)
    vmax = max(c[2] for c in comps)
    mcux, mcuy = -(-w // (8 * hmax)), -(-h // (8 * vmax))
    cmat = _fdct_matrix()
    quantised = []
    for plane, hi, vi, tq in comps:
        blocks = _plane_blocks(np.round(plane) - 128.0, mcuy * vi, mcux * hi)
        d = np.einsum("ux,abxy,vy->abuv", cmat, blocks, cmat)
        q = np.round(d.reshape(d.shape[0], d.shape[1], 64) / qt[tq]).astype(np.int64)
        q[..., 1:] = np.clip(q[..., 1:], -1023, 1023)  # baseline AC magnitudes: 10 bits
        quantised.append(q)
    dc_codes = [_codes(*_DC_LUMA), _codes(*_DC_CHROMA)]
    ac_codes = [_codes(*_AC_LUMA), _codes(*_AC_CHROMA)]
    zz = ZIGZAG.tolist()
    out = bytearray()
    acc, nacc = 0, 0

    def put(code, length):
        nonlocal acc, nacc
        acc = (acc << length) | code
        nacc += length
        while nacc >= 8:
            nacc -= 8
            byte = (acc >> nacc) & 0xFF
            out.append(byte)
            if byte == 0xFF:
                out.append(0)
        acc &= (1 << nacc) - 1

    def magnitude(v):
        s = abs(v).bit_length()
        return s, (v if v >= 0 else v + (1 << s) - 1)

    preds = [0] * len(comps)
    for my in range(mcuy):
        for mx in range(mcux):
            for ci, (_, hi, vi, tq) in enumerate(comps):
                for v in range(vi):
                    for u in range(hi):
                        blk = quantised[ci][my * vi + v, mx * hi + u].tolist()
                        diff = blk[0] - preds[ci]
                        preds[ci] = blk[0]
                        s, bits = magnitude(diff)
                        put(*dc_codes[tq][s])
                        if s:
                            put(bits, s)
                        run = 0
                        for k in range(1, 64):
                            c = blk[zz[k]]
                            if c == 0:
                                run += 1
                                continue
                            while run > 15:
                                put(*ac_codes[tq][0xF0])
                                run -= 16
                            s, bits = magnitude(c)
                            put(*ac_codes[tq][(run << 4) | s])
                            put(bits, s)
                            run = 0
                        if run:
                            put(*ac_codes[tq][0x00])
    if nacc:
        put((1 << (8 - nacc)) - 1, 8 - nacc)

    def segment(marker, body):
        return bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body

    head = bytearray(b"\xff\xd8")
    head += segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    for tq in sorted({c[3] for c in comps}):
        head += segment(0xDB, bytes([tq]) + bytes(qt[tq][ZIGZAG].astype(np.uint8).tolist()))
    sof = struct.pack(">BHHB", 8, h, w, len(comps))
    for ci, (_, hi, vi, tq) in enumerate(comps):
        sof += bytes([ci + 1, (hi << 4) | vi, tq])
    head += segment(0xC0, sof)
    for tq in sorted({c[3] for c in comps}):
        for tc, (bits, vals) in ((0, (_DC_LUMA, _DC_CHROMA)[tq]), (1, (_AC_LUMA, _AC_CHROMA)[tq])):
            head += segment(0xC4, bytes([(tc << 4) | tq]) + bytes(bits) + bytes(vals))
    sos = bytes([len(comps)]) + b"".join(bytes([ci + 1, (c[3] << 4) | c[3]]) for ci, c in enumerate(comps))
    head += segment(0xDA, sos + b"\x00\x3f\x00")
    with open(path, "wb") as f:
        f.write(bytes(head) + bytes(out) + b"\xff\xd9")
