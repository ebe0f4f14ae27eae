"""A reader and writer for the HDF5 subset that h5py writes by default and
BlenderProc scenes use (the port's own: the card's machine has no h5py).

Reading takes: superblock version 0; version-1 object headers with
continuation messages; the root group as a symbol table (a v1 B-tree of
group nodes, a local heap, symbol-table nodes) holding datasets only;
dataspaces scalar and simple; datatypes little-endian fixed-point and IEEE
float of 1, 2, 4 and 8 bytes and fixed-length strings (`|S<n>`, as
BlenderProc stores its JSON fields); data laid out (layout message
version 3) contiguous, compact or chunked, a chunked dataset indexed by a v1
B-tree of chunk nodes, its edge chunks stored at full size and its
unallocated chunks reading as the fill value; and the deflate (zlib) and
shuffle filters. Fill-value, modification-time, attribute and comment
messages are skipped. Anything else (another superblock or object-header
version, a filter other than deflate or shuffle, variable-length data, a
nested group, a link, big-endian or other datatypes) raises ValueError
naming the file and the feature.

Writing emits superblock 0, a root symbol-table group and contiguous
datasets of those numeric types and of fixed-length strings: the structure
h5py gives `create_dataset(name, data=array)`.

    with hdf5.File(path) as f:
        depth = f["depth"]          # np.ndarray
    hdf5.write(path, {"depth": depth, "campose": np.bytes_(json_text)})
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89HDF\r\n\x1a\n"
_UNDEF = 0xFFFFFFFFFFFFFFFF
_HEAP_FREE_NULL = 1   # the library's "no free block" in a local heap

# object-header message types
_NIL, _DATASPACE, _LINK_INFO, _DATATYPE, _FILL_OLD, _FILL = 0x00, 0x01, 0x02, 0x03, 0x04, 0x05
_LINK, _EXTERNAL, _LAYOUT, _BOGUS, _GROUP_INFO, _FILTERS = 0x06, 0x07, 0x08, 0x09, 0x0A, 0x0B
_ATTRIBUTE, _COMMENT, _MTIME_OLD, _CONTINUATION, _SYMBOL_TABLE = 0x0C, 0x0D, 0x0E, 0x10, 0x11
_MTIME, _ATTRIBUTE_INFO = 0x12, 0x15
_SKIPPED = {_NIL, _FILL_OLD, _FILL, _BOGUS, _ATTRIBUTE, _COMMENT, _MTIME_OLD, _MTIME, _ATTRIBUTE_INFO}
_GROUP_MESSAGES = {_LINK_INFO, _LINK, _GROUP_INFO, _SYMBOL_TABLE}

_DEFLATE, _SHUFFLE = 1, 2
_FILTER_NAMES = {3: "fletcher32", 4: "szip", 5: "nbit", 6: "scaleoffset", 32000: "lzf", 32001: "blosc",
                 32004: "lz4", 32008: "bitshuffle", 32015: "zstd"}
_CLASS_NAMES = {2: "time", 4: "bitfield", 5: "opaque", 6: "compound", 7: "reference", 8: "enum (bool)",
                9: "variable-length (string or sequence)", 10: "array"}

# IEEE float layouts by size: (sign location, exponent location, exponent
# size, mantissa size, exponent bias)
_FLOATS = {2: (15, 10, 5, 10, 15), 4: (31, 23, 8, 23, 127), 8: (63, 52, 11, 52, 1023)}


class _Dataset:
    """What a dataset's object header says: shape, dtype, layout, filters."""

    def __init__(self):
        self.shape = None
        self.dtype = None
        self.fill = None
        self.layout = None        # ("contiguous", address, size) | ("compact", bytes) | ("chunked", btree, chunk)
        self.filters = []         # filter ids in the order they were applied on write


class File:
    """A read-only HDF5 file of the subset in the module docstring, read
    whole when it is opened; datasets come back as numpy arrays."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            self._buf = f.read()
        self._datasets = self._read_root()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self) -> None:
        self._buf = b""

    def keys(self) -> list[str]:
        return list(self._datasets)

    def __contains__(self, name: str) -> bool:
        return name in self._datasets

    def __getitem__(self, name: str) -> np.ndarray:
        return self._read_data(self._datasets[name])

    # ------------------------------------------------------------ structure
    def _fail(self, what: str):
        raise ValueError(f"{self.path}: {what} is not supported by this HDF5 reader")

    def _bad(self, what: str):
        raise ValueError(f"{self.path}: corrupt HDF5 file ({what})")

    def _unpack(self, fmt: str, offset: int):
        if offset < 0 or offset + struct.calcsize(fmt) > len(self._buf):
            self._bad(f"a structure at {offset} runs past the end")
        return struct.unpack_from(fmt, self._buf, offset)

    def _read_root(self) -> dict:
        if self._buf[:8] != _SIGNATURE:
            if _SIGNATURE in self._buf[:4096]:
                self._fail("a user block before the superblock")
            raise ValueError(f"{self.path}: not an HDF5 file")
        version, = self._unpack("<B", 8)
        if version != 0:
            self._fail(f"superblock version {version} (h5py's libver='latest')")
        size_off, size_len = self._unpack("<BB", 13)
        if (size_off, size_len) != (8, 8):
            self._fail(f"{size_off}-byte offsets and {size_len}-byte lengths")
        root_header, = self._unpack("<Q", 64)   # the root group's symbol-table entry
        messages = self._header_messages(root_header)
        kinds = {t for t, _ in messages}
        if _SYMBOL_TABLE not in kinds:
            self._fail("a root group without a symbol table (link messages: a new-style group)")
        btree, heap = next(struct.unpack_from("<QQ", body) for t, body in messages if t == _SYMBOL_TABLE)
        names = self._heap_data(heap)
        datasets = {}
        for name_off, header in self._group_entries(btree):
            end = names.index(b"\0", name_off)
            name = names[name_off:end].decode()
            datasets[name] = self._dataset(name, header)
        return datasets

    def _header_messages(self, addr: int) -> list[tuple[int, bytes]]:
        """The (type, body) messages of the version-1 object header at `addr`,
        continuation blocks followed."""
        version, = self._unpack("<B", addr)
        if version != 1:
            self._fail(f"object header version {version} (signature {self._buf[addr:addr + 4]!r})")
        n_messages, _, size = self._unpack("<HII", addr + 2)
        blocks = [(addr + 16, size)]
        out = []
        while blocks:
            p, size = blocks.pop(0)
            end = p + size
            while p + 8 <= end and len(out) < n_messages:
                mtype, msize, flags = self._unpack("<HHB", p)
                body = self._buf[p + 8:p + 8 + msize]
                if mtype == _CONTINUATION:
                    blocks.append(struct.unpack_from("<QQ", body))
                elif flags & 0x02:
                    self._fail(f"a shared object-header message (type {mtype:#x})")
                out.append((mtype, body))
                p += 8 + msize
        return out

    def _heap_data(self, addr: int) -> bytes:
        if self._buf[addr:addr + 4] != b"HEAP":
            self._bad(f"no local heap at {addr}")
        size, _, data = self._unpack("<QQQ", addr + 8)
        return self._buf[data:data + size]

    def _btree_children(self, addr: int, node_type: int, key_size: int):
        """Yield (left key bytes, child address) of every leaf entry of the v1
        B-tree at `addr`."""
        if self._buf[addr:addr + 4] != b"TREE":
            self._bad(f"no B-tree node at {addr}")
        kind, level, entries = self._unpack("<BBH", addr + 4)
        if kind != node_type:
            self._bad(f"B-tree node type {kind} at {addr}, expected {node_type}")
        p = addr + 24
        for _ in range(entries):
            key = self._buf[p:p + key_size]
            child, = self._unpack("<Q", p + key_size)
            p += key_size + 8
            if level:
                yield from self._btree_children(child, node_type, key_size)
            else:
                yield key, child

    def _group_entries(self, btree: int):
        """(name offset in the heap, object header address) of every member."""
        for _, snod in self._btree_children(btree, 0, 8):
            if self._buf[snod:snod + 4] != b"SNOD":
                self._bad(f"no symbol-table node at {snod}")
            count, = self._unpack("<H", snod + 6)
            for i in range(count):
                name_off, header, cache = self._unpack("<QQI", snod + 8 + 40 * i)
                if cache == 2 or header == _UNDEF:
                    self._fail("a soft link")
                yield name_off, header

    def _dataset(self, name: str, header: int) -> _Dataset:
        d = _Dataset()
        for mtype, body in self._header_messages(header):
            if mtype in _GROUP_MESSAGES:
                self._fail(f"a nested group ({name!r})")
            if mtype == _DATASPACE:
                d.shape = self._dataspace(body)
            elif mtype == _DATATYPE:
                d.dtype = self._datatype(body)
            elif mtype == _FILL:
                d.fill = self._fill_value(body)
            elif mtype == _LAYOUT:
                d.layout = self._layout(body)
            elif mtype == _FILTERS:
                d.filters = self._filters(body)
            elif mtype == _EXTERNAL:
                self._fail(f"external storage ({name!r})")
            elif mtype not in _SKIPPED | {_CONTINUATION}:
                self._fail(f"object-header message type {mtype:#x} ({name!r})")
        if d.shape is None or d.dtype is None or d.layout is None:
            self._bad(f"{name!r} lacks a dataspace, datatype or layout")
        return d

    def _dataspace(self, body: bytes) -> tuple:
        version, rank, flags = struct.unpack_from("<BBB", body)
        if version == 1:
            dims_at = 8
        elif version == 2:
            if body[3] == 2:
                self._fail("a null dataspace")
            dims_at = 4
        else:
            self._fail(f"dataspace version {version}")
        return struct.unpack_from(f"<{rank}Q", body, dims_at)

    def _datatype(self, body: bytes) -> np.dtype:
        cls = body[0] & 0x0F
        bits = body[1] | body[2] << 8 | body[3] << 16
        size, = struct.unpack_from("<I", body, 4)
        if cls == 3:   # fixed-length string, any padding and character set
            return np.dtype(f"S{size}")
        if cls in (0, 1) and bits & 0x01:
            self._fail("big-endian numbers")
        if cls == 0:
            offset, precision = struct.unpack_from("<HH", body, 8)
            if size not in (1, 2, 4, 8) or (offset, precision) != (0, 8 * size):
                self._fail(f"a {size}-byte integer of {precision} bits at bit {offset}")
            return np.dtype(f"<{'i' if bits & 0x08 else 'u'}{size}")
        if cls == 1:
            offset, precision, exp_loc, exp_size, mant_loc, mant_size, bias = struct.unpack_from(
                "<HHBBBBI", body, 8)
            sign = bits >> 8 & 0xFF
            if size not in _FLOATS or (offset, precision, mant_loc) != (0, 8 * size, 0) \
                    or (sign, exp_loc, exp_size, mant_size, bias) != _FLOATS[size] or bits & 0x40:
                self._fail(f"a {size}-byte float that is not IEEE little-endian")
            return np.dtype(f"<f{size}")
        self._fail(f"datatype class {cls} ({_CLASS_NAMES.get(cls, 'unknown')})")

    def _fill_value(self, body: bytes) -> bytes | None:
        version = body[0]
        if version in (1, 2):
            if version == 2 and body[3] == 0:
                return None
            size, = struct.unpack_from("<I", body, 4)
            return body[8:8 + size] or None
        if version == 3:
            if not body[1] & 0x20:
                return None
            size, = struct.unpack_from("<I", body, 2)
            return body[6:6 + size] or None
        self._fail(f"fill-value message version {version}")

    def _layout(self, body: bytes):
        version, cls = body[0], body[1]
        if version != 3:
            self._fail(f"data layout message version {version}")
        if cls == 0:
            size, = struct.unpack_from("<H", body, 2)
            return ("compact", body[4:4 + size])
        if cls == 1:
            return ("contiguous", *struct.unpack_from("<QQ", body, 2))
        if cls == 2:
            ndims, btree = struct.unpack_from("<BQ", body, 2)
            chunk = struct.unpack_from(f"<{ndims}I", body, 11)
            return ("chunked", btree, chunk[:-1])
        self._fail(f"data layout class {cls}")

    def _filters(self, body: bytes) -> list[int]:
        version, count = body[0], body[1]
        if version not in (1, 2):
            self._fail(f"filter pipeline version {version}")
        p = 8 if version == 1 else 2
        ids = []
        for _ in range(count):
            fid, = struct.unpack_from("<H", body, p)
            if version == 1 or fid >= 256:
                name_len, _, n_values = struct.unpack_from("<HHH", body, p + 2)
                p += 8
            else:
                name_len, (_, n_values) = 0, struct.unpack_from("<HH", body, p + 2)
                p += 6
            p += (name_len + 7) // 8 * 8 if version == 1 else name_len
            p += 4 * n_values + (4 if version == 1 and n_values % 2 else 0)
            if fid not in (_DEFLATE, _SHUFFLE):
                self._fail(f"the {_FILTER_NAMES.get(fid, f'id {fid}')} filter")
            ids.append(fid)
        return ids

    # ----------------------------------------------------------------- data
    def _read_data(self, d: _Dataset) -> np.ndarray:
        n = int(np.prod(d.shape, dtype=np.int64))
        kind = d.layout[0]
        if kind == "compact":
            return np.frombuffer(d.layout[1], d.dtype, count=n).reshape(d.shape).copy()
        if kind == "contiguous":
            _, addr, size = d.layout
            if addr == _UNDEF:
                return self._filled(d)
            if size < n * d.dtype.itemsize or addr + size > len(self._buf):
                self._bad("contiguous data past the end of the file")
            return np.frombuffer(self._buf, d.dtype, count=n, offset=addr).reshape(d.shape).copy()
        _, btree, chunk = d.layout
        out = self._filled(d)
        if btree == _UNDEF:
            return out
        rank = len(d.shape)
        key_size = 8 + 8 * (rank + 1)
        chunk_n = int(np.prod(chunk, dtype=np.int64))
        for key, addr in self._btree_children(btree, 1, key_size):
            size, mask = struct.unpack_from("<II", key)
            origin = struct.unpack_from(f"<{rank}Q", key, 8)
            raw = self._buf[addr:addr + size]
            for i in reversed(range(len(d.filters))):
                if not mask >> i & 1:
                    raw = self._unfilter(d.filters[i], raw, d.dtype.itemsize)
            if len(raw) < chunk_n * d.dtype.itemsize:
                self._bad(f"a chunk at {addr} holds {len(raw)} bytes")
            block = np.frombuffer(raw, d.dtype, count=chunk_n).reshape(chunk)
            dst = tuple(slice(o, min(o + c, s)) for o, c, s in zip(origin, chunk, d.shape))
            out[dst] = block[tuple(slice(0, s.stop - s.start) for s in dst)]
        return out

    def _filled(self, d: _Dataset) -> np.ndarray:
        out = np.zeros(d.shape, d.dtype)
        if d.fill is not None:
            out[...] = np.frombuffer(d.fill, d.dtype, count=1)[0]
        return out

    def _unfilter(self, fid: int, raw: bytes, itemsize: int) -> bytes:
        if fid == _DEFLATE:
            try:
                return zlib.decompress(raw)
            except zlib.error as e:
                self._bad(f"a deflate chunk: {e}")
        n = len(raw) // itemsize
        body = np.frombuffer(raw, np.uint8, count=n * itemsize).reshape(itemsize, n).T.tobytes()
        return body + raw[n * itemsize:]


# ---------------------------------------------------------------- writing
def _pad8(b: bytes) -> bytes:
    return b + b"\0" * (-len(b) % 8)


def _message(mtype: int, body: bytes, flags: int = 0) -> bytes:
    body = _pad8(body)
    return struct.pack("<HHB3x", mtype, len(body), flags) + body


def _object_header(messages: list[bytes]) -> bytes:
    body = b"".join(messages)
    return struct.pack("<BBHII4x", 1, 0, len(messages), 1, len(body)) + body


def _datatype_message(dtype: np.dtype) -> bytes:
    size = dtype.itemsize
    if dtype.kind == "S":
        return struct.pack("<B3sI", 0x13, bytes([0x01, 0, 0]), size)   # null-padded ASCII
    if dtype.kind in "iu" and size in (1, 2, 4, 8):
        return struct.pack("<B3sIHH", 0x10, bytes([0x08 if dtype.kind == "i" else 0, 0, 0]), size, 0, 8 * size)
    if dtype.kind == "f" and size in _FLOATS:
        sign, exp_loc, exp_size, mant_size, bias = _FLOATS[size]
        return struct.pack("<B3sIHHBBBBI", 0x11, bytes([0x20, sign, 0]), size, 0, 8 * size, exp_loc, exp_size,
                           0, mant_size, bias)
    raise ValueError(f"hdf5.write: dtype {dtype} is not supported (little-endian ints, floats, |S strings)")


def write(path: str, datasets: dict) -> None:
    """Write {name: array} as an HDF5 file of contiguous datasets in a root
    symbol-table group (names sorted, as h5py orders them). Arrays are
    written little-endian; np.bytes_ scalars as fixed-length strings."""
    arrays = {}
    for name, a in sorted(datasets.items()):
        a = np.asarray(a)
        if a.dtype.kind in "iuf" and a.dtype.byteorder == ">":
            a = a.astype(a.dtype.newbyteorder("<"))
        arrays[name] = np.asarray(a, order="C")
    n = len(arrays)
    leaf_k = max(4, (n + 1) // 2)        # one symbol-table node holds 2K members
    internal_k = 16

    heap_data, name_offsets = bytearray(8), {}   # offset 0: the empty name
    for name in arrays:
        name_offsets[name] = len(heap_data)
        heap_data += _pad8(name.encode() + b"\0")
    superblock_size, root_size = 96, 16 + 24
    btree_size = 24 + (2 * internal_k + 1) * 8 + 2 * internal_k * 8
    snod_size = 8 + 2 * leaf_k * 40
    root_at = superblock_size
    btree_at = root_at + root_size
    heap_at = btree_at + btree_size
    heap_data_at = heap_at + 32
    snod_at = heap_data_at + len(heap_data)

    headers, p = {}, snod_at + snod_size
    for name, a in arrays.items():
        space = (struct.pack("<BBB5x", 1, a.ndim, 1) + struct.pack(f"<{2 * a.ndim}Q", *a.shape, *a.shape)
                 if a.ndim else struct.pack("<BBB5x", 1, 0, 0))
        messages = [_message(_DATASPACE, space), _message(_DATATYPE, _datatype_message(a.dtype), 1),
                    _message(_FILL, bytes([2, 2, 2, 1, 0, 0, 0, 0]), 1), None]
        headers[name] = (p, messages)
        p += len(_object_header(messages[:3])) + 8 + 24   # the layout message: 8 + 18 bytes padded
    out = bytearray()
    body_at = p
    for name, a in arrays.items():
        addr = body_at if a.nbytes else _UNDEF
        headers[name][1][3] = _message(_LAYOUT, struct.pack("<BBQQ", 3, 1, addr, a.nbytes))
        body_at += len(_pad8(a.tobytes())) if a.nbytes else 0

    out += _SIGNATURE + struct.pack("<BBBBBBBBHHI", 0, 0, 0, 0, 0, 8, 8, 0, leaf_k, internal_k, 0)
    out += struct.pack("<QQQQ", 0, _UNDEF, body_at, _UNDEF)
    out += struct.pack("<QQII", 0, root_at, 1, 0) + struct.pack("<QQ", btree_at, heap_at)
    out += _object_header([_message(_SYMBOL_TABLE, struct.pack("<QQ", btree_at, heap_at))])
    last = name_offsets[next(reversed(arrays))] if n else 0
    btree = b"TREE" + struct.pack("<BBHQQ", 0, 0, 1 if n else 0, _UNDEF, _UNDEF)
    btree += struct.pack("<QQQ", 0, snod_at, last) if n else b""
    out += btree + b"\0" * (btree_size - len(btree))
    out += b"HEAP" + struct.pack("<B3xQQQ", 0, len(heap_data), _HEAP_FREE_NULL, heap_data_at) + heap_data
    snod = b"SNOD" + struct.pack("<BxH", 1, n)
    for name in arrays:
        snod += struct.pack("<QQII16x", name_offsets[name], headers[name][0], 0, 0)
    out += snod + b"\0" * (snod_size - len(snod))
    for name in arrays:
        out += _object_header(headers[name][1])
    for a in arrays.values():
        if a.nbytes:
            out += _pad8(a.tobytes())
    if len(out) != body_at:
        raise AssertionError(f"hdf5.write: laid out {body_at} bytes, wrote {len(out)}")
    with open(path, "wb") as f:
        f.write(out)
