"""TensorBoard event-file reader of the port's own (the card's machine has
neither the tensorboard package's reader nor pandas; `utils/hdf5.py` and
`utils/jpeg.py` are the port's own for the same reason).

An event file is a TFRecord stream: each record is a little-endian uint64
length, the masked CRC-32C of those 8 bytes, the data, and the masked CRC-32C
of the data. Each record's data is a serialized `tensorflow.Event`; this
module reads the fields that `torch.utils.tensorboard`'s `add_scalar` writes
by default:

  Event   {1: wall_time double, 2: step int64, 5: summary Summary}
  Summary {1: value repeated Value}
  Value   {1: tag string, 2: simple_value float}

Events without a summary (the file-version record) are skipped. A bad CRC, a
truncated record, or a summary value that holds no `simple_value` (an image,
a histogram, a tensor) raises ValueError naming the file.
"""

from __future__ import annotations

import struct
from typing import Iterator, NamedTuple


def _crc32c_table() -> list[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _crc32c_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), as TFRecord uses it."""
    c = 0xFFFFFFFF
    for b in data:
        c = _CRC_TABLE[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    c = crc32c(data)
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def read_records(path: str) -> Iterator[bytes]:
    """The data of each TFRecord in the file, CRCs checked."""
    with open(path, "rb") as f:
        buf = f.read()
    pos = 0
    while pos < len(buf):
        if pos + 12 > len(buf):
            raise ValueError(f"{path}: truncated record header at byte {pos}")
        head = buf[pos:pos + 8]
        (n,) = struct.unpack("<Q", head)
        (crc,) = struct.unpack("<I", buf[pos + 8:pos + 12])
        if crc != masked_crc32c(head):
            raise ValueError(f"{path}: bad length CRC at byte {pos}")
        data = buf[pos + 12:pos + 12 + n]
        if pos + 16 + n > len(buf):
            raise ValueError(f"{path}: truncated record at byte {pos}")
        (crc,) = struct.unpack("<I", buf[pos + 12 + n:pos + 16 + n])
        if crc != masked_crc32c(data):
            raise ValueError(f"{path}: bad data CRC at byte {pos}")
        yield data
        pos += 16 + n


def _varint(buf: bytes, pos: int) -> tuple[int, int]:
    shift = result = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _fields(buf: bytes, path: str) -> Iterator[tuple[int, int, object]]:
    """(field number, wire type, value) of a protobuf message: an int for a
    varint, bytes for fixed64 / fixed32 / length-delimited fields."""
    pos = 0
    while pos < len(buf):
        key, pos = _varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            value, pos = _varint(buf, pos)
        elif wire == 1:
            value, pos = buf[pos:pos + 8], pos + 8
        elif wire == 2:
            n, pos = _varint(buf, pos)
            value, pos = buf[pos:pos + n], pos + n
        elif wire == 5:
            value, pos = buf[pos:pos + 4], pos + 4
        else:
            raise ValueError(f"{path}: unsupported protobuf wire type {wire}")
        yield field, wire, value


class Scalar(NamedTuple):
    wall_time: float
    step: int
    tag: str
    value: float


def read_scalars(path: str) -> Iterator[Scalar]:
    """Every scalar summary value in the event file, in file order."""
    for record in read_records(path):
        wall_time, step, summaries = 0.0, 0, []
        for field, wire, value in _fields(record, path):
            if field == 1 and wire == 1:
                (wall_time,) = struct.unpack("<d", value)
            elif field == 2 and wire == 0:
                step = value - (1 << 64) if value >= 1 << 63 else value
            elif field == 5 and wire == 2:
                summaries.append(value)
        for summary in summaries:
            for field, wire, value in _fields(summary, path):
                if field != 1 or wire != 2:
                    continue
                tag, simple = None, None
                for vf, vw, vv in _fields(value, path):
                    if vf == 1 and vw == 2:
                        tag = vv.decode("utf-8")
                    elif vf == 2 and vw == 5:
                        (simple,) = struct.unpack("<f", vv)
                if simple is None:
                    raise ValueError(f"{path}: summary value {tag!r} at step {step} holds no scalar")
                yield Scalar(wall_time, step, tag, simple)
