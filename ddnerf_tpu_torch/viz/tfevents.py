"""TensorBoard event files written and read with the standard library and
numpy: no tensorboardX, tensorboard or protobuf.

An events file is a sequence of TFRecord records, each
``u64 length | masked crc32c(length) | payload | masked crc32c(payload)``
(little endian), whose payloads are serialized ``Event`` protos
(``tensorflow/core/util/event.proto``): a ``file_version`` event first,
then one event per summary value.  :class:`EventsWriter` encodes the
protos by hand for the three kinds of value the Documenter writes:

* ``simple_value`` scalars (float32, as ``Summary.Value.simple_value``);
* ``Summary.Image``: PNG bytes of a uint8 ``[C, H, W]`` image (one channel
  is repeated to three, as tensorboardX's ``add_image`` does);
* ``HistogramProto`` built as tensorboardX's ``make_histogram`` builds it
  over its default bucket edges (``bins='tensorflow'``, :data:`DEFAULT_BINS`).

File name and framing are tensorboardX's, so TensorBoard reads the files
as it reads tensorboardX's.  :func:`read_events` reads them back: it checks
both CRCs of every record and decodes what the writer writes.
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Dict, Iterator, List, Tuple

import numpy as np

from ddnerf_tpu_torch.render.media import decode_png, encode_png


def _crc32c_table() -> Tuple[int, ...]:
    table = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return tuple(table)


_CRC32C_TABLE = _crc32c_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli) of ``data``, table-driven."""
    crc, table = 0xFFFFFFFF, _CRC32C_TABLE
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    """The TFRecord checksum: crc32c rotated right by 15 bits plus a
    constant, modulo 2**32."""
    x = crc32c(data)
    return (((x >> 15) | (x << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _default_bins() -> List[float]:
    # tensorboardX's SummaryWriter.default_bins (TensorFlow's histogram
    # buckets): +-1e-12 growing by 1.1 up to 1e20, and 0.
    v, buckets = 1e-12, []
    while v < 1e20:
        buckets.append(v)
        v *= 1.1
    return [-b for b in buckets[::-1]] + [0] + buckets


DEFAULT_BINS = _default_bins()

# ------------------------------------------------------------- encoding


def _varint(n: int) -> bytes:
    n &= 0xFFFFFFFFFFFFFFFF  # int64 fields: two's complement
    out = bytearray()
    while True:
        byte = n & 0x7F
        n >>= 7
        if n:
            out.append(byte | 0x80)
        else:
            out.append(byte)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint(field << 3 | wire)


def _bytes(field: int, value: bytes) -> bytes:
    return _key(field, 2) + _varint(len(value)) + value


def _double(field: int, value: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", value)


def _int(field: int, value: int) -> bytes:
    return _key(field, 0) + _varint(value)


def _packed_doubles(field: int, values) -> bytes:
    return _bytes(field, np.asarray(values, "<f8").tobytes())


def _event(wall_time: float, step: int = 0, file_version: str = "",
           summary_value: bytes = b"") -> bytes:
    out = _double(1, wall_time)
    if step:
        out += _int(2, step)
    if file_version:
        out += _bytes(3, file_version.encode())
    if summary_value:
        out += _bytes(5, _bytes(1, summary_value))  # Summary{value: [v]}
    return out


def _histogram(values: np.ndarray) -> bytes:
    """``HistogramProto`` of ``values``, as tensorboardX's
    ``make_histogram(values.astype(float), default_bins)``."""
    values = np.asarray(values, dtype=float).reshape(-1)
    if values.size == 0:
        raise ValueError("a histogram of no values")
    counts, limits = np.histogram(values, bins=DEFAULT_BINS)
    cum = np.cumsum(np.greater(counts, 0))
    start, end = np.searchsorted(cum, [0, cum[-1] - 1], side="right")
    start, end = int(start), int(end) + 1
    # TensorBoard reads right edges only: keep one empty bucket on the left.
    counts = (counts[start - 1:end] if start > 0
              else np.concatenate([[0], counts[:end]]))
    limits = limits[start:end + 1]
    return (_double(1, values.min()) + _double(2, values.max())
            + _double(3, len(values)) + _double(4, values.sum())
            + _double(5, values.dot(values))
            + _packed_doubles(6, limits) + _packed_doubles(7, counts))


def _image(image: np.ndarray) -> bytes:
    """``Summary.Image`` of a uint8 ``[C, H, W]`` image (C = 1, 3 or 4)."""
    image = np.asarray(image)
    if image.ndim != 3 or image.dtype != np.uint8 or image.shape[0] not in (
            1, 3, 4):
        raise ValueError("images are uint8 [C, H, W] with C = 1, 3 or 4, got "
                         f"{image.dtype} {image.shape}")
    hwc = np.ascontiguousarray(image.transpose(1, 2, 0))
    if hwc.shape[2] == 1:
        hwc = np.concatenate([hwc] * 3, 2)
    h, w, c = hwc.shape
    return (_int(1, h) + _int(2, w) + _int(3, c)
            + _bytes(4, encode_png(hwc)))


class EventsWriter:
    """One events file in ``logdir``, named as tensorboardX names it
    (``events.out.tfevents.{int(time)}.{hostname}``).  Every event is
    written and flushed when it is added; a file that cannot be created or
    written raises."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        now = time.time()
        self.path = os.path.join(
            logdir, f"events.out.tfevents.{int(now)}.{socket.gethostname()}")
        self._f = open(self.path, "ab")
        self._write(_event(now, file_version="brain.Event:2"))

    def _write(self, payload: bytes) -> None:
        header = struct.pack("<Q", len(payload))
        self._f.write(header + struct.pack("<I", masked_crc32c(header))
                      + payload + struct.pack("<I", masked_crc32c(payload)))
        self._f.flush()

    def _value(self, tag: str, step: int, value: bytes) -> None:
        """One event holding ``Summary.Value{tag, value}``."""
        self._write(_event(time.time(), int(step),
                           summary_value=_bytes(1, tag.encode()) + value))

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._value(tag, step, _key(2, 5) + struct.pack("<f", float(value)))

    def add_image(self, tag: str, image: np.ndarray, step: int) -> None:
        self._value(tag, step, _bytes(4, _image(image)))

    def add_histogram(self, tag: str, values: np.ndarray, step: int) -> None:
        self._value(tag, step, _bytes(5, _histogram(values)))

    def close(self) -> None:
        self._f.close()


# ------------------------------------------------------------- decoding


def _fields(buf: bytes) -> Iterator[Tuple[int, int, object]]:
    """(field, wire type, value) of each field of a serialized message:
    an int for varints, bytes for fixed64 / fixed32 / length-delimited."""
    pos = 0

    def varint():
        nonlocal pos
        shift = value = 0
        while True:
            b = buf[pos]
            pos += 1
            value |= (b & 0x7F) << shift
            if b < 0x80:
                return value
            shift += 7

    while pos < len(buf):
        key = varint()
        field, wire = key >> 3, key & 7
        if wire == 0:
            yield field, wire, varint()
        elif wire in (1, 5):
            size = 8 if wire == 1 else 4
            yield field, wire, buf[pos:pos + size]
            pos += size
        elif wire == 2:
            size = varint()
            yield field, wire, buf[pos:pos + size]
            pos += size
        else:
            raise ValueError(f"wire type {wire} in an event")


def _decode_histogram(buf: bytes) -> Dict[str, object]:
    names = {1: "min", 2: "max", 3: "num", 4: "sum", 5: "sum_squares"}
    out: Dict[str, object] = {"bucket_limit": [], "bucket": []}
    for field, wire, v in _fields(buf):
        if field in names:
            out[names[field]] = struct.unpack("<d", v)[0]
        elif field in (6, 7):
            key = "bucket_limit" if field == 6 else "bucket"
            out[key] += (np.frombuffer(v, "<f8").tolist() if wire == 2
                         else [struct.unpack("<d", v)[0]])
    return out


def _decode_value(buf: bytes) -> Dict[str, object]:
    out: Dict[str, object] = {}
    for field, _, v in _fields(buf):
        if field == 1:
            out["tag"] = v.decode()
        elif field == 2:
            out["kind"], out["value"] = "scalar", struct.unpack("<f", v)[0]
        elif field == 4:
            img = {f: x for f, _, x in _fields(v)}
            out["kind"] = "image"
            out["value"] = decode_png(img[4])
            out["size"] = (img.get(1, 0), img.get(2, 0), img.get(3, 0))
        elif field == 5:
            out["kind"], out["value"] = "histogram", _decode_histogram(v)
    return out


def read_events(path: str) -> List[Dict[str, object]]:
    """Every event of an events file, in order, as dicts: ``wall_time``,
    ``step``, and ``file_version`` or, for a summary event, one entry per
    value in ``values`` with its ``tag``, its ``kind`` (``scalar``,
    ``image`` or ``histogram``) and its ``value`` (a float, the decoded
    ``[H, W, C]`` pixels, or the histogram's fields).  Raises on a
    truncated record or a CRC that does not match."""
    with open(path, "rb") as f:
        data = f.read()
    events, pos = [], 0
    while pos < len(data):
        if pos + 12 > len(data):
            raise ValueError(f"{path}: truncated record header at {pos}")
        header = data[pos:pos + 8]
        (size,) = struct.unpack("<Q", header)
        (crc,) = struct.unpack_from("<I", data, pos + 8)
        if crc != masked_crc32c(header):
            raise ValueError(f"{path}: bad length CRC at {pos}")
        payload = data[pos + 12:pos + 12 + size]
        if len(payload) != size or pos + 16 + size > len(data):
            raise ValueError(f"{path}: truncated record at {pos}")
        (crc,) = struct.unpack_from("<I", data, pos + 12 + size)
        if crc != masked_crc32c(payload):
            raise ValueError(f"{path}: bad payload CRC at {pos}")
        pos += 16 + size
        event: Dict[str, object] = {"step": 0, "values": []}
        for field, _, v in _fields(payload):
            if field == 1:
                event["wall_time"] = struct.unpack("<d", v)[0]
            elif field == 2:
                event["step"] = v - (1 << 64) if v >= 1 << 63 else v
            elif field == 3:
                event["file_version"] = v.decode()
            elif field == 5:
                event["values"] += [_decode_value(x) for f, _, x in _fields(v)
                                    if f == 1]
        events.append(event)
    return events
