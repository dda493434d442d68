"""Video and image files written with the standard library.

``render_model_video`` writes ``video.avi`` as an uncompressed RIFF AVI of
24-bit ``DIB `` frames (BI_RGB with a negative height, i.e. top-down rows,
which FFmpeg-based readers decode; BGR order, rows padded to 4 bytes, an
``idx1`` index) and each frame as an 8-bit PNG (grey, RGB or RGBA), so
the port needs neither OpenCV nor imageio.  The readers parse exactly
what the writers produce; they serve the checks of a rendered video.
"""

from __future__ import annotations

import struct
import zlib
from typing import List, Tuple

import numpy as np

_AVIF_HASINDEX = 0x10
_AVIIF_KEYFRAME = 0x10
_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _dib_rows(height: int, width: int) -> Tuple[int, int]:
    """(row stride, frame bytes) of a 24-bit DIB: rows padded to 4 bytes."""
    stride = (3 * width + 3) & ~3
    return stride, stride * height


class AviWriter:
    """Append ``[H, W, 3]`` uint8 RGB frames to an uncompressed AVI.

    The frame count and the chunk sizes are patched in on :meth:`close`
    (or at the end of a ``with`` block)."""

    def __init__(self, path: str, width: int, height: int, fps: int = 24):
        self.width, self.height, self.fps = int(width), int(height), int(fps)
        self._stride, self._frame_bytes = _dib_rows(self.height, self.width)
        self._index: List[int] = []  # frame offsets from the 'movi' tag
        self._f = open(path, "wb")
        self._write_headers()

    def _write_headers(self) -> None:
        w, h, fb, fps = self.width, self.height, self._frame_bytes, self.fps
        avih = struct.pack(
            "<14I", 1_000_000 // fps, fb * fps, 0, _AVIF_HASINDEX,
            0, 0, 1, fb, w, h, 0, 0, 0, 0)  # total frames patched on close
        strh = struct.pack(
            "<4s4sIHHIIIIIIII4h", b"vids", b"DIB ", 0, 0, 0, 0, 1, fps, 0,
            0, fb, 0xFFFFFFFF, 0, 0, 0, w, h)  # length patched on close
        strf = struct.pack("<IiiHHIIiiII", 40, w, -h, 1, 24, 0, fb, 0, 0, 0,
                           0)  # top-down rows
        strl = b"strl" + _chunk(b"strh", strh) + _chunk(b"strf", strf)
        hdrl = b"hdrl" + _chunk(b"avih", avih) + _chunk(b"LIST", strl)
        f = self._f
        f.write(b"RIFF\0\0\0\0AVI ")
        f.write(_chunk(b"LIST", hdrl))
        self._movi_at = f.tell()  # the movi LIST's size field is +4
        f.write(b"LIST\0\0\0\0movi")

    # File offsets of the fields patched on close: avih starts at 32 (RIFF
    # header 12, hdrl LIST header 12, avih chunk header 8), strh at 108
    # (+ avih 56, strl LIST header 12, strh chunk header 8).
    _TOTAL_FRAMES_AT = 32 + 16  # avih.dwTotalFrames
    _LENGTH_AT = 108 + 32  # strh.dwLength

    def write(self, frame: np.ndarray) -> None:
        frame = np.asarray(frame)
        if frame.shape != (self.height, self.width, 3) or \
                frame.dtype != np.uint8:
            raise ValueError(f"frame must be uint8 [{self.height}, "
                             f"{self.width}, 3], got {frame.dtype} "
                             f"{frame.shape}")
        # RIFF sizes are 32-bit: the file, its index included, must fit.
        end = (self._f.tell() + 8 + self._frame_bytes
               + 8 + 16 * (len(self._index) + 1))
        if end > 0xFFFFFFFF:
            raise ValueError("an AVI file holds at most 4 GiB of frames")
        rows = np.zeros((self.height, self._stride), np.uint8)
        rows[:, :3 * self.width] = frame[:, :, ::-1].reshape(
            self.height, 3 * self.width)
        self._index.append(self._f.tell() - (self._movi_at + 8))
        self._f.write(struct.pack("<4sI", b"00db", self._frame_bytes))
        self._f.write(rows.tobytes())

    def close(self) -> None:
        f = self._f
        if f.closed:
            return
        movi_end = f.tell()
        f.write(struct.pack("<4sI", b"idx1", 16 * len(self._index)))
        for off in self._index:
            f.write(struct.pack("<4sIII", b"00db", _AVIIF_KEYFRAME, off,
                                self._frame_bytes))
        end = f.tell()
        n = len(self._index)
        for at, value in ((4, end - 8), (self._movi_at + 4,
                                          movi_end - self._movi_at - 8),
                          (self._TOTAL_FRAMES_AT, n), (self._LENGTH_AT, n)):
            f.seek(at)
            f.write(struct.pack("<I", value))
        f.close()

    def __enter__(self) -> "AviWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _chunk(tag: bytes, data: bytes) -> bytes:
    """A RIFF chunk: tag, little-endian size, data, padded to even size."""
    return (struct.pack("<4sI", tag, len(data)) + data
            + (b"\0" if len(data) % 2 else b""))


def read_avi(path: str) -> Tuple[np.ndarray, int]:
    """Frames ``[n, H, W, 3]`` uint8 RGB and the frame rate of an AVI
    written by :class:`AviWriter`."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"RIFF" or data[8:12] != b"AVI ":
        raise ValueError(f"{path}: not a RIFF AVI")
    if struct.unpack_from("<I", data, 4)[0] != len(data) - 8:
        raise ValueError(f"{path}: RIFF size does not match the file")
    chunks = {}
    frames, pos, movi = [], 12, None
    while pos < len(data):
        tag, size = struct.unpack_from("<4sI", data, pos)
        if tag == b"LIST":
            if data[pos + 8:pos + 12] == b"movi":
                movi = pos + 8  # idx1 offsets count from here
            pos += 12  # descend into the list
            continue
        body = data[pos + 8:pos + 8 + size]
        if tag == b"00db":
            frames.append(body)
        else:
            chunks[tag] = body
        pos += 8 + size + size % 2
    _, width, height, _, bits, comp = struct.unpack_from("<IiiHHI",
                                                         chunks[b"strf"])
    if bits != 24 or comp != 0 or height >= 0:
        raise ValueError(f"{path}: not top-down 24-bit uncompressed frames")
    height = -height
    total = struct.unpack_from("<I", chunks[b"avih"], 16)[0]
    fps = struct.unpack_from("<I", chunks[b"strh"], 24)[0]
    index = chunks[b"idx1"]
    if total != len(frames) or len(index) != 16 * len(frames):
        raise ValueError(f"{path}: {total} frames in the header, "
                         f"{len(frames)} in the file")
    for i in range(len(frames)):
        off = struct.unpack_from("<I", index, 16 * i + 8)[0]
        if data[movi + off:movi + off + 4] != b"00db":
            raise ValueError(f"{path}: index entry {i} misses its frame")
    stride, _ = _dib_rows(height, width)
    out = np.stack([
        np.frombuffer(b, np.uint8).reshape(height, stride)[:, :3 * width]
        .reshape(height, width, 3)[..., ::-1] for b in frames
    ]) if frames else np.zeros((0, height, width, 3), np.uint8)
    return out, fps


# PNG colour type -> channels, for the 8-bit images the port writes.
_PNG_CHANNELS = {0: 1, 2: 3, 6: 4}


def write_png(path: str, image: np.ndarray) -> None:
    """Write uint8 ``[H, W]`` (grey), ``[H, W, 3]`` (RGB) or ``[H, W, 4]``
    (RGBA) as an 8-bit PNG."""
    data = encode_png(image)
    with open(path, "wb") as f:
        f.write(data)


def encode_png(image: np.ndarray) -> bytes:
    """The bytes of :func:`write_png`'s file."""
    image = np.asarray(image)
    channels = 1 if image.ndim == 2 else image.shape[-1]
    color = {c: t for t, c in _PNG_CHANNELS.items()}.get(channels)
    if image.ndim not in (2, 3) or color is None or image.dtype != np.uint8:
        raise ValueError("image must be uint8 [H, W], [H, W, 3] or "
                         f"[H, W, 4], got {image.dtype} {image.shape}")
    h, w = image.shape[:2]
    raw = np.zeros((h, 1 + channels * w), np.uint8)  # filter type 0 per row
    raw[:, 1:] = image.reshape(h, channels * w)

    def chunk(tag: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body)))

    return (_PNG_SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + chunk(b"IEND", b""))


def read_png(path: str) -> np.ndarray:
    """uint8 ``[H, W]``, ``[H, W, 3]`` or ``[H, W, 4]`` of a PNG written by
    :func:`write_png` (8 bits, no interlace, filter type 0); each chunk's
    CRC is checked."""
    with open(path, "rb") as f:
        data = f.read()
    return decode_png(data, path)


def decode_png(data: bytes, path: str = "PNG") -> np.ndarray:
    """The pixels of :func:`encode_png`'s bytes (see :func:`read_png`);
    ``path`` names the source in errors."""
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG")
    pos, idat, header = 8, b"", None
    while pos < len(data):
        size, tag = struct.unpack_from(">I4s", data, pos)
        body = data[pos + 8:pos + 8 + size]
        if struct.unpack_from(">I", data, pos + 8 + size)[0] != \
                zlib.crc32(tag + body):
            raise ValueError(f"{path}: bad CRC in {tag!r}")
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat += body
        pos += 12 + size
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or color not in _PNG_CHANNELS or interlace:
        raise ValueError(f"{path}: not 8-bit grey, RGB or RGBA without "
                         "interlace")
    channels = _PNG_CHANNELS[color]
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(
        h, 1 + channels * w)
    if raw[:, 0].any():
        raise ValueError(f"{path}: row filters other than 0")
    pixels = raw[:, 1:].reshape(h, w, channels).copy()
    return pixels[..., 0] if channels == 1 else pixels
