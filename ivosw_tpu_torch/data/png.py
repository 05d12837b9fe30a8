"""Minimal PNG codec for 8-bit greyscale images (zlib + struct only).

The QA dump trees hold one 8-bit greyscale PNG per (round, object, frame)
prob map. The JAX package writes and reads them with PIL, which the port
does not use. :func:`write_gray8` writes filter type 0 (None) on every row;
:func:`read_gray8` reads any non-interlaced 8-bit greyscale PNG and undoes
all five filter types, since PIL's encoder picks a filter per row.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(kind: bytes, data: bytes) -> bytes:
    crc = zlib.crc32(kind + data) & 0xFFFFFFFF
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", crc)


def write_gray8(path: str, image: np.ndarray) -> None:
    """Write a [H, W] uint8 array as an 8-bit greyscale PNG."""
    image = np.asarray(image)
    if image.dtype != np.uint8 or image.ndim != 2:
        raise ValueError(f"need a [H, W] uint8 array, got {image.dtype} {image.shape}")
    h, w = image.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), image], axis=1)  # filter byte 0
    header = struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0)
    with open(path, "wb") as fp:
        fp.write(_SIGNATURE)
        fp.write(_chunk(b"IHDR", header))
        fp.write(_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        fp.write(_chunk(b"IEND", b""))


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter_row(kind: int, row: np.ndarray, prev: np.ndarray) -> np.ndarray:
    """Undo one row's filter (one byte per pixel); arithmetic modulo 256."""
    if kind == 0:
        return row
    if kind == 1:  # Sub: running sum along the row
        return (np.cumsum(row, dtype=np.uint64) & 0xFF).astype(np.uint8)
    if kind == 2:  # Up
        return row + prev  # uint8 wraps modulo 256
    out = [0] * len(row)
    left = 0
    up = prev.tolist()
    for x, v in enumerate(row.tolist()):
        if kind == 3:  # Average
            left = (v + ((left + up[x]) >> 1)) & 0xFF
        elif kind == 4:  # Paeth
            left = (v + _paeth(left, up[x], up[x - 1] if x else 0)) & 0xFF
        else:
            raise ValueError(f"PNG filter type {kind} is not defined")
        out[x] = left
    return np.asarray(out, dtype=np.uint8)


def read_gray8(path: str) -> np.ndarray:
    """Read a non-interlaced 8-bit greyscale PNG → [H, W] uint8."""
    with open(path, "rb") as fp:
        data = fp.read()
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, header = 8, [], None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        kind = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, color, _, _, interlace = header
    if (depth, color, interlace) != (8, 0, 0):
        raise ValueError(
            f"{path}: bit depth {depth}, colour type {color}, interlace {interlace}; "
            "only non-interlaced 8-bit greyscale is read"
        )
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), dtype=np.uint8)
    raw = raw.reshape(h, w + 1)
    out = np.empty((h, w), dtype=np.uint8)
    prev = np.zeros(w, dtype=np.uint8)
    for y in range(h):
        prev = out[y] = _unfilter_row(int(raw[y, 0]), raw[y, 1:], prev)
    return out
