"""Minimal PNG codec for greyscale and palette images (zlib + struct only).

The QA dump trees hold one 8-bit greyscale PNG per (round, object, frame)
prob map, and DAVIS and YouTube-VOS annotations are palette PNGs. The JAX
package writes and reads them with PIL, which the port does not use.
:func:`write_gray8`, :func:`write_rgb8` and :func:`write_palette8` (the
overlays and label masks of ``utils/visualize.py``) write filter type 0
(None) on every row;
:func:`read_gray8` reads any non-interlaced 8-bit greyscale PNG and
:func:`read_indexed` any non-interlaced palette PNG at bit depth 1, 2, 4 or
8; both undo all five filter types, since PIL's encoder picks a filter per
row for greyscale images.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(kind: bytes, data: bytes) -> bytes:
    crc = zlib.crc32(kind + data) & 0xFFFFFFFF
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", crc)


def _write(path: str, image: np.ndarray, color_type: int, extra: bytes = b"") -> None:
    """Rows of uint8 samples ([H, W] or [H, W, 3]) under colour type
    ``color_type``, with ``extra`` chunks (PLTE) before the data."""
    h, w = image.shape[:2]
    flat = image.reshape(h, -1)
    rows = np.concatenate([np.zeros((h, 1), np.uint8), flat], axis=1)  # filter byte 0
    header = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    with open(path, "wb") as fp:
        fp.write(_SIGNATURE)
        fp.write(_chunk(b"IHDR", header))
        fp.write(extra)
        fp.write(_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        fp.write(_chunk(b"IEND", b""))


def write_gray8(path: str, image: np.ndarray) -> None:
    """Write a [H, W] uint8 array as an 8-bit greyscale PNG."""
    image = np.asarray(image)
    if image.dtype != np.uint8 or image.ndim != 2:
        raise ValueError(f"need a [H, W] uint8 array, got {image.dtype} {image.shape}")
    _write(path, image, 0)


def write_rgb8(path: str, image: np.ndarray) -> None:
    """Write a [H, W, 3] uint8 array as an 8-bit RGB PNG."""
    image = np.ascontiguousarray(image)
    if image.dtype != np.uint8 or image.ndim != 3 or image.shape[2] != 3:
        raise ValueError(f"need a [H, W, 3] uint8 array, got {image.dtype} {image.shape}")
    _write(path, image, 2)


def write_palette8(path: str, labels: np.ndarray, palette: np.ndarray) -> None:
    """Write [H, W] uint8 palette indices as an 8-bit palette PNG whose
    PLTE holds ``palette`` ([N, 3] uint8, N ≤ 256)."""
    labels = np.asarray(labels)
    palette = np.asarray(palette, dtype=np.uint8)
    if labels.dtype != np.uint8 or labels.ndim != 2:
        raise ValueError(f"need [H, W] uint8 indices, got {labels.dtype} {labels.shape}")
    if palette.ndim != 2 or palette.shape[1] != 3 or not 1 <= len(palette) <= 256:
        raise ValueError(f"need an [N, 3] palette with N ≤ 256, got {palette.shape}")
    _write(path, labels, 3, _chunk(b"PLTE", palette.tobytes()))


def _unfilter(raw: np.ndarray) -> np.ndarray:
    """Undo the row filters of a non-interlaced image of one byte per pixel
    or less: ``raw`` [H, 1 + B] (each row's filter type, then its B bytes)
    → [H, B] uint8. Rows of types None, Sub and Up are undone row by row;
    when any row is Average or Paeth (whose bytes depend on their left
    neighbour through a floor or a choice), the whole image is undone along
    its anti-diagonals, each one vectorised."""
    kinds = raw[:, 0].astype(np.int64)
    data = raw[:, 1:].astype(np.int64)
    h, b = data.shape
    if (kinds > 4).any():
        raise ValueError(f"PNG filter type {int(kinds.max())} is not defined")
    if not np.isin(kinds, (3, 4)).any():
        out = np.zeros((h, b), np.int64)
        prev = np.zeros(b, np.int64)
        for y in range(h):
            row = data[y]
            if kinds[y] == 1:  # Sub: running sum along the row
                row = np.cumsum(row)
            elif kinds[y] == 2:  # Up
                row = row + prev
            prev = out[y] = row & 0xFF
        return out.astype(np.uint8)
    # byte (y, x) needs (y, x - 1), (y - 1, x) and (y - 1, x - 1): all lie on
    # earlier anti-diagonals y + x; a zero row above and a zero column left
    out = np.zeros((h + 1, b + 1), np.int64)
    for d in range(h + b - 1):
        ys = np.arange(max(0, d - b + 1), min(h, d + 1))
        xs = d - ys
        a, up, c = out[ys + 1, xs], out[ys, xs + 1], out[ys, xs]
        k = kinds[ys]
        p = a + up - c
        pa, pb, pc = np.abs(p - a), np.abs(p - up), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, up, c))
        pred = np.select([k == 1, k == 2, k == 3, k == 4], [a, up, (a + up) >> 1, paeth], 0)
        out[ys + 1, xs + 1] = (data[ys, xs] + pred) & 0xFF
    return out[1:, 1:].astype(np.uint8)


def _read_chunks(path: str):
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
    return header, b"".join(idat)


def read_indexed(path: str) -> np.ndarray:
    """Read a non-interlaced palette PNG (colour type 3, bit depth 1, 2, 4
    or 8) → its palette indices [H, W] uint8, as
    ``np.array(Image.open(path))`` (PLTE and tRNS are not read); an 8-bit
    greyscale PNG reads as :func:`read_gray8`. Anything else raises."""
    (w, h, depth, color, _, _, interlace), idat = _read_chunks(path)
    greyscale = (depth, color, interlace) == (8, 0, 0)
    if not greyscale and (color != 3 or depth not in (1, 2, 4, 8) or interlace):
        raise ValueError(
            f"{path}: bit depth {depth}, colour type {color}, interlace {interlace}; "
            "only non-interlaced palette PNGs (depth 1, 2, 4, 8) and 8-bit greyscale are read"
        )
    row_bytes = (w * depth + 7) // 8
    raw = np.frombuffer(zlib.decompress(idat), dtype=np.uint8)
    packed = _unfilter(raw[: h * (row_bytes + 1)].reshape(h, row_bytes + 1))
    if depth == 8:
        return packed
    per = 8 // depth
    shifts = (8 - depth * (np.arange(per) + 1)).astype(np.uint8)
    unpacked = (packed[:, :, None] >> shifts) & ((1 << depth) - 1)
    return unpacked.reshape(h, row_bytes * per)[:, :w].astype(np.uint8)


def read_gray8(path: str) -> np.ndarray:
    """Read a non-interlaced 8-bit greyscale PNG → [H, W] uint8."""
    (w, h, depth, color, _, _, interlace), idat = _read_chunks(path)
    if (depth, color, interlace) != (8, 0, 0):
        raise ValueError(
            f"{path}: bit depth {depth}, colour type {color}, interlace {interlace}; "
            "only non-interlaced 8-bit greyscale is read"
        )
    raw = np.frombuffer(zlib.decompress(idat), dtype=np.uint8)
    return _unfilter(raw[: h * (w + 1)].reshape(h, w + 1))
