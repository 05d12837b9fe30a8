"""Baseline JPEG decoder in numpy, bit-equal to libjpeg's default decode.

The JAX package reads DAVIS and YouTube-VOS frames with
``Image.open(f).convert("RGB")`` (libjpeg-turbo underneath), which the port
does not use. :func:`read_rgb` gives the same pixels, bit for bit, for the
files those datasets hold: baseline (SOF0) and extended sequential Huffman
(SOF1) 8-bit JPEGs with one (greyscale) or three (YCbCr) components in one
scan, 4:4:4, 4:2:2 or 4:2:0, with or without restart markers, and with the
Annex K or optimised Huffman tables. It follows libjpeg's default
decompression step by step:

- entropy decoding with a bit reservoir (a 32-bit window at every bit
  position of the unstuffed scan) and one lookup table per Huffman table
  that resolves the code and, where it fits in 16 bits, the coefficient;
  the DC predictors reset at every restart marker;
- dequantisation in zig-zag order and ``jidctint.c``'s ``jpeg_idct_islow``
  (CONST_BITS 13, PASS1_BITS 2, the +128 and the 1024-entry range limit),
  over all blocks of a component at once;
- ``jdsample.c``'s fancy upsampling (the triangle filter with its rounding
  biases; edge rows and columns are their own neighbours; plain replication
  for a component at most 2 samples wide);
- ``jdcolor.c``'s fixed-point YCbCr→RGB tables (SCALEBITS 16), then the
  crop of the MCU padding.

Progressive, lossless, arithmetic-coded, 12-bit, multi-scan, RGB- or
CMYK-coded (Adobe) and 4-component files raise ``ValueError`` naming the
file and the marker.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Dict, List, Tuple

import numpy as np

# jpeg_natural_order: the natural (row-major) index of the k-th coefficient
# in zig-zag order
NATURAL_ORDER = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
])

_SOF_NAMES = {
    0xC2: "SOF2 (progressive)", 0xC3: "SOF3 (lossless)",
    0xC5: "SOF5 (differential sequential)", 0xC6: "SOF6 (differential progressive)",
    0xC7: "SOF7 (differential lossless)", 0xC9: "SOF9 (arithmetic sequential)",
    0xCA: "SOF10 (arithmetic progressive)", 0xCB: "SOF11 (arithmetic lossless)",
    0xCD: "SOF13 (arithmetic differential)", 0xCE: "SOF14 (arithmetic differential)",
    0xCF: "SOF15 (arithmetic differential)", 0xCC: "DAC (arithmetic coding)",
}

# jidctint.c constants (CONST_BITS 13)
CONST_BITS, PASS1_BITS = 13, 2
FIX_0_298631336, FIX_0_390180644, FIX_0_541196100 = 2446, 3196, 4433
FIX_0_765366865, FIX_0_899976223, FIX_1_175875602 = 6270, 7373, 9633
FIX_1_501321110, FIX_1_847759065, FIX_1_961570560 = 12299, 15137, 16069
FIX_2_053119869, FIX_2_562915447, FIX_3_072711026 = 16819, 20995, 25172


def _range_limit_table() -> np.ndarray:
    """``range_limit[x & 1023]`` of ``jidctint.c`` (``jdmaster.c``'s
    ``prepare_range_limit_table`` seen from ``IDCT_range_limit``): x + 128
    clamped to [0, 255] for x in [-512, 511], wrapping beyond."""
    x = np.arange(1024)
    x = np.where(x < 512, x, x - 1024)
    return np.clip(x + 128, 0, 255).astype(np.int64)


_RANGE_LIMIT = _range_limit_table()


def _ycc_tables():
    """``jdcolor.c``'s ``build_ycc_rgb_table`` (SCALEBITS 16)."""
    one_half = 1 << 15
    fix = lambda v: int(v * (1 << 16) + 0.5)  # noqa: E731
    x = np.arange(256, dtype=np.int64) - 128
    cr_r = (fix(1.40200) * x + one_half) >> 16
    cb_b = (fix(1.77200) * x + one_half) >> 16
    cr_g = -fix(0.71414) * x
    cb_g = -fix(0.34414) * x + one_half
    return cr_r, cb_b, cr_g, cb_g


_CR_R, _CB_B, _CR_G, _CB_G = _ycc_tables()


# ----------------------------------------------------------------- markers --
def _marker_at(data: bytes, pos: int, name: str):
    """The marker segment at ``pos`` → (marker, payload offset, payload
    length, offset of what follows)."""
    n = len(data)
    if pos >= n or data[pos] != 0xFF:
        raise ValueError(f"{name}: expected a marker at byte {pos}")
    while pos < n and data[pos] == 0xFF:  # fill bytes
        pos += 1
    if pos >= n:
        raise ValueError(f"{name}: truncated before EOI")
    marker = data[pos]
    pos += 1
    if marker == 0xD9 or 0xD0 <= marker <= 0xD7 or marker == 0x01:
        return marker, pos, 0, pos
    length = (data[pos] << 8) | data[pos + 1]
    return marker, pos + 2, length - 2, pos + length


def _check_soi(data: bytes, name: str) -> None:
    if data[:2] != b"\xff\xd8":
        raise ValueError(f"{name}: not a JPEG file (no SOI marker)")


def image_size(path: str) -> Tuple[int, int]:
    """(width, height) from the frame header alone, as PIL's ``im.size``."""
    with open(path, "rb") as fp:
        data = fp.read()
    _check_soi(data, path)
    pos = 2
    while True:
        marker, off, length, pos = _marker_at(data, pos, path)
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            return (data[off + 3] << 8) | data[off + 4], (data[off + 1] << 8) | data[off + 2]
        if marker in (0xDA, 0xD9):
            raise ValueError(f"{path}: no frame header before the scan")


# ----------------------------------------------------------------- Huffman --
def _canonical_codes(counts: bytes, values: bytes):
    """(code, length, symbol) of a DHT table (JPEG Annex C)."""
    codes, code, k = [], 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            codes.append((code, length, values[k]))
            code += 1
            k += 1
        code <<= 1
    return codes


@lru_cache(maxsize=64)
def _dc_table(counts: bytes, values: bytes) -> Tuple[Tuple[int, int], ...]:
    """16-bit lookahead → (code length, category); length 0 marks a code
    that is not in the table."""
    n = np.zeros(1 << 16, np.int64)
    s = np.zeros(1 << 16, np.int64)
    for code, length, sym in _canonical_codes(counts, values):
        lo = code << (16 - length)
        hi = (code + 1) << (16 - length)
        n[lo:hi], s[lo:hi] = length, sym
    return tuple(zip(n.tolist(), s.tolist()))


@lru_cache(maxsize=64)
def _ac_table(counts: bytes, values: bytes) -> Tuple[Tuple[int, int, int], ...]:
    """16-bit lookahead → (bits, run, value). Where the code and its extra
    bits fit in 16 bits, ``bits`` is their total and ``value`` the
    coefficient; else ``bits`` is minus the code length and ``value`` the
    number of extra bits. EOB has run 64, ZRL run 15 and value 0; length 0
    marks a code that is not in the table."""
    idx = np.arange(1 << 16, dtype=np.int64)
    n = np.zeros(1 << 16, np.int64)
    r = np.zeros(1 << 16, np.int64)
    v = np.zeros(1 << 16, np.int64)
    for code, length, sym in _canonical_codes(counts, values):
        lo = code << (16 - length)
        hi = (code + 1) << (16 - length)
        run, size = sym >> 4, sym & 15
        if size == 0:  # EOB (0x00) or ZRL (0xF0)
            n[lo:hi], r[lo:hi], v[lo:hi] = length, (15 if run == 15 else 64), 0
        elif length + size <= 16:
            extra = (idx[lo:hi] >> (16 - length - size)) & ((1 << size) - 1)
            n[lo:hi], r[lo:hi] = length + size, run
            v[lo:hi] = np.where(extra < (1 << (size - 1)), extra - ((1 << size) - 1), extra)
        else:
            n[lo:hi], r[lo:hi], v[lo:hi] = -length, run, size
    return tuple(zip(n.tolist(), r.tolist(), v.tolist()))


def _scan_data(data: bytes, start: int, name: str):
    """The entropy-coded data from ``start`` to the next marker other than
    RSTn, unstuffed, as one buffer (each restart interval starts on a byte
    boundary) → (32-bit window at every bit position, start bit of each
    interval, end offset in ``data``)."""
    buf = np.frombuffer(data, np.uint8)
    ff = np.flatnonzero(buf[start:-1] == 0xFF) + start
    nxt = buf[ff + 1]
    ends = ff[(nxt != 0) & (nxt != 0xFF) & ((nxt < 0xD0) | (nxt > 0xD7))]
    end = int(ends[0]) if len(ends) else len(buf)
    keep = ff < end
    ff, nxt = ff[keep], nxt[keep]
    drop = np.zeros(end - start, bool)
    drop[ff[nxt == 0] + 1 - start] = True  # stuffed zero after FF
    drop[ff[nxt == 0xFF] - start] = True  # fill byte before a marker
    rst = ff[(nxt >= 0xD0) & (nxt <= 0xD7)]
    drop[rst - start] = True
    drop[rst + 1 - start] = True
    seg = buf[start:end]
    # interval starts in the unstuffed buffer: the bytes kept before each RSTn
    kept_before = np.cumsum(~drop) - (~drop)
    starts = [0] + [int(kept_before[p - start]) * 8 for p in rst]
    body = np.concatenate([seg[~drop], np.zeros(8, np.uint8)]).astype(np.uint64)
    m = len(body) - 4
    v40 = (body[:m] << 32) | (body[1:m + 1] << 24) | (body[2:m + 2] << 16) \
        | (body[3:m + 3] << 8) | body[4:m + 4]
    shifts = np.arange(8, 0, -1, dtype=np.uint64)
    win = ((v40[:, None] >> shifts) & np.uint64(0xFFFFFFFF)).astype(np.uint32).ravel()
    return memoryview(win), starts, end


def _decode_scan(win, starts, mcu_spec, bases, n_mcu, restart, total, name):
    """The serial stage: Huffman-decode every block of the scan into a flat
    zig-zag coefficient array of ``total`` entries. ``mcu_spec`` lists each
    block slot of an MCU as (component, DC table, AC table); ``bases`` the
    flat offset of every block in scan order."""
    # each coefficient as one int: (flat index << 16) | (value & 0xFFFF)
    found: List[int] = []
    put = found.append
    pred = [0] * 4
    pos = 0
    interval = 0
    b = 0
    for mcu in range(n_mcu):
        if restart and mcu and mcu % restart == 0:
            interval += 1
            if interval >= len(starts):
                raise ValueError(f"{name}: missing restart marker at MCU {mcu}")
            pos = starts[interval]
            pred = [0] * 4
        for comp, dct, act in mcu_spec:
            base = bases[b]
            b += 1
            w = win[pos]
            n, s = dct[w >> 16]
            if n == 0:
                raise ValueError(f"{name}: bad DC Huffman code at MCU {mcu}")
            if s:
                e = (w >> (32 - n - s)) & ((1 << s) - 1)
                if e < (1 << (s - 1)):
                    e -= (1 << s) - 1
                pred[comp] += e
                pos += n + s
            else:
                pos += n
            put((base << 16) | (pred[comp] & 0xFFFF))
            k = 1
            while k < 64:
                w = win[pos]
                n, r, e = act[w >> 16]
                if n > 0:
                    pos += n
                elif n < 0:
                    n, s = -n, e
                    e = (w >> (32 - n - s)) & ((1 << s) - 1)
                    if e < (1 << (s - 1)):
                        e -= (1 << s) - 1
                    pos += n + s
                else:
                    raise ValueError(f"{name}: bad AC Huffman code at MCU {mcu}")
                k += r
                if k >= 64:
                    break
                if e:
                    put(((base + k) << 16) | (e & 0xFFFF))
                k += 1
    packed = np.asarray(found, np.int64)
    value = packed & 0xFFFF
    coef = np.zeros(total, np.int64)
    coef[packed >> 16] = np.where(value >= 0x8000, value - 0x10000, value)
    return coef


# --------------------------------------------------------------------- IDCT --
def _descale(x, n):
    return (x + (1 << (n - 1))) >> n


def idct_islow(coef: np.ndarray) -> np.ndarray:
    """``jpeg_idct_islow`` over blocks: dequantised coefficients [N, 8, 8]
    (natural order, int) → samples [N, 8, 8] in [0, 255]."""
    c = coef.astype(np.int64)

    def one_pass(x0, x1, x2, x3, x4, x5, x6, x7):
        z1 = (x2 + x6) * FIX_0_541196100
        tmp2 = z1 + x6 * -FIX_1_847759065
        tmp3 = z1 + x2 * FIX_0_765366865
        tmp0 = (x0 + x4) << CONST_BITS
        tmp1 = (x0 - x4) << CONST_BITS
        tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
        tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
        t0, t1, t2, t3 = x7, x5, x3, x1
        z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
        z5 = (z3 + z4) * FIX_1_175875602
        t0 = t0 * FIX_0_298631336
        t1 = t1 * FIX_2_053119869
        t2 = t2 * FIX_3_072711026
        t3 = t3 * FIX_1_501321110
        z1 = z1 * -FIX_0_899976223
        z2 = z2 * -FIX_2_562915447
        z3 = z3 * -FIX_1_961570560 + z5
        z4 = z4 * -FIX_0_390180644 + z5
        t0 = t0 + z1 + z3
        t1 = t1 + z2 + z4
        t2 = t2 + z2 + z3
        t3 = t3 + z1 + z4
        return (tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
                tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3)

    # pass 1: columns (rows of the coefficient block index the frequency)
    cols = one_pass(*(c[:, r, :] for r in range(8)))
    ws = np.stack([_descale(v, CONST_BITS - PASS1_BITS) for v in cols], axis=1)
    # pass 2: rows
    rows = one_pass(*(ws[:, :, k] for k in range(8)))
    out = np.stack([_descale(v, CONST_BITS + PASS1_BITS + 3) for v in rows], axis=2)
    return _RANGE_LIMIT[out & 1023]


# --------------------------------------------------------------- upsampling --
def _fancy_h2v1(x: np.ndarray) -> np.ndarray:
    """``h2v1_fancy_upsample`` on rows [H, w] (w > 2) → [H, 2w]."""
    x = x.astype(np.int64)
    left = np.concatenate([x[:, :1], x[:, :-1]], axis=1)
    right = np.concatenate([x[:, 1:], x[:, -1:]], axis=1)
    even = (3 * x + left + 1) >> 2
    odd = (3 * x + right + 2) >> 2
    even[:, 0] = x[:, 0]
    odd[:, -1] = x[:, -1]
    return np.stack([even, odd], axis=2).reshape(x.shape[0], -1)


def _fancy_h2v2(x: np.ndarray) -> np.ndarray:
    """``h2v2_fancy_upsample`` on a plane [h, w] (w > 2) → [2h, 2w]; the
    first and last rows are their own neighbours (``jdmainct.c``)."""
    x = x.astype(np.int64)
    above = np.concatenate([x[:1], x[:-1]], axis=0)
    below = np.concatenate([x[1:], x[-1:]], axis=0)
    out = []
    for other in (above, below):
        cs = 3 * x + other  # column sums
        last = np.concatenate([cs[:, :1], cs[:, :-1]], axis=1)
        nxt = np.concatenate([cs[:, 1:], cs[:, -1:]], axis=1)
        even = (3 * cs + last + 8) >> 4
        odd = (3 * cs + nxt + 7) >> 4
        even[:, 0] = (cs[:, 0] * 4 + 8) >> 4
        odd[:, -1] = (cs[:, -1] * 4 + 7) >> 4
        out.append(np.stack([even, odd], axis=2).reshape(x.shape[0], -1))
    return np.stack(out, axis=1).reshape(2 * x.shape[0], -1)


def _upsample(plane: np.ndarray, hf: int, vf: int) -> np.ndarray:
    """``jdsample.c``'s choice for a component at (hf, vf) times less
    resolution than the image: fancy for 2×1 and 2×2 wider than 2 samples,
    else plain replication."""
    if (hf, vf) == (1, 1):
        return plane
    if plane.shape[1] > 2 and (hf, vf) == (2, 1):
        return _fancy_h2v1(plane)
    if plane.shape[1] > 2 and (hf, vf) == (2, 2):
        return _fancy_h2v2(plane)
    return np.repeat(np.repeat(plane, vf, axis=0), hf, axis=1)


# ------------------------------------------------------------------ decoder --
def decode(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """A JPEG file's bytes → [H, W, 3] uint8 RGB (a greyscale file's plane
    repeated, as ``.convert("RGB")``)."""
    qt: Dict[int, np.ndarray] = {}
    dc_tabs: Dict[int, Tuple[bytes, bytes]] = {}
    ac_tabs: Dict[int, Tuple[bytes, bytes]] = {}
    restart = 0
    frame = None
    adobe = None
    image = None
    _check_soi(data, name)
    pos = 2
    while True:
        marker, off, length, pos = _marker_at(data, pos, name)
        body = data[off:off + length]
        if marker in _SOF_NAMES:
            raise ValueError(f"{name}: {_SOF_NAMES[marker]} is not decoded; only baseline "
                             "and extended sequential Huffman (SOF0/SOF1) are")
        if marker in (0xC0, 0xC1):
            precision = body[0]
            h, w, nf = (body[1] << 8) | body[2], (body[3] << 8) | body[4], body[5]
            sof = f"SOF{marker - 0xC0}"
            if precision != 8:
                raise ValueError(f"{name}: {sof} with {precision}-bit samples; only 8-bit")
            if nf not in (1, 3):
                raise ValueError(f"{name}: {sof} with {nf} components; only 1 or 3")
            if h == 0 or w == 0:
                raise ValueError(f"{name}: {sof} with height {h}, width {w} (DNL not read)")
            comps = [(body[6 + 3 * i], body[7 + 3 * i] >> 4, body[7 + 3 * i] & 15,
                      body[8 + 3 * i]) for i in range(nf)]
            hmax, vmax = max(c[1] for c in comps), max(c[2] for c in comps)
            if any(not 1 <= c[1] <= 4 or not 1 <= c[2] <= 4 or hmax % c[1] or vmax % c[2]
                   for c in comps):
                raise ValueError(f"{name}: {sof} sampling factors "
                                 f"{[(c[1], c[2]) for c in comps]} are not decoded")
            frame = (sof, h, w, comps)
        elif marker == 0xC4:
            p = 0
            while p < length:
                tc, th = body[p] >> 4, body[p] & 15
                counts = bytes(body[p + 1:p + 17])
                k = sum(counts)
                (dc_tabs if tc == 0 else ac_tabs)[th] = (counts, bytes(body[p + 17:p + 17 + k]))
                p += 17 + k
        elif marker == 0xDB:
            p = 0
            while p < length:
                pq, tq = body[p] >> 4, body[p] & 15
                if pq == 0:
                    q = np.frombuffer(body[p + 1:p + 65], np.uint8).astype(np.int64)
                    p += 65
                else:
                    q = np.frombuffer(body[p + 1:p + 129], ">u2").astype(np.int64)
                    p += 129
                qt[tq] = q
        elif marker == 0xDD:
            restart = (body[0] << 8) | body[1]
        elif marker == 0xEE and body[:5] == b"Adobe":
            adobe = body[11] if length >= 12 else None
        elif marker == 0xDA:
            if image is not None:
                raise ValueError(f"{name}: a second scan (multi-scan JPEG) is not decoded")
            if frame is None:
                raise ValueError(f"{name}: SOS before the frame header")
            image, pos = _read_scan(data, off, length, frame, qt, dc_tabs, ac_tabs,
                                     restart, adobe, name)
        elif marker == 0xD9:
            break
        if pos >= len(data):
            break
    if image is None:
        raise ValueError(f"{name}: no scan")
    return image


def _read_scan(data, off, length, frame, qt, dc_tabs, ac_tabs, restart, adobe, name):
    sof, h, w, comps = frame
    body = data[off:off + length]
    ns = body[0]
    sel = [(body[1 + 2 * i], body[2 + 2 * i] >> 4, body[2 + 2 * i] & 15) for i in range(ns)]
    if ns != len(comps):
        raise ValueError(f"{name}: {sof} scan holds {ns} of {len(comps)} components "
                         "(multi-scan JPEG)")
    if len(comps) == 3:
        ids = tuple(c[0] for c in comps)
        if (adobe is not None and adobe != 1) or (adobe is None and ids == (82, 71, 66)):
            raise ValueError(f"{name}: {sof} RGB-coded (Adobe transform {adobe}), not YCbCr")
    hmax = max(c[1] for c in comps)
    vmax = max(c[2] for c in comps)
    # component sizes in samples, and in blocks as stored (whole MCUs)
    dims = [(-(-h * c[2] // vmax), -(-w * c[1] // hmax)) for c in comps]
    if ns == 1:
        bh, bw = -(-dims[0][0] // 8), -(-dims[0][1] // 8)
        blocks = [(bh, bw)]
        n_mcu, mcus_x = bh * bw, bw
    else:
        mcus_y, mcus_x = -(-h // (8 * vmax)), -(-w // (8 * hmax))
        blocks = [(mcus_y * c[2], mcus_x * c[1]) for c in comps]
        n_mcu = mcus_y * mcus_x
    offsets = np.cumsum([0] + [bh * bw * 64 for bh, bw in blocks])
    order = {c[0]: i for i, c in enumerate(comps)}
    mcu_spec, slot_base = [], []
    mcu = np.arange(n_mcu)
    my, mx = mcu // mcus_x, mcu % mcus_x
    for cid, td, ta in sel:
        i = order[cid]
        if td not in dc_tabs or ta not in ac_tabs:
            raise ValueError(f"{name}: scan names an undefined Huffman table")
        hi, vi = (1, 1) if ns == 1 else (comps[i][1], comps[i][2])
        dct, act = _dc_table(*dc_tabs[td]), _ac_table(*ac_tabs[ta])
        for by in range(vi):
            for bx in range(hi):
                mcu_spec.append((i, dct, act))
                row, col = my * vi + by, mx * hi + bx
                slot_base.append(offsets[i] + (row * blocks[i][1] + col) * 64)
    bases = np.stack(slot_base, axis=1).ravel().tolist()
    win, starts, end = _scan_data(data, off + length, name)
    try:
        coef = _decode_scan(win, starts, mcu_spec, bases, n_mcu, restart, int(offsets[-1]),
                            name)
    except IndexError:
        raise ValueError(f"{name}: the scan's data ends before its last block") from None

    out = []
    for i, (cid, hs, vs, tq) in enumerate(comps):
        if tq not in qt:
            raise ValueError(f"{name}: component {cid} names undefined table {tq}")
        bh, bw = blocks[i]
        zz = coef[offsets[i]:offsets[i + 1]].reshape(-1, 64) * qt[tq][None, :]
        nat = np.zeros_like(zz)
        nat[:, NATURAL_ORDER] = zz
        px = idct_islow(nat.reshape(-1, 8, 8))
        plane = px.reshape(bh, bw, 8, 8).transpose(0, 2, 1, 3).reshape(bh * 8, bw * 8)
        plane = plane[:dims[i][0], :dims[i][1]]
        out.append(_upsample(plane, hmax // hs, vmax // vs)[:h, :w])
    if len(out) == 1:
        y = out[0].astype(np.uint8)
        return np.repeat(y[:, :, None], 3, axis=2), end
    y, cb, cr = out
    r = y + _CR_R[cr]
    g = y + ((_CB_G[cb] + _CR_G[cr]) >> 16)
    b = y + _CB_B[cb]
    return np.clip(np.stack([r, g, b], axis=2), 0, 255).astype(np.uint8), end


def read_rgb(path: str) -> np.ndarray:
    """A JPEG file → [H, W, 3] uint8 RGB, as ``Image.open(path).convert("RGB")``."""
    with open(path, "rb") as fp:
        return decode(fp.read(), path)
