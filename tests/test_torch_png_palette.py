"""The port's palette PNG reader (``ivosw_tpu_torch/data/png.py``) against
``np.array(Image.open(f))``, which the JAX package's registry reads
annotations with: palette files at bit depths 1, 2, 4 and 8 as PIL writes
them, the committed annotations, every filter type, and the files it
refuses. Bound: 0."""

import glob
import os
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from ivosw_tpu_torch.data.png import _SIGNATURE, _chunk, read_gray8, read_indexed
from torch_dataset_trees import YTBVOS_DST, ytbvos_sequences


def _palette_png(path, labels, colours, **kw):
    p = Image.fromarray(labels, mode="P")
    p.putpalette([v for c in range(colours) for v in (c, 255 - c, c // 2)])
    p.save(path, **kw)
    return path


def _depth(path):
    with open(path, "rb") as fp:
        return fp.read(25)[24]


# colours in the palette → the bit depth this PIL writes
DEPTHS = [(2, 1), (3, 2), (4, 2), (5, 4), (16, 4), (17, 8), (256, 8)]


@pytest.mark.parametrize("optimize", [False, True], ids=["plain", "optimize"])
@pytest.mark.parametrize("colours,depth", DEPTHS)
@pytest.mark.parametrize("shape", [(40, 57), (1, 9), (13, 1), (480, 854)])
def test_palette_png_reads_as_pil(tmp_path, colours, depth, optimize, shape):
    labels = np.random.default_rng(colours).integers(0, colours, shape).astype(np.uint8)
    path = _palette_png(str(tmp_path / "a.png"), labels, colours, optimize=optimize)
    assert _depth(path) == depth
    got = read_indexed(path)
    assert got.dtype == np.uint8 and np.array_equal(got, np.array(Image.open(path)))
    assert np.array_equal(got, labels)


@pytest.mark.parametrize("bits", [1, 2, 4])
def test_palette_png_at_a_given_depth(tmp_path, bits):
    labels = np.random.default_rng(bits).integers(0, 2**bits, (31, 45)).astype(np.uint8)
    path = _palette_png(str(tmp_path / "b.png"), labels, 256, bits=bits)
    assert _depth(path) == bits
    assert np.array_equal(read_indexed(path), np.array(Image.open(path)))


@pytest.mark.parametrize("sequence", ytbvos_sequences())
def test_committed_annotations_read_as_pil(sequence):
    files = sorted(glob.glob(os.path.join(YTBVOS_DST, "Annotations", "480p", sequence, "*.png")))
    assert len(files) == 48
    for f in files:
        assert np.array_equal(read_indexed(f), np.array(Image.open(f))), f


def _write_filtered(path, image, kinds, color=0, depth=8):
    """A PNG whose rows use the given filter types (one byte per pixel)."""
    h, w = image.shape
    rows, prev = [], np.zeros(w, np.int64)
    for y in range(h):
        x = image[y].astype(np.int64)
        a = np.concatenate([[0], x[:-1]])
        c = np.concatenate([[0], prev[:-1]])
        b, k = prev, kinds[y]
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        pred = [0, a, b, (a + b) >> 1,
                np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))][k]
        rows.append(np.concatenate([[k], (x - pred) & 255]).astype(np.uint8))
        prev = x
    with open(path, "wb") as fp:
        fp.write(_SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, 0)))
        if color == 3:
            fp.write(_chunk(b"PLTE", bytes(range(256)) * 3))
        fp.write(_chunk(b"IDAT", zlib.compress(np.stack(rows).tobytes())))
        fp.write(_chunk(b"IEND", b""))
    return path


@pytest.mark.parametrize("color", [0, 3], ids=["grey", "palette"])
@pytest.mark.parametrize("kinds", ["all", "sub-up", "average", "paeth"])
@pytest.mark.parametrize("shape", [(37, 53), (1, 5), (480, 854)])
def test_every_filter_type(tmp_path, kinds, color, shape):
    rng = np.random.default_rng(7)
    image = (rng.random(shape) * 255).astype(np.uint8)
    choice = {"all": [0, 1, 2, 3, 4], "sub-up": [0, 1, 2], "average": [3], "paeth": [4]}[kinds]
    path = _write_filtered(str(tmp_path / "f.png"), image, rng.choice(choice, shape[0]), color)
    got = read_indexed(path)
    assert np.array_equal(got, np.array(Image.open(path))) and np.array_equal(got, image)
    if color == 0:
        assert np.array_equal(read_gray8(path), image)
    else:
        with pytest.raises(ValueError, match="colour type 3"):
            read_gray8(path)


def test_greyscale_png_reads_as_before(tmp_path):
    """An 8-bit greyscale file as PIL writes it reads as its values through
    both readers (``read_indexed`` takes it like PIL's ``.convert("P")``
    of an ``L`` image)."""
    image = (np.random.default_rng(3).random((40, 57)) * 255).astype(np.uint8)
    Image.fromarray(image).save(tmp_path / "g.png")
    assert np.array_equal(read_gray8(str(tmp_path / "g.png")), image)
    assert np.array_equal(read_indexed(str(tmp_path / "g.png")), image)


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "I;16", "interlaced", "1"])
def test_other_pngs_raise(tmp_path, mode):
    path = str(tmp_path / "x.png")
    image = np.random.default_rng(0).integers(0, 255, (8, 8, 4)).astype(np.uint8)
    if mode == "interlaced":
        _write_filtered(path, image[..., 0], [0] * 8, color=3)
        data = bytearray(open(path, "rb").read())
        data[28] = 1  # IHDR interlace method (the CRC is not checked)
        open(path, "wb").write(bytes(data))
    elif mode == "I;16":
        Image.fromarray(image[..., 0].astype(np.uint16) * 257).save(path)
    elif mode == "1":
        Image.fromarray(image[..., 0] > 128).save(path)
    else:
        Image.fromarray(image[..., : len(mode)]).save(path)
    with pytest.raises(ValueError, match="x.png: bit depth"):
        read_indexed(path)
