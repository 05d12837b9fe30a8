"""The port's baseline JPEG decoder (``ivosw_tpu_torch/data/jpeg.py``)
against PIL (libjpeg-turbo), bit for bit: ``Image.open(f).convert("RGB")``
is what the JAX package's registry reads frames with. Bound: 0 on every
case. Also the chip phase's JPEG encoder (``chip_smoke.py::encode_jpeg``):
its tables are libjpeg's, and PIL's decode of its bytes gives the digest
that ``chip_smoke.py`` holds the card machine's decode to."""

import glob
import hashlib
import io
import os
import sys

import numpy as np
import pytest
from PIL import Image

from ivosw_tpu_torch.data import jpeg
from torch_dataset_trees import REPO, YTBVOS_DST, ytbvos_sequences

sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402


def _image(kind, shape, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "noise":
        return (rng.random(shape) * 255).astype(np.uint8)
    yy, xx = np.mgrid[0:shape[0], 0:shape[1]]
    grad = np.stack([yy * 5 + xx, xx * 4, (yy + xx) * 2 + 7], axis=-1)
    return (grad % 256).astype(np.uint8)[..., : shape[2] if len(shape) > 2 else 1].squeeze()


def _encode(img, **kw):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", **kw)
    return buf.getvalue()


def _assert_decodes_as_pil(data):
    ref = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    got = jpeg.decode(data)
    assert got.dtype == np.uint8 and got.shape == ref.shape
    diff = np.abs(got.astype(np.int64) - ref)
    assert diff.max() == 0, (int(diff.max()), int((diff > 0).sum()))


@pytest.mark.parametrize("subsampling", [0, 1, 2], ids=["444", "422", "420"])
@pytest.mark.parametrize("quality", [50, 75, 95, 100])
@pytest.mark.parametrize("kind", ["noise", "gradient"])
def test_decoder_matches_pil(kind, quality, subsampling):
    _assert_decodes_as_pil(_encode(_image(kind, (48, 64, 3)), quality=quality,
                                   subsampling=subsampling))


CASES = {
    "greyscale": (lambda: _image("noise", (48, 64)), {}),
    "odd-37x53": (lambda: _image("noise", (37, 53, 3)), {"quality": 90}),
    "odd-37x53-422": (lambda: _image("noise", (37, 53, 3)), {"subsampling": 1}),
    "odd-37x53-444": (lambda: _image("gradient", (37, 53, 3)), {"subsampling": 0}),
    "17x1": (lambda: _image("noise", (17, 1, 3)), {"quality": 90}),
    "1x17": (lambda: _image("noise", (1, 17, 3)), {"quality": 90}),
    "3x5-420": (lambda: _image("noise", (3, 5, 3)), {}),
    "480x854": (lambda: _image("noise", (480, 854, 3)), {"quality": 95}),
    "optimize": (lambda: _image("noise", (48, 64, 3)), {"optimize": True}),
    "optimize-gradient": (lambda: _image("gradient", (40, 72, 3)), {"optimize": True}),
    "restart-rows": (lambda: _image("noise", (48, 64, 3)), {"restart_marker_rows": 1}),
    "restart-blocks": (lambda: _image("noise", (37, 53, 3)), {"restart_marker_blocks": 3}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_decoder_matches_pil_on_other_files(case):
    make, kw = CASES[case]
    _assert_decodes_as_pil(_encode(make(), **kw))


@pytest.mark.parametrize("sequence", ytbvos_sequences())
def test_committed_ytbvos_frames_decode_as_pil(sequence):
    """All 384 committed frames of ``train_demo/ytbvos_dst`` (q95 4:2:0
    baseline, 64×48), and their size from the header alone."""
    files = sorted(glob.glob(os.path.join(YTBVOS_DST, "JPEGImages", "480p", sequence, "*.jpg")))
    assert len(files) == 48
    for f in files:
        with Image.open(f) as im:
            ref = np.asarray(im.convert("RGB"))
            size = im.size
        assert np.array_equal(jpeg.read_rgb(f), ref), f
        assert jpeg.image_size(f) == size


@pytest.mark.parametrize("kw", [{"progressive": True}, {"progressive": True, "optimize": True}])
def test_progressive_raises(kw):
    data = _encode(_image("noise", (16, 16, 3)), **kw)
    with pytest.raises(ValueError, match="x.jpg: SOF2 .progressive."):
        jpeg.decode(data, "x.jpg")


def test_cmyk_and_other_files_raise():
    cmyk = io.BytesIO()
    Image.fromarray(_image("noise", (16, 16, 3))).convert("CMYK").save(cmyk, format="JPEG")
    with pytest.raises(ValueError, match="c.jpg: SOF0 with 4 components"):
        jpeg.decode(cmyk.getvalue(), "c.jpg")
    with pytest.raises(ValueError, match="not a JPEG"):
        jpeg.decode(b"\x89PNG\r\n\x1a\n", "p.png")
    lossless = bytearray(_encode(_image("noise", (16, 16, 3))))
    sof = lossless.index(b"\xff\xc0")
    lossless[sof + 1] = 0xC3
    with pytest.raises(ValueError, match="SOF3 .lossless."):
        jpeg.decode(bytes(lossless), "l.jpg")


def _chip_clip_frames(n):
    from ivosw_tpu_torch.data.demo import DemoSpec, demo_training_registry

    spec = DemoSpec(h=chip_smoke.H, w=chip_smoke.W, num_frames=chip_smoke.DATASET_FRAMES,
                    num_objects=chip_smoke.O, blob=chip_smoke.BLOB)
    reg = demo_training_registry(n_clips=1, seed=chip_smoke.SEED, spec=spec)
    return (np.asarray(reg.load_images(reg.subset("train")[0])[:n]) * 255).astype(np.uint8)


def test_chip_phase_digest_is_pils_decode():
    """PIL's decode of the chip phase's first two frames, as its encoder
    writes them, has the SHA-256 that ``chip_smoke.py`` holds; the port's
    decoder gives the same pixels."""
    decoded = []
    for frame in _chip_clip_frames(2):
        data = chip_smoke.encode_jpeg(frame, chip_smoke.DATASET_QUALITY)
        decoded.append(np.asarray(Image.open(io.BytesIO(data)).convert("RGB")))
        assert np.array_equal(jpeg.decode(data), decoded[-1])
    assert hashlib.sha256(np.stack(decoded).tobytes()).hexdigest() == chip_smoke.DATASET_DIGEST


@pytest.mark.parametrize("quality", [10, 50, 75, 95, 100])
def test_chip_encoder_writes_libjpegs_stream(quality):
    """At a whole number of MCUs the encoder's scan equals PIL's 4:2:0
    encoding byte for byte (libjpeg's quality scaling, Annex K tables,
    ``jfdctint`` islow DCT and ``jcsample`` downsampling); elsewhere its
    bytes decode as PIL decodes them."""
    img = _image("noise", (48, 64, 3), seed=quality)
    ours = chip_smoke.encode_jpeg(img, quality)
    pil = _encode(img, quality=quality, subsampling=2)
    assert ours[ours.index(b"\xff\xdb"):ours.index(b"\xff\xc0")] == \
        pil[pil.index(b"\xff\xdb"):pil.index(b"\xff\xc0")]  # DQT
    assert ours[ours.index(b"\xff\xda"):] == pil[pil.index(b"\xff\xda"):]
    _assert_decodes_as_pil(chip_smoke.encode_jpeg(_image("noise", (37, 53, 3)), quality))


def test_truncated_file_raises():
    data = _encode(_image("noise", (48, 64, 3)), quality=95)
    with pytest.raises(ValueError, match="t.jpg: the scan's data ends"):
        jpeg.decode(data[: len(data) // 2], "t.jpg")
