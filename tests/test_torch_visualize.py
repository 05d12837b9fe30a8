"""Visualisation (``ivosw_tpu_torch/utils/visualize.py``) and the PNG writers
it uses, against the JAX package's ``utils/visualize.py``: colours and
overlays equal, and the port's PNGs decode, through PIL, to the pixels of
the JAX package's PIL-written files; the key stream and the profiler
capture of ``utils/misc.py``."""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from ivosw_tpu.data.scribbles import empty_scribbles, make_scribble
from ivosw_tpu.utils import visualize as jax_vis
from ivosw_tpu_torch.data import png
from ivosw_tpu_torch.utils import visualize
from ivosw_tpu_torch.utils.misc import profile_trace, rng_chain


def _clip(t=3, h=24, w=40, seed=0):
    rng = np.random.default_rng(seed)
    frames = rng.random((t, h, w, 3)).astype(np.float32)
    labels = rng.integers(0, 11, (t, h, w))  # ids past the palette wrap around
    return frames, labels


def _scribbles():
    s = empty_scribbles("seq", 2)
    s["scribbles"][1].append(make_scribble(np.array([[0.1, 0.1], [0.5, 0.6], [0.9, 0.2]]), 1))
    s["scribbles"][1].append(make_scribble(np.array([[0.8, 0.2], [0.8, 0.8]]), 2))
    s["scribbles"][1].append(make_scribble(np.array([[0.3, 0.9]]), 3))
    return s


def test_colours_and_overlays_equal_the_jax_package():
    frames, labels = _clip()
    np.testing.assert_array_equal(visualize.label_to_color(labels[0]),
                                  jax_vis.label_to_color(labels[0]))
    for frame in (frames[0], (frames[1] * 255).astype(np.uint8)):
        for alpha in (0.5, 0.3):
            got = visualize.overlay_mask(frame, labels[1], alpha)
            assert got.dtype == np.uint8
            np.testing.assert_array_equal(got, jax_vis.overlay_mask(frame, labels[1], alpha))


@pytest.mark.parametrize("thickness", [1, 2, 3])
def test_scribble_overlay(thickness):
    """Scribble strokes over a frame equal the JAX package's (cv2's thick
    polyline past thickness 1); a frame without scribbles is the frame."""
    frames, _ = _clip()
    s = _scribbles()
    got = visualize.overlay_scribbles(frames[0], s, 1, thickness=thickness)
    np.testing.assert_array_equal(got, jax_vis.overlay_scribbles(frames[0], s, 1,
                                                                 thickness=thickness))
    assert (got != visualize._uint8(frames[0])).any()
    np.testing.assert_array_equal(visualize.overlay_scribbles(frames[0], s, 0),
                                  visualize._uint8(frames[0]))


@pytest.mark.parametrize("thickness", [2, 3, 4, 7])
def test_thick_scribbles2mask_equals_cv2(thickness):
    """The port's thick rasteriser against the JAX package's cv2.polylines
    on 200 seeded paths of 2-6 points (ends on the border, repeated points,
    overlapping objects) in frames of 5-60 pixels a side."""
    from ivosw_tpu.data.scribbles import scribbles2mask as jax_scribbles2mask
    from ivosw_tpu_torch.data.scribbles import scribbles2mask

    rng = np.random.default_rng(thickness)
    for _ in range(200):
        h, w = (int(v) for v in rng.integers(5, 60, 2))
        s = empty_scribbles("seq", 1)
        for obj in (1, 2):
            path = rng.random((int(rng.integers(2, 7)), 2))
            path[rng.random(path.shape) < 0.15] = 1.0
            path[rng.random(path.shape) < 0.15] = 0.0
            s["scribbles"][0].append(make_scribble(path, obj))
        np.testing.assert_array_equal(scribbles2mask(s, (h, w), thickness=thickness),
                                      jax_scribbles2mask(s, (h, w), thickness=thickness))


def test_overlay_sequence_pngs_decode_to_the_jax_pixels(tmp_path):
    frames, labels = _clip()
    visualize.save_overlay_sequence(frames, labels, str(tmp_path / "port"), alpha=0.4)
    jax_vis.save_overlay_sequence(frames, labels, str(tmp_path / "jax"), alpha=0.4)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == names == ["00000.png", "00001.png",
                                                              "00002.png"]
    for name in names:
        ours, theirs = Image.open(tmp_path / "port" / name), Image.open(tmp_path / "jax" / name)
        assert ours.mode == theirs.mode == "RGB"
        np.testing.assert_array_equal(np.array(ours), np.array(theirs))


@pytest.mark.parametrize("ids", [8, 256])
def test_label_png_decodes_to_the_jax_pixels(tmp_path, ids):
    label = np.random.default_rng(ids).integers(0, ids, (17, 31))
    visualize.save_label_png(label, str(tmp_path / "port.png"))
    jax_vis.save_label_png(label, str(tmp_path / "jax.png"))
    ours, theirs = Image.open(tmp_path / "port.png"), Image.open(tmp_path / "jax.png")
    assert ours.mode == theirs.mode == "P"
    np.testing.assert_array_equal(np.array(ours), np.array(theirs))
    np.testing.assert_array_equal(np.array(ours.convert("RGB")), np.array(theirs.convert("RGB")))
    # and the port's own reader takes it back
    np.testing.assert_array_equal(png.read_indexed(str(tmp_path / "port.png")),
                                  label.astype(np.uint8))


def test_png_writers_refuse_other_arrays(tmp_path):
    with pytest.raises(ValueError, match=r"\[H, W, 3\] uint8"):
        png.write_rgb8(str(tmp_path / "x.png"), np.zeros((4, 4), np.uint8))
    with pytest.raises(ValueError, match="palette"):
        png.write_palette8(str(tmp_path / "x.png"), np.zeros((4, 4), np.uint8),
                           np.zeros((257, 3), np.uint8))


def test_rng_chain_is_a_seeded_stream():
    a, b, c = rng_chain(7), rng_chain(7), rng_chain(8)
    draws = [torch.rand(3, generator=next(a)) for _ in range(4)]
    again = [torch.rand(3, generator=next(b)) for _ in range(4)]
    for x, y in zip(draws, again):
        assert torch.equal(x, y)
    assert not torch.equal(draws[0], draws[1])
    assert not torch.equal(draws[0], torch.rand(3, generator=next(c)))


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    with profile_trace(str(tmp_path / "trace")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    with open(tmp_path / "trace" / "trace.json") as fp:
        assert "traceEvents" in json.load(fp)
    assert prof.profile is not None
    with profile_trace(None) as off:
        torch.ones(2)
    assert off.profile is None and not (tmp_path / "none").exists()
