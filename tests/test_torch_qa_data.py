"""QA training data of the port against the JAX package (CPU): the PNG dump
codec and dataset, the pretext degradations, and the augmentations.

Tolerances and why:
- PNG dumps, dataset samples and batch order: identical (8-bit pixels,
  the same enumeration and the same ``default_rng`` permutation);
- ``degrade_mask``: identical masks and generator state (scipy's
  morphology with cv2's border rules, the same draws in the same order);
- ``_affine_matrix`` within 1e-12 (float64, cv2's formula written out);
- warps: image and prob within 1e-5 of cv2 (cv2 rounds the back-mapped
  coordinates to float32, the port keeps float64: an ulp of a coordinate
  near 64 px is 4e-6 and moves a bilinear value by at most that times the
  largest neighbour difference, 1); labels identical except where the
  source coordinate lies within 1e-4 of a .5 nearest-neighbour tie, where
  cv2's float32 coordinate may round the other way (ROADMAP §3);
- ``resize_sample`` off the identity path within 1e-6 of cv2 (float32
  interpolation in another op order); labels identical.
"""

import os
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from ivosw_tpu.data import augment as jax_augment
from ivosw_tpu.data import qa_dataset as jax_qa
from ivosw_tpu.data.registry import SequenceRegistry as JaxRegistry
from ivosw_tpu.train import pretrain_assess as jax_pretrain
from ivosw_tpu_torch.data import augment, png, qa_dataset
from ivosw_tpu_torch.data.qa_samples import samples as port_samples
from ivosw_tpu_torch.data.registry import SequenceRegistry
from ivosw_tpu_torch.train import pretrain_assess
from torch_port_cases import assert_labels_match_but_ties, record_augmentations

IMG_ATOL = 1e-5
RESIZE_ATOL = 1e-6


def _registries():
    kw = dict(num_frames=5, image_size=(64, 48), num_objects=2, split="train", seed=2)
    return (JaxRegistry.synthetic(["qa-a", "qa-b"], **kw),
            SequenceRegistry.synthetic(["qa-a", "qa-b"], **kw))


def _probs(seed, t=5, o=2, h=48, w=64):
    """[t, o+1, h, w] prob maps covering 0, 1, out-of-range and in-between."""
    rng = np.random.default_rng(seed)
    probs = rng.random((t, o + 1, h, w)).astype(np.float32)
    probs[0, 1] = 0.0
    probs[1, 1] = 1.0
    probs[2, 2, :10] = 1.7  # clipped to 255
    probs[3, 2, :10] = -0.2  # clipped to 0
    return probs


# --------------------------------------------------------------------- PNG --
def _filtered_png(path, image, kinds):
    """Encode [H, W] uint8 with the given filter type per row (independent
    of both codecs under test)."""
    h, w = image.shape
    img = image.astype(np.int64)
    rows = []
    for y in range(h):
        cur, up = img[y], img[y - 1] if y else np.zeros(w, np.int64)
        left = np.concatenate([[0], cur[:-1]])
        upleft = np.concatenate([[0], up[:-1]])
        k = kinds[y % len(kinds)]
        if k == 0:
            pred = np.zeros(w, np.int64)
        elif k == 1:
            pred = left
        elif k == 2:
            pred = up
        elif k == 3:
            pred = (left + up) // 2
        else:
            p = left + up - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
        rows.append(bytes([k]) + ((cur - pred) % 256).astype(np.uint8).tobytes())
    chunk = lambda t, d: struct.pack(">I", len(d)) + t + d + struct.pack(">I", zlib.crc32(t + d))
    with open(path, "wb") as fp:
        fp.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
                 + chunk(b"IDAT", zlib.compress(b"".join(rows))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("kinds", [(0,), (1,), (2,), (3,), (4,), (0, 1, 2, 3, 4)])
def test_png_reader_undoes_every_filter(tmp_path, kinds):
    image = (np.random.default_rng(len(kinds) + kinds[0]).random((23, 37)) * 256).astype(np.uint8)
    image[5:9] = 255
    path = str(tmp_path / "f.png")
    _filtered_png(path, image, kinds)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), image)
    np.testing.assert_array_equal(png.read_gray8(path), image)


def test_dumps_cross_between_packages(tmp_path):
    """Dumps written by either package read back to the same uint8 arrays
    through PIL and through the port's codec, in the same layout."""
    probs = _probs(0)
    meta = dict(sequence="qa-a", n_interaction=2, scribble_iter=1)
    jax_dir, port_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_qa.save_seg_preds(probs, meta, jax_dir)
    qa_dataset.save_seg_preds(probs, meta, port_dir)
    rel = lambda root: sorted(os.path.relpath(os.path.join(d, f), root)
                              for d, _, fs in os.walk(root) for f in fs)
    assert rel(jax_dir) == rel(port_dir) and len(rel(jax_dir)) == 10
    for name in rel(jax_dir):
        a, b = os.path.join(jax_dir, name), os.path.join(port_dir, name)
        ref = np.asarray(Image.open(a))
        np.testing.assert_array_equal(png.read_gray8(a), ref)
        np.testing.assert_array_equal(np.asarray(Image.open(b)), ref)
        np.testing.assert_array_equal(png.read_gray8(b), ref)


def test_qa_dataset_matches_jax(tmp_path):
    """Both datasets over one dump tree (written half by each package):
    the same sample list, the same samples and the same shuffled batches."""
    jreg, preg = _registries()
    for i, (seq, writer) in enumerate([("qa-a", jax_qa), ("qa-b", qa_dataset)]):
        for n in (1, 2):
            writer.save_seg_preds(_probs(10 * i + n), dict(sequence=seq, n_interaction=n,
                                                           scribble_iter=1), str(tmp_path))
    ref = jax_qa.QARegressionDataset(jreg, str(tmp_path), seed=3)
    got = qa_dataset.QARegressionDataset(preg, str(tmp_path), seed=3)
    assert got.samples_list == ref.samples_list and len(got) == 40
    for idx in (0, 7, 39):
        a, b = got.load(idx), ref.load(idx)
        for k in ("img", "prob", "label"):
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    for a, b in zip(got.batches(8, skip=1), ref.batches(8, skip=1), strict=True):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_qa_samples_fixture():
    from ivosw_tpu.data.qa_samples import samples

    assert port_samples == samples and len(port_samples) == 60


# --------------------------------------------------------------- pretext --
def _masks(h=48, w=64):
    """Binary masks: interior blobs, masks touching each border and a
    corner, a full frame, a single pixel and a thin line."""
    m = np.zeros((8, h, w), np.float32)
    m[0, 10:30, 15:40] = 1
    m[1, :12, 20:30] = 1
    m[2, 30:, :8] = 1
    m[3, 5:20, w - 6:] = 1
    m[4, h - 5:, w - 9:] = 1
    m[5] = 1
    m[6, 20, 30] = 1
    m[7, 10:40, 31] = 1
    return m


def test_degrade_mask_matches_cv2():
    """≥100 draws: identical prob maps and generator state."""
    masks = _masks()
    j_rng, p_rng = np.random.default_rng(7), np.random.default_rng(7)
    for i in range(136):
        mask = masks[i % len(masks)]
        ref = jax_pretrain.degrade_mask(mask, j_rng)
        got = pretrain_assess.degrade_mask(mask, p_rng)
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref, err_msg=str(i))
    assert p_rng.bit_generator.state == j_rng.bit_generator.state


def test_sample_batches_match_jax():
    from ivosw_tpu.data.demo import demo_training_registry as jax_demo
    from ivosw_tpu_torch.data.demo import demo_training_registry

    jreg, preg = jax_demo(n_clips=3, seed=1), demo_training_registry(n_clips=3, seed=1)
    seqs = preg.subset("train")
    j_stream = jax_pretrain.sample_batches(jreg, seqs, np.random.default_rng(5), 4)
    p_stream = pretrain_assess.sample_batches(preg, seqs, np.random.default_rng(5), 4)
    for _ in range(3):
        a, b = next(p_stream), next(j_stream)
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])


# ----------------------------------------------------------- augmentation --
def test_affine_matrix_matches_cv2():
    for seed in range(40):
        ref = jax_augment._affine_matrix(48, 64, np.random.default_rng(seed), 0.1, (0.9, 1.1), 15.0, 25.0)
        got = augment._affine_matrix(48, 64, np.random.default_rng(seed), 0.1, (0.9, 1.1), 15.0, 25.0)
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)


def _sample(seed, h=48, w=64):
    rng = np.random.default_rng(seed)
    label = np.zeros((h, w), np.uint8)
    label[rng.integers(0, h // 2):rng.integers(h // 2 + 2, h),
          rng.integers(0, w // 2):rng.integers(w // 2 + 2, w)] = 1
    return {"img": rng.random((h, w, 3), dtype=np.float32),
            "prob": rng.random((h, w), dtype=np.float32), "label": label}


def test_random_affine_matches_cv2(monkeypatch):
    records = record_augmentations(monkeypatch)
    j_rng, p_rng = np.random.default_rng(11), np.random.default_rng(11)
    refs, gots = [], []
    for i in range(30):
        s = _sample(i)
        ref = jax_augment.random_affine(dict(s), j_rng)
        got = augment.random_affine(dict(s), p_rng)
        np.testing.assert_allclose(got["img"], ref["img"], rtol=0, atol=IMG_ATOL)
        np.testing.assert_allclose(got["prob"], ref["prob"], rtol=0, atol=IMG_ATOL)
        assert got["img"].dtype == ref["img"].dtype and got["label"].dtype == ref["label"].dtype
        refs.append(ref["label"])
        gots.append(got["label"])
    assert_labels_match_but_ties(gots, refs, records)
    assert p_rng.bit_generator.state == j_rng.bit_generator.state


def test_augment_pipeline_matches_cv2(monkeypatch):
    """QAAugmentPipeline over 40 samples: identical draws and generator
    state, img/prob within 1e-5, labels identical but at ties."""
    records = record_augmentations(monkeypatch)
    ref_pipe = jax_augment.QAAugmentPipeline(size_wh=(64, 48), seed=3)
    got_pipe = augment.QAAugmentPipeline(size_wh=(64, 48), seed=3)
    refs, gots = [], []
    for i in range(40):
        s = _sample(100 + i)
        ref, got = ref_pipe(dict(s)), got_pipe(dict(s))
        for k in ("img", "prob"):
            assert got[k].dtype == ref[k].dtype
            np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=IMG_ATOL)
        refs.append(ref["label"])
        gots.append(got["label"])
    assert_labels_match_but_ties(gots, refs, records)
    assert got_pipe.rng.bit_generator.state == ref_pipe.rng.bit_generator.state


@pytest.mark.parametrize("size_wh", [(64, 48), (100, 70), (30, 20), (37, 61)])
def test_resize_sample_matches_cv2(size_wh):
    s = _sample(5)
    s["label"][3:9, 4:60] = 2
    ref, got = jax_augment.resize_sample(s, size_wh), augment.resize_sample(s, size_wh)
    for k in ("img", "prob"):
        assert got[k].shape == ref[k].shape and got[k].dtype == ref[k].dtype
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=RESIZE_ATOL)
    np.testing.assert_array_equal(got["label"], ref["label"])
