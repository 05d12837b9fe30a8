"""Seeded inputs shared by the port's tests (numpy only, no JAX)."""

import numpy as np


def edge_case_probs(t, o, h, w, seed=0):
    """[t, o, h, w] float32 prob planes cycling through the ROI box edge
    cases: empty, exactly 0.5 (not foreground), single pixel inside and at
    the far corner, a full border row, the whole frame (clamped at ±5 px),
    a 3×3 blob at the left edge (narrower than the 128 px minimum side, so
    the expansion hits the clamp), a box touching the bottom-right corner,
    scattered noise."""
    rng = np.random.default_rng(seed)
    probs = (rng.random((t, o, h, w)) * 0.5).astype(np.float32)
    for i in range(t * o):
        plane = probs[i // o, i % o]
        case = i % 9
        if case == 1:
            plane[...] = np.where(rng.random((h, w)) < 0.2, 0.5, plane)
        elif case == 2:
            plane[rng.integers(h), rng.integers(w)] = 0.9
        elif case == 3:
            plane[h - 1, w - 1] = 0.51
        elif case == 4:
            plane[0, :] = 0.8
        elif case == 5:
            plane[...] = 0.99
        elif case == 6:
            y = rng.integers(0, h - 3)
            plane[y : y + 3, 0:3] = 0.7
        elif case == 7:
            plane[h // 3 :, w // 2 :] = 0.6
        elif case == 8:
            plane[...] = np.where(rng.random((h, w)) < 0.01, 0.75, plane)
    return probs


def frames_like(t, h, w, seed=1):
    return np.random.default_rng(seed).random((t, h, w, 3), dtype=np.float32)


def train_batch(b, h, w, seed, invalid=(1,)):
    """Seeded {img, prob, label} host batch for the AssessNet trainer:
    rectangles as labels, their shifted copies at confidence 0.82-0.99 over
    noise as prob maps. Samples listed in ``invalid`` keep an empty label
    and no prob above 0.8, so the trainer leaves them out of the loss.
    ``chip_smoke.py::train_batch`` is a copy (with ``invalid=(1,)``)."""
    rng = np.random.default_rng(seed)
    img = rng.random((b, h, w, 3), dtype=np.float32)
    prob = (rng.random((b, h, w)) * 0.3).astype(np.float32)
    label = np.zeros((b, h, w), np.float32)
    for i in range(b):
        if i in invalid:
            continue
        y0, x0 = rng.integers(0, h // 2), rng.integers(0, w // 2)
        hh, ww = rng.integers(h // 6, h // 2), rng.integers(w // 6, w // 2)
        label[i, y0:y0 + hh, x0:x0 + ww] = 1.0
        dy, dx = rng.integers(-3, 4, size=2)
        shifted = np.roll(label[i], (int(dy), int(dx)), axis=(0, 1))
        prob[i] = np.clip(shifted * rng.uniform(0.82, 0.99) + prob[i] * 0.5, 0.0, 1.0)
    return {"img": img, "prob": prob, "label": label}


# A nearest-neighbour label tie: cv2 rounds the back-mapped coordinate to
# float32 (an ulp is ~4e-6 at 64 px), the port keeps it in float64, so a
# coordinate this close to a half-integer may pick either neighbour.
TIE_EPS = 1e-4


def tie_pixels(m, h, w, flipped=False):
    """[h, w] bool: output pixels of the port's warp by forward matrix ``m``
    whose source x or y lies within TIE_EPS of a .5 tie (mirrored when the
    sample was flipped afterwards)."""
    from ivosw_tpu_torch.data.augment import _source_coords

    sx, sy = _source_coords(m, h, w)
    near = lambda c: np.abs(c - np.floor(c) - 0.5) < TIE_EPS
    ties = near(sx) | near(sy)
    return ties[:, ::-1] if flipped else ties


def record_augmentations(monkeypatch):
    """Record, per sample the port's QAAugmentPipeline transforms, the
    affine matrix it applied (None when it kept the original) and whether
    it flipped. Returns the list the records are appended to."""
    from ivosw_tpu_torch.data import augment

    records = []
    affine, hflip, warp = augment.random_affine, augment.random_hflip, augment._warp_linear

    def random_affine(sample, rng, *args, **kwargs):
        used = []
        monkeypatch.setattr(augment, "_warp_linear", lambda s, m: (used.append(m), warp(s, m))[1])
        out = affine(sample, rng, *args, **kwargs)
        monkeypatch.setattr(augment, "_warp_linear", warp)
        records.append({"m": used[0] if used else None, "flipped": False})
        return out

    def random_hflip(sample, rng, *args, **kwargs):
        out = hflip(sample, rng, *args, **kwargs)
        records[-1]["flipped"] = out is not sample
        return out

    monkeypatch.setattr(augment, "random_affine", random_affine)
    monkeypatch.setattr(augment, "random_hflip", random_hflip)
    return records


def assert_labels_match_but_ties(port, ref, records):
    """Labels [N, h, w] of the port and of the JAX package (cv2) agree
    except at nearest-neighbour ties of the recorded warps; returns how many
    tie pixels flipped."""
    port, ref = np.asarray(port), np.asarray(ref)
    assert port.shape == ref.shape and len(records) == port.shape[0]
    flips = 0
    for i, rec in enumerate(records):
        diff = port[i] != ref[i]
        if not diff.any():
            continue
        assert rec["m"] is not None, f"sample {i}: labels differ without a warp"
        ties = tie_pixels(rec["m"], *port.shape[1:], rec["flipped"])
        assert not (diff & ~ties).any(), f"sample {i}: label differs off a tie"
        flips += int(diff.sum())
    return flips
