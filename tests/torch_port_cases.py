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
