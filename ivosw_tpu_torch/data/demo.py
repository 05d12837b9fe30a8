"""Deterministic demo dataset: a copy of ``ivosw_tpu/data/demo.py``.

The same generator and rng streams, so one seed gives the same clips bit for
bit as the JAX package. Each clip holds textured frames with drifting
objects, two contiguous hard bands (occlusion plus same-coloured distractor
blobs) and an appearance-churn window, so that not every low-quality frame
is worth annotating and the choice of frame matters.

Two tiers share the generator (``DemoSpec``): the default 48×64/2-object
tier and an HD tier (``HD_SPEC``: 192×256, 3 objects). Any other geometry,
e.g. 480×854 with 64 frames and 3 objects, is one ``DemoSpec`` away.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np

from ivosw_tpu_torch.data.registry import SequenceInfo, SequenceRegistry

H, W = 48, 64
NUM_FRAMES = 48
HARD_LEN = 8  # per hard band; two bands per clip
CHURN_LEN = 12  # appearance-churn window length
NUM_OBJECTS = 2
TRAIN_SEQS = [f"dm-t{i}" for i in range(12)]
VAL_SEQS = [f"dm-v{i}" for i in range(8)]


# shared appearance across clips: object identity is colour-coded the same
# way in every clip (small per-clip jitter), so a backbone trained on the
# train split generalises to unseen val clips — without this, a from-scratch
# net memorises per-clip colours and val quality collapses (measured)
PALETTE = np.array(
    [[0.85, 0.25, 0.20], [0.20, 0.80, 0.30], [0.25, 0.35, 0.90]],
    dtype=np.float32,
)


@dataclass(frozen=True)
class DemoSpec:
    """Generator geometry for one demo tier.

    The default values reproduce the original 48×64 tier bit-for-bit (the
    rng draw sequence in :func:`_make_clip` depends only on these fields,
    so equal fields ⇒ identical streams ⇒ identical committed artifacts).
    """

    h: int = H
    w: int = W
    num_frames: int = NUM_FRAMES
    hard_len: int = HARD_LEN
    churn_len: int = CHURN_LEN
    num_objects: int = NUM_OBJECTS
    # distractor blob side in the hard bands; scaled with resolution so the
    # false-positive bait stays object-sized, not speck-sized
    blob: int = 8

    @property
    def name(self) -> str:
        return f"{self.h}x{self.w}-{self.num_objects}obj-{self.num_frames}f"


DEFAULT_SPEC = DemoSpec()
# HD tier: 4× the per-side resolution (16× pixels), one more object. Frame
# count and band/churn economics are unchanged — budget scarcity, not pixel
# count, is what makes the ordering learnable; pixels are what make the
# segmentation task approach DAVIS conditions.
HD_SPEC = DemoSpec(h=192, w=256, num_objects=3, blob=32)


def _reflect01(x: float) -> float:
    """Reflect a scalar into [0, 1] (smooth bounce, no wraparound teleport)."""
    x = float(np.mod(x, 2.0))
    return 2.0 - x if x > 1.0 else x


def _make_clip(
    rng: np.random.Generator, spec: DemoSpec = DEFAULT_SPEC
) -> Tuple[np.ndarray, np.ndarray, tuple, int]:
    """One clip: textured background + drifting objects + two hard bands.

    Returns (frames, annotations, hard_band_starts, churn_start)."""
    h, w, nf, n_obj = spec.h, spec.w, spec.num_frames, spec.num_objects
    hard_len, churn_len = spec.hard_len, spec.churn_len
    frames = np.zeros((nf, h, w, 3), dtype=np.float32)
    anns = np.zeros((nf, h, w), dtype=np.uint8)
    base = rng.random((h, w, 3)).astype(np.float32) * 0.3
    centers = rng.random((n_obj, 2)) * 0.5 + 0.25
    vels = (rng.random((n_obj, 2)) - 0.5) * 0.03
    # objects span several /16-scale feature cells (tiny sub-cell objects
    # are unsegmentable by design at this resolution)
    sizes = rng.integers(h // 3, h // 2 + 1, size=n_obj)
    colors = np.clip(
        PALETTE[:n_obj] + rng.normal(0, 0.04, (n_obj, 3)).astype(np.float32),
        0.0,
        1.0,
    )
    # segment layout: two hard bands + one churn window in random order,
    # >=3 clean frames between structured segments and >=2 at the clip
    # ends. Session-bootstrap scribbles land at t/6, t/2, 5t/6 (scribble
    # index over num_scribbles=3, session.py::_start_sample) and MAY fall
    # inside a band/churn window — intentional: a round-1 anchor wasted on
    # a hard band is part of what makes frame choice matter. One band
    # alone is too easy (round-1 J&F 0.83, policy spread 0.001 —
    # measured); two bands put 1/3 of the budget-wasting frames back.
    segs = [("hard", hard_len), ("hard", hard_len), ("churn", churn_len)]
    order = [int(i) for i in rng.permutation(3)]
    gap = 3
    slack = nf - 4 - (2 * hard_len + churn_len) - 2 * gap
    extras = rng.multinomial(slack, [0.25] * 4)
    pos = 2 + int(extras[0])
    hard_list = []
    churn_start = 0
    for idx, extra in zip(order, extras[1:]):
        kind, ln = segs[idx]
        if kind == "hard":
            hard_list.append(pos)
        else:
            churn_start = pos
        pos += ln + gap + int(extra)
    hard_starts = tuple(sorted(hard_list))

    # churn: per-object colour random walk — appearance decorrelates within
    # a few frames, so propagation needs several anchors inside the window
    churn_off = np.zeros((n_obj, 3), dtype=np.float32)

    for t in range(nf):
        frame = base + rng.normal(0, 0.02, (h, w, 3)).astype(np.float32)
        ann = np.zeros((h, w), dtype=np.uint8)
        hard = any(s <= t < s + hard_len for s in hard_starts)
        if churn_start <= t < churn_start + churn_len:
            churn_off += rng.normal(0, 0.07, (n_obj, 3)).astype(np.float32)
        colors_t = np.clip(colors + churn_off, 0.12, 1.0)
        for o in range(n_obj):
            cy = int(_reflect01(centers[o, 0] + vels[o, 0] * t) * (h - 1))
            cx = int(_reflect01(centers[o, 1] + vels[o, 1] * t) * (w - 1))
            s = int(sizes[o])
            y0, y1 = max(0, cy - s // 2), min(h, cy + s // 2)
            x0, x1 = max(0, cx - s // 2), min(w, cx + s // 2)
            if not hard:
                frame[y0:y1, x0:x1] = colors_t[o] + rng.normal(
                    0, 0.03, (y1 - y0, x1 - x0, 3)
                )
            # hard band: true occlusion — the object keeps the clip's
            # background texture (same statistics train AND val, nothing
            # clip-specific to memorise); GT still labels the true extent,
            # so in-band quality depends on carrying the previous-round mask
            ann[y0:y1, x0:x1] = o + 1
        if hard:
            # same-coloured distractor blobs: false-positive bait for
            # matching-based propagation and the interaction net
            b = spec.blob
            for o in range(n_obj):
                dy = int(rng.integers(0, h - b))
                dx = int(rng.integers(0, w - b))
                patch = ann[dy : dy + b, dx : dx + b]
                frame[dy : dy + b, dx : dx + b][patch == 0] = colors[o]
        frames[t] = np.clip(frame, 0.0, 1.0)
        anns[t] = ann
    return frames, anns, hard_starts, churn_start


def demo_training_registry(
    n_clips: int = 400, seed: int = 1, spec: DemoSpec = DEFAULT_SPEC
) -> SequenceRegistry:
    """Large pool of generator-fresh clips for appearance training.

    A from-scratch backbone (or QA net) trained on the 12 fixed train clips
    memorises them (measured: train in-band J&F 0.88 vs val 0.02). Backbone
    and QA training therefore draw from this pool — same generator family,
    disjoint rng stream from :func:`demo_registry` — while the RL stages and
    evaluation keep the small fixed registry (the reward baseline table is
    keyed per sequence)."""
    reg = SequenceRegistry()
    rng = np.random.default_rng(np.random.SeedSequence([seed, 0xBEEF]))
    for i in range(n_clips):
        name = f"dmx-{i:04d}"
        frames, anns, _, _ = _make_clip(rng, spec)
        reg.sequences[name] = SequenceInfo(
            name=name,
            set="train",
            num_frames=spec.num_frames,
            image_size=(spec.w, spec.h),
            num_objects=spec.num_objects,
            num_scribbles=1,
        )
        reg._synthetic[name] = (frames, anns)
    return reg


def demo_registry(seed: int = 0, spec: DemoSpec = DEFAULT_SPEC) -> SequenceRegistry:
    """Train+val registry of hard-band clips (fully determined by seed).

    Returns a registry whose ``hard_starts`` / ``churn_starts`` attributes
    map sequence name → tuple of hard-band starts / churn-window start
    (diagnostics/tests only — the models never see them)."""
    reg = SequenceRegistry()
    rng = np.random.default_rng(np.random.SeedSequence([seed, 0xDE]))
    hard_starts = {}
    churn_starts = {}
    # 3 scribbles per sequence like DAVIS: bootstrap frames land at t/6,
    # t/2, 5t/6, giving the RL stages three distinct training windows per
    # clip and 30-epoch reward baselines exactly 30 records per parity group
    for names, split, n_scb in ((TRAIN_SEQS, "train", 3), (VAL_SEQS, "val", 3)):
        for name in names:
            frames, anns, hard_starts_i, churn_i = _make_clip(rng, spec)
            reg.sequences[name] = SequenceInfo(
                name=name,
                set=split,
                num_frames=spec.num_frames,
                image_size=(spec.w, spec.h),
                num_objects=spec.num_objects,
                num_scribbles=n_scb,
            )
            reg._synthetic[name] = (frames, anns)
            hard_starts[name] = hard_starts_i
            churn_starts[name] = churn_i
    reg.hard_starts = hard_starts
    reg.churn_starts = churn_starts
    return reg
