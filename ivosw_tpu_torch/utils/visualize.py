"""Visualisation helpers: mask overlays, the DAVIS palette, label PNGs.

Counterpart of ``ivosw_tpu/utils/visualize.py`` in numpy, writing PNGs with
:mod:`ivosw_tpu_torch.data.png` (no PIL) and drawing scribbles with the
port's cv2-exact rasteriser (:func:`ivosw_tpu_torch.data.scribbles.scribbles2mask`).
Label colours, overlays and the written pixels equal the JAX package's.
"""

from __future__ import annotations

import os

import numpy as np

from ivosw_tpu_torch.data.png import write_palette8, write_rgb8

# the standard DAVIS 2017 palette head (object ids 0..7)
DAVIS_PALETTE = np.array(
    [
        [0, 0, 0],
        [128, 0, 0],
        [0, 128, 0],
        [128, 128, 0],
        [0, 0, 128],
        [128, 0, 128],
        [0, 128, 128],
        [128, 128, 128],
    ],
    dtype=np.uint8,
)


def _uint8(frame) -> np.ndarray:
    img = np.asarray(frame)
    if img.dtype != np.uint8:
        img = np.clip(img * 255.0, 0, 255).astype(np.uint8)
    return img


def label_to_color(label: np.ndarray) -> np.ndarray:
    """[H, W] integer labels → [H, W, 3] uint8 palette colours (ids modulo
    the palette's 8 entries)."""
    label = np.asarray(label).astype(np.int64) % len(DAVIS_PALETTE)
    return DAVIS_PALETTE[label]


def overlay_mask(frame: np.ndarray, label: np.ndarray, alpha: float = 0.5) -> np.ndarray:
    """Blend palette-coloured labels over a frame ([H, W, 3], float in
    [0, 1] or uint8); background (label 0) keeps the frame. Returns uint8."""
    img = _uint8(frame)
    color = label_to_color(label)
    fg = (np.asarray(label) > 0)[..., None]
    return np.where(fg, (alpha * color + (1 - alpha) * img).astype(np.uint8), img)


def overlay_scribbles(
    frame: np.ndarray, scribbles: dict, frame_idx: int, thickness: int = 2
) -> np.ndarray:
    """Draw frame ``frame_idx``'s scribble paths over a frame, each in its
    object's palette colour (uint8 output; later strokes on top)."""
    from ivosw_tpu_torch.data.scribbles import scribbles2mask

    img = _uint8(frame)
    label = scribbles2mask(scribbles, img.shape[:2], only_frame=frame_idx, thickness=thickness)
    drawn = label > 0
    out = img.copy()
    out[drawn] = label_to_color(np.where(drawn, label, 0))[drawn]
    return out


def save_overlay_sequence(
    frames: np.ndarray, masks: np.ndarray, out_dir: str, alpha: float = 0.5
) -> None:
    """One RGB overlay PNG per frame of a clip, ``{out_dir}/{i:05d}.png``."""
    os.makedirs(out_dir, exist_ok=True)
    for i in range(frames.shape[0]):
        write_rgb8(os.path.join(out_dir, f"{i:05d}.png"), overlay_mask(frames[i], masks[i], alpha))


def save_label_png(label: np.ndarray, path: str) -> None:
    """An integer label mask as a DAVIS-style palette PNG (the palette's 8
    colours, then black up to 256 entries)."""
    palette = np.zeros((256, 3), np.uint8)
    palette[: len(DAVIS_PALETTE)] = DAVIS_PALETTE
    write_palette8(path, np.asarray(label, dtype=np.uint8), palette)
