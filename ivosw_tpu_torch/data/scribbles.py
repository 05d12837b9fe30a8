"""Scribble data structures (davisinteractive wire format) and rasterisation.

Counterpart of ``ivosw_tpu/data/scribbles.py`` without cv2. Scribble dicts:

    {"sequence": str,
     "scribbles": [per-frame list of
         {"path": [[x, y], ...],   # normalized to [0, 1]
          "object_id": int,
          "start_time"/"end_time": int}]}

Rasterisation draws each path as connected 8-connected line segments
(:func:`draw_line`, the pixels ``cv2.polylines(thickness=1)`` sets) and
dilates per-object masks with a square max filter (``cv2.dilate``'s
result; the out-of-frame border adds nothing).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
from scipy import ndimage


def empty_scribbles(sequence: str, num_frames: int) -> Dict:
    return {"sequence": sequence, "scribbles": [[] for _ in range(num_frames)]}


def annotated_frames(scribbles: Dict) -> List[int]:
    """Frames that carry at least one scribble line
    (davisinteractive.utils.scribbles.annotated_frames equivalent)."""
    return [i for i, lines in enumerate(scribbles["scribbles"]) if len(lines) > 0]


def is_empty(scribbles: Dict) -> bool:
    return len(annotated_frames(scribbles)) == 0


def merge_scribbles(base: Dict, new: Dict) -> Dict:
    """Accumulate scribbles across rounds (get_scribbles(only_last=False))."""
    assert base["sequence"] == new["sequence"]
    merged = {
        "sequence": base["sequence"],
        "scribbles": [list(a) + list(b) for a, b in zip(base["scribbles"], new["scribbles"])],
    }
    return merged


def make_scribble(
    path_xy: np.ndarray, object_id: int, start_time: int = 0, end_time: int = 1000
) -> Dict:
    return {
        "path": [[float(x), float(y)] for x, y in path_xy],
        "object_id": int(object_id),
        "start_time": start_time,
        "end_time": end_time,
    }


def draw_line(canvas: np.ndarray, x0: int, y0: int, x1: int, y1: int, value: int) -> None:
    """Set the pixels of the 8-connected line (x0, y0)–(x1, y1) to ``value``
    in place: OpenCV's ``LineIterator`` (connectivity 8, left to right),
    which ``cv2.polylines`` with thickness 1 walks for each segment. Both
    ends lie inside ``canvas``."""
    if x1 < x0:  # walk left to right
        x0, y0, x1, y1 = x1, y1, x0, y0
    dx, dy = x1 - x0, y1 - y0
    step_y = 1
    if dy < 0:
        dy, step_y = -dy, -1
    steep = dy > dx
    if steep:  # the major axis is y
        dx, dy = dy, dx
    err = dx - 2 * dy
    x, y = x0, y0
    for _ in range(dx + 1):
        canvas[y, x] = value
        minor = err < 0
        err += -2 * dy + (2 * dx if minor else 0)
        if steep:
            y += step_y
            x += 1 if minor else 0
        else:
            x += 1
            y += step_y if minor else 0


def scribbles2mask(
    scribbles: Dict,
    output_resolution,
    only_frame: Optional[int] = None,
    default_value: int = -1,
) -> np.ndarray:
    """Rasterise scribbles to label masks: [T, H, W] int32 (or [H, W] when
    ``only_frame`` is given) holding ``default_value`` where unannotated.
    Path points are scaled by (W-1, H-1), rounded half to even and clipped
    to the frame; a one-point path sets its pixel; later lines overwrite
    earlier ones."""
    h, w = output_resolution
    frames = scribbles["scribbles"]
    t = len(frames)
    out = np.full((t, h, w), default_value, dtype=np.int32)
    for fi in [only_frame] if only_frame is not None else range(t):
        for line in frames[fi]:
            path = np.asarray(line["path"], dtype=np.float64)
            if len(path) == 0:
                continue
            xs = np.clip(np.round(path[:, 0] * (w - 1)), 0, w - 1).astype(np.int32)
            ys = np.clip(np.round(path[:, 1] * (h - 1)), 0, h - 1).astype(np.int32)
            obj = int(line["object_id"])
            if len(xs) == 1:
                out[fi, ys[0], xs[0]] = obj
                continue
            for k in range(len(xs) - 1):
                draw_line(out[fi], int(xs[k]), int(ys[k]), int(xs[k + 1]), int(ys[k + 1]), obj)
    return out[only_frame] if only_frame is not None else out


def rough_roi_filter(
    scribble_label: np.ndarray, dist: int = 20, background_value: int = 0
) -> np.ndarray:
    """Keep scribble labels only inside the ±dist box of all scribbles.

    MANet's rough_ROI (reference utils/utils_manet.py:22-39): pixels outside
    the padded bounding box of every scribbled pixel (label ≠ −1) become
    ``background_value``. The box's end rows and columns are
    ``min(max + dist, size − 1)``, exclusive, as in the reference.
    scribble_label: [H, W] with −1 marking no scribble."""
    label = np.asarray(scribble_label)
    h, w = label.shape
    ys, xs = np.nonzero(label != -1)
    if len(ys) == 0:
        return label.copy()
    keep = np.zeros_like(label, dtype=bool)
    keep[
        max(int(ys.min()) - dist, 0) : min(int(ys.max()) + dist, h - 1),
        max(int(xs.min()) - dist, 0) : min(int(xs.max()) + dist, w - 1),
    ] = True
    return np.where(keep, label, background_value)


def scribble_masks_per_object(
    scribbles: Dict,
    output_resolution,
    frame: int,
    num_objects: int,
    dilation: int = 0,
) -> np.ndarray:
    """Per-object positive scribble masks of one frame: [O+1, H, W] float32
    (index 0 = background scribbles), each dilated by a (2·dilation+1)²
    square when ``dilation`` > 0."""
    label = scribbles2mask(scribbles, output_resolution, only_frame=frame)
    out = np.zeros((num_objects + 1,) + tuple(output_resolution), dtype=np.float32)
    for obj in range(num_objects + 1):
        m = (label == obj).astype(np.float32)
        if dilation > 0 and m.any():
            m = ndimage.maximum_filter(m, size=2 * dilation + 1, mode="constant", cval=0.0)
        out[obj] = m
    return out
