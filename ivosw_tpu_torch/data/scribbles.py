"""Scribble data structures (davisinteractive wire format) and rasterisation.

Counterpart of ``ivosw_tpu/data/scribbles.py`` without cv2. Scribble dicts:

    {"sequence": str,
     "scribbles": [per-frame list of
         {"path": [[x, y], ...],   # normalized to [0, 1]
          "object_id": int,
          "start_time"/"end_time": int}]}

Rasterisation draws each path as connected 8-connected line segments
(:func:`draw_line`, the pixels ``cv2.polylines(thickness=1)`` sets; a
thicker path takes OpenCV's thick-line route, :func:`draw_thick_polyline`)
and dilates per-object masks with a square max filter (``cv2.dilate``'s
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


# ---------------------------------------------------------- thick lines --
# OpenCV's integer drawing routines behind cv2.polylines with thickness > 1
# (imgproc/src/drawing.cpp), step for step: ends in XY_SHIFT fixed point,
# C's truncating division, arithmetic shifts.
XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT


def _tdiv(a, b):
    """C's integer division (truncates toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _hline(canvas, y, x0, x1, value):
    if x0 <= x1:
        canvas[y, x0:x1 + 1] = value


def _clip_line(w, h, x1, y1, x2, y2):
    right, bottom = w - 1, h - 1
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    return (c1 | c2) == 0, x1, y1, x2, y2


def _line2(canvas, x1, y1, x2, y2, value):
    """OpenCV's ``Line2``: an 8-connected line between ends in XY_SHIFT
    fixed point, clipped to the canvas (``clipLine``)."""
    h, w = canvas.shape
    ok, x1, y1, x2, y2 = _clip_line(w << XY_SHIFT, h << XY_SHIFT, x1, y1, x2, y2)
    if not ok:
        return
    dx, dy = x2 - x1, y2 - y1
    j = -1 if dx < 0 else 0
    ax = (dx ^ j) - j
    i = -1 if dy < 0 else 0
    ay = (dy ^ i) - i
    if ax > ay:
        dy = (dy ^ j) - j
        if j:
            x1, x2, y1, y2 = x2, x1, y2, y1
        x_step, y_step = XY_ONE, _tdiv(dy << XY_SHIFT, ax | 1)
        ecount = (x2 - x1) >> XY_SHIFT
    else:
        dx = (dx ^ i) - i
        if i:
            x1, x2, y1, y2 = x2, x1, y2, y1
        x_step, y_step = _tdiv(dx << XY_SHIFT, ay | 1), XY_ONE
        ecount = (y2 - y1) >> XY_SHIFT
    x1 += XY_ONE >> 1
    y1 += XY_ONE >> 1

    def put(x, y):
        if 0 <= x < w and 0 <= y < h:
            canvas[y, x] = value

    put((x2 + (XY_ONE >> 1)) >> XY_SHIFT, (y2 + (XY_ONE >> 1)) >> XY_SHIFT)
    if ax > ay:
        x1 >>= XY_SHIFT
        while ecount >= 0:
            put(x1, y1 >> XY_SHIFT)
            x1 += 1
            y1 += y_step
            ecount -= 1
    else:
        y1 >>= XY_SHIFT
        while ecount >= 0:
            put(x1 >> XY_SHIFT, y1)
            x1 += x_step
            y1 += 1
            ecount -= 1


def _fill_convex_poly(canvas, v, value):
    """OpenCV's ``FillConvexPoly`` (8-connected, vertices in XY_SHIFT fixed
    point): the outline by :func:`_line2`, then the rows between the left
    and right edges, each edge stepped in fixed point."""
    h, w = canvas.shape
    shift = XY_SHIFT
    delta = 1 << shift >> 1
    npts = len(v)
    edges = npts
    delta1 = delta2 = XY_ONE >> 1
    p0 = v[-1]
    xmin = xmax = v[0][0]
    ymin = ymax = v[0][1]
    imin = 0
    for i, p in enumerate(v):
        if p[1] < ymin:
            ymin, imin = p[1], i
        ymax = max(ymax, p[1])
        xmax = max(xmax, p[0])
        xmin = min(xmin, p[0])
        _line2(canvas, p0[0], p0[1], p[0], p[1], value)
        p0 = p
    xmin = (xmin + delta) >> shift
    xmax = (xmax + delta) >> shift
    ymin = (ymin + delta) >> shift
    ymax = (ymax + delta) >> shift
    if npts < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    edge = [dict(idx=imin, di=1, x=-XY_ONE, dx=0, ye=ymin),
            dict(idx=imin, di=npts - 1, x=-XY_ONE, dx=0, ye=ymin)]
    y = ymin
    while True:
        for e in edge:
            if y >= e["ye"]:
                idx0, di = e["idx"], e["di"]
                idx = idx0 + di
                if idx >= npts:
                    idx -= npts
                while True:
                    edges -= 1
                    if edges < 0:
                        break
                    ty = (v[idx][1] + delta) >> shift
                    if ty > y:
                        xs, xe = v[idx0][0], v[idx][0]
                        e["ye"] = ty
                        e["dx"] = _tdiv((xe - xs) * 2 + (ty - y), 2 * (ty - y))
                        e["x"] = xs
                        e["idx"] = idx
                        break
                    idx0 = idx
                    idx += di
                    if idx >= npts:
                        idx -= npts
        if edges < 0:
            break
        if y >= 0:
            left, right = (1, 0) if edge[0]["x"] > edge[1]["x"] else (0, 1)
            xx1 = (edge[left]["x"] + delta1) >> XY_SHIFT
            xx2 = (edge[right]["x"] + delta2) >> XY_SHIFT
            if xx2 >= 0 and xx1 < w:
                _hline(canvas, y, max(xx1, 0), min(xx2, w - 1), value)
        edge[0]["x"] += edge[0]["dx"]
        edge[1]["x"] += edge[1]["dx"]
        y += 1
        if y > ymax:
            break


def _circle(canvas, cx, cy, radius, value):
    """OpenCV's filled ``Circle`` (integer centre and radius, midpoint
    steps)."""
    h, w = canvas.shape
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1
    inside = radius <= cx < w - radius and radius <= cy < h - radius
    while dx >= dy:
        y11, y12, y21, y22 = cy - dy, cy + dy, cy - dx, cy + dx
        x11, x12, x21, x22 = cx - dx, cx + dx, cx - dy, cx + dy
        if inside:
            _hline(canvas, y11, x11, x12, value)
            _hline(canvas, y12, x11, x12, value)
            _hline(canvas, y21, x21, x22, value)
            _hline(canvas, y22, x21, x22, value)
        elif x11 < w and x12 >= 0 and y21 < h and y22 >= 0:
            x11, x12 = max(x11, 0), min(x12, w - 1)
            if 0 <= y11 < h:
                _hline(canvas, y11, x11, x12, value)
            if 0 <= y12 < h:
                _hline(canvas, y12, x11, x12, value)
            if x21 < w and x22 >= 0:
                x21, x22 = max(x21, 0), min(x22, w - 1)
                if 0 <= y21 < h:
                    _hline(canvas, y21, x21, x22, value)
                if 0 <= y22 < h:
                    _hline(canvas, y22, x21, x22, value)
        dy += 1
        err += plus
        plus += 2
        mask = (1 if err <= 0 else 0) - 1
        err -= minus & mask
        dx += mask
        minus -= mask & 2


def _thick_line(canvas, x0, y0, x1, y1, value, thickness, flags):
    """OpenCV's ``ThickLine`` for thickness > 1 (8-connected, integer ends):
    a filled quadrilateral of half-width thickness/2 around the segment and,
    where ``flags`` asks (bit 1 the start, bit 2 the end), a filled circle
    of radius thickness/2 at an end."""
    p0 = [x0 << XY_SHIFT, y0 << XY_SHIFT]
    p1 = [x1 << XY_SHIFT, y1 << XY_SHIFT]
    dx = (p0[0] - p1[0]) / XY_ONE
    dy = (p1[1] - p0[1]) / XY_ONE
    r = dx * dx + dy * dy
    odd = thickness & 1
    thickness <<= XY_SHIFT - 1
    if abs(r) > np.finfo(np.float64).eps:
        r = (thickness + odd * XY_ONE * 0.5) / np.sqrt(r)
        dpx, dpy = int(np.rint(dy * r)), int(np.rint(dx * r))
        pts = [(p0[0] + dpx, p0[1] + dpy), (p0[0] - dpx, p0[1] - dpy),
               (p1[0] - dpx, p1[1] - dpy), (p1[0] + dpx, p1[1] + dpy)]
        _fill_convex_poly(canvas, pts, value)
    for i in range(2):
        if flags & (i + 1):
            cx = (p0[0] + (XY_ONE >> 1)) >> XY_SHIFT
            cy = (p0[1] + (XY_ONE >> 1)) >> XY_SHIFT
            _circle(canvas, cx, cy, (thickness + (XY_ONE >> 1)) >> XY_SHIFT, value)
        p0 = p1


def draw_thick_polyline(canvas: np.ndarray, xs, ys, value: int, thickness: int) -> None:
    """Set the pixels ``cv2.polylines(canvas, [pts], False, value,
    thickness)`` sets for an open path of integer points inside ``canvas``
    and thickness > 1: each segment a thick line, with round caps at the
    path's start and at every segment's end."""
    flags = 3
    for k in range(len(xs) - 1):
        _thick_line(canvas, int(xs[k]), int(ys[k]), int(xs[k + 1]), int(ys[k + 1]), value,
                    thickness, flags)
        flags = 2


def scribbles2mask(
    scribbles: Dict,
    output_resolution,
    only_frame: Optional[int] = None,
    default_value: int = -1,
    thickness: int = 1,
) -> np.ndarray:
    """Rasterise scribbles to label masks: [T, H, W] int32 (or [H, W] when
    ``only_frame`` is given) holding ``default_value`` where unannotated.
    Path points are scaled by (W-1, H-1), rounded half to even and clipped
    to the frame; a one-point path sets its pixel; later lines overwrite
    earlier ones; ``thickness`` as cv2's."""
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
            if thickness > 1:
                draw_thick_polyline(out[fi], xs, ys, obj, thickness)
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
