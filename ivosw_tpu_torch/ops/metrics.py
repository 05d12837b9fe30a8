"""Segmentation quality metrics: batched Jaccard (J) and boundary F-measure.

Counterpart of ``ivosw_tpu/ops/metrics.py`` with the same DAVIS-benchmark
semantics and results, without cv2:

- J per (frame, object): |pred ∩ gt| / |pred ∪ gt|, with empty-∪-empty = 1.
- F per (frame, object): boundary precision/recall where boundaries are
  1-pixel maps (seg2bmap semantics) matched within a tolerance radius
  ``ceil(0.008 * ||(H, W)||)`` via disk dilation.

The disk dilation is decided by ``scipy.ndimage.distance_transform_edt``
(pixels outside the image never count, as with cv2's default dilate
border). It runs on the bounding box of both boundary maps padded by the
radius: every boundary pixel lies inside that box, so the matched counts
are the same as on the full plane, and at 480p the box is a small part of
the frame.

:func:`batched_jaccard` and :func:`batched_f_measure` take ``backend``:
``"auto"`` and ``"native"`` run the host C++ library
(:mod:`ivosw_tpu_torch.ops.metrics_native`, built at first use; a failed
build raises), ``"numpy"`` the plain version above, which the tests hold
the library against.
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage

__all__ = [
    "disk_kernel",
    "batched_jaccard",
    "batched_f_measure",
    "sequence_metric",
    "auc_from_curve",
    "seg2bmap",
]


def disk_kernel(radius: int) -> np.ndarray:
    """Disk structuring element ``x² + y² ≤ r²`` of the given radius, uint8."""
    r = int(radius)
    y, x = np.mgrid[-r : r + 1, -r : r + 1]
    return (x * x + y * y <= r * r).astype(np.uint8)


def seg2bmap(seg: np.ndarray) -> np.ndarray:
    """1-pixel-wide boundary map of a binary segmentation (DAVIS semantics).

    A pixel is boundary if it differs from its east, south, or south-east
    neighbour; the last row/column compare against east/south only.
    """
    seg = seg.astype(bool)
    e = np.zeros_like(seg)
    s = np.zeros_like(seg)
    se = np.zeros_like(seg)
    e[:, :-1] = seg[:, 1:]
    s[:-1, :] = seg[1:, :]
    se[:-1, :-1] = seg[1:, 1:]

    b = (seg ^ e) | (seg ^ s) | (seg ^ se)
    b[-1, :] = seg[-1, :] ^ e[-1, :]
    b[:, -1] = seg[:, -1] ^ s[:, -1]
    b[-1, -1] = False
    return b


def _matched_counts(fg_boundary, gt_boundary, radius):
    """(#gt boundary px within ``radius`` of a fg boundary px, and vice versa).

    Equal to ANDing each map with the other dilated by the radius-r disk
    ``x² + y² ≤ r²``:
    a pixel lies in that dilation iff its Euclidean distance to the nearest
    set pixel is ≤ radius, and the exact distance transform decides that
    without rounding (integer squared distances, correctly rounded sqrt)."""
    both = fg_boundary | gt_boundary
    ys, xs = np.nonzero(both)
    r = int(radius)
    h, w = both.shape
    y0, y1 = max(int(ys.min()) - r, 0), min(int(ys.max()) + r + 1, h)
    x0, x1 = max(int(xs.min()) - r, 0), min(int(xs.max()) + r + 1, w)
    fg = fg_boundary[y0:y1, x0:x1]
    gt = gt_boundary[y0:y1, x0:x1]
    fg_near = ndimage.distance_transform_edt(~fg) <= r
    gt_near = ndimage.distance_transform_edt(~gt) <= r
    return int((gt & fg_near).sum()), int((fg & gt_near).sum())


def f_measure_single(
    pred_mask: np.ndarray, gt_mask: np.ndarray, bound_th: float = 0.008
) -> float:
    """Boundary F-measure of one binary (pred, gt) pair."""
    bound_pix = (
        bound_th
        if bound_th >= 1
        else int(np.ceil(bound_th * np.linalg.norm(pred_mask.shape)))
    )
    fg_boundary = seg2bmap(pred_mask)
    gt_boundary = seg2bmap(gt_mask)

    n_fg = fg_boundary.sum()
    n_gt = gt_boundary.sum()

    if n_fg == 0 and n_gt > 0:
        precision, recall = 1.0, 0.0
    elif n_fg > 0 and n_gt == 0:
        precision, recall = 0.0, 1.0
    elif n_fg == 0 and n_gt == 0:
        precision, recall = 1.0, 1.0
    else:
        gt_match, fg_match = _matched_counts(fg_boundary, gt_boundary, bound_pix)
        precision = fg_match / float(n_fg)
        recall = gt_match / float(n_gt)

    if precision + recall == 0:
        return 0.0
    return 2.0 * precision * recall / (precision + recall)


def _use_native(backend: str) -> bool:
    if backend not in ("auto", "native", "numpy"):
        raise ValueError(f"backend must be 'auto', 'native' or 'numpy', got {backend!r}")
    return backend != "numpy"


def _check_inputs(y_true, y_pred, nb_objects):
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    if y_true.shape != y_pred.shape:
        raise ValueError(
            f"shape mismatch: gt {y_true.shape} vs pred {y_pred.shape}"
        )
    if y_true.ndim != 3:
        raise ValueError(f"expected [T, H, W] label masks, got {y_true.shape}")
    if nb_objects is None:
        nb_objects = int(max(y_true.max(), 1))
    return y_true, y_pred, int(nb_objects)


def batched_jaccard(
    y_true: np.ndarray,
    y_pred: np.ndarray,
    average_over_objects: bool = True,
    nb_objects: int | None = None,
    backend: str = "auto",
) -> np.ndarray:
    """Per-frame Jaccard over object ids 1..nb_objects.

    Returns [T] if averaged over objects else [T, nb_objects]."""
    y_true, y_pred, nb_objects = _check_inputs(y_true, y_pred, nb_objects)
    if _use_native(backend):
        from ivosw_tpu_torch.ops.metrics_native import batched_jaccard_native

        jac = batched_jaccard_native(y_true, y_pred, nb_objects)
        return jac.mean(axis=1) if average_over_objects else jac
    T = y_true.shape[0]
    jac = np.empty((T, nb_objects), dtype=np.float64)
    for j in range(nb_objects):
        mask_true = y_true == j + 1
        mask_pred = y_pred == j + 1
        union = np.count_nonzero(mask_true | mask_pred, axis=(1, 2))
        inter = np.count_nonzero(mask_true & mask_pred, axis=(1, 2))
        jac[:, j] = np.where(union == 0, 1.0, inter / np.maximum(union, 1))
    if average_over_objects:
        return jac.mean(axis=1)
    return jac


def batched_f_measure(
    y_true: np.ndarray,
    y_pred: np.ndarray,
    average_over_objects: bool = True,
    nb_objects: int | None = None,
    bound_th: float = 0.008,
    backend: str = "auto",
) -> np.ndarray:
    """Per-frame boundary F-measure over object ids 1..nb_objects."""
    y_true, y_pred, nb_objects = _check_inputs(y_true, y_pred, nb_objects)
    if _use_native(backend):
        from ivosw_tpu_torch.ops.metrics_native import batched_f_measure_native

        f = batched_f_measure_native(y_true, y_pred, nb_objects, bound_th)
        return f.mean(axis=1) if average_over_objects else f
    T = y_true.shape[0]
    f = np.empty((T, nb_objects), dtype=np.float64)
    for t in range(T):
        for j in range(nb_objects):
            obj_id = j + 1
            f[t, j] = f_measure_single(
                y_pred[t] == obj_id, y_true[t] == obj_id, bound_th=bound_th
            )
    if average_over_objects:
        return f.mean(axis=1)
    return f


def sequence_metric(
    metric_to_optimize: str,
    gt_masks: np.ndarray,
    pred_masks: np.ndarray,
    nb_objects: int,
    average_over_objects: bool = True,
    convert_to_single_obj: bool = False,
) -> np.ndarray:
    """Per-frame J / F / J&F curve."""
    if convert_to_single_obj:
        gt_masks = np.where(gt_masks > 0, 1, 0)
        pred_masks = np.where(pred_masks > 0, 1, 0)
        nb_objects = 1

    if metric_to_optimize == "J":
        return batched_jaccard(
            gt_masks, pred_masks, average_over_objects, nb_objects
        )
    if metric_to_optimize == "F":
        return batched_f_measure(
            gt_masks, pred_masks, average_over_objects, nb_objects
        )
    if metric_to_optimize == "J_AND_F":
        jac = batched_jaccard(
            gt_masks, pred_masks, average_over_objects, nb_objects
        )
        con = batched_f_measure(
            gt_masks, pred_masks, average_over_objects, nb_objects
        )
        return 0.5 * jac + 0.5 * con
    raise NotImplementedError(metric_to_optimize)


def auc_from_curve(curve) -> float:
    """AUC of the quality-vs-round curve: trapezoid normalised by (n-1)."""
    curve = np.asarray(curve, dtype=np.float64)
    if len(curve) < 2:
        return float(curve.mean()) if len(curve) else 0.0
    return float(np.trapezoid(curve) / (len(curve) - 1))
