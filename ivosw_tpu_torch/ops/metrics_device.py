"""Batched J/F metrics as tensor programs on the tensors' device.

Counterpart of ``ivosw_tpu/ops/metrics_jax.py``, with the same semantics as
the host metrics (:mod:`ivosw_tpu_torch.ops.metrics`), batched over frames ×
objects so the training step computes its regression target where its
tensors live:

- the boundary map is seg2bmap's shifted XORs;
- the disk-tolerance dilation is one float32 convolution with the disk
  kernel, thresholded at 0.5. Its inputs are 0/1 and its sums integers below
  2²⁴, so it is exact in float32 (and in TF32, whose products of 0/1 are
  exact too; ``device.py`` turns TF32 off anyway);
- Jaccard is two masked reductions.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ivosw_tpu_torch.ops.metrics import disk_kernel


def _boundary_map(seg: torch.Tensor) -> torch.Tensor:
    """seg2bmap on a [..., H, W] mask: a pixel differs from its east, south
    or south-east neighbour (the image edge replicated); the last row and
    column compare east / south only, and the far corner is never boundary."""
    seg = seg.bool()
    e = torch.cat([seg[..., :, 1:], seg[..., :, -1:]], dim=-1)
    s = torch.cat([seg[..., 1:, :], seg[..., -1:, :]], dim=-2)
    se_row = torch.cat([seg[..., 1:, 1:], seg[..., 1:, -1:]], dim=-1)
    se = torch.cat([se_row, torch.zeros_like(seg[..., -1:, :])], dim=-2)

    b = (seg ^ e) | (seg ^ s) | (seg ^ se)
    b = torch.cat([b[..., :-1, :], seg[..., -1:, :] ^ e[..., -1:, :]], dim=-2)
    b = torch.cat([b[..., :, :-1], seg[..., :, -1:] ^ s[..., :, -1:]], dim=-1)
    last_row = torch.cat([b[..., -1:, :-1], torch.zeros_like(b[..., -1:, -1:])], dim=-1)
    return torch.cat([b[..., :-1, :], last_row], dim=-2)


def _dilate(mask: torch.Tensor, kernel: np.ndarray) -> torch.Tensor:
    """Binary dilation of [N, H, W] masks with a [k, k] 0/1 kernel (zeros
    beyond the image)."""
    k = kernel.shape[0]
    weight = torch.as_tensor(kernel, dtype=torch.float32, device=mask.device)[None, None]
    y = F.conv2d(mask.float()[:, None], weight, padding=k // 2)
    return y[:, 0] > 0.5


def batched_jaccard_device(
    y_true: torch.Tensor, y_pred: torch.Tensor, nb_objects: int
) -> torch.Tensor:
    """Per-frame, per-object Jaccard of [T, H, W] label maps → [T, nb_objects]
    float32 (an empty union scores 1)."""
    ids = torch.arange(1, nb_objects + 1, device=y_true.device)[None, :, None, None]
    mt = y_true[:, None] == ids
    mp = y_pred[:, None] == ids
    inter = (mt & mp).sum(dim=(-2, -1)).float()
    union = (mt | mp).sum(dim=(-2, -1)).float()
    return torch.where(union == 0, 1.0, inter / torch.clamp_min(union, 1.0))


def _f_measure_flat(pred_b, gt_b, kernel):
    """pred_b / gt_b [N, H, W] binary masks → [N] boundary F."""
    fg_boundary = _boundary_map(pred_b)
    gt_boundary = _boundary_map(gt_b)
    fg_dil = _dilate(fg_boundary, kernel)
    gt_dil = _dilate(gt_boundary, kernel)

    gt_match = (gt_boundary & fg_dil).sum(dim=(-2, -1)).float()
    fg_match = (fg_boundary & gt_dil).sum(dim=(-2, -1)).float()
    n_fg = fg_boundary.sum(dim=(-2, -1)).float()
    n_gt = gt_boundary.sum(dim=(-2, -1)).float()

    precision = torch.where(n_fg == 0, 1.0, fg_match / torch.clamp_min(n_fg, 1.0))
    precision = torch.where((n_fg > 0) & (n_gt == 0), 0.0, precision)
    recall = torch.where(n_gt == 0, 1.0, gt_match / torch.clamp_min(n_gt, 1.0))
    recall = torch.where((n_gt > 0) & (n_fg == 0), 0.0, recall)

    denom = precision + recall
    f = 2.0 * precision * recall / torch.clamp_min(denom, 1e-12)
    return torch.where(denom == 0, 0.0, f)


def batched_f_measure_device(
    y_true: torch.Tensor, y_pred: torch.Tensor, nb_objects: int, bound_th: float = 0.008
) -> torch.Tensor:
    """Per-frame, per-object boundary F of [T, H, W] label maps →
    [T, nb_objects] float32, within ``ceil(bound_th · hypot(H, W))`` px."""
    t, h, w = y_true.shape
    bound_pix = int(bound_th) if bound_th >= 1 else int(np.ceil(bound_th * np.hypot(h, w)))
    ids = torch.arange(1, nb_objects + 1, device=y_true.device)[None, :, None, None]
    gt_b = (y_true[:, None] == ids).reshape(t * nb_objects, h, w)
    pr_b = (y_pred[:, None] == ids).reshape(t * nb_objects, h, w)
    return _f_measure_flat(pr_b, gt_b, disk_kernel(bound_pix)).reshape(t, nb_objects)


def sequence_metric_device(
    metric_to_optimize: str, gt_masks: torch.Tensor, pred_masks: torch.Tensor, nb_objects: int
) -> torch.Tensor:
    """Per-frame J / F / J&F curve averaged over objects → [T]."""
    if metric_to_optimize == "J":
        return batched_jaccard_device(gt_masks, pred_masks, nb_objects).mean(dim=1)
    if metric_to_optimize == "F":
        return batched_f_measure_device(gt_masks, pred_masks, nb_objects).mean(dim=1)
    if metric_to_optimize == "J_AND_F":
        j = batched_jaccard_device(gt_masks, pred_masks, nb_objects).mean(dim=1)
        f = batched_f_measure_device(gt_masks, pred_masks, nb_objects).mean(dim=1)
        return 0.5 * j + 0.5 * f
    raise NotImplementedError(metric_to_optimize)
