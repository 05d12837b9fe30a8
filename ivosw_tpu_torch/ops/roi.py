"""ROI geometry for mask-quality assessment, in plain torch.

Counterpart of ``ivosw_tpu/ops/roi.py``: mask → (y, x, h, w) box with a
minimum 128 px side, 1.5× context expansion clamped to ±5 px beyond the
image, then a bilinear ROI crop with align_corners=True / zeros-padding
semantics. Every function runs in float32 with the JAX package's op order,
so boxes agree bit for bit: the CUDA crop kernel
(:mod:`ivosw_tpu_torch.kernels.roi_crop`) is held against these.

The crop is separable: per-sample 1-D interpolation matrices Ry [S, H] and
Rx [S, W] (≤ 2 non-zeros per row) give ``crop = Ry @ img @ Rxᵀ``. Rows of
coordinates outside [-1, src] are all zero, which is grid_sample's zeros
padding.
"""

from __future__ import annotations

import torch


def mask_to_yxhw(mask: torch.Tensor, scale: float = 1.5, min_side: float = 128.0):
    """Batched mask → (y, x, h, w) ROI boxes [B, 4] float32.

    mask: [B, H, W] bool (already thresholded), or float where values
    ≥ 0.49 are foreground. Empty masks fall back to the whole image
    (ymin=0, ymax=H)."""
    b, h, w = mask.shape
    fg = mask if mask.dtype == torch.bool else mask >= 0.49
    rows = fg.any(dim=2)  # [B, H]
    cols = fg.any(dim=1)  # [B, W]
    any_fg = rows.any(dim=1)  # [B]

    dev = mask.device
    row_idx = torch.arange(h, dtype=torch.float32, device=dev)
    col_idx = torch.arange(w, dtype=torch.float32, device=dev)

    big = torch.tensor(1e9, dtype=torch.float32, device=dev)
    ymin = torch.where(rows, row_idx, big).amin(dim=1)
    ymax = torch.where(rows, row_idx, -big).amax(dim=1)
    xmin = torch.where(cols, col_idx, big).amin(dim=1)
    xmax = torch.where(cols, col_idx, -big).amax(dim=1)

    zero = torch.zeros((), dtype=torch.float32, device=dev)
    ymin = torch.where(any_fg, ymin, zero)
    ymax = torch.where(any_fg, ymax, torch.full((), float(h), device=dev))
    xmin = torch.where(any_fg, xmin, zero)
    xmax = torch.where(any_fg, xmax, torch.full((), float(w), device=dev))

    # minimum box side: floor(res/2) added at each end
    def expand(lo, hi):
        res = min_side - (hi - lo)
        half = torch.floor(res / 2.0)
        return torch.where(res > 0, lo - half, lo), torch.where(res > 0, hi + half, hi)

    ymin, ymax = expand(ymin, ymax)
    xmin, xmax = expand(xmin, xmax)

    # context expansion, clamped to ±5 px beyond the image
    orig_h = ymax - ymin + 1.0
    orig_w = xmax - xmin + 1.0
    grow = (scale - 1.0) / 2.0
    ymin = torch.clamp_min(ymin - grow * orig_h, -5.0)
    ymax = torch.clamp_max(ymax + grow * orig_h, float(h) + 5.0)
    xmin = torch.clamp_min(xmin - grow * orig_w, -5.0)
    xmax = torch.clamp_max(xmax + grow * orig_w, float(w) + 5.0)

    y = (ymax + ymin) / 2.0
    x = (xmax + xmin) / 2.0
    hh = ymax - ymin + 1.0
    ww = xmax - xmin + 1.0
    return torch.stack([y, x, hh, ww], dim=1)


def yxhw_to_minmax(yxhw: torch.Tensor, scale: float = 1.0):
    """(y, x, h, w) → (ymin, ymax, xmin, xmax)."""
    ry, rx, rh, rw = yxhw[:, 0], yxhw[:, 1], scale * yxhw[:, 2], scale * yxhw[:, 3]
    return ry - rh / 2.0, ry + rh / 2.0, rx - rw / 2.0, rx + rw / 2.0


def _interp_matrix(lo: torch.Tensor, hi: torch.Tensor, src_len: int, dst_len: int):
    """Per-sample 1-D bilinear sampling matrix R [B, dst, src] in float32.

    coord(i) = lo + (hi - lo) · i/(dst-1); each row holds the hat weights
    max(0, 1 - |coord - s|)."""
    dev = lo.device
    # a tensor divisor: PyTorch's CUDA division by a Python scalar multiplies
    # by its reciprocal, which is not the rounded quotient i/(dst-1)
    denom = torch.full((), dst_len - 1, dtype=torch.float32, device=dev)
    steps = torch.arange(dst_len, dtype=torch.float32, device=dev) / denom
    coords = lo[:, None] + (hi - lo)[:, None] * steps[None, :]  # [B, dst]
    src = torch.arange(src_len, dtype=torch.float32, device=dev)
    return torch.clamp_min(1.0 - torch.abs(coords[:, :, None] - src[None, None, :]), 0.0)


def roi_crop(
    images: torch.Tensor,
    yxhw: torch.Tensor,
    out_size: int = 256,
    dtype=torch.float32,
) -> torch.Tensor:
    """Batched separable bilinear ROI crop. images: [B, H, W, C] → [B, s, s, C]
    in ``dtype`` (the interpolation matrices and the images are cast to
    ``dtype``; products accumulate in float32)."""
    b, h, w, c = images.shape
    ymin, ymax, xmin, xmax = yxhw_to_minmax(yxhw)
    ry = _interp_matrix(ymin, ymax, h, out_size).to(dtype).float()
    rx = _interp_matrix(xmin, xmax, w, out_size).to(dtype).float()
    img = images.to(dtype).float()
    tmp = torch.einsum("bsh,bhwc->bswc", ry, img).to(dtype).float()
    return torch.einsum("btw,bswc->bstc", rx, tmp).to(dtype)
