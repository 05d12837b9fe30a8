"""The port's CUDA kernels against their plain versions, on the card.

Marked ``requires_cuda``: without a CUDA device they skip (the decision is
taken inside the fixture, never at import). On a machine with the card:
``python -m pytest -m requires_cuda tests/test_torch_kernels_cuda.py``.
This file imports no JAX, so it runs where only torch is installed."""

import numpy as np
import pytest
import torch

from ivosw_tpu_torch.kernels.roi_crop import (
    BF16_CROP_ATOL,
    F32_CROP_ATOL,
    roi_crop_pairs_fusedbox,
    roi_crop_pairs_fusedbox_reference,
)
from torch_port_cases import edge_case_probs, frames_like

pytestmark = pytest.mark.requires_cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ivosw_tpu_torch.device import resolve_device

    return resolve_device(None)


@pytest.mark.parametrize("h,w,s", [(48, 64, 64), (192, 256, 256), (480, 854, 256)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fusedbox_kernel_matches_plain(cuda, h, w, s, dtype):
    t, o = 2, 5  # background plane + 4 objects, read through obj_offset=1
    probs = torch.from_numpy(edge_case_probs(t, o, h, w, seed=h)).to(cuda)
    frames = torch.from_numpy(frames_like(t, h, w)).to(cuda)
    before = roi_crop_pairs_fusedbox.launches
    out, boxes = roi_crop_pairs_fusedbox(frames, probs, s, dtype, obj_offset=1,
                                         return_boxes=True)
    ref, ref_boxes = roi_crop_pairs_fusedbox_reference(frames, probs, s, dtype,
                                                       obj_offset=1, return_boxes=True)
    torch.cuda.synchronize()
    assert roi_crop_pairs_fusedbox.launches == before + 1
    assert out.shape == (t * (o - 1), s, s, 4) and out.dtype == dtype
    assert torch.equal(boxes, ref_boxes)
    atol = F32_CROP_ATOL if dtype == torch.float32 else BF16_CROP_ATOL
    assert float((out.float() - ref.float()).abs().max()) <= atol


def test_fusedbox_kernel_rejects_bad_inputs(cuda):
    frames = torch.zeros((2, 16, 16, 3), device=cuda)
    probs = torch.zeros((2, 2, 16, 16), device=cuda)
    with pytest.raises(TypeError):
        roi_crop_pairs_fusedbox(frames.double(), probs, 8)
    with pytest.raises(ValueError):
        roi_crop_pairs_fusedbox(frames, probs.transpose(2, 3), 8)
    with pytest.raises(ValueError):
        roi_crop_pairs_fusedbox(frames, probs.cpu(), 8)
    with pytest.raises(ValueError):
        roi_crop_pairs_fusedbox(frames, probs[:1], 8)
    assert np.isfinite(roi_crop_pairs_fusedbox(frames, probs, 8).float().cpu().numpy()).all()


@pytest.mark.parametrize("h,w,c,s", [(48, 64, 1, 64), (96, 128, 3, 256), (480, 854, 4, 256)])
def test_roi_crop_kernel_matches_plain(cuda, h, w, c, s):
    """Boxes from edge-case masks plus boxes far outside the image."""
    from ivosw_tpu_torch.kernels.roi_crop import roi_crop, roi_crop_reference
    from ivosw_tpu_torch.ops.roi import mask_to_yxhw

    masks = torch.from_numpy(edge_case_probs(1, 9, h, w, seed=w)[0] > 0.5).to(cuda)
    yxhw = torch.cat([mask_to_yxhw(masks, 1.5), torch.tensor(
        [[-40.0, -60.0, 20.0, 30.0], [h + 30.0, w / 2, 50.0, 25.0], [h / 2, w / 2, 4.0 * h, 4.0 * w]],
        device=cuda)])
    images = torch.rand((len(yxhw), h, w, c), device=cuda)
    before = roi_crop.launches
    out = roi_crop(images, yxhw, s)
    ref = roi_crop_reference(images, yxhw, s)
    torch.cuda.synchronize()
    assert roi_crop.launches == before + 1
    assert out.shape == (len(yxhw), s, s, c) and out.dtype == torch.float32
    assert float((out - ref).abs().max()) <= F32_CROP_ATOL


def test_roi_crop_kernel_rejects_bad_inputs(cuda):
    from ivosw_tpu_torch.kernels.roi_crop import roi_crop

    images = torch.zeros((2, 16, 16, 4), device=cuda)
    yxhw = torch.tensor([[8.0, 8.0, 10.0, 10.0]] * 2, device=cuda)
    with pytest.raises(TypeError):
        roi_crop(images.double(), yxhw, 8)
    with pytest.raises(ValueError):
        roi_crop(images.transpose(1, 2), yxhw, 8)
    with pytest.raises(ValueError):
        roi_crop(images, yxhw.cpu(), 8)
    with pytest.raises(ValueError):
        roi_crop(images, yxhw[:1], 8)
    assert torch.isfinite(roi_crop(images, yxhw, 8)).all()


def _pair_case(cuda, h, w, t, o, seed):
    """Frames, [T, O+1, H, W] probs (background plane 0) and yxhw boxes of
    their edge-case masks, with the last pairs' boxes moved far outside the
    image, partly outside, and around the whole image."""
    from ivosw_tpu_torch.ops.roi import mask_to_yxhw

    probs = torch.from_numpy(edge_case_probs(t, o + 1, h, w, seed=seed)).to(cuda)
    frames = torch.from_numpy(frames_like(t, h, w)).to(cuda)
    yxhw = mask_to_yxhw((probs[:, 1:] > 0.5).reshape(t * o, h, w), 1.5)
    yxhw[-3:] = torch.tensor([[-40.0, -60.0, 20.0, 30.0], [h + 3.0, w / 2, 50.0, 25.0],
                              [h / 2, w / 2, 4.0 * h, 4.0 * w]], device=cuda)
    return frames, probs, yxhw


def _off_base(x, offset):
    """x copied into storage that starts ``offset`` values before it (a
    base off 16 bytes for offset 1)."""
    flat = torch.zeros(x.numel() + offset, dtype=x.dtype, device=x.device)
    flat[offset:] = x.flatten()
    return flat[offset:].view(x.shape)


def _box_layout(yxhw, layout):
    """yxhw as given, as a column slice of a wider tensor (row stride 7),
    or as the transposed view of a [4, T·O] tensor (strides (1, T·O))."""
    if layout == "column_slice":
        wide = torch.zeros((len(yxhw), 7), dtype=yxhw.dtype, device=yxhw.device)
        wide[:, 2:6] = yxhw
        return wide[:, 2:6]
    if layout == "transposed":
        return yxhw.t().contiguous().t()
    return yxhw


MIXES = [(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
         (torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16)]


@pytest.mark.parametrize("h,w,s", [(48, 64, 64), (50, 70, 32), (49, 71, 100), (50, 70, 300),
                                   (480, 854, 256)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("inputs", MIXES, ids=["f32", "bf16", "bf16_frames", "bf16_probs"])
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("boxes", ["contiguous", "column_slice", "transposed", "bf16",
                                   "bf16_column_slice"])
def test_pair_kernel_matches_plain(cuda, h, w, s, dtype, inputs, offset, boxes):
    """12 pairs: boxes of edge-case masks, then boxes of zero width, of
    negative height and width, right of the image, far outside it, across
    its bottom edge and around it (the span clamped at both ends). Odd
    sizes take narrow span loads, and so do frames and probs whose base is
    one value off a 16-byte boundary (``offset``); S=300 is past the
    columns whose taps a thread keeps. Boxes read through their strides,
    float32 or bfloat16 (edges rounded to bfloat16, as the plain version
    computes them); one launch per call."""
    from ivosw_tpu_torch.kernels.roi_crop import (
        PAIR_BF16_ATOL,
        roi_crop_pairs,
        roi_crop_pairs_reference,
    )

    frames, probs, yxhw = _pair_case(cuda, h, w, 3, 4, seed=w)
    yxhw[-6:-3] = torch.tensor([[h / 2, w / 3, 30.0, 0.0], [h / 2, w / 2, -40.0, -60.0],
                                [h / 3, 3.0 * w, 20.0, w / 2]], device=cuda)
    frames = _off_base(frames.to(inputs[0]), offset)
    probs = _off_base(probs.to(inputs[1]), offset)
    if boxes.startswith("bf16"):
        yxhw = yxhw.to(torch.bfloat16)
    ref = roi_crop_pairs_reference(frames, probs, yxhw, s, dtype, obj_offset=1)
    yxhw = _box_layout(yxhw, boxes.removeprefix("bf16_"))
    assert yxhw.is_contiguous() == (boxes in ("contiguous", "bf16"))
    before = roi_crop_pairs.launches
    out = roi_crop_pairs(frames, probs, yxhw, s, dtype, obj_offset=1)
    torch.cuda.synchronize()
    assert roi_crop_pairs.launches == before + 1
    assert out.shape == (12, s, s, 4) and out.dtype == dtype
    atol = F32_CROP_ATOL if dtype == torch.float32 else PAIR_BF16_ATOL
    assert float((out.float() - ref.float()).abs().max()) <= atol


@pytest.mark.parametrize("h,w,s", [(48, 64, 64), (50, 70, 32), (192, 256, 256),
                                   (480, 854, 256), (49, 71, 24)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("matrices", ["bilinear", "random"])
def test_premat_kernel_matches_plain(cuda, h, w, s, dtype, matrices):
    """The kernel reads the given matrices: bilinear ones from the boxes,
    and seeded random dense ones (rows summing to about 1). 480×854 is the
    main width: 1708-byte rows, K tails of 480 and 854 against 32-deep
    steps, planes off 16-byte boundaries; 49×71 takes the bf16 route's
    padding to even sizes."""
    from ivosw_tpu_torch.kernels.roi_crop import (
        PAIR_BF16_ATOL,
        PREMAT_BF16_ATOL,
        PREMAT_F32_RTOL,
        interp_matrices,
        roi_crop_pairs_premat,
        roi_crop_pairs_premat_reference,
    )

    frames, probs, yxhw = _pair_case(cuda, h, w, 2, 3, seed=h)
    if matrices == "bilinear":
        ry, rx = interp_matrices(yxhw, h, w, s)
    else:
        g = torch.Generator(device=cuda).manual_seed(s)
        ry = torch.rand((6, s, h), generator=g, device=cuda) * (2.0 / h)
        rx = torch.rand((6, s, w), generator=g, device=cuda) * (2.0 / w)
    before = roi_crop_pairs_premat.launches
    out = roi_crop_pairs_premat(frames, probs, dtype=dtype, obj_offset=1, ry=ry, rx=rx)
    ref = roi_crop_pairs_premat_reference(frames, probs, ry, rx, dtype, obj_offset=1)
    torch.cuda.synchronize()
    assert roi_crop_pairs_premat.launches == before + 1
    assert out.shape == (6, s, s, 4) and out.dtype == dtype
    err = float((out.float() - ref.float()).abs().max())
    if dtype == torch.float32:
        assert err <= max(F32_CROP_ATOL, PREMAT_F32_RTOL * float(ref.abs().max()))
    else:
        assert err <= (PAIR_BF16_ATOL if matrices == "bilinear" else PREMAT_BF16_ATOL)


@pytest.mark.parametrize("frames_type,probs_type", [
    (torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32),
    (torch.float32, torch.bfloat16),
])
def test_fusedbox_kernel_reads_bf16_inputs(cuda, frames_type, probs_type):
    """assess_net.bf16_inputs: bf16 frames and planes, boxes thresholded on
    the exact float32 upcast."""
    t, o, h, w = 2, 5, 480, 854
    probs = torch.from_numpy(edge_case_probs(t, o, h, w, seed=7)).to(cuda).to(probs_type)
    frames = torch.from_numpy(frames_like(t, h, w)).to(cuda).to(frames_type)
    out, boxes = roi_crop_pairs_fusedbox(frames, probs, 256, torch.bfloat16, obj_offset=1,
                                         return_boxes=True)
    ref, ref_boxes = roi_crop_pairs_fusedbox_reference(frames, probs, 256, torch.bfloat16,
                                                       obj_offset=1, return_boxes=True)
    torch.cuda.synchronize()
    assert torch.equal(boxes, ref_boxes)
    assert float((out.float() - ref.float()).abs().max()) <= BF16_CROP_ATOL


def test_pair_kernels_reject_bad_inputs(cuda):
    from ivosw_tpu_torch.kernels.roi_crop import roi_crop_pairs, roi_crop_pairs_premat

    frames = torch.zeros((2, 16, 16, 3), device=cuda)
    probs = torch.zeros((2, 2, 16, 16), device=cuda)
    yxhw = torch.tensor([[8.0, 8.0, 10.0, 10.0]] * 4, device=cuda)
    with pytest.raises(TypeError):
        roi_crop_pairs(frames.double(), probs, yxhw, 8)
    for box_dtype in (torch.float64, torch.float16):  # as on the CPU route
        with pytest.raises(TypeError, match="float32 or bfloat16 yxhw"):
            roi_crop_pairs(frames, probs, yxhw.to(box_dtype), 8)
    with pytest.raises(ValueError):
        roi_crop_pairs(frames, probs, yxhw[:3], 8)
    with pytest.raises(ValueError):
        roi_crop_pairs(frames, probs, yxhw.cpu(), 8)
    with pytest.raises(ValueError):
        roi_crop_pairs_premat(frames, probs.transpose(2, 3), yxhw, 8)
    with pytest.raises(ValueError):
        roi_crop_pairs(frames.requires_grad_(), probs, yxhw, 8)
    frames = frames.detach()
    assert torch.isfinite(roi_crop_pairs(frames, probs, yxhw, 8).float()).all()
    assert torch.isfinite(roi_crop_pairs(frames, probs, yxhw.bfloat16(), 8).float()).all()
    assert torch.isfinite(roi_crop_pairs_premat(frames, probs, yxhw, 8).float()).all()


@pytest.mark.parametrize("c", [1, 3, 4])
def test_roi_crop_kernel_ragged_shapes_and_strided_boxes(cuda, c):
    """An odd batch, odd image sizes and S=37, so the output pixels are no
    multiple of a thread's rows or of a block's columns; boxes read through
    a non-contiguous view. One launch per call."""
    from ivosw_tpu_torch.kernels.roi_crop import roi_crop, roi_crop_reference
    from ivosw_tpu_torch.ops.roi import mask_to_yxhw

    h, w, s = 49, 71, 37
    masks = torch.from_numpy(edge_case_probs(1, 5, h, w, seed=c)[0] > 0.5).to(cuda)
    boxes = mask_to_yxhw(masks, 1.5)
    wide = torch.zeros((len(boxes), 7), device=cuda)
    wide[:, 1:5] = boxes
    yxhw = wide[:, 1:5]  # row stride 7
    assert not yxhw.is_contiguous()
    images = torch.rand((len(boxes), h, w, c), device=cuda)
    before = roi_crop.launches
    out = roi_crop(images, yxhw, s)
    ref = roi_crop_reference(images, boxes, s)
    torch.cuda.synchronize()
    assert roi_crop.launches == before + 1
    assert out.shape == (len(boxes), s, s, c)
    assert float((out - ref).abs().max()) <= F32_CROP_ATOL


def test_roi_crop_kernel_whole_pixels_need_an_aligned_base(cuda):
    """At C=4 an image batch starting off a 16-byte boundary raises; one
    starting on one (a later image of a batch) is cropped."""
    from ivosw_tpu_torch.kernels.roi_crop import roi_crop, roi_crop_reference

    flat = torch.rand(3 * 16 * 16 * 4 + 1, device=cuda)
    yxhw = torch.tensor([[8.0, 8.0, 10.0, 12.0], [3.0, 4.0, 20.0, 20.0]], device=cuda)
    with pytest.raises(ValueError, match="16-byte"):
        roi_crop(flat[1:1 + 2 * 16 * 16 * 4].view(2, 16, 16, 4), yxhw, 8)
    images = flat[:3 * 16 * 16 * 4].view(3, 16, 16, 4)[1:]
    out = roi_crop(images, yxhw, 8)
    torch.cuda.synchronize()
    assert float((out - roi_crop_reference(images, yxhw, 8)).abs().max()) <= F32_CROP_ATOL


def _single_pixel_planes(h, w, flat_positions, seed):
    """[1, 1 + n, h, w] prob maps, background plane 0, object plane k holding
    one foreground value at flat index flat_positions[k] over noise < 0.5."""
    rng = np.random.default_rng(seed)
    probs = (rng.random((1, 1 + len(flat_positions), h * w)) * 0.5).astype(np.float32)
    for k, f in enumerate(flat_positions):
        probs[0, 1 + k, f] = 0.75
    return probs.reshape(1, 1 + len(flat_positions), h, w)


@pytest.mark.parametrize("h,w", [(49, 71), (50, 70), (480, 854)])
@pytest.mark.parametrize("inputs", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("offset", [0, 1])
def test_fusedbox_box_pass_edges(cuda, h, w, inputs, offset):
    """Planes whose only foreground value lies at the first or last value of
    the plane, in the tail past its last whole 16-byte load, on each side
    of a band boundary of the box pass, and at the last value of a row.
    49×71 planes are off 16-byte boundaries (one-value loads), 50×70 bf16
    planes take 8-byte loads; ``offset`` 1 starts the probs one value past
    an aligned base, which narrows the loads again. Boxes bit-equal, crops
    within the bounds, with both input types."""
    from ivosw_tpu_torch.kernels.roi_crop import (
        BOX_BAND_LOADS,
        box_bands,
        plane_load_bytes,
    )

    itemsize = torch.tensor([], dtype=inputs).element_size()
    hw = h * w
    last_whole = hw * itemsize // 16 * 16 // itemsize  # first value past whole 16-byte loads
    positions = [0, hw - 1, min(last_whole, hw - 1), w - 1, w * (h // 2) + w - 1]
    # torch's allocations start on 256-byte boundaries, so the load width
    # follows from the offset and the plane size
    width = plane_load_bytes(offset * itemsize, hw * itemsize, itemsize)
    per_band = BOX_BAND_LOADS * width // itemsize  # values per band
    if per_band < hw:
        positions += [per_band - 1, per_band]
    planes = _single_pixel_planes(h, w, sorted(set(positions)), seed=h + offset)
    flat = torch.zeros(planes.size + offset, dtype=inputs, device=cuda)
    flat[offset:] = torch.from_numpy(planes.ravel()).to(cuda).to(inputs)
    probs = flat[offset:].view(planes.shape)
    assert plane_load_bytes(probs.data_ptr(), hw * itemsize, itemsize) == width
    assert (offset == 0 and hw * itemsize % 16 == 0) == (width == 16)
    assert (per_band < hw) == (box_bands(hw * itemsize, width) > 1)
    frames = torch.from_numpy(frames_like(1, h, w)).to(cuda).to(inputs)
    for dtype in (torch.bfloat16, torch.float32):
        out, boxes = roi_crop_pairs_fusedbox(frames, probs, 64, dtype, obj_offset=1,
                                             return_boxes=True)
        ref, ref_boxes = roi_crop_pairs_fusedbox_reference(frames, probs, 64, dtype,
                                                           obj_offset=1, return_boxes=True)
        torch.cuda.synchronize()
        assert torch.equal(boxes, ref_boxes)
        atol = F32_CROP_ATOL if dtype == torch.float32 else BF16_CROP_ATOL
        assert float((out.float() - ref.float()).abs().max()) <= atol
