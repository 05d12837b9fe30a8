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


@pytest.mark.parametrize("h,w,s", [(48, 64, 64), (50, 70, 32), (480, 854, 256)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("inputs", [torch.float32, torch.bfloat16])
def test_pair_kernel_matches_plain(cuda, h, w, s, dtype, inputs):
    from ivosw_tpu_torch.kernels.roi_crop import (
        PAIR_BF16_ATOL,
        roi_crop_pairs,
        roi_crop_pairs_reference,
    )

    frames, probs, yxhw = _pair_case(cuda, h, w, 3, 4, seed=w)
    frames, probs = frames.to(inputs), probs.to(inputs)
    before = roi_crop_pairs.launches
    out = roi_crop_pairs(frames, probs, yxhw, s, dtype, obj_offset=1)
    ref = roi_crop_pairs_reference(frames, probs, yxhw, s, dtype, obj_offset=1)
    torch.cuda.synchronize()
    assert roi_crop_pairs.launches == before + 1
    assert out.shape == (12, s, s, 4) and out.dtype == dtype
    atol = F32_CROP_ATOL if dtype == torch.float32 else PAIR_BF16_ATOL
    assert float((out.float() - ref.float()).abs().max()) <= atol


@pytest.mark.parametrize("h,w,s", [(48, 64, 64), (50, 70, 32), (192, 256, 256)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("matrices", ["bilinear", "random"])
def test_premat_kernel_matches_plain(cuda, h, w, s, dtype, matrices):
    """The kernel reads the given matrices: bilinear ones from the boxes,
    and seeded random dense ones (rows summing to about 1)."""
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
    assert torch.isfinite(roi_crop_pairs_premat(frames, probs, yxhw, 8).float()).all()
