"""ROI boxes and crops of the port against the JAX package (CPU).

Boxes must agree bit for bit (same float32 op sequence). Crops: float32
within 1e-5 of the JAX einsum path (summation order only); bfloat16 within 2⁻⁷, two bf16
roundings of values in [0, 1]: the port's plain version repeats the JAX
recipe's casts, so the two differ only where a float32 sum in another order
moves the rounded intermediate by one ulp (≤ 2⁻⁸) and where the JAX einsum
leaves its output unrounded (≤ 2⁻⁹)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ivosw_tpu.kernels import roi_pallas as jax_roi_pallas
from ivosw_tpu.ops import roi as jax_roi
from ivosw_tpu_torch.kernels import roi_crop as port_kernel
from ivosw_tpu_torch.ops import roi as port_roi
from torch_port_cases import edge_case_probs, frames_like

BF16_VS_JAX_ATOL = 2.0**-7
F32_ATOL = 1e-5
SHAPES = [(48, 64), (192, 256), (480, 854)]


def _bits(x):
    return np.asarray(x, dtype=np.float32).view(np.uint32)


@pytest.mark.parametrize("h,w", SHAPES)
def test_mask_to_yxhw_bitexact(h, w):
    probs = edge_case_probs(2, 9, h, w, seed=h)
    flat = probs.reshape(-1, h, w)
    for mask in (flat > 0.5, flat):  # bool path and the >= 0.49 float path
        ref = jax_roi.mask_to_yxhw(jnp.asarray(mask), scale=1.5)
        got = port_roi.mask_to_yxhw(torch.from_numpy(mask), scale=1.5)
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(ref))
        ref_mm = np.stack(jax_roi.yxhw_to_minmax(ref), axis=1)
        got_mm = torch.stack(port_roi.yxhw_to_minmax(got), dim=1).numpy()
        np.testing.assert_array_equal(_bits(got_mm), _bits(ref_mm))


@pytest.mark.parametrize("h,w", SHAPES)
def test_fusedbox_boxes_match_inkernel_boxes(h, w):
    """The plain version's boxes == the Pallas kernel's in-kernel box
    function, plane by plane, bit for bit (480×854 included: boxes are
    cheap, the crop is not run there)."""
    probs = edge_case_probs(1, 9, h, w, seed=w)
    frames = np.zeros((1, h, w, 3), np.float32)
    _, boxes = port_kernel.roi_crop_pairs_fusedbox_reference(
        torch.from_numpy(frames), torch.from_numpy(probs), 4, torch.float32,
        return_boxes=True,
    )
    inkernel = jax.jit(
        lambda p: jnp.stack(jax_roi_pallas._bbox_minmax_inkernel(p, h, w, 1.5, 128.0))
    )
    ref = np.stack([np.asarray(inkernel(jnp.asarray(p))) for p in probs[0]])
    np.testing.assert_array_equal(_bits(boxes.numpy()), _bits(ref))


def test_interp_matrix_and_roi_crop_match_jax():
    rng = np.random.default_rng(3)
    lo = (rng.random(5) * 40 - 8).astype(np.float32)
    hi = lo + (rng.random(5) * 60 + 1).astype(np.float32)
    ref = jax_roi._interp_matrix(jnp.asarray(lo), jnp.asarray(hi), 48, 32)
    got = port_roi._interp_matrix(torch.from_numpy(lo), torch.from_numpy(hi), 48, 32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))

    images = rng.random((3, 40, 56, 4), dtype=np.float32)
    masks = edge_case_probs(1, 3, 40, 56, seed=4)[0] > 0.5
    yxhw = jax_roi.mask_to_yxhw(jnp.asarray(masks), scale=1.5, min_side=16.0)
    ref = jax_roi.roi_crop(jnp.asarray(images), yxhw, 32)
    got = port_roi.roi_crop(torch.from_numpy(images), torch.tensor(np.asarray(yxhw)), 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=F32_ATOL)


@pytest.mark.parametrize("h,w,s", [(48, 64, 64), (192, 256, 256)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fusedbox_crops_match_jax(h, w, s, dtype):
    """Plain fused-box crop vs the JAX einsum path and the Pallas kernel in
    interpret mode, T=2, O=3 (six pairs covering the edge cases)."""
    t, o = 2, 3
    probs = edge_case_probs(t, o, h, w, seed=s)
    frames = frames_like(t, h, w)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    atol = F32_ATOL if dtype == "float32" else BF16_VS_JAX_ATOL

    got = port_kernel.roi_crop_pairs_fusedbox(
        torch.from_numpy(frames), torch.from_numpy(probs), s, tdt
    )
    assert got.dtype == tdt and got.shape == (t * o, s, s, 4)
    got = got.float().numpy()
    tf, tp = jax_roi_pallas.roi_crop_pairs_from_probs(
        jnp.asarray(frames), jnp.asarray(probs), s, dtype=jdt, impl="einsum"
    )
    einsum = np.concatenate([np.asarray(tf, np.float32), np.asarray(tp, np.float32)], -1)
    np.testing.assert_allclose(got, einsum, rtol=0, atol=atol)
    pallas = np.asarray(jax_roi_pallas.roi_crop_pairs_pallas_fusedbox(
        jnp.asarray(frames), jnp.asarray(probs), s, dtype=jdt, interpret=True
    ), np.float32)
    # the Pallas kernel's float32 dots differ from the JAX einsum path
    # itself (4.1e-5 at 192×256); the port can be held no closer than that
    jax_gap = float(np.abs(pallas - einsum).max()) if dtype == "float32" else 0.0
    np.testing.assert_allclose(got, pallas, rtol=0, atol=atol + jax_gap)


def test_object_offset_reads_the_planes_in_place():
    """[T, O+1, H, W] with obj_offset=1 == the sliced [T, O, H, W] planes,
    and from_probs returns rgb/prob views of one crop."""
    probs = edge_case_probs(2, 4, 48, 64, seed=5)
    frames = torch.from_numpy(frames_like(2, 48, 64))
    full = port_kernel.roi_crop_pairs_fusedbox(frames, torch.from_numpy(probs), 32, obj_offset=1)
    sliced = port_kernel.roi_crop_pairs_fusedbox(
        frames, torch.from_numpy(np.ascontiguousarray(probs[:, 1:])), 32
    )
    assert torch.equal(full, sliced)
    tf, tp = port_kernel.roi_crop_pairs_from_probs(
        frames, torch.from_numpy(probs), 32, obj_offset=1, num_objects=3
    )
    assert torch.equal(torch.cat([tf, tp], -1), full)
    with pytest.raises(ValueError):
        port_kernel.roi_crop_pairs_fusedbox(frames, torch.from_numpy(probs), 32, obj_offset=2, num_objects=3)


def _crop_boxes(n_masks, h, w, seed):
    """yxhw boxes of edge-case masks, plus boxes past the ±5 px clamp: far
    outside the image, straddling a corner, degenerate (zero height) and
    larger than the image."""
    masks = edge_case_probs(1, n_masks, h, w, seed=seed)[0] > 0.5
    yxhw = np.asarray(jax_roi.mask_to_yxhw(jnp.asarray(masks), scale=1.5))
    extra = np.array([
        [-40.0, -60.0, 20.0, 30.0],
        [h + 30.0, w / 2, 50.0, 25.0],
        [0.0, w, 3.0 * h, 0.5 * w],
        [h / 2, w / 2, 0.0, w / 3],
        [h / 2, w / 2, 4.0 * h, 4.0 * w],
    ], np.float32)
    return np.concatenate([yxhw, extra]).astype(np.float32)


@pytest.mark.parametrize("c", [1, 3, 4])
@pytest.mark.parametrize("s", [64, 256])
@pytest.mark.parametrize("h,w", [(48, 64), (96, 128)])
def test_roi_crop_matches_pallas_and_einsum(h, w, s, c):
    """The port's roi_crop_best on the CPU (the plain version) against the
    JAX einsum crop, float32 within 1e-5 (summation order only), and against
    the Pallas kernel in interpret mode within 1e-5 plus the JAX package's
    own Pallas-vs-einsum gap on these inputs: its interpreted kernel builds
    the sample coordinates in another float32 op order, which moves crops by
    up to 2.7e-5 here (its own test, test_pallas_roi.py, allows 2e-5)."""
    yxhw = _crop_boxes(9, h, w, seed=s + c)
    images = np.random.default_rng(c).random((len(yxhw), h, w, c), dtype=np.float32)
    got = port_kernel.roi_crop_best(torch.from_numpy(images), torch.from_numpy(yxhw), s)
    assert got.dtype == torch.float32 and got.shape == (len(yxhw), s, s, c)
    pallas = jax_roi_pallas.roi_crop_pallas(jnp.asarray(images), jnp.asarray(yxhw), s,
                                            interpret=True)
    einsum = jax_roi.roi_crop(jnp.asarray(images), jnp.asarray(yxhw), s)
    np.testing.assert_allclose(got.numpy(), np.asarray(einsum), rtol=0, atol=F32_ATOL)
    jax_gap = float(np.abs(np.asarray(pallas) - np.asarray(einsum)).max())
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), rtol=0, atol=F32_ATOL + jax_gap)


def test_roi_crop_wrapper_contract():
    """CPU tensors take the plain version and count no launch; another
    device, or an input that requires a gradient, raises."""
    images = torch.rand((2, 16, 16, 4))
    yxhw = torch.tensor([[8.0, 8.0, 10.0, 12.0], [3.0, 4.0, 20.0, 20.0]])
    before = port_kernel.roi_crop.launches
    out = port_kernel.roi_crop(images, yxhw, 8)
    assert out.shape == (2, 8, 8, 4) and port_kernel.roi_crop.launches == before
    assert torch.equal(out, port_kernel.roi_crop_reference(images, yxhw, 8))
    with pytest.raises(ValueError, match="CUDA device"):
        port_kernel.roi_crop(images.to("meta"), yxhw.to("meta"), 8)
    with pytest.raises(ValueError, match="no backward"):
        port_kernel.roi_crop(images.requires_grad_(), yxhw, 8)


H100_SMS = 132


@pytest.mark.parametrize("h,w,itemsize,offset,want", [
    (480, 854, 2, 0, 16), (480, 854, 4, 0, 16),  # the path: 16-byte planes
    (49, 71, 4, 0, 4), (49, 71, 2, 0, 2),  # odd planes: one value per load
    (50, 70, 2, 0, 8), (50, 70, 4, 0, 16),
    (480, 854, 2, 8, 8), (480, 854, 4, 4, 4), (480, 854, 2, 2, 2),  # bases off 16 bytes
])
def test_box_pass_load_width(h, w, itemsize, offset, want):
    """The fused-box kernel's box pass loads the widest of 16/8/4/2 bytes
    that divides both the probs' base address and one plane's byte size,
    and never less than one value: every plane starts and ends on a load."""
    plane = h * w * itemsize
    width = port_kernel.plane_load_bytes(0x7F0000000000 + offset, plane, itemsize)
    assert width == want
    assert plane % width == 0 and offset % width == 0 and width >= itemsize


def test_box_pass_rejects_values_off_their_alignment():
    with pytest.raises(ValueError, match="aligned"):
        port_kernel.plane_load_bytes(0x1001, 100, 2)
    with pytest.raises(ValueError, match="aligned"):
        port_kernel.plane_load_bytes(0x1002, 100, 4)


@pytest.mark.parametrize("itemsize", [2, 4])
def test_box_pass_fills_the_card_at_the_path_shape(itemsize):
    """At one launch of the scoring round (T=32, O=3, 480×854) the box
    pass runs several blocks per SM of the H100, and its bands cover each
    plane's loads once."""
    plane = 480 * 854 * itemsize
    width = port_kernel.plane_load_bytes(0, plane, itemsize)
    bands = port_kernel.box_bands(plane, width)
    assert 32 * 3 * bands > 4 * H100_SMS
    loads = plane // width
    assert (bands - 1) * port_kernel.BOX_BAND_LOADS < loads <= bands * port_kernel.BOX_BAND_LOADS
    assert port_kernel.box_bands(49 * 71 * itemsize, itemsize) == 2  # 3479 one-value loads


@pytest.mark.parametrize("h,w,channels,itemsize,offset,want", [
    (480, 854, 3, 2, 0, 16), (480, 854, 1, 2, 0, 16),  # the path: bf16 frames and planes
    (480, 854, 3, 4, 0, 16), (480, 854, 1, 4, 0, 16),
    (49, 71, 3, 2, 0, 2), (49, 71, 1, 2, 0, 2), (49, 71, 3, 4, 0, 4), (49, 71, 1, 4, 0, 4),
    (50, 70, 3, 2, 0, 8), (50, 70, 1, 2, 0, 8),
    (480, 854, 3, 2, 2, 2), (480, 854, 1, 4, 4, 4), (480, 854, 3, 2, 8, 8),  # bases off 16 bytes
])
def test_pair_span_load_width(h, w, channels, itemsize, offset, want):
    """The given-box pair kernel loads row spans of frames (3 channels) and
    planes in the widest of 16/8/4/2 bytes that divides both the tensor's
    base and one image's byte size, never less than one value: a span
    aligned down and up to the load stays inside its frame or plane (480×854
    rows are 5124 or 1708 bytes, off 16, yet take 16-byte loads)."""
    image = h * w * channels * itemsize
    width = port_kernel.span_load_bytes(0x7F0000000000 + offset, image, itemsize)
    assert width == want
    assert image % width == 0 and offset % width == 0 and width >= itemsize


def test_pair_span_load_rejects_values_off_their_alignment():
    with pytest.raises(ValueError, match="aligned"):
        port_kernel.span_load_bytes(0x1001, 480 * 854 * 3 * 2, 2)
    with pytest.raises(ValueError, match="aligned"):
        port_kernel.span_load_bytes(0x1002, 480 * 854 * 4, 4)


@pytest.mark.parametrize("frame_size,prob_size", [(2, 2), (4, 4), (2, 4), (4, 2)])
def test_pair_stage_bytes_fit_the_card(frame_size, prob_size):
    """The pair kernel's shared memory at 480×854: each slot holds a row's
    span plus a 16-byte load of head and tail, on a 16-byte boundary; the
    block holds PAIR_STAGES buffers of two frame and two plane slots, and
    at least four blocks fit on an H100 SM."""
    w = 854
    frame_cap, plane_cap, total = port_kernel.pair_stage_bytes(w, frame_size, prob_size)
    assert frame_cap % 16 == 0 and plane_cap % 16 == 0
    assert frame_cap >= w * 3 * frame_size + 32 and plane_cap >= w * prob_size + 32
    assert total == port_kernel.PAIR_STAGES * 2 * (frame_cap + plane_cap)
    assert 4 * total <= port_kernel.MAX_SMEM
    assert port_kernel.pair_stage_bytes(w, 2, 2)[2] == port_kernel.PAIR_STAGES * 13824


def test_pair_stage_bytes_reject_a_frame_too_wide():
    assert port_kernel.pair_stage_bytes(4096, 2, 2)[2] <= port_kernel.MAX_SMEM
    with pytest.raises(ValueError, match="shared memory"):
        port_kernel.pair_stage_bytes(8192, 4, 4)


@pytest.mark.parametrize("c,offset,want", [(4, 0, True), (4, 32, True), (1, 4, False),
                                           (3, 4, False), (2, 8, False), (5, 0, False)])
def test_roi_crop_variant_follows_c(c, offset, want):
    """roi_crop's kernel takes its whole-pixel (16-byte) variant at C=4 and
    its scalar variant at any other C, whatever the base."""
    assert port_kernel.whole_pixel_loads(c, 0x7F0000000000 + offset) is want


def test_roi_crop_whole_pixels_reject_a_misaligned_base():
    """At C=4 a base off a 16-byte boundary raises rather than being read
    as whole pixels, and is never sent to the scalar variant."""
    for offset in (4, 8, 12):
        with pytest.raises(ValueError, match="16-byte"):
            port_kernel.whole_pixel_loads(4, 0x7F0000000000 + offset)


def _pair_boxes(t, o, h, w, seed):
    """yxhw [T·O, 4] of edge-case masks with the last three pairs' boxes
    far outside the image, straddling the bottom edge and around it."""
    masks = edge_case_probs(t, o, h, w, seed=seed).reshape(t * o, h, w) > 0.5
    yxhw = np.array(jax_roi.mask_to_yxhw(jnp.asarray(masks), scale=1.5))
    yxhw[-3:] = [[-40.0, -60.0, 20.0, 30.0], [h + 3.0, w / 2, 50.0, 25.0],
                 [h / 2, w / 2, 4.0 * h, 4.0 * w]]
    return yxhw.astype(np.float32)


@pytest.mark.parametrize("h,w,s", [(48, 64, 64), (50, 70, 32), (192, 256, 256)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("crop", ["pairs", "premat"])
def test_pair_crops_match_pallas_and_einsum(h, w, s, dtype, crop):
    """The plain given-box pair crop (``roi_crop_pairs``) and the plain
    matrix crop (``roi_crop_pairs_premat``) on the CPU against the JAX
    einsum path and the matching Pallas kernel in interpret mode, T=2, O=4,
    the probs read with object offset 1 out of [T, O+1, H, W]."""
    t, o = 2, 4
    probs = edge_case_probs(t, o + 1, h, w, seed=w)
    frames = frames_like(t, h, w)
    yxhw = _pair_boxes(t, o, h, w, seed=h)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    atol = F32_ATOL if dtype == "float32" else BF16_VS_JAX_ATOL
    wrapper = port_kernel.roi_crop_pairs if crop == "pairs" else port_kernel.roi_crop_pairs_premat
    pallas_fn = (jax_roi_pallas.roi_crop_pairs_pallas if crop == "pairs"
                 else jax_roi_pallas.roi_crop_pairs_pallas_premat)

    before = wrapper.launches
    got = wrapper(torch.from_numpy(frames), torch.from_numpy(probs), torch.from_numpy(yxhw), s,
                  tdt, obj_offset=1)
    assert wrapper.launches == before  # the plain version on the CPU
    assert got.dtype == tdt and got.shape == (t * o, s, s, 4)
    got = got.float().numpy()
    jprobs = jnp.asarray(probs[:, 1:])
    tf, tp = jax_roi_pallas.roi_crop_pairs_einsum(jnp.asarray(frames), jprobs, jnp.asarray(yxhw),
                                                  s, dtype=jdt)
    einsum = np.concatenate([np.asarray(tf, np.float32), np.asarray(tp, np.float32)], -1)
    np.testing.assert_allclose(got, einsum, rtol=0, atol=atol)
    pallas = np.asarray(pallas_fn(jnp.asarray(frames), jprobs, jnp.asarray(yxhw), s, dtype=jdt,
                                  interpret=True), np.float32)
    jax_gap = float(np.abs(pallas - einsum).max()) if dtype == "float32" else 0.0
    np.testing.assert_allclose(got, pallas, rtol=0, atol=atol + jax_gap)


@pytest.mark.parametrize("h,w,s", [(48, 64, 64), (50, 70, 32), (192, 256, 256)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pair_crop_takes_bf16_boxes(h, w, s, dtype):
    """bfloat16 yxhw boxes on the CPU route: each edge computed in bfloat16,
    then widened (``roi_pallas.py:320-321``), as the JAX package's Pallas
    kernel (interpret mode) takes them, within the bounds of
    test_pair_crops_match_pallas_and_einsum. The JAX einsum path rounds
    each box's span hi − lo to bfloat16 as well (``ops/roi.py::
    _interp_matrix`` on bfloat16 edges), which moves every sample of the
    pair by up to that rounding: pairs whose spans are exact in bfloat16
    agree with it within the same bound, the others within the bound plus
    their two spans' rounding (frames and planes lie in [0, 1], so a
    bilinear sample moves by at most its coordinate's shift). In float32
    both JAX paths' own gap on these boxes (widened) is added, as there.
    Pair 0's box has edges that bfloat16 rounds (y − h/2 = 33.625 → 33.5)."""
    t, o = 2, 4
    probs = edge_case_probs(t, o + 1, h, w, seed=w)
    frames = frames_like(t, h, w)
    boxes = _pair_boxes(t, o, h, w, seed=h)
    boxes[0] = [40.0, 50.0, 12.75, 9.375]
    yxhw = torch.from_numpy(boxes).to(torch.bfloat16)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    atol = F32_ATOL if dtype == "float32" else BF16_VS_JAX_ATOL

    got = port_kernel.roi_crop_pairs(torch.from_numpy(frames), torch.from_numpy(probs), yxhw, s,
                                     tdt, obj_offset=1).float().numpy()
    jframes, jprobs = jnp.asarray(frames), jnp.asarray(probs[:, 1:])
    jyxhw = jnp.asarray(yxhw.float().numpy()).astype(jnp.bfloat16)
    pallas = np.asarray(jax_roi_pallas.roi_crop_pairs_pallas(jframes, jprobs, jyxhw, s, dtype=jdt,
                                                             interpret=True), np.float32)
    tf, tp = jax_roi_pallas.roi_crop_pairs_einsum(jframes, jprobs, jyxhw, s, dtype=jdt)
    einsum = np.concatenate([np.asarray(tf, np.float32), np.asarray(tp, np.float32)], -1)
    gap = 0.0
    if dtype == "float32":
        wide = jyxhw.astype(jnp.float32)
        tf, tp = jax_roi_pallas.roi_crop_pairs_einsum(jframes, jprobs, wide, s, dtype=jdt)
        gap = float(np.abs(np.asarray(jax_roi_pallas.roi_crop_pairs_pallas(
            jframes, jprobs, wide, s, dtype=jdt, interpret=True))
            - np.concatenate([np.asarray(tf), np.asarray(tp)], -1)).max())
    np.testing.assert_allclose(got, pallas, rtol=0, atol=atol + gap)

    # the einsum path's span rounding, per pair
    edges = [np.asarray(e, np.float32) for e in jax_roi.yxhw_to_minmax(jyxhw)]
    span_shift = sum(
        np.abs(np.asarray((hi - lo).astype(jnp.bfloat16), np.float32)
               - (np.asarray(hi, np.float32) - np.asarray(lo, np.float32)))
        for lo, hi in ((edges[0], edges[1]), (edges[2], edges[3])))
    assert (span_shift == 0).any()
    for i in range(t * o):
        np.testing.assert_allclose(got[i], einsum[i], rtol=0,
                                   atol=atol + gap + span_shift[i], err_msg=f"pair {i}")
    # float32 boxes of the same values crop pair 0 elsewhere: its edges
    # are not rounded to bfloat16 there
    f32 = port_kernel.roi_crop_pairs(torch.from_numpy(frames), torch.from_numpy(probs),
                                     yxhw.float(), s, tdt, obj_offset=1).float().numpy()
    assert edges[0][0] == 33.5 and not np.array_equal(f32[0], got[0])


@pytest.mark.parametrize("box_dtype", [torch.float16, torch.float64])
def test_pair_crop_rejects_other_box_types(box_dtype):
    """Boxes other than float32 and bfloat16 raise the same TypeError on
    the CPU route as on the card's (tests/test_torch_kernels_cuda.py)."""
    frames = torch.from_numpy(frames_like(1, 16, 16))
    probs = torch.zeros((1, 2, 16, 16))
    with pytest.raises(TypeError, match="float32 or bfloat16 yxhw"):
        port_kernel.roi_crop_pairs(frames, probs, torch.ones((2, 4), dtype=box_dtype), 8)


@pytest.mark.parametrize("h,w", [(49, 71), (48, 63), (50, 70)])
@pytest.mark.parametrize("matrices", ["bilinear", "random"])
def test_premat_mma_operands_keep_the_crop(h, w, matrices):
    """The matrix crop's bfloat16 tensor-core route reads the operands of
    ``premat_mma_operands``: bfloat16, even H and W, every tensor 4-byte
    aligned (here frames whose storage starts 2 bytes off), float32 planes
    rounded once. The plain crop of those operands is the crop of the
    given ones, within the kernel's bounds (a zero pad changes no sum; the
    float32 einsums may run in another order)."""
    t, o, s = 2, 3, 24
    probs = torch.from_numpy(edge_case_probs(t, o + 1, h, w, seed=h))
    flat = torch.from_numpy(frames_like(t, h, w)).flatten()
    frames = torch.cat([flat[:1], flat]).to(torch.bfloat16)[1:].view(t, h, w, 3)
    assert frames.data_ptr() % 4 == 2
    yxhw = torch.from_numpy(_pair_boxes(t, o, h, w, seed=w))
    if matrices == "bilinear":
        ry, rx = port_kernel.interp_matrices(yxhw, h, w, s, torch.bfloat16)
    else:
        rng = np.random.default_rng(s)
        ry = torch.from_numpy(rng.random((t * o, s, h), dtype=np.float32) * (2.0 / h))
        rx = torch.from_numpy(rng.random((t * o, s, w), dtype=np.float32) * (2.0 / w))
        ry, rx = ry.to(torch.bfloat16), rx.to(torch.bfloat16)

    ops = port_kernel.premat_mma_operands(frames, probs, ry, rx)
    for x in ops:
        assert x.dtype == torch.bfloat16 and x.is_contiguous() and x.data_ptr() % 4 == 0
    f, p, ry2, rx2 = ops
    h2, w2 = f.shape[1], f.shape[2]
    assert (h2, w2) == (h + h % 2, w + w % 2)
    assert p.shape == (t, o + 1, h2, w2) and ry2.shape == (t * o, s, h2)
    assert rx2.shape == (t * o, s, w2)
    ref = port_kernel.roi_crop_pairs_premat_reference(frames, probs, ry, rx, torch.bfloat16,
                                                      obj_offset=1)
    got = port_kernel.roi_crop_pairs_premat_reference(f, p, ry2, rx2, torch.bfloat16,
                                                      obj_offset=1)
    atol = (port_kernel.PAIR_BF16_ATOL if matrices == "bilinear"
            else port_kernel.PREMAT_BF16_ATOL)
    assert float((got.float() - ref.float()).abs().max()) <= atol


@pytest.mark.parametrize("inputs", ["float32", "bfloat16"])
def test_crop_dispatch_impls_match_jax(inputs):
    """roi_crop_pairs_from_probs: impl="einsum" (mask_to_yxhw, then the pair
    crop) and impl="pallas" (fused box) against the JAX dispatch with the
    same impl (its fused-box kernel in interpret mode), frames and probs in
    ``inputs`` (assess_net.bf16_inputs), bfloat16 crops."""
    t, o, h, w, s = 2, 3, 48, 64, 64
    probs = edge_case_probs(t, o + 1, h, w, seed=11)
    frames = frames_like(t, h, w)
    jin, tin = getattr(jnp, inputs), getattr(torch, inputs)
    jframes, jprobs = jnp.asarray(frames).astype(jin), jnp.asarray(probs[:, 1:]).astype(jin)
    fused = jax_roi_pallas.roi_crop_pairs_pallas_fusedbox
    for impl in ("einsum", "pallas"):
        jax_roi_pallas.roi_crop_pairs_pallas_fusedbox = (
            lambda *a, **k: fused(*a, **{**k, "interpret": True}))
        try:
            ref = jax_roi_pallas.roi_crop_pairs_from_probs(jframes, jprobs, s,
                                                           dtype=jnp.bfloat16, impl=impl)
        finally:
            jax_roi_pallas.roi_crop_pairs_pallas_fusedbox = fused
        got = port_kernel.roi_crop_pairs_from_probs(
            torch.from_numpy(frames).to(tin), torch.from_numpy(probs).to(tin), s,
            torch.bfloat16, obj_offset=1, num_objects=o, impl=impl,
        )
        for g, r in zip(got, ref):
            assert g.dtype == torch.bfloat16
            np.testing.assert_allclose(g.float().numpy(), np.asarray(r, np.float32), rtol=0,
                                       atol=BF16_VS_JAX_ATOL if impl == "einsum"
                                       else port_kernel.BF16_CROP_ATOL)
    with pytest.raises(NotImplementedError):
        port_kernel.roi_crop_pairs_from_probs(torch.from_numpy(frames), torch.from_numpy(probs),
                                              s, impl="nope")
