"""ROI crop kernels for Hopper and their plain versions.

Four CUDA kernels, each beside its plain torch version. A wrapper launches
its kernel for CUDA tensors and counts each launch in ``<wrapper>.launches``
(under a lock, so concurrent shard threads count exactly); for CPU tensors it computes the plain version instead (and counts nothing).
Any other device raises. None has a backward (nor have the TPU kernels).

T×O pair crops (the scoring round). For each pair (t, o) the S×S bilinear
crop (align corners, zeros outside the image) of frame t's 3 channels and of
prob plane ``obj_offset + o`` is returned as NHWC ``[T·O, S, S, 4]`` in
``dtype``. Frames ``[T, H, W, 3]`` and probs ``[T, P, H, W]`` may each be
float32 or bfloat16 (``assess_net.bf16_inputs``); an adapter's
``[T, O+1, H, W]`` maps with background plane 0 are passed whole with
``obj_offset=1``, so no strided copy of the object planes is made.

- :func:`roi_crop_pairs_fusedbox` (``csrc/roi_crop_fusedbox.cu``, replaces
  ``roi_crop_pairs_pallas_fusedbox``, ``ivosw_tpu/kernels/roi_pallas.py:461``):
  the boxes come from ``probs > 0.5`` inside the kernel
  (:func:`ivosw_tpu_torch.ops.roi.mask_to_yxhw` rules). Plain version
  :func:`roi_crop_pairs_fusedbox_reference`: those boxes, then
  :func:`roi_crop_pairs_reference`. The kernel rounds once, on store, while
  the plain version rounds five times (inputs, both matrices, the
  intermediate, the output); for values in [0, 1] each rounding moves a
  value by at most half an ulp, 2⁻⁹, and the output rounding at the top of
  the range by up to 2⁻⁸, so in bfloat16 the two differ by at most
  :data:`BF16_CROP_ATOL` = 2⁻⁶; boxes agree bit for bit. The kernel's box
  pass reads each plane in :func:`box_bands` bands of loads as wide as
  :func:`plane_load_bytes` allows, into a scratch of per-band partial
  boxes; a second launch reduces them to the boxes, a third crops.
- :func:`roi_crop_pairs` (``csrc/roi_crop_pairs.cu``, replaces
  ``roi_crop_pairs_pallas``, ``roi_pallas.py:299``, reached through
  ``roi_crop_pairs`` :639): given yxhw boxes ``[T·O, 4]``. Plain version
  :func:`roi_crop_pairs_reference`, the einsum of ``roi_crop_pairs_einsum``
  (:663) with its casts to ``dtype`` (inputs, matrices, the row-contracted
  intermediate, the output). The kernel rounds at those same points, and
  each of its sums has two terms whose bfloat16 products are exact, so in
  bfloat16 it agrees with the plain version to :data:`PAIR_BF16_ATOL` (one
  ulp at 1, for a sum order neither side fixes); in float32 to
  :data:`F32_CROP_ATOL`. One launch per call: the kernel reads the float32
  or bfloat16 boxes through their strides and converts them itself, and
  stages spans of source rows in shared memory (slots sized by
  :func:`pair_stage_bytes`) with loads as wide as :func:`span_load_bytes`
  allows.
- :func:`roi_crop_pairs_premat` (``csrc/roi_crop_pairs_premat.cu``, replaces
  ``roi_crop_pairs_pallas_premat``, ``roi_pallas.py:584``): the same crop
  from given interpolation matrices Ry ``[T·O, S, H]`` and Rx
  ``[T·O, S, W]``, built from yxhw boxes as the TPU wrapper builds them or
  passed in (any values: the kernel reads every entry). Plain version
  :func:`roi_crop_pairs_premat_reference`. With bilinear matrices each dense
  sum has two non-zero terms and the bound is :data:`PAIR_BF16_ATOL`; with
  dense matrices the float32 sums of H (then W) terms run in another order
  than the plain version's, a bfloat16 intermediate may round the other way
  (one ulp), and the bound is :data:`PREMAT_BF16_ATOL` (float32:
  :data:`PREMAT_F32_RTOL` of the largest output). In bfloat16 both products
  run on the tensor cores, on the operands of :func:`premat_mma_operands`;
  in float32 on the CUDA cores (TF32 would not match float32 sums).
- :func:`roi_crop_pairs_from_probs` is the scoring round's dispatch, the
  counterpart of ``roi_pallas.py:518``: ``impl="auto"`` or ``"pallas"`` →
  the fused-box kernel; ``"einsum"`` → the two-stage round,
  ``mask_to_yxhw`` on the selected planes and then :func:`roi_crop_pairs`.

Crop with given boxes, counterpart of ``roi_crop_pallas`` and
``roi_crop_best`` (``roi_pallas.py:67``, ``:233``; the AssessNet training
path): ``[B, H, W, C]`` float32 images and ``[B, 4]`` yxhw boxes →
``[B, S, S, C]`` float32.

- :func:`roi_crop` launches the kernel of ``csrc/roi_crop.cu`` for CUDA
  tensors, once per call (the kernel converts the yxhw boxes itself; its
  C=4 variant is picked by :func:`whole_pixel_loads`), and counts each
  launch in ``roi_crop.launches``; CPU tensors go to
  the plain version. Any other device raises, and so does an input that
  requires a gradient: like the TPU kernel, the kernel has no backward.
- :func:`roi_crop_reference` is the plain version, the float32 einsum of
  :func:`ivosw_tpu_torch.ops.roi.roi_crop` (``ivosw_tpu/ops/roi.py:109``).
- :func:`roi_crop_best` is the dispatch ``assess_forward`` calls.

The kernel sums the same two non-zero taps per row and column in float32,
so it agrees with the plain version to summation order
(:data:`F32_CROP_ATOL`).
"""

from __future__ import annotations

import ctypes
import threading

import torch

from ivosw_tpu_torch.ops.roi import _interp_matrix, mask_to_yxhw, yxhw_to_minmax
from ivosw_tpu_torch.ops.roi import roi_crop as _roi_crop_einsum  # the plain crop

ROI_S = 256
BF16_CROP_ATOL = 2.0**-6
F32_CROP_ATOL = 1e-5
PAIR_BF16_ATOL = 2.0**-7
PREMAT_BF16_ATOL = 2.0**-6
PREMAT_F32_RTOL = 1e-5

_SOURCE = "roi_crop_fusedbox"
_PAIRS_SOURCE = "roi_crop_pairs"
_PREMAT_SOURCE = "roi_crop_pairs_premat"
_CROP_SOURCE = "roi_crop"
_INPUT_TYPES = (torch.float32, torch.bfloat16)


def _selected_planes(probs, obj_offset, num_objects):
    o = probs.shape[1] - obj_offset if num_objects is None else int(num_objects)
    if obj_offset < 0 or o < 1 or obj_offset + o > probs.shape[1]:
        raise ValueError(
            f"objects [{obj_offset}, {obj_offset + o}) outside probs {tuple(probs.shape)}"
        )
    return o


def _on_cpu(*tensors) -> bool:
    """True when every tensor lies on the CPU (the plain version runs),
    False when all lie on one CUDA device (the kernel runs); raises for any
    other placement and for a tensor that requires a gradient."""
    if any(x.requires_grad for x in tensors):
        raise ValueError("the crop kernels have no backward: pass tensors that do not require grad")
    devices = {x.device for x in tensors}
    if all(d.type == "cpu" for d in devices):
        return True
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        names = ", ".join(str(d) for d in sorted(devices, key=str))
        raise ValueError(f"tensors on {names}: all must be on one CUDA device (or on the CPU)")
    return False


def _check_pair_inputs(frames, probs, out_size, dtype):
    """Shape/type/layout checks of a pair crop's CUDA launch → (T, H, W)."""
    if frames.dtype not in _INPUT_TYPES or probs.dtype not in _INPUT_TYPES:
        raise TypeError(f"need float32 or bfloat16 frames/probs, got {frames.dtype}/{probs.dtype}")
    if frames.dim() != 4 or frames.shape[3] != 3 or probs.dim() != 4:
        raise ValueError(f"need frames [T,H,W,3], probs [T,P,H,W]; got "
                         f"{tuple(frames.shape)}, {tuple(probs.shape)}")
    t, h, w, _ = frames.shape
    if probs.shape[0] != t or tuple(probs.shape[2:]) != (h, w):
        raise ValueError(f"probs {tuple(probs.shape)} do not match frames "
                         f"{tuple(frames.shape)}")
    if not (frames.is_contiguous() and probs.is_contiguous()):
        raise ValueError("frames and probs must be contiguous")
    if dtype not in _INPUT_TYPES:
        raise TypeError(f"output dtype must be bfloat16 or float32, got {dtype}")
    if out_size < 2:
        raise ValueError(f"out_size must be >= 2, got {out_size}")
    return t, h, w


def _is_bf16(x) -> int:
    return int(x.dtype == torch.bfloat16)


def _bind(lib: ctypes.CDLL, name: str, argtypes):
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


_c_int, _c_float, _ptr = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
_c_longlong = ctypes.c_longlong


def _check_launch(lib: ctypes.CDLL, err: int, name: str) -> None:
    """Raise when a launch returned a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if err != 0:
        lib.ivosw_cuda_error_string.argtypes = [ctypes.c_int]
        lib.ivosw_cuda_error_string.restype = ctypes.c_char_p
        msg = lib.ivosw_cuda_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {err}: {msg}")


_launch_lock = threading.Lock()


def _count_launch(wrapper) -> None:
    """One more launch of ``wrapper``'s kernel, exact when threads (the
    shards of a data-parallel evaluation) launch at once."""
    with _launch_lock:
        wrapper.launches += 1


def _load(source: str) -> ctypes.CDLL:
    from ivosw_tpu_torch.kernels import _build

    return _build.load(source)


# The fused-box kernel's box pass reads each prob plane in bands of
# BOX_BAND_LOADS loads, one block per (band, pair): two steps of 256 threads
# × 4 loads (csrc/roi_crop_fusedbox.cu, kBoxThreads and kBoxUnroll). Its
# launches take at most MAX_PAIRS pairs, and a frame's values must have
# 32-bit offsets.
BOX_BAND_LOADS = 256 * 4 * 2
MAX_PAIRS = 65535


def _widest_load(base_ptr: int, image_bytes: int, itemsize: int, what: str) -> int:
    for width in (16, 8, 4, 2):
        if width >= itemsize and base_ptr % width == 0 and image_bytes % width == 0:
            return width
    raise ValueError(f"{what} at {base_ptr:#x} are not aligned to their {itemsize}-byte values")


def plane_load_bytes(base_ptr: int, plane_bytes: int, itemsize: int) -> int:
    """The box pass's load width: the widest of 16, 8, 4 and 2 bytes, not
    narrower than a value, that divides both the probs' base address and
    one plane's byte size, so that every plane starts and ends on a load
    boundary (480×854 takes 16 bytes in both types; 49×71 takes 4 in
    float32 and 2 in bfloat16)."""
    return _widest_load(base_ptr, plane_bytes, itemsize, "probs")


def span_load_bytes(base_ptr: int, image_bytes: int, itemsize: int) -> int:
    """The given-box pair kernel's row-span load width for frames or probs:
    the widest of 16, 8, 4 and 2 bytes, not narrower than a value, that
    divides both the tensor's base address and one frame's (or plane's)
    byte size. A span aligned down and up to it then never leaves its image
    (480×854 takes 16 bytes for frames and planes in both types; 49×71
    bfloat16 takes 2). Raises for a base off its values' alignment."""
    return _widest_load(base_ptr, image_bytes, itemsize, "frames or probs")


# Shared memory one block of the given-box pair kernel may take (H100), and
# its row buffers (csrc/roi_crop_pairs.cu, kStages).
MAX_SMEM = 232448
PAIR_STAGES = 2


def pair_stage_bytes(w: int, frame_itemsize: int, prob_itemsize: int) -> tuple[int, int, int]:
    """Shared memory of the given-box pair kernel at width ``w`` →
    (frame slot, plane slot, block total) in bytes. A slot holds one source
    row's span with a 16-byte load's worth of head and tail (a 16-byte
    multiple); a block holds :data:`PAIR_STAGES` buffers of two frame and
    two plane slots. Raises when that exceeds :data:`MAX_SMEM` (a frame too
    wide)."""
    frame_cap = -(-(w * 3 * frame_itemsize + 32) // 16) * 16
    plane_cap = -(-(w * prob_itemsize + 32) // 16) * 16
    total = PAIR_STAGES * 2 * (frame_cap + plane_cap)
    if total > MAX_SMEM:
        raise ValueError(f"width {w}: the pair kernel would need {total} bytes of shared "
                         f"memory per block, more than {MAX_SMEM}")
    return frame_cap, plane_cap, total


def box_bands(plane_bytes: int, load_bytes: int) -> int:
    """Bands per prob plane in the box pass: one block reads BOX_BAND_LOADS
    loads of ``load_bytes`` (the last band may be shorter)."""
    return -(-(plane_bytes // load_bytes) // BOX_BAND_LOADS)


def whole_pixel_loads(c: int, base_ptr: int) -> bool:
    """Whether :func:`roi_crop`'s kernel takes its C=4 variant (one 16-byte
    load per tap, one 16-byte store per output pixel) rather than its scalar
    variant; the choice follows C alone. At C=4 a base off a 16-byte
    boundary raises rather than being read wrong."""
    if c != 4:
        return False
    if base_ptr % 16:
        raise ValueError(f"images at {base_ptr:#x}: the C=4 crop needs a 16-byte aligned base")
    return True


# ------------------------------------------------------- plain versions --
def roi_crop_pairs_premat_reference(
    frames, probs, ry, rx, dtype=torch.bfloat16, obj_offset: int = 0,
    num_objects: int | None = None,
):
    """Plain torch version of :func:`roi_crop_pairs_premat` (any device):
    ``roi_crop_pairs_einsum``'s contractions with the given Ry [T·O, S, H]
    and Rx [T·O, S, W] and its casts to ``dtype`` → [T·O, S, S, 4]."""
    t, h, w, _ = frames.shape
    o = _selected_planes(probs, obj_offset, num_objects)
    s = ry.shape[1]

    def cast(x):  # one rounding to the working type, then float32 products
        return x.to(dtype).float()

    planes = probs[:, obj_offset : obj_offset + o]
    ry = cast(ry).reshape(t, o, s, h)
    rx = cast(rx).reshape(t, o, s, w)
    tmp_f = cast(torch.einsum("tosh,thwc->toswc", ry, cast(frames)))
    tf_roi = torch.einsum("toxw,toswc->tosxc", rx, tmp_f)
    tmp_p = cast(torch.einsum("tosh,tohw->tosw", ry, cast(planes)))
    tp_roi = torch.einsum("toxw,tosw->tosx", rx, tmp_p)
    out = torch.cat([tf_roi, tp_roi[..., None]], dim=-1).reshape(t * o, s, s, 4)
    return out.to(dtype)


def interp_matrices(yxhw, h: int, w: int, out_size: int = ROI_S, dtype=torch.float32):
    """Ry [B, S, H] and Rx [B, S, W] of yxhw boxes [B, 4] in ``dtype``
    (``_interp_matrix`` of the box edges, as ``roi_pallas.py:599-601``).
    The edges are computed in the boxes' type, then widened to float32, as
    ``roi_pallas.py:320-321`` does for the pair kernel."""
    ymin, ymax, xmin, xmax = (e.float() for e in yxhw_to_minmax(yxhw))
    return (_interp_matrix(ymin, ymax, h, out_size).to(dtype),
            _interp_matrix(xmin, xmax, w, out_size).to(dtype))


def roi_crop_pairs_reference(
    frames, probs, yxhw, out_size: int = ROI_S, dtype=torch.bfloat16,
    obj_offset: int = 0, num_objects: int | None = None,
):
    """Plain torch version of :func:`roi_crop_pairs` (any device):
    ``roi_crop_pairs_einsum`` with the JAX package's casts → [T·O, S, S, 4]."""
    ry, rx = interp_matrices(yxhw, frames.shape[1], frames.shape[2], out_size)
    return roi_crop_pairs_premat_reference(frames, probs, ry, rx, dtype, obj_offset,
                                           num_objects)


def _boxes_from_probs(probs, obj_offset, o, scale, min_side):
    t, _, h, w = probs.shape
    planes = probs[:, obj_offset : obj_offset + o]
    return mask_to_yxhw((planes > 0.5).reshape(t * o, h, w), scale, min_side)


def roi_crop_pairs_fusedbox_reference(
    frames: torch.Tensor,
    probs: torch.Tensor,
    out_size: int = ROI_S,
    dtype=torch.bfloat16,
    scale: float = 1.5,
    min_side: float = 128.0,
    obj_offset: int = 0,
    num_objects: int | None = None,
    return_boxes: bool = False,
):
    """Plain torch version of :func:`roi_crop_pairs_fusedbox` (any device):
    the mask_to_yxhw boxes of ``probs > 0.5`` (thresholded on the float32
    value of a bfloat16 plane, exact), then :func:`roi_crop_pairs_reference`.
    Returns [T·O, S, S, 4] in ``dtype`` (and the [T·O, 4] float32 (ymin,
    ymax, xmin, xmax) boxes)."""
    o = _selected_planes(probs, obj_offset, num_objects)
    yxhw = _boxes_from_probs(probs.float(), obj_offset, o, scale, min_side)
    out = roi_crop_pairs_reference(frames, probs, yxhw, out_size, dtype, obj_offset, o)
    if return_boxes:
        return out, torch.stack(yxhw_to_minmax(yxhw), dim=1)
    return out


# ------------------------------------------------------------- wrappers --
def roi_crop_pairs_fusedbox(
    frames: torch.Tensor,
    probs: torch.Tensor,
    out_size: int = ROI_S,
    dtype=torch.bfloat16,
    scale: float = 1.5,
    min_side: float = 128.0,
    obj_offset: int = 0,
    num_objects: int | None = None,
    return_boxes: bool = False,
):
    """All T×O pair crops with in-kernel boxes → [T·O, S, S, 4] in ``dtype``.

    frames [T, H, W, 3] and probs [T, P, H, W], float32 or bfloat16, both
    contiguous; the crop uses prob planes ``obj_offset .. obj_offset+O-1``
    (O = ``num_objects``, default all planes after the offset).
    ``return_boxes`` also returns the [T·O, 4] float32 (ymin, ymax, xmin,
    xmax) boxes."""
    args = (frames, probs, out_size, dtype, scale, min_side, obj_offset, num_objects)
    if _on_cpu(frames, probs):
        return roi_crop_pairs_fusedbox_reference(*args, return_boxes=return_boxes)
    t, h, w = _check_pair_inputs(frames, probs, out_size, dtype)
    o = _selected_planes(probs, obj_offset, num_objects)

    if t * o > MAX_PAIRS or h * w * 3 >= 2**31:
        raise ValueError(f"{t * o} pairs of {h}×{w}: the kernel takes at most {MAX_PAIRS} "
                         "pairs of frames with fewer than 2³¹ values")
    plane_bytes = h * w * probs.element_size()
    load_bytes = plane_load_bytes(probs.data_ptr(), plane_bytes, probs.element_size())
    bands = box_bands(plane_bytes, load_bytes)

    lib = _load(_SOURCE)
    fn = _bind(lib, "ivosw_roi_crop_pairs_fusedbox", [
        _ptr, _ptr, _c_int, _c_int,  # frames, probs, their bf16 flags
        _c_int, _c_int, _c_int, _c_int,  # T, planes per frame, obj offset, O
        _c_int, _c_int, _c_int,  # H, W, S
        _c_float, _c_float,  # min_side, grow
        _c_int, _c_int, _c_int, _ptr,  # load bytes, loads per band, bands, partials
        _ptr, _ptr, _c_int,  # boxes, out, out_bf16
        _ptr,  # stream
    ])
    out = torch.empty((t * o, out_size, out_size, 4), dtype=dtype, device=frames.device)
    boxes = torch.empty((t * o, 4), dtype=torch.float32, device=frames.device)
    partial = torch.empty((t * o, bands, 4), dtype=torch.int32, device=frames.device)
    err = fn(
        frames.data_ptr(), probs.data_ptr(), _is_bf16(frames), _is_bf16(probs),
        t, probs.shape[1], obj_offset, o, h, w, out_size,
        float(min_side), (scale - 1.0) / 2.0,
        load_bytes, BOX_BAND_LOADS, bands, partial.data_ptr(),
        boxes.data_ptr(), out.data_ptr(), _is_bf16(out),
        torch.cuda.current_stream(frames.device).cuda_stream,
    )
    _check_launch(lib, err, "roi_crop_pairs_fusedbox")
    _count_launch(roi_crop_pairs_fusedbox)
    return (out, boxes) if return_boxes else out


roi_crop_pairs_fusedbox.launches = 0


def roi_crop_pairs(
    frames: torch.Tensor,
    probs: torch.Tensor,
    yxhw: torch.Tensor,
    out_size: int = ROI_S,
    dtype=torch.bfloat16,
    obj_offset: int = 0,
    num_objects: int | None = None,
):
    """All T×O pair crops in given yxhw boxes [T·O, 4] → [T·O, S, S, 4] in
    ``dtype``; frames and probs as :func:`roi_crop_pairs_fusedbox` takes
    them, yxhw float32 or bfloat16 on the same device (any strides; another
    type raises ``TypeError`` on either device). One launch: the kernel
    turns the boxes into (ymin, ymax, xmin, xmax) itself, in the boxes' type
    and then widened to float32, as ``roi_pallas.py:320-321`` does inside
    the TPU function, and this wrapper does no tensor work besides
    allocating the output."""
    if yxhw.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"need float32 or bfloat16 yxhw boxes, got {yxhw.dtype}")
    if _on_cpu(frames, probs, yxhw):
        return roi_crop_pairs_reference(frames, probs, yxhw, out_size, dtype, obj_offset,
                                        num_objects)
    t, h, w = _check_pair_inputs(frames, probs, out_size, dtype)
    o = _selected_planes(probs, obj_offset, num_objects)
    if tuple(yxhw.shape) != (t * o, 4):
        raise ValueError(f"need yxhw [{t * o}, 4], got {tuple(yxhw.shape)}")
    if t * o > MAX_PAIRS or h * w * 3 >= 2**31:
        raise ValueError(f"{t * o} pairs of {h}×{w}: the kernel takes at most {MAX_PAIRS} "
                         "pairs of frames with fewer than 2³¹ values")
    fsize, psize = frames.element_size(), probs.element_size()
    frame_load = span_load_bytes(frames.data_ptr(), h * w * 3 * fsize, fsize)
    plane_load = span_load_bytes(probs.data_ptr(), h * w * psize, psize)
    frame_cap, plane_cap, _ = pair_stage_bytes(w, fsize, psize)

    lib = _load(_PAIRS_SOURCE)
    fn = _bind(lib, "ivosw_roi_crop_pairs", [
        _ptr, _ptr, _c_int, _c_int,  # frames, probs, their bf16 flags
        _c_int, _c_int, _c_int, _c_int,  # T, planes per frame, obj offset, O
        _c_int, _c_int, _c_int,  # H, W, S
        _ptr, _c_longlong, _c_longlong, _c_int,  # yxhw, its strides, its bf16 flag
        _c_int, _c_int, _c_int, _c_int,  # load widths, row slots
        _ptr, _c_int,  # out, out_bf16
        _ptr,  # stream
    ])
    out = torch.empty((t * o, out_size, out_size, 4), dtype=dtype, device=frames.device)
    err = fn(
        frames.data_ptr(), probs.data_ptr(), _is_bf16(frames), _is_bf16(probs),
        t, probs.shape[1], obj_offset, o, h, w, out_size,
        yxhw.data_ptr(), yxhw.stride(0), yxhw.stride(1), _is_bf16(yxhw),
        frame_load, plane_load, frame_cap, plane_cap,
        out.data_ptr(), _is_bf16(out),
        torch.cuda.current_stream(frames.device).cuda_stream,
    )
    _check_launch(lib, err, "roi_crop_pairs")
    _count_launch(roi_crop_pairs)
    return out


roi_crop_pairs.launches = 0


def premat_mma_operands(frames, probs, ry, rx):
    """The operands of the matrix crop's bfloat16 (tensor-core) route, which
    copies pairs of bfloat16 values from 4-byte aligned rows: float32 frames
    and planes rounded to bfloat16 (the rounding on load, once), an odd H or
    W padded with zeros to even (zero weights in Ry/Rx, frames and planes:
    the same crop), and a tensor that starts off a 4-byte boundary copied.
    Any device; returns (frames, probs, ry, rx)."""
    frames, probs = frames.to(torch.bfloat16), probs.to(torch.bfloat16)
    ry, rx = ry.to(torch.bfloat16), rx.to(torch.bfloat16)
    ph, pw = frames.shape[1] % 2, frames.shape[2] % 2
    if ph or pw:
        frames = torch.nn.functional.pad(frames, (0, 0, 0, pw, 0, ph))
        probs = torch.nn.functional.pad(probs, (0, pw, 0, ph))
        ry = torch.nn.functional.pad(ry, (0, ph))
        rx = torch.nn.functional.pad(rx, (0, pw))
    return tuple(x if x.data_ptr() % 4 == 0 else x.clone() for x in (frames, probs, ry, rx))


def roi_crop_pairs_premat(
    frames: torch.Tensor,
    probs: torch.Tensor,
    yxhw: torch.Tensor | None = None,
    out_size: int = ROI_S,
    dtype=torch.bfloat16,
    obj_offset: int = 0,
    num_objects: int | None = None,
    ry: torch.Tensor | None = None,
    rx: torch.Tensor | None = None,
):
    """The pair crop from interpolation matrices → [T·O, S, S, 4] in
    ``dtype``: Ry/Rx built from yxhw boxes [T·O, 4] and cast to ``dtype``
    (as ``roi_pallas.py:599-601``), or given as ``ry`` [T·O, S, H] and
    ``rx`` [T·O, S, W] (cast to ``dtype``; then ``out_size`` is their S)."""
    t, h, w, _ = frames.shape
    if yxhw is not None:
        if ry is not None or rx is not None:
            raise ValueError("pass yxhw or ry/rx, not both")
        ry, rx = interp_matrices(yxhw, h, w, out_size, dtype)
    elif ry is None or rx is None:
        raise ValueError("pass yxhw or both ry and rx")
    ry, rx = ry.to(dtype), rx.to(dtype)
    if _on_cpu(frames, probs, ry, rx):
        return roi_crop_pairs_premat_reference(frames, probs, ry, rx, dtype, obj_offset,
                                               num_objects)
    s = ry.shape[1]
    _check_pair_inputs(frames, probs, s, dtype)
    o = _selected_planes(probs, obj_offset, num_objects)
    if tuple(ry.shape) != (t * o, s, h) or tuple(rx.shape) != (t * o, s, w):
        raise ValueError(f"need ry [{t * o}, S, {h}] and rx [{t * o}, S, {w}]; got "
                         f"{tuple(ry.shape)}, {tuple(rx.shape)}")
    ry, rx = ry.contiguous(), rx.contiguous()
    tmp_ld = w
    if dtype == torch.bfloat16:
        frames, probs, ry, rx = premat_mma_operands(frames, probs, ry, rx)
        h, w = frames.shape[1], frames.shape[2]
        tmp_ld = -(-w // 8) * 8  # 16-byte rows: stage 2 reads them in 16-byte copies

    lib = _load(_PREMAT_SOURCE)
    fn = _bind(lib, "ivosw_roi_crop_pairs_premat", [
        _ptr, _ptr, _ptr, _ptr, _c_int, _c_int,  # ry, rx, frames, probs, bf16 flags
        _c_int, _c_int, _c_int, _c_int,  # T, planes per frame, obj offset, O
        _c_int, _c_int, _c_int,  # H, W, S
        _ptr, _c_int, _ptr, _c_int,  # scratch, its row stride, out, working type bf16
        _ptr,  # stream
    ])
    scratch = torch.empty((t * o, 4, s, tmp_ld), dtype=dtype, device=frames.device)
    out = torch.empty((t * o, s, s, 4), dtype=dtype, device=frames.device)
    err = fn(
        ry.data_ptr(), rx.data_ptr(), frames.data_ptr(), probs.data_ptr(),
        _is_bf16(frames), _is_bf16(probs), t, probs.shape[1], obj_offset, o, h, w, s,
        scratch.data_ptr(), tmp_ld, out.data_ptr(), _is_bf16(out),
        torch.cuda.current_stream(frames.device).cuda_stream,
    )
    _check_launch(lib, err, "roi_crop_pairs_premat")
    _count_launch(roi_crop_pairs_premat)
    return out


roi_crop_pairs_premat.launches = 0

IMPLS = ("auto", "pallas", "einsum")


def roi_crop_pairs_from_probs(
    frames, probs, out_size: int = ROI_S, dtype=torch.bfloat16,
    obj_offset: int = 0, num_objects: int | None = None, impl: str = "auto",
):
    """Scoring-round crop: prob maps → ROI boxes → (tf_roi [T·O,S,S,3],
    tp_roi [T·O,S,S,1]), views of one [T·O,S,S,4] tensor in ``dtype``.

    ``impl``: ``"auto"`` / ``"pallas"`` → the fused-box kernel (boxes in
    the kernel); ``"einsum"`` → the two-stage round, the boxes of
    ``probs > 0.5`` by :func:`ivosw_tpu_torch.ops.roi.mask_to_yxhw`, then the
    given-box kernel :func:`roi_crop_pairs`. CUDA tensors go to the
    kernels, CPU tensors to their plain versions."""
    if impl not in IMPLS:
        raise NotImplementedError(f"roi_crop_pairs_from_probs impl={impl!r}")
    if impl == "einsum":
        o = _selected_planes(probs, obj_offset, num_objects)
        yxhw = _boxes_from_probs(probs, obj_offset, o, 1.5, 128.0)
        out = roi_crop_pairs(frames, probs, yxhw, out_size, dtype, obj_offset, o)
    else:
        out = roi_crop_pairs_fusedbox(
            frames, probs, out_size, dtype, obj_offset=obj_offset, num_objects=num_objects
        )
    return out[..., :3], out[..., 3:]


# --------------------------------------------------- crop with given boxes --
def roi_crop_reference(images: torch.Tensor, yxhw: torch.Tensor, out_size: int = ROI_S):
    """Plain torch version of :func:`roi_crop` (any device): the separable
    float32 einsum with dense interpolation matrices."""
    return _roi_crop_einsum(images.float(), yxhw.float(), out_size, torch.float32)


def roi_crop(images: torch.Tensor, yxhw: torch.Tensor, out_size: int = ROI_S) -> torch.Tensor:
    """Bilinear crop of every image inside its box → [B, S, S, C] float32.

    images [B, H, W, C] float32 and yxhw [B, 4] float32 (y, x, h, w) boxes,
    on one device, the images contiguous (a 16-byte aligned base at C=4).
    One launch: the kernel turns the boxes into (ymin, ymax, xmin, xmax)
    itself, where the TPU wrapper did it outside (``roi_pallas.py:72-73``),
    and this wrapper does no tensor work besides allocating the output."""
    if _on_cpu(images, yxhw):
        return roi_crop_reference(images, yxhw, out_size)
    if images.dtype != torch.float32 or yxhw.dtype != torch.float32:
        raise TypeError(f"need float32 images/boxes, got {images.dtype}/{yxhw.dtype}")
    if images.dim() != 4 or tuple(yxhw.shape) != (images.shape[0], 4):
        raise ValueError(f"need images [B,H,W,C] and yxhw [B,4]; got "
                         f"{tuple(images.shape)}, {tuple(yxhw.shape)}")
    if not images.is_contiguous():
        raise ValueError("images must be contiguous")
    if out_size < 2:
        raise ValueError(f"out_size must be >= 2, got {out_size}")
    b, h, w, c = images.shape
    pixel4 = whole_pixel_loads(c, images.data_ptr())

    lib = _load(_CROP_SOURCE)
    fn = _bind(lib, "ivosw_roi_crop", [
        _ptr,  # images
        _c_int, _c_int, _c_int, _c_int, _c_int, _c_int,  # B, H, W, C, S, C=4 variant
        _ptr, _c_longlong, _c_longlong,  # yxhw and its strides
        _ptr,  # out
        _ptr,  # stream
    ])
    out = torch.empty((b, out_size, out_size, c), dtype=torch.float32, device=images.device)
    stream = torch.cuda.current_stream(images.device).cuda_stream
    err = fn(
        images.data_ptr(), b, h, w, c, out_size, int(pixel4), yxhw.data_ptr(), yxhw.stride(0),
        yxhw.stride(1), out.data_ptr(), stream,
    )
    _check_launch(lib, err, "roi_crop")
    _count_launch(roi_crop)
    return out


roi_crop.launches = 0


def roi_crop_best(images: torch.Tensor, yxhw: torch.Tensor, out_size: int = ROI_S) -> torch.Tensor:
    """The crop ``assess_forward`` calls: the kernel for CUDA tensors, the
    plain version for CPU ones; computed in float32 and returned in the
    images' dtype, as ``roi_pallas.py:247`` casts."""
    return roi_crop(images.float().contiguous(), yxhw.float(), out_size).to(images.dtype)
