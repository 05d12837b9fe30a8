"""ROI crop kernels for Hopper and their plain versions.

Two CUDA kernels, each beside its plain torch version:

Fused-box pair crop, counterpart of ``roi_crop_pairs_pallas_fusedbox`` and
``roi_crop_pairs_from_probs`` in ``ivosw_tpu/kernels/roi_pallas.py`` (the
scoring path). For each pair (t, o) the ROI box comes from
``probs[t, obj_offset + o] > 0.5`` (:func:`ivosw_tpu_torch.ops.roi.mask_to_yxhw`
rules) and the S×S bilinear crop of the frame's 3 channels and of that prob
plane is returned as NHWC ``[T·O, S, S, 4]``.

- :func:`roi_crop_pairs_fusedbox` launches the kernel of
  ``csrc/roi_crop_fusedbox.cu`` for CUDA tensors and counts each launch in
  ``roi_crop_pairs_fusedbox.launches``; for CPU tensors it computes the plain
  version instead (and counts nothing). Any other device raises.
- :func:`roi_crop_pairs_fusedbox_reference` is the plain version: the
  mask_to_yxhw boxes and the einsum recipe of ``roi_pallas.py:536-545`` and
  ``:663-693`` with the JAX package's casts to ``dtype`` (frames, prob
  planes, interpolation matrices and the row-contracted intermediate).

Numbers: boxes agree bit for bit. In float32 the crops agree to summation
order (1e-5). In bfloat16 the kernel rounds once, on store, while the plain
version rounds five times (inputs, both matrices, the intermediate, the
output); for values in [0, 1] each rounding moves a value by at most half
an ulp, 2⁻⁹, and the output rounding at the top of the range by up to 2⁻⁸,
so the two differ by at most :data:`BF16_CROP_ATOL` = 2⁻⁶.

Crop with given boxes, counterpart of ``roi_crop_pallas`` and
``roi_crop_best`` (``roi_pallas.py:67``, ``:233``; the AssessNet training
path): ``[B, H, W, C]`` float32 images and ``[B, 4]`` yxhw boxes →
``[B, S, S, C]`` float32.

- :func:`roi_crop` launches the kernel of ``csrc/roi_crop.cu`` for CUDA
  tensors and counts each launch in ``roi_crop.launches``; CPU tensors go to
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

import torch

from ivosw_tpu_torch.ops.roi import _interp_matrix, mask_to_yxhw, yxhw_to_minmax
from ivosw_tpu_torch.ops.roi import roi_crop as _roi_crop_einsum  # the plain crop

ROI_S = 256
BF16_CROP_ATOL = 2.0**-6
F32_CROP_ATOL = 1e-5

_SOURCE = "roi_crop_fusedbox"
_CROP_SOURCE = "roi_crop"


def _selected_planes(probs, obj_offset, num_objects):
    o = probs.shape[1] - obj_offset if num_objects is None else int(num_objects)
    if obj_offset < 0 or o < 1 or obj_offset + o > probs.shape[1]:
        raise ValueError(
            f"objects [{obj_offset}, {obj_offset + o}) outside probs {tuple(probs.shape)}"
        )
    return o


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
    """Plain torch version of :func:`roi_crop_pairs_fusedbox` (any device).

    frames [T, H, W, 3] float; probs [T, P, H, W] float32 from which planes
    ``obj_offset .. obj_offset+O-1`` are used. Returns [T·O, S, S, 4] in
    ``dtype`` (and the [T·O, 4] float32 (ymin, ymax, xmin, xmax) boxes)."""
    t, h, w, _ = frames.shape
    o = _selected_planes(probs, obj_offset, num_objects)
    s = out_size
    planes = probs[:, obj_offset : obj_offset + o].float()
    yxhw = mask_to_yxhw((planes > 0.5).reshape(t * o, h, w), scale, min_side)
    ymin, ymax, xmin, xmax = yxhw_to_minmax(yxhw)

    def cast(x):  # one rounding to the working type, then float32 products
        return x.to(dtype).float()

    ry = cast(_interp_matrix(ymin, ymax, h, s)).reshape(t, o, s, h)
    rx = cast(_interp_matrix(xmin, xmax, w, s)).reshape(t, o, s, w)
    tmp_f = cast(torch.einsum("tosh,thwc->toswc", ry, cast(frames)))
    tf_roi = torch.einsum("toxw,toswc->tosxc", rx, tmp_f)
    tmp_p = cast(torch.einsum("tosh,tohw->tosw", ry, cast(planes)))
    tp_roi = torch.einsum("toxw,tosw->tosx", rx, tmp_p)
    out = torch.cat([tf_roi, tp_roi[..., None]], dim=-1).reshape(t * o, s, s, 4)
    out = out.to(dtype)
    if return_boxes:
        return out, torch.stack([ymin, ymax, xmin, xmax], dim=1)
    return out


def _bind(lib: ctypes.CDLL):
    fn = lib.ivosw_roi_crop_pairs_fusedbox
    if fn.argtypes is None:
        c_int, c_float, ptr = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
        fn.argtypes = [
            ptr, ptr,  # frames, probs
            c_int, c_int, c_int, c_int,  # T, planes per frame, obj offset, O
            c_int, c_int, c_int,  # H, W, S
            c_float, c_float,  # min_side, grow
            ptr, ptr, c_int,  # boxes, out, out_bf16
            ptr,  # stream
        ]
        fn.restype = c_int
    return fn


def _check_launch(lib: ctypes.CDLL, err: int, name: str) -> None:
    """Raise when a launch returned a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if err != 0:
        lib.ivosw_cuda_error_string.argtypes = [ctypes.c_int]
        lib.ivosw_cuda_error_string.restype = ctypes.c_char_p
        msg = lib.ivosw_cuda_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {err}: {msg}")


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

    frames [T, H, W, 3] float32 and probs [T, P, H, W] float32, both
    contiguous; the crop uses prob planes ``obj_offset .. obj_offset+O-1``
    (O = ``num_objects``, default all planes after the offset), so an
    adapter's [T, O+1, H, W] output with background plane 0 is passed
    whole with ``obj_offset=1``. ``return_boxes`` also returns the [T·O, 4]
    float32 (ymin, ymax, xmin, xmax) boxes."""
    args = (frames, probs, out_size, dtype, scale, min_side, obj_offset, num_objects)
    if frames.device.type == "cpu" and probs.device.type == "cpu":
        return roi_crop_pairs_fusedbox_reference(*args, return_boxes=return_boxes)
    if frames.device.type != "cuda" or probs.device != frames.device:
        raise ValueError(
            f"frames on {frames.device} and probs on {probs.device}: "
            "both must be on one CUDA device (or both on the CPU)"
        )
    if frames.dtype != torch.float32 or probs.dtype != torch.float32:
        raise TypeError(f"need float32 frames/probs, got {frames.dtype}/{probs.dtype}")
    if frames.dim() != 4 or frames.shape[3] != 3 or probs.dim() != 4:
        raise ValueError(f"need frames [T,H,W,3], probs [T,P,H,W]; got "
                         f"{tuple(frames.shape)}, {tuple(probs.shape)}")
    t, h, w, _ = frames.shape
    if probs.shape[0] != t or tuple(probs.shape[2:]) != (h, w):
        raise ValueError(f"probs {tuple(probs.shape)} do not match frames "
                         f"{tuple(frames.shape)}")
    if not (frames.is_contiguous() and probs.is_contiguous()):
        raise ValueError("frames and probs must be contiguous")
    if dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"output dtype must be bfloat16 or float32, got {dtype}")
    if out_size < 2:
        raise ValueError(f"out_size must be >= 2, got {out_size}")
    o = _selected_planes(probs, obj_offset, num_objects)

    from ivosw_tpu_torch.kernels import _build

    lib = _build.load(_SOURCE)
    fn = _bind(lib)
    out = torch.empty((t * o, out_size, out_size, 4), dtype=dtype, device=frames.device)
    boxes = torch.empty((t * o, 4), dtype=torch.float32, device=frames.device)
    stream = torch.cuda.current_stream(frames.device).cuda_stream
    err = fn(
        frames.data_ptr(), probs.data_ptr(),
        t, probs.shape[1], obj_offset, o,
        h, w, out_size,
        float(min_side), (scale - 1.0) / 2.0,
        boxes.data_ptr(), out.data_ptr(), int(dtype == torch.bfloat16),
        stream,
    )
    _check_launch(lib, err, "roi_crop_pairs_fusedbox")
    roi_crop_pairs_fusedbox.launches += 1
    return (out, boxes) if return_boxes else out


roi_crop_pairs_fusedbox.launches = 0


def roi_crop_pairs_from_probs(
    frames, probs, out_size: int = ROI_S, dtype=torch.bfloat16,
    obj_offset: int = 0, num_objects: int | None = None,
):
    """Scoring-path crop: prob maps → ROI boxes → (tf_roi [T·O,S,S,3],
    tp_roi [T·O,S,S,1]), views of one [T·O,S,S,4] tensor. CUDA tensors go to
    the kernel, CPU tensors to the plain version."""
    out = roi_crop_pairs_fusedbox(
        frames, probs, out_size, dtype, obj_offset=obj_offset, num_objects=num_objects
    )
    return out[..., :3], out[..., 3:]


# --------------------------------------------------- crop with given boxes --
def roi_crop_reference(images: torch.Tensor, yxhw: torch.Tensor, out_size: int = ROI_S):
    """Plain torch version of :func:`roi_crop` (any device): the separable
    float32 einsum with dense interpolation matrices."""
    return _roi_crop_einsum(images.float(), yxhw.float(), out_size, torch.float32)


def _bind_crop(lib: ctypes.CDLL):
    fn = lib.ivosw_roi_crop
    if fn.argtypes is None:
        c_int, ptr = ctypes.c_int, ctypes.c_void_p
        fn.argtypes = [
            ptr,  # images
            c_int, c_int, c_int, c_int, c_int,  # B, H, W, C, S
            ptr, ptr,  # boxes, out
            ptr,  # stream
        ]
        fn.restype = c_int
    return fn


def roi_crop(images: torch.Tensor, yxhw: torch.Tensor, out_size: int = ROI_S) -> torch.Tensor:
    """Bilinear crop of every image inside its box → [B, S, S, C] float32.

    images [B, H, W, C] float32 and yxhw [B, 4] float32 (y, x, h, w) boxes,
    both contiguous and on one device. The boxes become (ymin, ymax, xmin,
    xmax) here, outside the kernel, as ``roi_pallas.py:72-73`` does."""
    if images.requires_grad or yxhw.requires_grad:
        raise ValueError("roi_crop has no backward: pass inputs that do not require grad")
    if images.device.type == "cpu" and yxhw.device.type == "cpu":
        return roi_crop_reference(images, yxhw, out_size)
    if images.device.type != "cuda" or yxhw.device != images.device:
        raise ValueError(
            f"images on {images.device} and boxes on {yxhw.device}: "
            "both must be on one CUDA device (or both on the CPU)"
        )
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
    boxes = torch.stack(yxhw_to_minmax(yxhw), dim=1).contiguous()

    from ivosw_tpu_torch.kernels import _build

    lib = _build.load(_CROP_SOURCE)
    out = torch.empty((b, out_size, out_size, c), dtype=torch.float32, device=images.device)
    stream = torch.cuda.current_stream(images.device).cuda_stream
    err = _bind_crop(lib)(
        images.data_ptr(), b, h, w, c, out_size, boxes.data_ptr(), out.data_ptr(), stream
    )
    _check_launch(lib, err, "roi_crop")
    roi_crop.launches += 1
    return out


roi_crop.launches = 0


def roi_crop_best(images: torch.Tensor, yxhw: torch.Tensor, out_size: int = ROI_S) -> torch.Tensor:
    """The crop ``assess_forward`` calls: the kernel for CUDA tensors, the
    plain version for CPU ones; computed in float32 and returned in the
    images' dtype, as ``roi_pallas.py:247`` casts."""
    return roi_crop(images.float().contiguous(), yxhw.float(), out_size).to(images.dtype)
