"""ctypes bridge to the host J / boundary-F library (C++, threads).

Counterpart of ``ivosw_tpu/ops/metrics_native.py`` over the port's own copy
of its source, ``ivosw_tpu_torch/csrc/host/metrics.cpp``, which
:func:`ivosw_tpu_torch.kernels._build.load_host` compiles with ``g++`` at
first use. Per (frame, object) the library computes J, and the boundary F
with an exact squared Euclidean distance transform thresholded at r²
(the disk dilation of :mod:`ivosw_tpu_torch.ops.metrics`), parallel over
the T×O batch on ``std::thread``s (the JAX package's copy uses OpenMP,
whose runtime, libgomp, not every g++ install carries): ``OMP_NUM_THREADS`` bounds them, else
the host's cores; :func:`native_num_threads` reports the count. Results
equal the numpy path's exactly for ``bound_th`` < 1 and for integer
``bound_th`` ≥ 1 (the tests hold them at 0).

A failed build raises with the compiler's output; nothing falls back to
the numpy path quietly.
"""

from __future__ import annotations

import ctypes

import numpy as np

_I32P = ctypes.POINTER(ctypes.c_int32)
_F64P = ctypes.POINTER(ctypes.c_double)
_c_int = ctypes.c_int
_bound = False


def _lib() -> ctypes.CDLL:
    global _bound
    from ivosw_tpu_torch.kernels import _build

    lib = _build.load_host("metrics")
    if not _bound:
        lib.boundary_f_measure_batch.argtypes = [
            _I32P, _I32P, _c_int, _c_int, _c_int, _c_int, ctypes.c_double, _F64P]
        lib.boundary_f_measure_batch.restype = None
        lib.jaccard_batch.argtypes = [_I32P, _I32P, _c_int, _c_int, _c_int, _c_int, _F64P]
        lib.jaccard_batch.restype = None
        lib.native_num_threads.restype = _c_int
        _bound = True
    return lib


def native_num_threads() -> int:
    """The threads a call of the library uses (``OMP_NUM_THREADS``, else the
    host's cores)."""
    return int(_lib().native_num_threads())


def _prep(y_true, y_pred):
    gt = np.ascontiguousarray(y_true, dtype=np.int32)
    pr = np.ascontiguousarray(y_pred, dtype=np.int32)
    if gt.shape != pr.shape or gt.ndim != 3:
        raise ValueError(f"need two [T, H, W] label arrays, got {gt.shape} and {pr.shape}")
    return gt, pr


def batched_f_measure_native(
    y_true: np.ndarray, y_pred: np.ndarray, nb_objects: int, bound_th: float = 0.008
) -> np.ndarray:
    """Boundary F per (frame, object id 1..nb_objects) → [T, nb_objects] float64."""
    lib = _lib()
    gt, pr = _prep(y_true, y_pred)
    t, h, w = gt.shape
    out = np.zeros((t, nb_objects), dtype=np.float64)
    lib.boundary_f_measure_batch(gt.ctypes.data_as(_I32P), pr.ctypes.data_as(_I32P),
                                 t, h, w, nb_objects, float(bound_th), out.ctypes.data_as(_F64P))
    return out


def batched_jaccard_native(y_true: np.ndarray, y_pred: np.ndarray, nb_objects: int) -> np.ndarray:
    """J per (frame, object id 1..nb_objects) → [T, nb_objects] float64
    (empty ∪ empty = 1)."""
    lib = _lib()
    gt, pr = _prep(y_true, y_pred)
    t, h, w = gt.shape
    out = np.zeros((t, nb_objects), dtype=np.float64)
    lib.jaccard_batch(gt.ctypes.data_as(_I32P), pr.ctypes.data_as(_I32P),
                      t, h, w, nb_objects, out.ctypes.data_as(_F64P))
    return out
