"""The port's host J&F library (``ops/metrics_native.py`` over
``csrc/host/metrics.cpp``) against its numpy path and the JAX package's
native path: equal to the last bit (tolerance 0) on seeded label masks with
empty, full, border-touching and one-pixel objects, tolerance radii of
whole pixels (``bound_th`` ≥ 1), and one 480×854 clip."""

import os
import subprocess
import sys

import numpy as np
import pytest

from ivosw_tpu.ops import metrics as jax_metrics
from ivosw_tpu_torch.kernels import _build
from ivosw_tpu_torch.ops import metrics, metrics_native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _blobs(rng, t, h, w, o):
    """Ragged seeded masks: a noisy rectangle per object."""
    out = np.zeros((t, h, w), np.int32)
    for ti in range(t):
        for obj in range(1, o + 1):
            y0, x0 = rng.integers(0, h - 4), rng.integers(0, w - 4)
            y1, x1 = y0 + rng.integers(2, h // 2), x0 + rng.integers(2, w // 2)
            region = out[ti, y0:y1, x0:x1]
            region[rng.random(region.shape) < 0.85] = obj
    return out


def _cases():
    rng = np.random.default_rng(0)
    t, h, w, o = 6, 40, 56, 3
    gt, pr = _blobs(rng, t, h, w, o), _blobs(rng, t, h, w, o)
    # frame 0: object 1 empty in both, object 2 empty in the prediction only
    gt[0][gt[0] == 1] = 0
    pr[0][pr[0] <= 2] = 0
    # frame 1: object 3 fills the frame in the ground truth
    gt[1] = 3
    # frame 2: objects touching every border
    gt[2, :, :3] = 1
    gt[2, -2:, :] = 2
    pr[2, :2, :] = 1
    pr[2, :, -1] = 2
    # frame 3: one-pixel objects, at a corner and inside
    gt[3] = 0
    pr[3] = 0
    gt[3, 0, 0] = pr[3, 0, 1] = 1
    gt[3, 20, 30] = pr[3, 20, 30] = 2
    pr[3, h - 1, w - 1] = 3
    return gt, pr, o


CASES = _cases()


@pytest.mark.parametrize("bound_th", [0.008, 0.05, 1.0, 2.0, 5.0])
def test_f_measure_native_equals_numpy_and_jax(bound_th):
    gt, pr, o = CASES
    native = metrics.batched_f_measure(gt, pr, False, o, bound_th, backend="native")
    plain = metrics.batched_f_measure(gt, pr, False, o, bound_th, backend="numpy")
    jax_native = jax_metrics.batched_f_measure(gt, pr, False, o, bound_th, backend="native")
    assert native.shape == (gt.shape[0], o) and native.dtype == np.float64
    np.testing.assert_array_equal(native, plain)
    np.testing.assert_array_equal(native, jax_native)
    # the special cases took their defined values
    assert native[0, 0] == 1.0 and native[0, 1] == 0.0


def test_jaccard_native_equals_numpy_and_jax():
    gt, pr, o = CASES
    native = metrics.batched_jaccard(gt, pr, False, o, backend="native")
    np.testing.assert_array_equal(native, metrics.batched_jaccard(gt, pr, False, o,
                                                                  backend="numpy"))
    np.testing.assert_array_equal(native, jax_metrics.batched_jaccard(gt, pr, False, o,
                                                                      backend="native"))
    assert native[0, 0] == 1.0 and native[0, 1] == 0.0


def test_full_size_clip_and_auto_backend(monkeypatch):
    """480×854, T=4, O=3 (the evaluation's frame size): auto runs the
    library, and J, F and J&F equal the numpy path and the JAX package."""
    rng = np.random.default_rng(1)
    gt, pr = _blobs(rng, 4, 480, 854, 3), _blobs(rng, 4, 480, 854, 3)
    calls = []
    for name in ("batched_f_measure_native", "batched_jaccard_native"):
        fn = getattr(metrics_native, name)
        monkeypatch.setattr(metrics_native, name,
                            lambda *a, _fn=fn, _n=name, **k: calls.append(_n) or _fn(*a, **k))
    got = metrics.sequence_metric("J_AND_F", gt, pr, 3)
    assert sorted(calls) == ["batched_f_measure_native", "batched_jaccard_native"]
    ref = 0.5 * metrics.batched_jaccard(gt, pr, nb_objects=3, backend="numpy") + \
        0.5 * metrics.batched_f_measure(gt, pr, nb_objects=3, backend="numpy")
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, jax_metrics.sequence_metric("J_AND_F", gt, pr, 3))


def test_unknown_backend_and_bad_shapes_raise():
    gt, pr, o = CASES
    with pytest.raises(ValueError, match="backend"):
        metrics.batched_jaccard(gt, pr, nb_objects=o, backend="cv2")
    with pytest.raises(ValueError, match="T, H, W"):
        metrics_native.batched_jaccard_native(gt[0], pr[0], o)


def test_failed_build_raises_with_the_compiler_output(monkeypatch):
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="host library build failed: metrics.cpp"):
        _build.build_host("metrics")


def test_omp_num_threads_is_respected():
    code = ("from ivosw_tpu_torch.ops.metrics_native import native_num_threads\n"
            "print(native_num_threads())\n")
    env = dict(os.environ, OMP_NUM_THREADS="3")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.split()[-1] == "3"
