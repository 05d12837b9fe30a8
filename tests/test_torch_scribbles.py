"""The port's cv2-free scribble rasteriser against the JAX package's
(``cv2.polylines`` thickness 1, ``cv2.dilate`` with a square kernel):
pixel for pixel, on seeded random paths (one-point paths, paths along and
across the border, overlapping lines of several objects) and on the
scribble robot's paths."""

import numpy as np
import pytest

from ivosw_tpu.data import scribbles as J
from ivosw_tpu.data.registry import SequenceRegistry as JaxRegistry
from ivosw_tpu.interact.robot import ScribbleRobot as JaxRobot
from ivosw_tpu_torch.data import scribbles as T


def _random_scribbles(rng, t, n_lines):
    frames = [[] for _ in range(t)]
    for _ in range(n_lines):
        kind = rng.integers(4)
        n = 1 if kind == 0 else int(rng.integers(2, 12))
        path = rng.random((n, 2))
        if kind == 1:  # along a border
            path[:, int(rng.integers(2))] = float(rng.integers(2))
        elif kind == 2:  # beyond the frame, clipped
            path = path * 1.4 - 0.2
        frames[int(rng.integers(t))].append(
            J.make_scribble(path, int(rng.integers(0, 4)))
        )
    return {"sequence": "s", "scribbles": frames}


@pytest.mark.parametrize("hw", [(48, 64), (50, 70), (7, 5), (1, 9)])
def test_random_paths_match_jax(hw):
    rng = np.random.default_rng(hw[0] * 100 + hw[1])
    for _ in range(60):
        scrib = _random_scribbles(rng, 3, int(rng.integers(1, 8)))
        np.testing.assert_array_equal(T.scribbles2mask(scrib, hw), J.scribbles2mask(scrib, hw))
        frame = int(rng.integers(3))
        np.testing.assert_array_equal(
            T.scribbles2mask(scrib, hw, only_frame=frame, default_value=0),
            J.scribbles2mask(scrib, hw, only_frame=frame, default_value=0),
        )
        for dilation in (0, 1, 3):
            np.testing.assert_array_equal(
                T.scribble_masks_per_object(scrib, hw, frame, 3, dilation=dilation),
                J.scribble_masks_per_object(scrib, hw, frame, 3, dilation=dilation),
            )


def test_robot_paths_match_jax():
    """The robot's scribbles on a synthetic clip over a few rounds of
    degraded masks, dilated as the TAPNet adapter does (3)."""
    reg = JaxRegistry.synthetic(["r"], num_frames=5, image_size=(64, 48), num_objects=3, seed=2)
    gt = reg.load_annotations("r")
    rng = np.random.default_rng(0)
    robot = JaxRobot(seed=0)
    checked = 0
    for k in range(40):
        pred = np.where(rng.random(gt.shape) < 0.2 * (k % 4), 0, gt).astype(gt.dtype)
        frame = k % 5
        scrib = robot.interact("r", pred, gt, 3, frame=frame)
        for dilation in (0, 3):
            ours = T.scribble_masks_per_object(scrib, (48, 64), frame, 3, dilation=dilation)
            ref = J.scribble_masks_per_object(scrib, (48, 64), frame, 3, dilation=dilation)
            np.testing.assert_array_equal(ours, ref)
        checked += sum(len(line["path"]) for line in scrib["scribbles"][frame])
    assert checked > 100


def test_draw_line_matches_cv2_on_every_octant():
    import cv2

    rng = np.random.default_rng(1)
    for _ in range(2000):
        h, w = (int(v) for v in rng.integers(1, 30, size=2))
        x0, x1 = (int(v) for v in rng.integers(0, w, size=2))
        y0, y1 = (int(v) for v in rng.integers(0, h, size=2))
        ref = np.full((h, w), -1, np.int32)
        cv2.polylines(ref, [np.array([[x0, y0], [x1, y1]], np.int32).reshape(-1, 1, 2)],
                      isClosed=False, color=2, thickness=1)
        ours = np.full((h, w), -1, np.int32)
        T.draw_line(ours, x0, y0, x1, y1, 2)
        np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("dist", [0, 3, 20])
def test_rough_roi_filter_matches_jax(dist):
    """MANet's rough_ROI on seeded scribble labels (−1 where unannotated),
    boxes away from and against the border, and a label without scribbles."""
    rng = np.random.default_rng(dist)
    for k in range(30):
        h, w = int(rng.integers(5, 60)), int(rng.integers(5, 60))
        label = np.full((h, w), -1, dtype=np.int32)
        if k % 6 != 0:  # every sixth label holds no scribble
            rows = rng.integers(0, h, int(rng.integers(1, 6)))
            cols = rng.integers(0, w, len(rows))
            label[rows, cols] = rng.integers(0, 3, len(rows))
        background = int(rng.integers(-1, 2))
        ours = T.rough_roi_filter(label, dist=dist, background_value=background)
        ref = J.rough_roi_filter(label, dist=dist, background_value=background)
        assert ours.dtype == ref.dtype
        np.testing.assert_array_equal(ours, ref)
        if k % 6 == 0:
            np.testing.assert_array_equal(ours, label)
            assert ours is not label
