"""Scribble data structures (davisinteractive wire format).

A copy of the part of ``ivosw_tpu/data/scribbles.py`` the wild-setting loop
uses. Scribble dicts:

    {"sequence": str,
     "scribbles": [per-frame list of
         {"path": [[x, y], ...],   # normalized to [0, 1]
          "object_id": int,
          "start_time"/"end_time": int}]}

Rasterisation (``scribbles2mask``) belongs to the slice that ports the
scribble-driven backbones.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def empty_scribbles(sequence: str, num_frames: int) -> Dict:
    return {"sequence": sequence, "scribbles": [[] for _ in range(num_frames)]}


def annotated_frames(scribbles: Dict) -> List[int]:
    """Frames that carry at least one scribble line
    (davisinteractive.utils.scribbles.annotated_frames equivalent)."""
    return [i for i, lines in enumerate(scribbles["scribbles"]) if len(lines) > 0]


def is_empty(scribbles: Dict) -> bool:
    return len(annotated_frames(scribbles)) == 0


def merge_scribbles(base: Dict, new: Dict) -> Dict:
    """Accumulate scribbles across rounds (get_scribbles(only_last=False))."""
    assert base["sequence"] == new["sequence"]
    merged = {
        "sequence": base["sequence"],
        "scribbles": [list(a) + list(b) for a, b in zip(base["scribbles"], new["scribbles"])],
    }
    return merged


def make_scribble(
    path_xy: np.ndarray, object_id: int, start_time: int = 0, end_time: int = 1000
) -> Dict:
    return {
        "path": [[float(x), float(y)] for x, y in path_xy],
        "object_id": int(object_id),
        "start_time": start_time,
        "end_time": end_time,
    }
