"""Replay transition record (a copy of ``Transition`` from
``ivosw_tpu/data/replay.py``; the ring buffer and its CSV I/O come with the
agent-training slice)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np


def _join(vec) -> str:
    return "/".join(str(v) for v in np.asarray(vec).reshape(-1))


@dataclass
class Transition:
    sequence: str
    scribble_iter: int
    n_interaction: int
    n_interaction_next: int
    action: int
    reward_step: float
    reward_done: float
    done: bool
    state_iou: np.ndarray
    next_state_iou: np.ndarray
    annotated_frames: np.ndarray
    next_annotated_frames: np.ndarray

    def to_row(self) -> List:
        return [
            self.sequence,
            self.scribble_iter,
            self.n_interaction,
            self.n_interaction_next,
            self.action,
            self.reward_step,
            self.reward_done,
            self.done,
            _join(self.state_iou),
            _join(self.next_state_iou),
            _join(self.annotated_frames),
            _join(self.next_annotated_frames),
        ]
