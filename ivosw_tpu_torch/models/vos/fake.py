"""Deterministic fake VOS backbone for hermetic tests and pipeline bring-up.

(A copy of ``ivosw_tpu/models/vos/fake.py``.)

Fills the role the SURVEY test plan assigns to a "fake VOS backbone
implementing the adapter contract so the full interactive loop runs
hermetically" (reference has nothing comparable — its backbones are external
git clones, ``README.md:35-41``).

Model of behaviour: the backbone "knows" ground truth and returns it degraded
per frame. Each object keeps only a fraction q_t of its pixels (prefix in
row-major order), so the per-object Jaccard is exactly q_t. Quality improves
with proximity to annotated frames and with every round, which gives the
session's J&F-vs-round curve the same monotone shape real backbones produce —
enough signal for reward production, Q-learning and policy comparison tests.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np

from ivosw_tpu_torch.data.scribbles import annotated_frames


@dataclass
class _FakeState:
    gt: np.ndarray  # [T, H, W]
    num_objects: int
    annotated: List[int] = field(default_factory=list)


class FakeVOS:
    name = "fake"

    def __init__(
        self,
        registry,
        base_quality: float = 0.35,
        gain: float = 0.45,
        tau: float = 6.0,
        max_quality: float = 0.98,
    ):
        self.registry = registry
        self.base_quality = base_quality
        self.gain = gain
        self.tau = tau
        self.max_quality = max_quality
        self._sequence: str | None = None

    def begin_sequence(
        self, frames: np.ndarray, num_objects: int, sequence=None, gt=None
    ):
        if gt is None:
            assert sequence is not None, "FakeVOS needs a sequence name or gt"
            gt = self.registry.load_annotations(sequence)
        self._sequence = sequence
        return _FakeState(gt=gt, num_objects=num_objects)

    def frame_quality(self, state: _FakeState) -> np.ndarray:
        t = state.gt.shape[0]
        q = np.full(t, self.base_quality, dtype=np.float64)
        for a in state.annotated:
            dist = np.abs(np.arange(t) - a)
            q += self.gain * np.exp(-dist / self.tau) / (1.0 + 0.3 * state.annotated.count(a))
        return np.clip(q, 0.0, self.max_quality)

    def segment(self, state: _FakeState, scribbles: Dict, annotated_frame: int, n_interaction: int):
        state.annotated.append(int(annotated_frame))
        # sanity: the scribble set really annotates that frame
        afs = annotated_frames(scribbles)
        if afs and annotated_frame not in afs:
            # robot may have fallen back to another frame; trust the scribbles
            state.annotated[-1] = afs[-1]

        q = self.frame_quality(state)
        t, h, w = state.gt.shape
        o = state.num_objects
        masks = np.zeros((t, h, w), dtype=np.int32)
        probs = np.zeros((t, o + 1, h, w), dtype=np.float32)
        for ti in range(t):
            for obj in range(1, o + 1):
                obj_mask = state.gt[ti] == obj
                n_pix = int(obj_mask.sum())
                if n_pix == 0:
                    continue
                keep = int(round(q[ti] * n_pix))
                flat_idx = np.flatnonzero(obj_mask.reshape(-1))[:keep]
                kept = np.zeros(h * w, dtype=bool)
                kept[flat_idx] = True
                kept = kept.reshape(h, w)
                masks[ti][kept] = obj
                probs[ti, obj] = np.where(kept, 0.9, np.where(obj_mask, 0.45, 0.02))
        probs[:, 0] = np.clip(1.0 - probs[:, 1:].sum(axis=1), 0.0, 1.0)
        return masks, probs, state
