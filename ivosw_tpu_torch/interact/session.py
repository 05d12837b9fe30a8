"""Interactive VOS session: the simulated-human evaluation harness.

(A copy of ``ivosw_tpu/interact/session.py``.)

Standalone implementation of the protocol the reference drives through
``davisinteractive.session.DavisInteractiveSession``
(``eval_agent_atnet.py:179-194,307,347``):

    with InteractiveSession(...) as sess:
        while sess.next():
            sequence, scribbles, first_scribble = sess.get_scribbles(only_last=False)
            ...
            sess.submit_masks(masks, next_scribble_frame_candidates=[f])
        summary = sess.get_global_summary()

Semantics kept from the reference usage:
- samples = (sequence × scribble-index) pairs, publicly overridable
  (``generate_data.py:129`` injects a fixture list);
- ``sample_last_scribble`` exposes the robot's newest scribble;
- submit_masks evaluates the per-frame metric curve against ground truth and
  asks the robot to annotate the WORST frame among the provided candidates;
- get_global_summary returns a per-round averaged curve with one trailing
  extra point, so driver code that slices ``curve[:-1]``
  (``eval_agent_atnet.py:352-360``) reproduces the reference exactly;
- a ``connector.service.robot`` shim keeps the reference's robot-tuning
  pattern (``sess.connector.service.robot.min_nb_nodes = n``) working;
- when ``report_save_dir`` is set, a ``session_report.csv`` is written in
  the davisinteractive report layout (one row per (sequence, scribble_idx,
  interaction, object_id, frame) with per-object ``jaccard``/``contour``
  columns — the package's ``EvaluationService`` REPORT_COLUMNS), so external
  tooling written against the reference's report CSVs reads it unmodified.
  The only divergence is the deterministic filename (davisinteractive names
  the file after the session start timestamp).

Round-1 scribbles: DAVIS ships human scribble JSON files
(``Scribbles/<seq>/00N.json``); when present they are used, otherwise the
robot self-bootstraps against an empty prediction on an evenly-spaced frame
per scribble index — deterministic either way.
"""

from __future__ import annotations

import json
import os
import time
from types import SimpleNamespace
from typing import Dict, List, Optional, Tuple

import numpy as np

from ivosw_tpu_torch.data.registry import SequenceRegistry
from ivosw_tpu_torch.data.scribbles import (
    annotated_frames,
    empty_scribbles,
    merge_scribbles,
)
from ivosw_tpu_torch.interact.robot import ScribbleRobot
from ivosw_tpu_torch.ops.metrics import (
    auc_from_curve,
    batched_f_measure,
    batched_jaccard,
    sequence_metric,
)


class InteractiveSession:
    def __init__(
        self,
        registry: SequenceRegistry,
        subset: str = "val",
        metric_to_optimize: str = "J_AND_F",
        max_nb_interactions: int = 8,
        max_time: Optional[float] = None,
        report_save_dir: Optional[str] = None,
        robot: Optional[ScribbleRobot] = None,
        seed: int = 0,
        shuffle: bool = False,
    ):
        self.registry = registry
        self.subset = subset
        self.metric = metric_to_optimize
        self.max_nb_interactions = max_nb_interactions
        self.max_time = max_time
        self.report_save_dir = report_save_dir
        self.robot = robot or ScribbleRobot(seed=seed)
        self.rng = np.random.default_rng(seed)

        self.samples: List[Tuple[str, int]] = [
            (seq, i)
            for seq in registry.subset(subset)
            for i in range(1, registry.info(seq).num_scribbles + 1)
        ]
        if shuffle:
            self.rng.shuffle(self.samples)

        # reference drivers tune the robot through this chain
        self.connector = SimpleNamespace(service=SimpleNamespace(robot=self.robot))

        self._sample_idx = -1
        self._interaction = 0  # interactions completed for current sample
        self._gt: Optional[np.ndarray] = None
        self._nb_objects = 0
        self._accumulated: Optional[Dict] = None
        self.sample_last_scribble: Optional[Dict] = None
        self._scribbles_ready = False

        # round -> list of per-sample mean metric values
        self._curve_acc: Dict[int, List[float]] = {}
        self._report_rows: List[Dict] = []
        # davisinteractive-layout detail rows (per object × frame); only
        # accumulated when a report CSV will actually be written
        self._detail_rows: List[Dict] = []
        self._session_id = time.strftime("%Y%m%d_%H%M%S")
        self._t_start = time.time()

    # ---------------------------------------------------------------- ctx --
    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if self.report_save_dir:
            self._write_report()
        return False

    # --------------------------------------------------------------- next --
    def next(self) -> bool:
        """Advance: new interaction of the current sample, or a new sample.

        Moves to the next sample when the round budget is exhausted or the
        robot could produce no further correction scribbles."""
        need_new_sample = (
            self._sample_idx < 0
            or self._interaction >= self.max_nb_interactions
            or not self._scribbles_ready
        )
        while need_new_sample:
            self._sample_idx += 1
            if self._sample_idx >= len(self.samples):
                return False
            self._start_sample()
            # degenerate sample (no objects / nothing to scribble): skip it
            need_new_sample = len(annotated_frames(self.sample_last_scribble)) == 0
        return True

    def _start_sample(self):
        sequence, scribble_idx = self.samples[self._sample_idx]
        info = self.registry.info(sequence)
        self._gt = self.registry.load_annotations(sequence)
        self._nb_objects = info.num_objects
        self._interaction = 0

        self._sample_t_start = time.time()
        self._interaction_t_start = self._sample_t_start
        scrib = self._load_human_scribble(sequence, scribble_idx)
        if scrib is None:
            t = info.num_frames
            n_scb = info.num_scribbles
            frame = int(round((scribble_idx - 0.5) * t / n_scb))
            frame = min(max(frame, 0), t - 1)
            zero_pred = np.zeros_like(self._gt)
            scrib = self.robot.interact(
                sequence, zero_pred, self._gt, self._nb_objects, frame
            )
        self.sample_last_scribble = scrib
        self._accumulated = scrib
        self._scribbles_ready = True

    def _load_human_scribble(self, sequence: str, scribble_idx: int) -> Optional[Dict]:
        if self.registry.root is None:
            return None
        path = os.path.join(
            self.registry.root, "Scribbles", sequence, f"{scribble_idx:03d}.json"
        )
        if not os.path.exists(path):
            return None
        with open(path) as fp:
            return json.load(fp)

    @property
    def current_sample(self) -> Tuple[str, int]:
        """The (sequence, scribble_idx) pair currently being annotated."""
        return self.samples[self._sample_idx]

    # ---------------------------------------------------------- scribbles --
    def get_scribbles(self, only_last: bool = False):
        sequence, _ = self.samples[self._sample_idx]
        first = self._interaction == 0
        scrib = self.sample_last_scribble if only_last else self._accumulated
        return sequence, scrib, first

    # ------------------------------------------------------------- submit --
    def submit_masks(
        self,
        pred_masks: np.ndarray,
        next_scribble_frame_candidates: Optional[List[int]] = None,
    ) -> None:
        sequence, scribble_idx = self.samples[self._sample_idx]
        pred = np.asarray(pred_masks).astype(np.int32)
        detail = self.report_save_dir is not None
        if detail or self.metric == "J_AND_F":
            # per-object [T, O] arrays; the scalar curve derives from them so
            # J and F are never computed twice for one submission
            jac = batched_jaccard(
                self._gt, pred, average_over_objects=False,
                nb_objects=self._nb_objects,
            )
            con = batched_f_measure(
                self._gt, pred, average_over_objects=False,
                nb_objects=self._nb_objects,
            )
            if self.metric == "J":
                per_frame = jac.mean(axis=1)
            elif self.metric == "F":
                per_frame = con.mean(axis=1)
            else:
                per_frame = (0.5 * jac + 0.5 * con).mean(axis=1)
        else:
            per_frame = sequence_metric(
                self.metric, self._gt, pred, self._nb_objects
            )
        self._interaction += 1
        round_idx = self._interaction
        self._curve_acc.setdefault(round_idx, []).append(float(per_frame.mean()))
        self._report_rows.append(
            {
                "sequence": sequence,
                "scribble_idx": scribble_idx,
                "interaction": round_idx,
                "metric": self.metric,
                "value": float(per_frame.mean()),
                "timestamp": time.time() - self._t_start,
            }
        )
        if detail:
            # davisinteractive EvaluationService report rows: one per
            # (object, frame), interaction timing in seconds
            timing = time.time() - self._interaction_t_start
            t_frames = jac.shape[0]
            for obj in range(self._nb_objects):
                for f in range(t_frames):
                    self._detail_rows.append(
                        {
                            "session_id": self._session_id,
                            "sequence": sequence,
                            "scribble_idx": scribble_idx,
                            "interaction": round_idx,
                            "object_id": obj + 1,
                            "frame": f,
                            "jaccard": float(jac[f, obj]),
                            "contour": float(con[f, obj]),
                            "timing": timing,
                        }
                    )
        self._interaction_t_start = time.time()

        # max_time semantics (davisinteractive): the per-sample interaction
        # budget is max_time seconds per object; once exhausted, the sample
        # ends early and the session moves on
        if self.max_time is not None:
            budget = self.max_time * max(self._nb_objects, 1)
            if time.time() - self._sample_t_start > budget:
                self._scribbles_ready = False
                self._interaction = self.max_nb_interactions
                return

        if self._interaction < self.max_nb_interactions:
            if next_scribble_frame_candidates:
                cands = list(next_scribble_frame_candidates)
                frame = int(cands[int(np.argmin(per_frame[cands]))])
            else:
                frame = int(np.argmin(per_frame))
            scrib = self.robot.interact(
                sequence, pred, self._gt, self._nb_objects, frame
            )
            if len(annotated_frames(scrib)) == 0:
                # nothing left to correct on that frame; annotate globally
                # worst frame instead, else emit an empty scribble set
                frame2 = int(np.argmin(per_frame))
                scrib = self.robot.interact(
                    sequence, pred, self._gt, self._nb_objects, frame2
                )
            if len(annotated_frames(scrib)) == 0:
                scrib = empty_scribbles(sequence, self._gt.shape[0])
                self._scribbles_ready = False
            else:
                self._scribbles_ready = True
            self.sample_last_scribble = scrib
            self._accumulated = merge_scribbles(self._accumulated, scrib)

    # ------------------------------------------------------------ summary --
    def get_global_summary(self) -> Dict:
        rounds = sorted(self._curve_acc)
        curve = [float(np.mean(self._curve_acc[r])) for r in rounds]
        # trailing duplicate so reference-style curve[:-1] slicing works
        curve_out = curve + [curve[-1] if curve else 0.0]
        auc = auc_from_curve(curve)
        return {
            "curve": {self.metric: curve_out},
            "auc": auc,
            "metric": self.metric,
            "num_samples": len(self.samples),
            "max_nb_interactions": self.max_nb_interactions,
        }

    def get_report(self) -> List[Dict]:
        return list(self._report_rows)

    # davisinteractive's EvaluationService report schema — external tooling
    # written against the reference's report CSVs keys on these columns
    REPORT_COLUMNS = [
        "session_id",
        "sequence",
        "scribble_idx",
        "interaction",
        "object_id",
        "frame",
        "jaccard",
        "contour",
        "timing",
    ]

    def _write_report(self):
        os.makedirs(self.report_save_dir, exist_ok=True)
        import csv

        path = os.path.join(self.report_save_dir, "session_report.csv")
        if not self._detail_rows:
            return
        with open(path, "w", newline="") as fp:
            writer = csv.DictWriter(fp, fieldnames=self.REPORT_COLUMNS)
            writer.writeheader()
            writer.writerows(self._detail_rows)
