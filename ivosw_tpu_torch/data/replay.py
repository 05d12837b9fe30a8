"""Experience replay: in-memory ring buffer with the reference's CSV I/O.

Counterpart of ``ivosw_tpu/data/replay.py``: the same 12-column CSV schema
with '/'-joined per-frame vectors, the same per-sequence quality-range
filter ``p_max - p_min > sample_th`` on load, ring push, and a sampler that
draws from the caller's numpy ``Generator`` in the JAX package's order.

The JAX package reads and rewrites the CSV with pandas; the port uses the
standard ``csv`` module and keeps pandas' semantics where they show:
``load_from_csv`` takes the index column, cuts the table to ``capacity``
rows before the filter and reads ``done`` as a bool; ``rewrite_csv`` writes
``DataFrame.to_csv``'s layout (an empty first header cell, index 0..n-1,
floats as ``repr``, bools as ``True``/``False``). Floats are parsed with
``float()``.
"""

from __future__ import annotations

import csv
import os
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

COLUMNS = [
    "sequence",
    "scribble_iter",
    "n_interaction",
    "n_interaction_next",
    "action",
    "reward_step",
    "reward_done",
    "done",
    "state_iou",
    "next_state_iou",
    "annotated_frames",
    "next_annotated_frames",
]

BASENAME_CSV = "memory_pool.csv"


def _join(vec) -> str:
    return "/".join(str(v) for v in np.asarray(vec).reshape(-1))


def _parse(s: str) -> np.ndarray:
    return np.array([float(v) for v in str(s).split("/")], dtype=np.float32)


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

    @classmethod
    def from_row(cls, row: Dict[str, str]) -> "Transition":
        """A transition from one CSV row (column name → text)."""
        return cls(
            sequence=row["sequence"],
            scribble_iter=int(row["scribble_iter"]),
            n_interaction=int(row["n_interaction"]),
            n_interaction_next=int(row["n_interaction_next"]),
            action=int(row["action"]),
            reward_step=float(row["reward_step"]),
            reward_done=float(row["reward_done"]),
            done=row["done"] == "True",
            state_iou=_parse(row["state_iou"]),
            next_state_iou=_parse(row["next_state_iou"]),
            annotated_frames=_parse(row["annotated_frames"]),
            next_annotated_frames=_parse(row["next_annotated_frames"]),
        )


def read_csv_rows(path: str) -> List[Dict[str, str]]:
    """Rows of a memory-pool CSV as dicts of column name → text; the first
    (index) column is dropped, as ``pandas.read_csv(index_col=0)`` does."""
    with open(path, newline="") as fp:
        reader = csv.reader(fp)
        header = next(reader)[1:]
        return [dict(zip(header, line[1:])) for line in reader]


def _csv_cell(value) -> str:
    """One cell as ``DataFrame.to_csv`` writes it: floats by ``repr``."""
    if isinstance(value, (float, np.floating)):
        return repr(float(value))
    return str(value)


class ReplayMemory:
    """Ring buffer of transitions with uniform sampling."""

    def __init__(self, capacity: int, csv_basename: str = BASENAME_CSV):
        self.capacity = int(capacity)
        self.memory: List[Optional[Transition]] = []
        self.position = -1
        self.basename_csv = csv_basename
        self.seq_list: List[str] = []
        self._csv_rows_written = 0

    def __len__(self) -> int:
        return len(self.memory)

    def push(self, transition: Transition) -> None:
        if len(self.memory) < self.capacity:
            self.memory.append(None)
        self.position = (self.position + 1) % self.capacity
        self.memory[self.position] = transition

    def push_to_csv(self, report_save_dir: str) -> None:
        """Append the latest transition to the CSV mirror."""
        os.makedirs(report_save_dir, exist_ok=True)
        csv_path = os.path.join(report_save_dir, self.basename_csv)
        t = self.memory[self.position]
        new_file = not os.path.exists(csv_path)
        with open(csv_path, "a", newline="") as fp:
            writer = csv.writer(fp)
            if new_file:
                writer.writerow([""] + COLUMNS)
                self._csv_rows_written = 0
            writer.writerow([self._csv_rows_written] + t.to_row())
            self._csv_rows_written += 1

    def rewrite_csv(self, report_save_dir: str) -> None:
        """Full dump in pandas' ``to_csv`` layout (the reference's)."""
        os.makedirs(report_save_dir, exist_ok=True)
        csv_path = os.path.join(report_save_dir, self.basename_csv)
        rows = [t.to_row() for t in self.memory if t is not None]
        with open(csv_path, "w", newline="") as fp:
            writer = csv.writer(fp, lineterminator="\n")
            writer.writerow([""] + COLUMNS)
            for i, row in enumerate(rows):
                writer.writerow([i] + [_csv_cell(v) for v in row])
        self._csv_rows_written = len(rows)

    def load_from_csv(
        self,
        path_to_csv: str,
        report_save_dir: Optional[str] = None,
        sample_th: float = 0.0,
    ) -> List[str]:
        """Bootstrap from a reference-format CSV.

        The table is cut to ``capacity`` rows first; with ``sample_th > 0``
        only sequences whose max mean next-state quality exceeds their min
        mean state quality by more than ``sample_th`` are kept. The capacity
        shrinks to the surviving count. Returns the surviving sequence list
        (which restricts the training set)."""
        if sample_th >= 1:
            raise ValueError(f"sample_th must be below 1, got {sample_th}")
        rows = read_csv_rows(path_to_csv)[: self.capacity]

        seq_names = list(dict.fromkeys(r["sequence"] for r in rows))
        self.seq_list = []
        if sample_th > 0:
            for seq in seq_names:
                mp_seq = [r for r in rows if r["sequence"] == seq]
                p_min = min(_parse(r["state_iou"]).mean() for r in mp_seq)
                p_max = max(_parse(r["next_state_iou"]).mean() for r in mp_seq)
                if p_max - p_min > sample_th:
                    self.seq_list.append(seq)
            if not self.seq_list:
                raise ValueError(f"no sequence of {path_to_csv} passes sample_th={sample_th}")
        else:
            self.seq_list = list(seq_names)

        count = 0
        for row in rows:
            if sample_th > 0 and row["sequence"] not in self.seq_list:
                continue
            count += 1
            self.push(Transition.from_row(row))
        self.capacity = max(count, 1)
        self.memory = self.memory[: self.capacity]

        if report_save_dir is not None:
            self.rewrite_csv(report_save_dir)
        return self.seq_list

    def sample_batch(
        self, batch_size: int, rng: np.random.Generator
    ) -> Optional[Dict[str, np.ndarray]]:
        """Uniform sample → stacked arrays ([B] / [B, T]), or None when the
        pool holds fewer than ``batch_size`` transitions.

        With mixed clip lengths in the pool, a length is first drawn
        (``rng.choice`` weighted by its share among the lengths with at
        least ``batch_size`` transitions) and the batch sampled within that
        group, so batches stay stackable; then ``rng.choice(n, B,
        replace=False)``."""
        valid = [t for t in self.memory if t is not None]
        if len(valid) < batch_size:
            return None
        lengths = np.array([len(t.state_iou) for t in valid])
        uniq = np.unique(lengths)
        if len(uniq) > 1:
            eligible = [
                l for l in uniq if np.count_nonzero(lengths == l) >= batch_size
            ]
            if not eligible:
                return None
            weights = np.array(
                [np.count_nonzero(lengths == l) for l in eligible], dtype=np.float64
            )
            t_pick = rng.choice(eligible, p=weights / weights.sum())
            valid = [t for t in valid if len(t.state_iou) == t_pick]
        idx = rng.choice(len(valid), size=batch_size, replace=False)
        picks = [valid[i] for i in idx]
        return {
            "action": np.array([p.action for p in picks], dtype=np.int32),
            "reward_step": np.array([p.reward_step for p in picks], dtype=np.float32),
            "reward_done": np.array([p.reward_done for p in picks], dtype=np.float32),
            "done": np.array([p.done for p in picks], dtype=np.float32),
            "old_state_iou": np.stack([p.state_iou for p in picks]),
            "new_state_iou": np.stack([p.next_state_iou for p in picks]),
            "annotated_frames": np.stack([p.annotated_frames for p in picks]),
            "next_annotated_frames": np.stack([p.next_annotated_frames for p in picks]),
        }
