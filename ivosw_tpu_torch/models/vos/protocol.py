"""The VOS backbone adapter protocol.

(A copy of ``ivosw_tpu/models/vos/protocol.py``.)

Unifies the reference's three per-backbone call conventions —
``run_VOS_singleiact`` (ATNet, ``utils/utils_atnet.py:14-160``),
``get_results`` (MANet, ``utils/utils_manet.py:59-163``) and IPN's
``init_variables``/``Run`` (``eval_agent_ipn.py:228,246-248``) — behind one
contract:

    state = adapter.begin_sequence(frames, num_objects)
    masks, probs, state = adapter.segment(
        state, scribbles, annotated_frame, n_interaction)

with masks [T, H, W] integer labels and probs [T, O+1, H, W] per-object
probabilities (channel 0 = background), exactly the tuple shape every
recommendation policy consumes (``eval_agent_atnet.py:278-300``).

Adapters own all cross-round backbone state (the reference leaks it into the
driver via vos_kwargs, ``eval_agent_atnet.py:243-257``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Protocol, Tuple, runtime_checkable

import numpy as np


@dataclass
class SegmentationResult:
    masks: np.ndarray  # [T, H, W] int labels
    probs: np.ndarray  # [T, O+1, H, W] float probabilities
    state: Any


def begin_sequence_compat(adapter, frames, num_objects, sequence=None, gt=None):
    """Call begin_sequence with only the kwargs the adapter declares.

    Real backbones need just the clip; the fake backbone also wants the
    sequence name or a ground-truth override (training subsequences)."""
    import inspect

    kwargs = {}
    try:
        params = inspect.signature(adapter.begin_sequence).parameters
    except (TypeError, ValueError):
        params = {}
    if "sequence" in params and sequence is not None:
        kwargs["sequence"] = sequence
    if "gt" in params and gt is not None:
        kwargs["gt"] = gt
    return adapter.begin_sequence(frames, num_objects, **kwargs)


@runtime_checkable
class VOSAdapter(Protocol):
    name: str

    def begin_sequence(self, frames: np.ndarray, num_objects: int) -> Any:
        """Per-sequence setup (embedding precompute etc). frames: [T,H,W,3]."""
        ...

    def segment(
        self,
        state: Any,
        scribbles: Dict,
        annotated_frame: int,
        n_interaction: int,
    ) -> Tuple[np.ndarray, np.ndarray, Any]:
        """One interaction round: consume scribbles, propagate to all frames."""
        ...
