"""Drop-in surface of the ``davisinteractive`` package the reference drives.

A copy of ``ivosw_tpu/compat/davisinteractive.py``. Users of the reference
interact with davisinteractive through four touch points
(``eval_agent_atnet.py:17-19``): ``DavisInteractiveSession``, the ``Davis``
dataset class, ``metrics.batched_jaccard/batched_f_measure``, and
``utils.scribbles``. This module re-exposes all four backed by the port's
implementations, so reference-style evaluation code ports by switching
one import:

    from ivosw_tpu_torch.compat.davisinteractive import (
        DavisInteractiveSession, Davis, batched_jaccard, batched_f_measure,
        scribbles as scribble_utils)

Differences: ``host`` is accepted and ignored (no server — everything is
in-process); the scribble robot is the port's wavefront robot.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

from ivosw_tpu_torch.data import scribbles  # noqa: F401  (utils.scribbles surface)
from ivosw_tpu_torch.data.registry import SequenceRegistry
from ivosw_tpu_torch.interact.session import InteractiveSession
from ivosw_tpu_torch.ops.metrics import batched_f_measure, batched_jaccard  # noqa: F401


def _registry_for_root(davis_root: str) -> SequenceRegistry:
    json_path = os.path.join(davis_root, "scb_ytbvos.json")
    if os.path.exists(json_path):
        return SequenceRegistry.from_json(json_path, root=davis_root)
    return SequenceRegistry.from_davis_root(davis_root)


class Davis:
    """Dataset facade matching davisinteractive.dataset.Davis usage:
    ``Davis(davis_root=...).load_annotations(seq)`` and the class-level
    ``dataset`` registry dict (``eval_agent_atnet.py:84,210-211,240``)."""

    dataset: Dict[str, dict] = {}

    def __init__(self, davis_root: Optional[str] = None):
        self.davis_root = davis_root
        self.registry = _registry_for_root(davis_root)
        Davis.dataset = {
            name: {
                "name": info.name,
                "set": info.set,
                "num_frames": info.num_frames,
                "image_size": list(info.image_size),
                "num_objects": info.num_objects,
                "num_scribbles": info.num_scribbles,
            }
            for name, info in self.registry.sequences.items()
        }

    def load_annotations(self, sequence: str):
        return self.registry.load_annotations(sequence)

    def load_images(self, sequence: str):
        return self.registry.load_images(sequence)

    def get_sequences(self, subset: str) -> List[str]:
        return self.registry.subset(subset)


class DavisInteractiveSession(InteractiveSession):
    """Constructor-compatible session (``eval_agent_atnet.py:179-182``)."""

    def __init__(
        self,
        host: str = "localhost",
        davis_root: Optional[str] = None,
        subset: str = "val",
        metric_to_optimize: str = "J_AND_F",
        max_nb_interactions: int = 8,
        max_time: Optional[float] = None,
        report_save_dir: Optional[str] = None,
        seed: int = 0,
    ):
        del host  # in-process: no service endpoint
        registry = _registry_for_root(davis_root)
        super().__init__(
            registry,
            subset=subset,
            metric_to_optimize=metric_to_optimize,
            max_nb_interactions=max_nb_interactions,
            max_time=max_time,
            report_save_dir=report_save_dir,
            seed=seed,
        )
