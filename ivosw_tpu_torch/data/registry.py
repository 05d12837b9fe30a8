"""Sequence registry: the in-memory (synthetic) form.

A copy of the in-memory part of ``ivosw_tpu/data/registry.py``: the same
``SequenceInfo`` records and the same deterministic ``synthetic`` clips.
The DAVIS-tree and YouTube-VOS readers decode images with PIL, which the
port does not use; they come with a later slice. ``root`` stays ``None``
here (the session reads human scribble files only under a dataset root).

Frames are float32 NHWC in [0, 1].
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclass
class SequenceInfo:
    name: str
    set: str  # 'train' | 'val'
    num_frames: int
    image_size: Tuple[int, int]  # (width, height), davisinteractive convention
    num_objects: int
    num_scribbles: int = 3


@dataclass
class SequenceRegistry:
    root: Optional[str] = None
    sequences: Dict[str, SequenceInfo] = field(default_factory=dict)
    # in-memory data for synthetic registries: name -> (frames, annotations)
    _synthetic: Dict[str, Tuple[np.ndarray, np.ndarray]] = field(
        default_factory=dict, repr=False
    )

    # ------------------------------------------------------------ queries --
    def subset(self, name: str) -> List[str]:
        if name == "trainval":
            return sorted(
                s.name for s in self.sequences.values() if s.set in ("train", "val")
            )
        return sorted(s.name for s in self.sequences.values() if s.set == name)

    def __contains__(self, name: str) -> bool:
        return name in self.sequences

    def info(self, name: str) -> SequenceInfo:
        return self.sequences[name]

    # ------------------------------------------------------------ loaders --
    def load_annotations(self, name: str) -> np.ndarray:
        """Ground-truth label masks [T, H, W] uint8 (0 = background)."""
        return self._synthetic[name][1]

    def load_images(self, name: str) -> np.ndarray:
        """Frames [T, H, W, 3] float32 in [0, 1], RGB."""
        return self._synthetic[name][0]

    def load_image_frame(self, name: str, frame: int) -> np.ndarray:
        """ONE frame [H, W, 3] float32 (per-sample loaders, the QA dataset)."""
        return self._synthetic[name][0][frame]

    def load_annotation_frame(self, name: str, frame: int) -> np.ndarray:
        """ONE annotation [H, W] uint8."""
        return self._synthetic[name][1][frame]

    # ------------------------------------------------------- constructors --
    @classmethod
    def synthetic(
        cls,
        names: List[str],
        num_frames: int = 12,
        image_size: Tuple[int, int] = (64, 48),
        num_objects: int = 2,
        split: str = "val",
        seed: int = 0,
    ) -> "SequenceRegistry":
        """Deterministic in-memory clips: textured frames + moving objects.

        Objects are axis-aligned blobs drifting across the clip so that
        propagation quality, scribbles, and metrics all behave non-trivially
        in hermetic tests.
        """
        rng = np.random.default_rng(seed)
        w, h = image_size
        reg = cls()
        for name in names:
            frames = np.zeros((num_frames, h, w, 3), dtype=np.float32)
            anns = np.zeros((num_frames, h, w), dtype=np.uint8)
            base = rng.random((h, w, 3)).astype(np.float32) * 0.3
            centers = rng.random((num_objects, 2)) * 0.5 + 0.25
            vels = (rng.random((num_objects, 2)) - 0.5) * 0.04
            sizes = rng.integers(max(4, h // 6), max(6, h // 3), size=num_objects)
            colors = rng.random((num_objects, 3)).astype(np.float32) * 0.7 + 0.3
            for t in range(num_frames):
                frame = base + rng.normal(0, 0.02, (h, w, 3)).astype(np.float32)
                ann = np.zeros((h, w), dtype=np.uint8)
                for o in range(num_objects):
                    cy = int((centers[o, 0] + vels[o, 0] * t) * h) % h
                    cx = int((centers[o, 1] + vels[o, 1] * t) * w) % w
                    s = int(sizes[o])
                    y0, y1 = max(0, cy - s // 2), min(h, cy + s // 2 + 1)
                    x0, x1 = max(0, cx - s // 2), min(w, cx + s // 2 + 1)
                    frame[y0:y1, x0:x1] = colors[o]
                    ann[y0:y1, x0:x1] = o + 1
                frames[t] = np.clip(frame, 0, 1)
                anns[t] = ann
            reg.sequences[name] = SequenceInfo(
                name=name,
                set=split,
                num_frames=num_frames,
                image_size=(w, h),
                num_objects=num_objects,
            )
            reg._synthetic[name] = (frames, anns)
        return reg


def registry_from_config(cfg) -> SequenceRegistry:
    """Config → registry. ``dataset=demo`` is the demo generator's val/train
    registry (:func:`ivosw_tpu_torch.data.demo.demo_registry`, seeded by
    ``cfg.seed``); the DAVIS and YouTube-VOS readers are a later slice."""
    if cfg.dataset == "demo":
        from ivosw_tpu_torch.data.demo import demo_registry

        return demo_registry(seed=cfg.seed)
    if cfg.dataset in ("davis", "ytbvos"):
        raise NotImplementedError(
            f"dataset={cfg.dataset}: the image-file readers are not ported yet "
            "(later slice); use dataset=demo"
        )
    raise NotImplementedError(cfg.dataset)
