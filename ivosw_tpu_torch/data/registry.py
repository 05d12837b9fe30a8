"""Sequence registry + frame/annotation loaders (DAVIS & Scribble-YouTube-VOS).

A copy of ``ivosw_tpu/data/registry.py``: one registry class with three
constructors — a DAVIS directory tree, a ``scb_ytbvos.json`` registry file,
or fully in-memory synthetic clips — and the same ``SequenceInfo`` records.
Frames decode with :mod:`ivosw_tpu_torch.data.jpeg` and annotations with
:func:`ivosw_tpu_torch.data.png.read_indexed`, which give PIL's pixels bit
for bit. The session reads human scribble files under a dataset ``root``.

Frames are float32 NHWC in [0, 1].
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from ivosw_tpu_torch.data import jpeg
from ivosw_tpu_torch.data.png import read_indexed


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
    # tiny LRU caches: eval/session/training visit the same sequence several
    # times in a row (scribble samples are consecutive); decoding a 480p
    # clip repeatedly is pure waste
    _ann_cache: Dict[str, np.ndarray] = field(default_factory=dict, repr=False)
    _img_cache: Dict[str, np.ndarray] = field(default_factory=dict, repr=False)
    cache_sequences: int = 2

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
    def _lru(self, cache: Dict, name: str, loader):
        if name in cache:
            return cache[name]
        val = loader()
        while len(cache) >= max(self.cache_sequences, 1):
            cache.pop(next(iter(cache)))
        cache[name] = val
        return val

    def _files(self, kind: str, name: str) -> List[str]:
        seq_dir = os.path.join(self.root, kind, "480p", name)
        return [os.path.join(seq_dir, f) for f in sorted(os.listdir(seq_dir))]

    def load_annotations(self, name: str) -> np.ndarray:
        """Ground-truth label masks [T, H, W] uint8 (0 = background)."""
        if name in self._synthetic:
            return self._synthetic[name][1]
        return self._lru(
            self._ann_cache,
            name,
            lambda: np.stack([read_indexed(f) for f in self._files("Annotations", name)]),
        )

    def load_images(self, name: str) -> np.ndarray:
        """Frames [T, H, W, 3] float32 in [0, 1], RGB."""
        if name in self._synthetic:
            return self._synthetic[name][0]
        return self._lru(
            self._img_cache,
            name,
            lambda: np.stack(
                [
                    np.asarray(jpeg.read_rgb(f), dtype=np.float32) / 255.0
                    for f in self._files("JPEGImages", name)
                ]
            ),
        )

    def load_image_frame(self, name: str, frame: int) -> np.ndarray:
        """ONE frame [H, W, 3] float32 — avoids whole-clip decodes in
        per-sample loaders (the QA dataset)."""
        if name in self._synthetic:
            return self._synthetic[name][0][frame]
        if name in self._img_cache:
            return self._img_cache[name][frame]
        return (
            np.asarray(jpeg.read_rgb(self._files("JPEGImages", name)[frame]), dtype=np.float32)
            / 255.0
        )

    def load_annotation_frame(self, name: str, frame: int) -> np.ndarray:
        """ONE annotation [H, W] uint8."""
        if name in self._synthetic:
            return self._synthetic[name][1][frame]
        if name in self._ann_cache:
            return self._ann_cache[name][frame]
        return read_indexed(self._files("Annotations", name)[frame])

    # ------------------------------------------------------- constructors --
    @classmethod
    def from_davis_root(cls, root: str, num_scribbles: int = 3) -> "SequenceRegistry":
        """Scan a DAVIS-layout tree (ImageSets/2017/{train,val}.txt). The
        image size comes from the first frame's JPEG header alone. A root
        with neither split file gives an empty registry, as in the JAX
        package."""
        reg = cls(root=root)
        sets_dir = os.path.join(root, "ImageSets", "2017")
        for split in ("train", "val"):
            split_file = os.path.join(sets_dir, f"{split}.txt")
            if not os.path.exists(split_file):
                continue
            with open(split_file) as fp:
                names = [line.strip() for line in fp if line.strip()]
            for name in names:
                img_dir = os.path.join(root, "JPEGImages", "480p", name)
                ann_dir = os.path.join(root, "Annotations", "480p", name)
                frames = sorted(os.listdir(img_dir))
                first_ann = sorted(os.listdir(ann_dir))[0]
                ann = read_indexed(os.path.join(ann_dir, first_ann))
                w, h = jpeg.image_size(os.path.join(img_dir, frames[0]))
                reg.sequences[name] = SequenceInfo(
                    name=name,
                    set=split,
                    num_frames=len(frames),
                    image_size=(w, h),
                    num_objects=int(ann.max()),
                    num_scribbles=num_scribbles,
                )
        return reg

    @classmethod
    def from_json(cls, json_path: str, root: Optional[str] = None) -> "SequenceRegistry":
        """Load a scb_ytbvos.json-style registry
        (reference datasets/prepare_ytbvos.py:23-51 schema)."""
        with open(json_path) as fp:
            data = json.load(fp)
        reg = cls(root=root or os.path.dirname(json_path))
        for name, v in data["sequences"].items():
            reg.sequences[name] = SequenceInfo(
                name=v.get("name", name),
                set=v["set"],
                num_frames=int(v["num_frames"]),
                image_size=tuple(v["image_size"]),
                num_objects=int(v["num_objects"]),
                num_scribbles=int(v.get("num_scribbles", 3)),
            )
        return reg

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
    """Config → registry: a DAVIS directory tree (``dataset=davis``), a
    YouTube-VOS tree's ``scb_ytbvos.json`` (``dataset=ytbvos``), or the demo
    generator's val/train registry (``dataset=demo``:
    :func:`ivosw_tpu_torch.data.demo.demo_registry`, seeded by ``cfg.seed``)."""
    if cfg.dataset == "davis":
        return SequenceRegistry.from_davis_root(cfg.data.root_dir_davis)
    if cfg.dataset == "ytbvos":
        root = cfg.data.root_dir_scribble_youtube_vos
        return SequenceRegistry.from_json(os.path.join(root, "scb_ytbvos.json"), root=root)
    if cfg.dataset == "demo":
        from ivosw_tpu_torch.data.demo import demo_registry

        return demo_registry(seed=cfg.seed)
    raise NotImplementedError(cfg.dataset)
