"""QA regression dataset: (image, prob map, label) triplets from dump trees.

Counterpart of ``ivosw_tpu/data/qa_dataset.py`` on the port's PNG codec
(:mod:`ivosw_tpu_torch.data.png`), with the same directory layout, the same
sorted enumeration of every (interaction, scribble, object, frame) tuple
under ``{save_result_dir}/interaction-*/scribble-*/{seq}/probs/{obj}/*.png``,
and the same ``default_rng(seed)`` shuffle, so both packages read each
other's dumps into the same batches in the same order. Plus the dump writer
the generator uses (:func:`save_seg_preds`).
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, List, Optional

import numpy as np

from ivosw_tpu_torch.data.png import read_gray8, write_gray8


def save_seg_preds(probs: np.ndarray, meta: Dict, save_result_dir: str) -> None:
    """Dump per-frame per-object prob maps as 8-bit PNGs (prob·255, clipped).

    probs: [T, O+1, H, W]; meta: sequence / n_interaction / scribble_iter.
    Layout: interaction-{i}/scribble-{s}/{seq}/probs/{obj}/{frame:05d}.png
    """
    base = os.path.join(
        save_result_dir,
        f"interaction-{meta['n_interaction']}",
        f"scribble-{meta['scribble_iter']}",
        meta["sequence"],
        "probs",
    )
    t, n_ch = probs.shape[0], probs.shape[1]
    for obj in range(1, n_ch):
        obj_dir = os.path.join(base, str(obj))
        os.makedirs(obj_dir, exist_ok=True)
        for i in range(t):
            arr = np.clip(probs[i, obj] * 255.0, 0, 255).astype(np.uint8)
            write_gray8(os.path.join(obj_dir, f"{i:05d}.png"), arr)


class QARegressionDataset:
    """Iterates (img [H,W,3] f32, prob [H,W] f32, label [H,W] u8) samples."""

    def __init__(
        self,
        registry,
        save_result_dir: str,
        transform=None,
        sequences: Optional[List[str]] = None,
        seed: int = 0,
    ):
        self.registry = registry
        self.save_result_dir = save_result_dir
        self.transform = transform
        self.rng = np.random.default_rng(seed)

        self.samples_list: List[Dict] = []
        interactions = sorted(
            int(x.split("-")[-1])
            for x in os.listdir(save_result_dir)
            if x.startswith("interaction-")
        )
        for i in interactions:
            i_dir = os.path.join(save_result_dir, f"interaction-{i}")
            for s_name in sorted(os.listdir(i_dir)):
                if not s_name.startswith("scribble-"):
                    continue
                s_dir = os.path.join(i_dir, s_name)
                for seq in sorted(os.listdir(s_dir)):
                    if sequences is not None and seq not in sequences:
                        continue
                    probs_dir = os.path.join(s_dir, seq, "probs")
                    if not os.path.isdir(probs_dir):
                        continue
                    for obj in sorted(os.listdir(probs_dir), key=int):
                        obj_dir = os.path.join(probs_dir, obj)
                        for png in sorted(os.listdir(obj_dir)):
                            self.samples_list.append(
                                dict(
                                    sequence=seq,
                                    frame=int(png.split(".")[0]),
                                    obj_id=int(obj),
                                    prob_path=os.path.join(obj_dir, png),
                                )
                            )

    def __len__(self) -> int:
        return len(self.samples_list)

    def load(self, idx: int) -> Dict[str, np.ndarray]:
        """One sample: single-frame loads (samples are shuffled across
        sequences), then the transform."""
        rec = self.samples_list[idx]
        img = self.registry.load_image_frame(rec["sequence"], rec["frame"])
        ann = self.registry.load_annotation_frame(rec["sequence"], rec["frame"])
        label = (ann == rec["obj_id"]).astype(np.uint8)
        prob = read_gray8(rec["prob_path"]).astype(np.float32) / 255.0
        sample = {"img": img.astype(np.float32), "prob": prob, "label": label}
        if self.transform is not None:
            sample = self.transform(sample)
        return sample

    def batches(
        self,
        batch_size: int,
        shuffle: bool = True,
        drop_last: bool = True,
        skip: int = 0,
    ) -> Iterator[Dict[str, np.ndarray]]:
        """Stacked batches in one ``default_rng(seed)`` permutation. ``skip``
        drops the first N batches without loading them (a resumed epoch
        consumes the same remaining batch sequence)."""
        order = np.arange(len(self))
        if shuffle:
            self.rng.shuffle(order)
        end = len(order) - (len(order) % batch_size) if drop_last else len(order)
        for start in range(skip * batch_size, end, batch_size):
            idxs = order[start : start + batch_size]
            if len(idxs) < batch_size and drop_last:
                break
            loaded = [self.load(int(i)) for i in idxs]
            yield {
                "img": np.stack([s["img"] for s in loaded]),
                "prob": np.stack([s["prob"] for s in loaded]),
                "label": np.stack([s["label"] for s in loaded]),
            }
