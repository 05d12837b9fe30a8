"""YouTube-VOS → DAVIS-layout converter (Scribble-YouTube-VOS preparation).

A copy of ``ivosw_tpu/data/ytbvos_prepare.py`` that reads the annotations
with :func:`ivosw_tpu_torch.data.png.read_indexed` in place of PIL: copy the
scribble-val sequence list's frames (``train/JPEGImages``) and cleaned
annotations (``train/CleanedAnnotations``) into a DAVIS-style tree with
zero-padded renumbered filenames, copy the scribble JSONs, write
``ImageSets/2017/val.txt``, and generate the ``scb_ytbvos.json`` sequence
registry (num_frames / image_size [w, h] / num_objects / num_scribbles=3).

CLI: ``python -m ivosw_tpu_torch.data.ytbvos_prepare --src S --scb C --dst D``
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
from typing import List

import numpy as np

from ivosw_tpu_torch.data.png import read_indexed


def get_seq_info(dataset_dir: str, seq: str):
    ann_dir = os.path.join(dataset_dir, "Annotations", "480p", seq)
    frames = sorted(os.listdir(ann_dir))
    masks = np.stack([read_indexed(os.path.join(ann_dir, f)) for f in frames])
    img_size = [masks.shape[2], masks.shape[1]]  # (w, h)
    obj_ids = np.setdiff1d(np.unique(masks), [0])
    return len(frames), img_size, int(len(obj_ids))


def create_json(root_dir: str) -> str:
    with open(os.path.join(root_dir, "ImageSets", "2017", "val.txt")) as fp:
        val_seqs = [line.strip() for line in fp if line.strip()]

    json_dict = {
        "attributes": [],
        "sets": ["train", "val"],
        "years": [2018],
        "sequences": {},
    }
    for seq in val_seqs:
        num_frames, image_size, num_objects = get_seq_info(root_dir, seq)
        json_dict["sequences"][seq] = {
            "attributes": [],
            "eval_t": True,
            "name": seq,
            "set": "val",
            "year": 2018,
            "num_scribbles": 3,
            "num_frames": num_frames,
            "image_size": image_size,
            "num_objects": num_objects,
        }
    path = os.path.join(root_dir, "scb_ytbvos.json")
    with open(path, "w") as fp:
        json.dump(json_dict, fp, indent=2, separators=(",", ": "))
    return path


def _copy_renumbered(src_dir: str, dst_dir: str, ext: str) -> int:
    os.makedirs(dst_dir, exist_ok=True)
    files = sorted(os.listdir(src_dir))
    for j, f in enumerate(files):
        dst = os.path.join(dst_dir, f"{j:05d}{ext}")
        if not os.path.exists(dst):
            shutil.copyfile(os.path.join(src_dir, f), dst)
    return len(files)


def create_dataset(src_ytbvos: str, dst: str, scb_dir: str) -> List[str]:
    src_jpeg = os.path.join(src_ytbvos, "train", "JPEGImages")
    src_ann = os.path.join(src_ytbvos, "train", "CleanedAnnotations")
    for p, name in ((src_jpeg, "JPEGImages"), (src_ann, "CleanedAnnotations"), (scb_dir, "scribbles")):
        if not os.path.isdir(p):
            raise FileNotFoundError(f"{name} directory not found at {p}")

    with open(os.path.join(scb_dir, "val.txt")) as fp:
        seqs = [line.strip() for line in fp if line.strip()]

    os.makedirs(os.path.join(dst, "ImageSets", "2017"), exist_ok=True)
    shutil.copyfile(
        os.path.join(scb_dir, "val.txt"),
        os.path.join(dst, "ImageSets", "2017", "val.txt"),
    )
    for seq in seqs:
        _copy_renumbered(
            os.path.join(src_jpeg, seq),
            os.path.join(dst, "JPEGImages", "480p", seq),
            ".jpg",
        )
        _copy_renumbered(
            os.path.join(src_ann, seq),
            os.path.join(dst, "Annotations", "480p", seq),
            ".png",
        )
        src_scb = os.path.join(scb_dir, seq)
        if os.path.isdir(src_scb):
            dst_scb = os.path.join(dst, "Scribbles", seq)
            os.makedirs(dst_scb, exist_ok=True)
            for f in sorted(os.listdir(src_scb)):
                target = os.path.join(dst_scb, f)
                if not os.path.exists(target):
                    shutil.copyfile(os.path.join(src_scb, f), target)
    return seqs


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--src", required=True, help="YouTube-VOS root")
    parser.add_argument("--scb", required=True, help="scribble dir (val.txt + per-seq json)")
    parser.add_argument("--dst", required=True, help="output DAVIS-layout root")
    args = parser.parse_args(argv)
    create_dataset(args.src, args.dst, args.scb)
    create_json(args.dst)


if __name__ == "__main__":
    main()
