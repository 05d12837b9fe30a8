"""Dataset trees of the reader tests: the mini-DAVIS tree that the
committed ``results/fake/*/davis`` cells were evaluated on, written with
PIL, and the committed YouTube-VOS demo trees (``scripts/demo_ytbvos.py``)."""

import os

import numpy as np
from PIL import Image

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YTBVOS_SRC = os.path.join(REPO, "train_demo", "ytbvos_src")
YTBVOS_SCB = os.path.join(REPO, "train_demo", "ytbvos_scb")
YTBVOS_DST = os.path.join(REPO, "train_demo", "ytbvos_dst")


def write_mini_davis(root: str) -> str:
    """``toy-car`` and ``toy-dog``: 6 frames at 48×64 each, PIL's default
    JPEG quality (75), palette annotations with two objects, seeded with
    ``default_rng(0)``; ``ImageSets/2017/val.txt`` lists both."""
    rng = np.random.default_rng(0)
    for seq in ["toy-car", "toy-dog"]:
        os.makedirs(f"{root}/JPEGImages/480p/{seq}", exist_ok=True)
        os.makedirs(f"{root}/Annotations/480p/{seq}", exist_ok=True)
        for t in range(6):
            h, w = 48, 64
            img = (rng.random((h, w, 3)) * 255).astype(np.uint8)
            ann = np.zeros((h, w), dtype=np.uint8)
            cy, cx = 10 + 3 * t, 15 + 4 * t
            img[cy:cy + 14, cx:cx + 14] = [200, 60, 60]
            ann[cy:cy + 14, cx:cx + 14] = 1
            img[30:42, 5:20] = [60, 200, 60]
            ann[30:42, 5:20] = 2
            Image.fromarray(img).save(f"{root}/JPEGImages/480p/{seq}/{t:05d}.jpg")
            p = Image.fromarray(ann, mode="P")
            p.putpalette([0, 0, 0, 255, 0, 0, 0, 255, 0] + [0] * 759)
            p.save(f"{root}/Annotations/480p/{seq}/{t:05d}.png")
    os.makedirs(f"{root}/ImageSets/2017", exist_ok=True)
    with open(f"{root}/ImageSets/2017/val.txt", "w") as fp:
        fp.write("toy-car\ntoy-dog\n")
    return root


def ytbvos_sequences():
    return sorted(os.listdir(os.path.join(YTBVOS_DST, "JPEGImages", "480p")))
