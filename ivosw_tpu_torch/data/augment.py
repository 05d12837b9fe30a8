"""QA training augmentations on the host, in numpy (no cv2).

Counterpart of ``ivosw_tpu/data/augment.py`` with the same transforms and
the same draws from the same ``numpy`` generator, in the same order:
Resize → RandomAffine (crop 0–10 %, scale 0.9–1.1, shear ±15°, rotate ±25°,
retried ≤ 10× until every object label survives) → AdditiveNoise (±5/255)
→ RandomContrast (×[0.97, 1.03]) → RandomHorizontalFlip.

What the JAX package leaves to cv2 is written out here:

- ``cv2.getRotationMatrix2D``: α = s·cos θ, β = s·sin θ (θ in degrees);
- ``cv2.warpAffine`` with the forward 2×3 matrix: each output pixel maps
  back through the inverted matrix (``cv2.invertAffineTransform``'s
  formula, in float64); bilinear with a zero border for the image and the
  prob map, and ``floor(src + 0.5)`` nearest for the label, zero outside;
- ``cv2.resize``: half-pixel bilinear for float images, nearest
  ``floor(dst · src/dst)`` for labels, and the identity when the size
  already matches (the case on the training path).

cv2 rounds the back-mapped coordinates to float32, the port keeps them in
float64: a nearest label whose coordinate lies within a few 1e-6 of a .5
tie can take the other neighbour (ROADMAP §3), and the bilinear values
differ by about 1e-5 at 48×64.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np


def _resize_linear(img: np.ndarray, w: int, h: int) -> np.ndarray:
    """cv2.INTER_LINEAR resize of a float [H, W(, C)] image: half-pixel
    centres, edge taps clamped (replicated)."""

    def taps(dst, src):
        f = (np.arange(dst, dtype=np.float64) + 0.5) * (src / dst) - 0.5
        i0 = np.floor(f).astype(np.int64)
        a = (f - i0).astype(np.float32)
        a = np.where(i0 < 0, 0.0, a).astype(np.float32)
        i0 = np.clip(i0, 0, src - 1)
        a = np.where(i0 >= src - 1, 0.0, a).astype(np.float32)
        return i0, np.minimum(i0 + 1, src - 1), a

    x0, x1, ax = taps(w, img.shape[1])
    y0, y1, ay = taps(h, img.shape[0])
    ex = (slice(None),) + (None,) * (img.ndim - 2)
    rows = img[:, x0] * (1.0 - ax)[ex] + img[:, x1] * ax[ex]  # horizontal pass
    ey = (slice(None), None) + (None,) * (img.ndim - 2)
    out = rows[y0] * (1.0 - ay)[ey] + rows[y1] * ay[ey]
    return out.astype(img.dtype)


def _resize_nearest(img: np.ndarray, w: int, h: int) -> np.ndarray:
    ys = np.minimum(np.floor(np.arange(h) * (img.shape[0] / h)).astype(np.int64), img.shape[0] - 1)
    xs = np.minimum(np.floor(np.arange(w) * (img.shape[1] / w)).astype(np.int64), img.shape[1] - 1)
    return img[ys][:, xs]


def resize_sample(sample: Dict[str, np.ndarray], size_wh=(854, 480)) -> Dict:
    w, h = size_wh
    if sample["label"].shape[:2] == (h, w):
        return dict(sample)
    out = dict(sample)
    out["img"] = _resize_linear(sample["img"], w, h)
    out["prob"] = _resize_linear(sample["prob"], w, h)
    out["label"] = _resize_nearest(sample["label"], w, h)
    return out


def _rotation_matrix(cx, cy, angle_deg, scale) -> np.ndarray:
    """``cv2.getRotationMatrix2D((cx, cy), angle, scale)`` → 2×3 float64."""
    theta = angle_deg * (np.pi / 180.0)
    alpha = np.cos(theta) * scale
    beta = np.sin(theta) * scale
    return np.array(
        [
            [alpha, beta, (1.0 - alpha) * cx - beta * cy],
            [-beta, alpha, beta * cx + (1.0 - alpha) * cy],
        ]
    )


def _affine_matrix(h, w, rng, crop_frac, scale_rng, shear_deg, rot_deg):
    """Compose crop+scale+shear+rotate about the image centre → 2×3 matrix."""
    cy, cx = h / 2.0, w / 2.0
    angle = rng.uniform(-rot_deg, rot_deg)
    scale = rng.uniform(*scale_rng)
    shear = np.deg2rad(rng.uniform(-shear_deg, shear_deg))

    m_rot3 = np.vstack([_rotation_matrix(cx, cy, angle, scale), [0, 0, 1]])
    m_shear3 = np.array(
        [[1, np.tan(shear), -cy * np.tan(shear)], [0, 1, 0], [0, 0, 1]]
    )
    # crop: shift + zoom-in by up to crop_frac on each side
    cl = rng.uniform(0, crop_frac) * w
    cr = rng.uniform(0, crop_frac) * w
    ct = rng.uniform(0, crop_frac) * h
    cb = rng.uniform(0, crop_frac) * h
    sx = w / max(w - cl - cr, 1.0)
    sy = h / max(h - ct - cb, 1.0)
    m_crop3 = np.array([[sx, 0, -sx * cl], [0, sy, -sy * ct], [0, 0, 1]])
    m = m_crop3 @ m_shear3 @ m_rot3
    return m[:2]


def _source_coords(m: np.ndarray, h: int, w: int):
    """Source (x, y) of every output pixel: the inverse of the forward
    matrix ``m``, by ``cv2.invertAffineTransform``'s formula, in float64."""
    det = m[0, 0] * m[1, 1] - m[0, 1] * m[1, 0]
    d = 1.0 / det if det != 0 else 0.0
    a11, a22 = m[1, 1] * d, m[0, 0] * d
    a12, a21 = -m[0, 1] * d, -m[1, 0] * d
    b1 = -a11 * m[0, 2] - a12 * m[1, 2]
    b2 = -a21 * m[0, 2] - a22 * m[1, 2]
    yy, xx = np.mgrid[:h, :w].astype(np.float64)
    return a11 * xx + a12 * yy + b1, a21 * xx + a22 * yy + b2


def _gather(src: np.ndarray, xi: np.ndarray, yi: np.ndarray) -> np.ndarray:
    """src[yi, xi] with zeros where (xi, yi) lies outside the image."""
    h, w = src.shape[:2]
    inside = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
    out = src[np.clip(yi, 0, h - 1), np.clip(xi, 0, w - 1)]
    mask = inside if src.ndim == 2 else inside[..., None]
    return np.where(mask, out, 0).astype(src.dtype)


def _warp_nearest(src: np.ndarray, m: np.ndarray) -> np.ndarray:
    sx, sy = _source_coords(m, *src.shape[:2])
    return _gather(src, np.floor(sx + 0.5).astype(np.int64), np.floor(sy + 0.5).astype(np.int64))


def _warp_linear(src: np.ndarray, m: np.ndarray) -> np.ndarray:
    sx, sy = _source_coords(m, *src.shape[:2])
    x0, y0 = np.floor(sx), np.floor(sy)
    ax, ay = sx - x0, sy - y0
    x0, y0 = x0.astype(np.int64), y0.astype(np.int64)
    out = np.zeros(src.shape, dtype=np.float64)
    for dy, wy in ((0, 1.0 - ay), (1, ay)):
        for dx, wx in ((0, 1.0 - ax), (1, ax)):
            wgt = wy * wx
            if src.ndim == 3:
                wgt = wgt[..., None]
            out += wgt * _gather(src, x0 + dx, y0 + dy)
    return out.astype(src.dtype)


def random_affine(
    sample: Dict[str, np.ndarray],
    rng: np.random.Generator,
    crop_frac: float = 0.10,
    scale_rng=(0.9, 1.1),
    shear_deg: float = 15.0,
    rot_deg: float = 25.0,
    max_tries: int = 10,
) -> Dict:
    """One shared affine for img/prob/label; retried until every label id
    present before the transform is still present after."""
    h, w = sample["label"].shape[:2]
    wanted = set(np.unique(sample["label"])) - {0}
    for _ in range(max_tries):
        m = _affine_matrix(h, w, rng, crop_frac, scale_rng, shear_deg, rot_deg)
        new_label = _warp_nearest(sample["label"], m)
        if wanted.issubset(set(np.unique(new_label))):
            out = dict(sample)
            out["img"] = _warp_linear(sample["img"], m)
            out["prob"] = _warp_linear(sample["prob"], m)
            out["label"] = new_label
            return out
    return dict(sample)  # give up, keep the original


def additive_noise(sample: Dict, rng: np.random.Generator, magnitude=5.0 / 255.0) -> Dict:
    out = dict(sample)
    noise = rng.uniform(-magnitude, magnitude)
    out["img"] = np.clip(sample["img"] + noise, 0.0, 1.0).astype(np.float32)
    return out


def random_contrast(sample: Dict, rng: np.random.Generator, lo=0.97, hi=1.03) -> Dict:
    out = dict(sample)
    out["img"] = np.clip(sample["img"] * rng.uniform(lo, hi), 0.0, 1.0).astype(
        np.float32
    )
    return out


def random_hflip(sample: Dict, rng: np.random.Generator, p: float = 0.5) -> Dict:
    if rng.random() >= p:
        return sample
    out = dict(sample)
    for k in ("img", "prob", "label"):
        out[k] = np.ascontiguousarray(sample[k][:, ::-1])
    return out


@dataclass
class QAAugmentPipeline:
    """The five QA transforms in order; deterministic per seed."""

    size_wh: tuple = (854, 480)
    seed: int = 0
    enable_resize: bool = True

    def __post_init__(self):
        self.rng = np.random.default_rng(self.seed)

    def __call__(self, sample: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        if self.enable_resize:
            sample = resize_sample(sample, self.size_wh)
        sample = random_affine(sample, self.rng)
        sample = additive_noise(sample, self.rng)
        sample = random_contrast(sample, self.rng)
        sample = random_hflip(sample, self.rng)
        return sample
