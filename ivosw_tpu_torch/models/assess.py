"""AssessNet: per-frame, per-object mask-quality regressor, in torch.

Counterpart of ``ivosw_tpu/models/assess.py``: 256×256 ROI crops of
(image, prob map) → ResNet-50 trunk whose stem fuses a 1-channel prob conv
into conv1 (``x = conv1(f) + conv1_p(p)``) → global mean of r5 → FC
2048→1 in float32. :func:`assess_forward` is the training path: box,
crop (:func:`ivosw_tpu_torch.kernels.roi_crop.roi_crop_best`) and the
unfolded net with train-mode BatchNorm. :func:`score_clip` scores all T×O
(frame, object) pairs of a clip in one pass: the fused-box crop kernel
(:mod:`ivosw_tpu_torch.kernels.roi_crop`) writes bfloat16 NHWC crops, and
their NCHW permute is already a channels_last tensor for the convs.

``fold=True`` is the inference variant of
:func:`ivosw_tpu_torch.models.fold.fold_assess_variables`: one bias-carrying
4-channel ``conv_stem`` over ``concat([crop_rgb - mean, crop_prob])`` and
no BatchNorm. Public functions keep the JAX layouts: crops NHWC
``[B, 256, 256, C]``, frames ``[T, H, W, 3]``, probs ``[T, O, H, W]``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ivosw_tpu_torch.kernels.roi_crop import roi_crop_best, roi_crop_pairs_from_probs
from ivosw_tpu_torch.models.resnet import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    Conv,
    BatchNorm,
    ResNet50Trunk,
)
from ivosw_tpu_torch.ops.roi import mask_to_yxhw

ROI_SIZE = 256


class AssessNet(nn.Module):
    """Quality regressor over pre-cropped (image, prob) ROI pairs (NHWC).

    ``dtype`` is the compute type of the convs (bfloat16 on the scoring
    path, float32 for reference checks); parameters stay float32."""

    def __init__(self, dtype=torch.bfloat16, fold: bool = False):
        super().__init__()
        self.dtype = dtype
        self.fold = fold
        if fold:
            self.conv_stem = Conv(4, 64, 7, stride=2, padding=3, bias=True)
        else:
            self.conv1 = Conv(3, 64, 7, stride=2, padding=3, bias=False)
            self.conv1_p = Conv(1, 64, 7, stride=2, padding=3, bias=False)
            self.bn1 = BatchNorm(64)
        self.trunk = ResNet50Trunk(fold=fold)
        self.fc1 = nn.Linear(2048, 1)
        self.register_buffer(
            "mean", torch.tensor(IMAGENET_MEAN, dtype=torch.float32), persistent=False
        )
        self.register_buffer(
            "std", torch.tensor(IMAGENET_STD, dtype=torch.float32), persistent=False
        )

    def forward(self, tf_roi: torch.Tensor, tp_roi: torch.Tensor) -> torch.Tensor:
        """tf_roi [B, S, S, 3] in [0, 1], tp_roi [B, S, S, 1] → [B, 1] float32."""
        dt = self.dtype
        nchw = lambda x: x.permute(0, 3, 1, 2)  # NHWC storage = channels_last
        if self.fold:
            # the mean stays an input subtraction (exact at the zero-padded
            # border); 1/std and bn1 live in conv_stem's weight and bias
            fused = torch.cat([tf_roi.to(dt) - self.mean.to(dt), tp_roi.to(dt)], dim=-1)
            x = self.conv_stem(nchw(fused))
        else:
            f = ((tf_roi.float() - self.mean) / self.std).to(dt)
            x = self.conv1(nchw(f)) + self.conv1_p(nchw(tp_roi.to(dt)))
            x = self.bn1(x)
        r5, _, _, _ = self.trunk(F.relu(x))
        pooled = r5.mean(dim=(2, 3))  # mean in dt, then float32 for fc1, as the JAX package
        return self.fc1(pooled.float())


def init_assess_net(seed: int = 0, fold: bool = False, dtype=torch.bfloat16) -> AssessNet:
    """AssessNet with seeded random weights (CPU, float32 parameters).

    Convs He-normal (fan-out, as torchvision's ResNet), BatchNorm at its
    identity statistics, fc1 U(±1/√2048) — drawn in a fixed module order
    from ``torch.Generator().manual_seed(seed)``."""
    net = AssessNet(dtype=dtype, fold=fold)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for module in net.modules():
            if isinstance(module, Conv):
                fan_out = module.out_channels * module.kernel_size[0] * module.kernel_size[1]
                module.weight.normal_(0.0, math.sqrt(2.0 / fan_out), generator=g)
                if module.bias is not None:
                    module.bias.zero_()
        bound = 1.0 / math.sqrt(2048)
        net.fc1.weight.uniform_(-bound, bound, generator=g)
        net.fc1.bias.uniform_(-bound, bound, generator=g)
    return net.eval()


def assess_forward(
    net: AssessNet, tf: torch.Tensor, tp: torch.Tensor, train: bool = False
) -> torch.Tensor:
    """Full-frame forward of the training path (``ivosw_tpu/models/assess.py:124``).

    tf [B, H, W, 3] frames in [0, 1], tp [B, H, W] prob maps → [B, 1]
    float32 predictions. Boxes from ``tp > 0.5`` (1.5× context), one fused
    C=4 float32 crop of ``concat([tf, tp])`` through :func:`roi_crop_best`
    (the crop kernel on the card), then the unfolded net in its dtype. The
    net is put in train mode when ``train`` is true (batch statistics, and
    the BN running stats updated in place) and in eval mode otherwise."""
    boxes = mask_to_yxhw(tp > 0.5, scale=1.5)
    fused = torch.cat([tf, tp[..., None]], dim=-1).float()
    roi = roi_crop_best(fused, boxes, ROI_SIZE)
    net.train(train)
    return net(roi[..., :3], roi[..., 3:])


def _chunk_slices(t: int, chunk: int):
    """[start, end) frame slices covering t in steps of chunk."""
    return [(s, min(s + chunk, t)) for s in range(0, t, chunk)]


@torch.no_grad()
def score_clip(
    assess_net: AssessNet,
    frames: torch.Tensor,
    probs: torch.Tensor,
    obj_valid: torch.Tensor,
    chunk: int | None = None,
    obj_offset: int = 0,
) -> torch.Tensor:
    """Score every (frame, object) pair of a clip → [T, O] float32.

    frames [T, H, W, 3] float32; probs [T, P, H, W] float32 whose planes
    ``obj_offset .. obj_offset+O-1`` are the objects (O = len(obj_valid));
    obj_valid [O] 1/0 zeroes padded object slots. ``chunk`` < T crops and
    encodes chunk-frame slices one after the other; it mirrors the JAX
    package's signature and only tests pass it (the scoring path,
    ``predict_clip_quality``, chunks and pads the tail itself)."""
    t = probs.shape[0]
    if chunk and t > chunk:
        return torch.cat([
            _score_clip_body(assess_net, frames[s:e], probs[s:e], obj_valid, obj_offset)
            for s, e in _chunk_slices(t, chunk)
        ], dim=0)
    return _score_clip_body(assess_net, frames, probs, obj_valid, obj_offset)


def _score_clip_body(assess_net, frames, probs, obj_valid, obj_offset):
    t, o = probs.shape[0], obj_valid.shape[0]
    tf_roi, tp_roi = roi_crop_pairs_from_probs(
        frames, probs, ROI_SIZE, dtype=assess_net.dtype,
        obj_offset=obj_offset, num_objects=o,
    )
    q = assess_net(tf_roi, tp_roi)
    return q.reshape(t, o) * obj_valid[None, :]


def score_clip_folded(
    assess_net: AssessNet,
    frames: torch.Tensor,
    probs: torch.Tensor,
    obj_valid: torch.Tensor,
    chunk: int | None = None,
    obj_offset: int = 0,
) -> torch.Tensor:
    """:func:`score_clip` on a BN-folded AssessNet (``fold=True``)."""
    if not assess_net.fold:
        raise ValueError("score_clip_folded needs AssessNet(fold=True)")
    return score_clip(assess_net, frames, probs, obj_valid, chunk, obj_offset)


def mean_object_quality(scores: torch.Tensor, obj_valid: torch.Tensor) -> torch.Tensor:
    """Mean over valid objects → per-frame predicted quality [T]."""
    denom = torch.clamp_min(obj_valid.sum(), 1.0)
    return (scores * obj_valid[None, :]).sum(dim=1) / denom
