"""Inference-time constant folding for AssessNet (BN + stem fusion).

Counterpart of ``ivosw_tpu/models/fold.py`` on torch state dicts, with the
same float32 maths:

    BN(conv(x)) = conv'(x) + bias'   with  k = gamma / sqrt(var + eps),
                                           conv' = conv · k (per out channel),
                                           bias' = beta - mu · k
    conv1((f - m)/s) = conv1''(f - m)  with  conv1'' = conv1 · (1/s) (per in channel)

The mean stays an input subtraction (the conv zero-pads its input, and the
standard path pads *normalised* zeros), so the stem (normalise → conv1 +
conv1_p → bn1) becomes one bias-carrying ``conv_stem`` over
``concat([crop_rgb - m, crop_prob])`` with weight
``concat([K1 · 1/s, Kp], in-channel axis) · k`` and bias ``beta - mu · k``.
"""

from __future__ import annotations

from typing import Dict

import torch

from ivosw_tpu_torch.models.resnet import BN_EPS, IMAGENET_STD, RESNET50_BLOCKS

StateDict = Dict[str, torch.Tensor]


def _fold_conv_bn(weight, sd: StateDict, bn: str):
    """Fold BN ``bn`` (affine + running stats) into an OIHW conv weight →
    (weight', bias') in float32."""
    gamma = sd[f"{bn}.weight"].float()
    beta = sd[f"{bn}.bias"].float()
    mu = sd[f"{bn}.running_mean"].float()
    var = sd[f"{bn}.running_var"].float()
    k = gamma / torch.sqrt(var + BN_EPS)
    return weight.float() * k[:, None, None, None], beta - mu * k


def fold_assess_variables(state_dict: StateDict) -> StateDict:
    """State dict of ``AssessNet(fold=False)`` → state dict of ``AssessNet(fold=True)``."""
    sd = state_dict
    out: StateDict = {}

    k1 = sd["conv1.weight"].float()  # [64, 3, 7, 7]
    kp = sd["conv1_p.weight"].float()  # [64, 1, 7, 7]
    inv_std = 1.0 / torch.tensor(IMAGENET_STD, dtype=torch.float32, device=k1.device)
    stem = torch.cat([k1 * inv_std[None, :, None, None], kp], dim=1)
    out["conv_stem.weight"], out["conv_stem.bias"] = _fold_conv_bn(stem, sd, "bn1")

    for idx, (_, blocks) in enumerate(RESNET50_BLOCKS):
        for i in range(blocks):
            p = f"trunk.res{idx + 2}.block{i}."
            pairs = [("conv1", "bn1"), ("conv2", "bn2"), ("conv3", "bn3")]
            if i == 0:
                pairs.append(("downsample_conv", "downsample_bn"))
            for conv, bn in pairs:
                w, b = _fold_conv_bn(sd[p + conv + ".weight"], sd, p + bn)
                out[p + conv + ".weight"], out[p + conv + ".bias"] = w, b

    out["fc1.weight"] = sd["fc1.weight"].float()
    out["fc1.bias"] = sd["fc1.bias"].float()
    return out
