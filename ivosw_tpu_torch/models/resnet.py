"""ResNet-50 trunk in torch (NCHW tensors, channels_last memory).

Counterpart of ``ivosw_tpu/models/resnet.py``: the same torchvision-style
bottlenecks (stride on ``conv2``, BN ε = 1e-5), the padded 3×3/2 max-pool
(``MaxPool2d(3, 2, 1)``, -inf padding as flax's ``max_pool``), and the
``fold=True`` inference variant whose convs carry biases and whose BNs are
gone. Modules are named after the JAX parameter tree (``res2.block0.conv1``
…) so the weight converter is a layout change only.

Parameters stay float32; a conv runs in the dtype of its input (its weight
and bias are cast on the fly, as flax casts float32 params to ``dtype``)
and a BatchNorm computes in float32 and returns the input's dtype, as
flax's BatchNorm with ``dtype=bfloat16`` does, in inference and in training
(:class:`BatchNorm`).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-5
BN_MOMENTUM = 0.9  # flax momentum 0.9 ≡ torch momentum 0.1
RESNET50_BLOCKS: Sequence[Tuple[int, int]] = ((64, 3), (128, 4), (256, 6), (512, 3))
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


class Conv(nn.Conv2d):
    """Conv2d whose float32 parameters are cast to the input's dtype.

    The bias is added after the convolution's output is rounded to that
    dtype, as flax's ``nn.Conv`` does: a bias fused into the accumulator
    would round once where the JAX package rounds twice, and in bfloat16
    that difference, repeated over 53 layers, moves the scores."""

    def forward(self, x):
        y = F.conv2d(x, self.weight.to(x.dtype), None, self.stride, self.padding)
        if self.bias is not None:
            y = y + self.bias.to(x.dtype)[None, :, None, None]
        return y


class BatchNorm(nn.Module):
    """BatchNorm with flax's semantics. Parameters/buffers named as
    ``nn.BatchNorm2d``'s.

    Inference (``eval()``): the running statistics, in float32, output in
    the input's dtype. Training (``train()``), as flax's ``nn.BatchNorm``
    with ``use_running_average=False`` (``normalization.py::_compute_stats``):
    the batch mean and the variance ``E[x²] − E[x]²`` clipped at 0, both in
    float32 over N·H·W whatever the input's dtype; the output normalised
    with that biased variance; the running stats updated in place as
    ``ra = m·ra + (1 − m)·batch`` with m = :data:`BN_MOMENTUM` and the
    biased variance (``F.batch_norm`` would store the unbiased one)."""

    def __init__(self, channels: int, eps: float = BN_EPS):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x):
        xf = x.float()
        if self.training:
            mean = xf.mean(dim=(0, 2, 3))
            var = torch.clamp_min((xf * xf).mean(dim=(0, 2, 3)) - mean * mean, 0.0)
            with torch.no_grad():
                self.running_mean.mul_(BN_MOMENTUM).add_((1.0 - BN_MOMENTUM) * mean)
                self.running_var.mul_(BN_MOMENTUM).add_((1.0 - BN_MOMENTUM) * var)
        else:
            mean, var = self.running_mean, self.running_var
        # flax's op order: (x - mean) * (rsqrt(var + eps) * scale) + bias
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean[None, :, None, None]) * mul[None, :, None, None]
        return (y + self.bias[None, :, None, None]).to(x.dtype)


class Bottleneck(nn.Module):
    def __init__(self, in_ch: int, features: int, strides: int = 1,
                 downsample: bool = False, fold: bool = False):
        super().__init__()
        self.fold = fold
        out_ch = features * 4

        def conv(cin, cout, k, s):
            return Conv(cin, cout, k, stride=s, padding=k // 2, bias=fold)

        self.conv1 = conv(in_ch, features, 1, 1)
        self.conv2 = conv(features, features, 3, strides)
        self.conv3 = conv(features, out_ch, 1, 1)
        self.downsample_conv = conv(in_ch, out_ch, 1, strides) if downsample else None
        if not fold:
            self.bn1 = BatchNorm(features)
            self.bn2 = BatchNorm(features)
            self.bn3 = BatchNorm(out_ch)
            self.downsample_bn = BatchNorm(out_ch) if downsample else None

    def _bn(self, name, y):
        return y if self.fold else getattr(self, name)(y)

    def forward(self, x):
        residual = x
        y = F.relu(self._bn("bn1", self.conv1(x)))
        y = F.relu(self._bn("bn2", self.conv2(y)))
        y = self._bn("bn3", self.conv3(y))
        if self.downsample_conv is not None:
            residual = self._bn("downsample_bn", self.downsample_conv(x))
        return F.relu(y + residual)


class ResStage(nn.Module):
    def __init__(self, in_ch: int, features: int, num_blocks: int, strides: int,
                 fold: bool = False):
        super().__init__()
        self.num_blocks = num_blocks
        for i in range(num_blocks):
            self.add_module(f"block{i}", Bottleneck(
                in_ch if i == 0 else features * 4, features,
                strides=strides if i == 0 else 1, downsample=(i == 0), fold=fold,
            ))

    def forward(self, x):
        for i in range(self.num_blocks):
            x = getattr(self, f"block{i}")(x)
        return x


class ResNet50Trunk(nn.Module):
    """res2..res5 stages of ResNet-50 behind the padded max-pool (the stem
    belongs to the caller). Input [B, 64, H, W]; returns (r5, r4, r3, r2)."""

    def __init__(self, fold: bool = False):
        super().__init__()
        in_ch = 64
        for idx, (width, blocks) in enumerate(RESNET50_BLOCKS):
            self.add_module(f"res{idx + 2}", ResStage(
                in_ch, width, blocks, strides=1 if idx == 0 else 2, fold=fold
            ))
            in_ch = width * 4

    def forward(self, c1):
        x = F.max_pool2d(c1, 3, stride=2, padding=1)
        feats = []
        for idx in range(len(RESNET50_BLOCKS)):
            x = getattr(self, f"res{idx + 2}")(x)
            feats.append(x)
        r2, r3, r4, r5 = feats
        return r5, r4, r3, r2
