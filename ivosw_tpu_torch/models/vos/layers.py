"""Building blocks of the VOS backbones, in torch.

Counterpart of ``ivosw_tpu/models/vos/layers.py``. Modules take NCHW
tensors (the JAX package's are NHWC); parameters stay float32 and a block
computes in its ``dtype`` (bfloat16 on the backbones' path), as flax casts
its float32 params to ``dtype``. Submodules carry the flax tree's names
(``ConvBlock_0``, ``GroupNorm_0`` …) so the weight converter
(:func:`ivosw_tpu_torch.utils.convert.tapnet_state_dict_from_numpy`) is a
layout change only.

Numerics kept from flax and ``jax.image``:

- :class:`GroupNorm`: ε = 1e-6 (flax's default; torch's is 1e-5). The
  statistics are E[x] and E[x²] − E[x]² clipped at 0, in float32 over each
  group; the output ``(x − mean)·(rsqrt(var + ε)·scale) + bias`` is formed
  in float32 and cast to the block's dtype.
- :func:`resize_bilinear`: ``jax.image.resize(..., "bilinear")`` as dense
  per-axis weight matrices — half-pixel centres, a triangle kernel
  widened by the scale when downsampling (antialiasing), each output's
  weights normalised to sum 1, outputs whose centre falls outside the input
  zeroed; an axis whose size does not change is left alone. The matrices
  are cast to the input's dtype and the two contractions accumulate in
  float32 and round to that dtype, in the order XLA's einsum of bfloat16
  operands takes.
- The decoder's last conv runs in float32 on the float32 cast of its input.
- :func:`global_match_readout`: bfloat16 operands, float32 logits
  (``preferred_element_type=float32``), float32 softmax, bfloat16 weights.
"""

from __future__ import annotations

import math
import os
from functools import lru_cache
from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ivosw_tpu_torch.models import resnet

GN_EPS = 1e-6


class Conv(resnet.Conv):
    """:class:`ivosw_tpu_torch.models.resnet.Conv` (float32 params cast to
    the input's dtype, bias added after the rounding). A bfloat16 conv on
    the CPU is one float32 convolution of the rounded operands, rounded
    once: what cuDNN's bfloat16 convolution and XLA's compute, where
    oneDNN's bfloat16 kernel rounds elsewhere."""

    def forward(self, x):
        if x.dtype != torch.bfloat16 or x.device.type != "cpu":
            return super().forward(x)
        w = self.weight.to(x.dtype).float()
        y = F.conv2d(x.float(), w, None, self.stride, self.padding).to(x.dtype)
        if self.bias is not None:
            y = y + self.bias.to(x.dtype)[None, :, None, None]
        return y


class GroupNorm(nn.Module):
    """flax ``nn.GroupNorm`` (``weight`` = flax ``scale``) on NCHW input."""

    def __init__(self, num_groups: int, channels: int, eps: float = GN_EPS):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x, dtype):
        n, c, h, w = x.shape
        g = self.num_groups
        xf = x.float().reshape(n, g, c // g, h, w)
        mean = xf.mean(dim=(2, 3, 4), keepdim=True)
        var = torch.clamp_min((xf * xf).mean(dim=(2, 3, 4), keepdim=True) - mean * mean, 0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight.reshape(1, g, c // g, 1, 1)
        y = (xf - mean) * mul + self.bias.reshape(1, g, c // g, 1, 1)
        return y.reshape(n, c, h, w).to(dtype)


class ConvBlock(nn.Module):
    """conv (no bias, 'same' padding k//2) → GroupNorm(min(32, C)) → ReLU."""

    def __init__(self, in_ch: int, features: int, kernel: int = 3, strides: int = 1,
                 dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.Conv_0 = Conv(in_ch, features, kernel, stride=strides, padding=kernel // 2,
                           bias=False)
        self.GroupNorm_0 = GroupNorm(min(32, features), features)

    def forward(self, x):
        return F.relu(self.GroupNorm_0(self.Conv_0(x.to(self.dtype)), self.dtype))


class ResBlock(nn.Module):
    def __init__(self, in_ch: int, features: int, strides: int = 1, dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.ConvBlock_0 = ConvBlock(in_ch, features, 3, strides, dtype)
        self.Conv_0 = Conv(features, features, 3, padding=1, bias=False)
        self.GroupNorm_0 = GroupNorm(min(32, features), features)
        # flax names the projection Conv_1: it is created after Conv_0
        self.Conv_1 = (
            Conv(in_ch, features, 1, stride=strides, bias=False)
            if in_ch != features or strides != 1 else None
        )

    def forward(self, x):
        y = self.GroupNorm_0(self.Conv_0(self.ConvBlock_0(x)), self.dtype)
        # an identity residual keeps the input's dtype, so a float32 input
        # makes a float32 sum, as in flax
        residual = x if self.Conv_1 is None else self.Conv_1(x.to(self.dtype))
        return F.relu(y + residual)


class VOSEncoder(nn.Module):
    """4-stage encoder: stem /2 → r2 /4 → r3 /8 → r4 /16; returns (r4, r3, r2)."""

    def __init__(self, in_ch: int, widths: Sequence[int] = (32, 64, 128, 256),
                 dtype=torch.bfloat16):
        super().__init__()
        w = widths
        self.ConvBlock_0 = ConvBlock(in_ch, w[0], 7, 2, dtype)
        self.ResBlock_0 = ResBlock(w[0], w[1], 2, dtype)
        self.ResBlock_1 = ResBlock(w[1], w[1], 1, dtype)
        self.ResBlock_2 = ResBlock(w[1], w[2], 2, dtype)
        self.ResBlock_3 = ResBlock(w[2], w[2], 1, dtype)
        self.ResBlock_4 = ResBlock(w[2], w[3], 2, dtype)
        self.ResBlock_5 = ResBlock(w[3], w[3], 1, dtype)

    def forward(self, x):
        x = self.ResBlock_0(self.ConvBlock_0(x))
        r2 = self.ResBlock_1(x)
        r3 = self.ResBlock_3(self.ResBlock_2(r2))
        r4 = self.ResBlock_5(self.ResBlock_4(r3))
        return r4, r3, r2


class VOSDecoder(nn.Module):
    """Refinement decoder: r4 (+ skips r3, r2) → float32 logits [N, H, W]."""

    def __init__(self, r4_ch: int, r3_ch: int, r2_ch: int, mid: int = 128,
                 dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.ConvBlock_0 = ConvBlock(r4_ch, mid, 3, 1, dtype)
        self.ConvBlock_1 = ConvBlock(mid + r3_ch, mid, 3, 1, dtype)
        self.ConvBlock_2 = ConvBlock(mid + r2_ch, mid // 2, 3, 1, dtype)
        self.Conv_0 = Conv(mid // 2, 1, 3, padding=1, bias=True)  # float32

    def forward(self, r4, r3, r2, out_hw: Tuple[int, int]):
        dt = self.dtype
        x = self.ConvBlock_0(r4)
        x = resize_like(x, r3)
        x = self.ConvBlock_1(torch.cat([x, r3.to(dt)], dim=1))
        x = resize_like(x, r2)
        x = self.ConvBlock_2(torch.cat([x, r2.to(dt)], dim=1))
        logit = self.Conv_0(x.float())
        return resize_bilinear(logit, out_hw)[:, 0]


@lru_cache(maxsize=64)
def _weight_matrix_np(in_size: int, out_size: int) -> np.ndarray:
    """[out, in] float32 resize weights: ``jax.image``'s ``compute_weight_mat``
    (triangle kernel, antialiased) in its float32 op order, transposed. The
    sample position ``(i + 0.5)·inv_scale − 0.5`` rounds once, as XLA
    contracts it into one multiply-add; the weights then agree with the JAX
    package's to one float32 ulp (the order of the normalising sum)."""
    scale = out_size / in_size  # a Python float, as jax.image.resize passes it
    inv_scale = np.float32(1.0 / scale)
    kernel_scale = np.maximum(inv_scale, np.float32(1.0))
    centres = np.arange(out_size, dtype=np.float64) + 0.5
    sample_f = (centres * np.float64(inv_scale) - 0.5).astype(np.float32)
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=np.float32)[:, None]) / kernel_scale
    weights = np.maximum(np.float32(0.0), np.float32(1.0) - x)
    total = weights.sum(axis=0, keepdims=True, dtype=np.float32)
    eps = np.float32(1000.0 * np.finfo(np.float32).eps)
    weights = np.where(np.abs(total) > eps, weights / np.where(total != 0, total, 1), 0)
    inside = (sample_f >= -0.5) & (sample_f <= np.float32(in_size) - np.float32(0.5))
    return np.ascontiguousarray(np.where(inside[None, :], weights, 0).astype(np.float32).T)


def resize_bilinear(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """``jax.image.resize(x, ..., "bilinear")`` over the last two axes of
    ``x`` ([..., H, W]) → [..., h, w] in x's dtype (see the module notes).

    The two contractions go in the order with fewer multiply-adds (columns
    first on a tie), the order XLA's einsum picks; in bfloat16 the
    intermediate's rounding makes the order visible."""
    h_in, w_in = x.shape[-2:]
    h_out, w_out = int(out_hw[0]), int(out_hw[1])
    dt = x.dtype

    def mat(n_in, n_out):
        w = torch.from_numpy(_weight_matrix_np(n_in, n_out)).to(x.device)
        return w.to(dt).float()

    def rows(y):
        return y if h_in == h_out else torch.matmul(mat(h_in, h_out), y.float()).to(dt)

    def cols(y):
        return y if w_in == w_out else torch.matmul(y.float(), mat(w_in, w_out).T).to(dt)

    rows_first = h_in * w_in * h_out + h_out * w_in * w_out
    cols_first = h_in * w_in * w_out + h_in * w_out * h_out
    if rows_first < cols_first:
        return cols(rows(x))
    return rows(cols(x))


def flax_style_init(net: nn.Module, seed: int) -> Dict[str, torch.Tensor]:
    """Seeded flax-style initial weights of a backbone (CPU float32 state
    dict): convs LeCun-normal (truncated at ±2σ, σ = √(1/fan_in)/0.8796, as
    ``flax.linen.initializers.lecun_normal``), conv biases 0, GroupNorm
    scale 1 and bias 0; drawn in module order from
    ``torch.Generator().manual_seed(seed)``. The numbers differ from the
    JAX package's draw from the same seed."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for module in net.modules():
            if isinstance(module, Conv):
                fan_in = module.in_channels * module.kernel_size[0] * module.kernel_size[1]
                std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                nn.init.trunc_normal_(module.weight, 0.0, std, -2.0 * std, 2.0 * std, generator=g)
                if module.bias is not None:
                    module.bias.zero_()
            elif isinstance(module, GroupNorm):
                module.weight.fill_(1.0)
                module.bias.zero_()
    return net.state_dict()


def backbone_weights(net: nn.Module, ckpt_dir, filename: str, seed: int) -> nn.Module:
    """``net`` with the state dict ``{ckpt_dir}/{filename}`` when that file
    exists, else with :func:`flax_style_init` ``(net, seed)``."""
    path = os.path.join(ckpt_dir, filename) if ckpt_dir else None
    if path and os.path.exists(path):
        state = torch.load(path, map_location="cpu", weights_only=True)
    else:
        state = flax_style_init(net, seed)
    net.load_state_dict(state)
    return net


def encode_clip(encoder: nn.Module, frames, chunk: int, device):
    """frames [T, H, W, 3] (host array or tensor) → (float32 NCHW frames on
    ``device``, (r4, r3, r2) of every frame, encoded ``chunk`` frames at a
    time). The JAX package zero-pads the last chunk; GroupNorm works per
    sample, so encoding the remainder alone gives the same features."""
    frames = torch.as_tensor(frames, dtype=torch.float32, device=device)
    frames = frames.permute(0, 3, 1, 2).contiguous()
    parts = [encoder(frames[s:s + chunk]) for s in range(0, frames.shape[0], chunk)]
    return frames, tuple(torch.cat([p[i] for p in parts]) for i in range(3))


def resize_like(x: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    return resize_bilinear(x, ref.shape[-2:])


def labels_and_probs(prob_maps: torch.Tensor, dtype=torch.float32):
    """[T, O, H, W] float32 foreground probs → (labels [T, H, W] uint8 on the
    same device, all_P [T, O+1, H, W] in ``dtype`` with background plane 0).

    The labels come from the float32 maps before the cast to ``dtype``; an
    argmax tie takes the first object."""
    fg_max = prob_maps.amax(dim=1)
    labels = torch.where(fg_max > 0.5, prob_maps.argmax(dim=1) + 1, 0).to(torch.uint8)
    bg = torch.clamp(1.0 - fg_max, 0.0, 1.0)[:, None]
    return labels, torch.cat([bg, prob_maps], dim=1).to(dtype)


def global_match_readout(query, memory_keys, memory_values, valid, dtype=torch.bfloat16):
    """Attention readout of memory features: query [N, P, C], memory
    keys/values [N, M, C], valid [N, M] 1/0 → [N, P, C] in ``dtype``.

    Operands are rounded to ``dtype`` and contracted in float32; logits are
    scaled by 1/√C, masked with −1e9 where invalid, and softmaxed in float32;
    the weights are rounded to ``dtype`` for the second contraction."""
    q = query.to(dtype).float()
    k = memory_keys.to(dtype).float()
    v = memory_values.to(dtype).float()
    c = torch.tensor(float(q.shape[-1]), dtype=torch.float32, device=q.device)
    scale = 1.0 / torch.sqrt(c)
    logits = torch.matmul(q, k.transpose(1, 2)) * scale
    logits = torch.where(valid[:, None, :] > 0, logits, torch.full_like(logits, -1e9))
    attn = torch.softmax(logits, dim=-1).to(dtype).float()
    return torch.matmul(attn, v).to(dtype)
