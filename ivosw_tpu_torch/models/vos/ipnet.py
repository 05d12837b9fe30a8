"""IPNet: interaction-and-propagation VOS backbone (IPN family), in torch.

Counterpart of ``ivosw_tpu/models/vos/ipnet.py``. An interaction network
segments the annotated frame from the image, positive and negative
scribbles and the previous round's mask; a propagation network carries the
mask frame by frame, conditioned on the annotated frame through a masked
mean of its /16 features (one vector per object). Each round's result is
fused with the previous round's by :func:`get_weight`'s linear ramp between
annotated frames.

On the device of the adapter, for the whole sequence: the frames, their
features (encoded once per sequence, in chunks), the probability maps and
the ``all_P`` handed to the QA pass (in ``qa_dtype``). The JAX package's
``lax.scan`` round is a loop over :func:`prop_order` (backward then
forward): the carry restarts from the annotated frame's probabilities at
the seam, and an invalid step keeps the previous round's map.

Modules take NCHW tensors and compute in bfloat16 (parameters float32),
with the JAX package's rounding points (:mod:`.layers`). ``IPNet``'s
submodules carry the flax tree's names, so the flax params convert by a
layout change (:func:`ivosw_tpu_torch.utils.convert.ipnet_state_dict_from_numpy`).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ivosw_tpu_torch.data.scribbles import scribble_masks_per_object
from ivosw_tpu_torch.device import resolve_device
from ivosw_tpu_torch.models.vos.layers import (
    ConvBlock,
    VOSDecoder,
    VOSEncoder,
    backbone_weights,
    encode_clip,
    flax_style_init,
    labels_and_probs,
    resize_bilinear,
)
from ivosw_tpu_torch.models.vos.tapnet import prop_order

IPNET_CKPT = "ipnet.pt"


def get_weight(t: int, annotated_prev: np.ndarray, annotated_now: int) -> np.ndarray:
    """Linear distance fusion weights (reference utils/utils_ipn.py:37-72).

    1 at the new annotation, falling linearly to 0 at the nearest OTHER
    annotated frame on each side; 1 beyond the extremes (no older annotation
    to defer to)."""
    w = np.ones(t, dtype=np.float32)
    idx = np.arange(t)
    lower = annotated_prev[annotated_prev < annotated_now]
    if len(lower) > 0:
        closest = int(lower.max())
        span = max(annotated_now - closest, 1)
        ramp = (idx - closest) / span
        w = np.where((idx >= closest) & (idx < annotated_now), ramp, w)
        w = np.where(idx < closest, 0.0, w)  # defer fully to older rounds
    upper = annotated_prev[annotated_prev > annotated_now]
    if len(upper) > 0:
        closest = int(upper.min())
        span = max(closest - annotated_now, 1)
        ramp = (closest - idx) / span
        w = np.where((idx > annotated_now) & (idx <= closest), ramp, w)
        w = np.where(idx > closest, 0.0, w)
    w[annotated_now] = 1.0
    return np.clip(w, 0.0, 1.0)


# ------------------------------------------------------------------ model --
class InteractionNet(nn.Module):
    """(image ⊕ positive, negative, previous mask) → mask logit."""

    def __init__(self, dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.int_enc = VOSEncoder(6, dtype=dtype)
        self.int_dec = VOSDecoder(256, 128, 64, dtype=dtype)

    def forward(self, img, pos, neg, prev_mask):
        """img [O, 3, H, W]; pos, neg, prev_mask [O, H, W] → float32 logit
        [O, H, W]."""
        x = torch.cat([img, pos[:, None], neg[:, None], prev_mask[:, None]], dim=1)
        r4, r3, r2 = self.int_enc(x.to(self.dtype))
        return self.int_dec(r4, r3, r2, img.shape[-2:])


class PropagationNet(nn.Module):
    """Frame features + the reference vector + the carried mask → logit."""

    def __init__(self, dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.p1 = ConvBlock(256 + 256 + 1, 256, 3, 1, dtype)
        self.p2 = ConvBlock(256, 256, 3, 1, dtype)
        self.prop_dec = VOSDecoder(256, 128, 64, dtype=dtype)

    def forward(self, r4c, r3c, r2c, ref_vec, prev_prob, out_hw):
        """r4c [O, C, h16, w16] (r3c, r2c likewise), ref_vec [O, C] float32,
        prev_prob [O, H, W] float32 → logit [O, H, W]."""
        dt = self.dtype
        o, c, h16, w16 = r4c.shape
        prev16 = resize_bilinear(prev_prob, (h16, w16))
        cond = ref_vec[:, :, None, None].expand(o, c, h16, w16)
        x = torch.cat([r4c.to(dt), cond.to(dt), prev16[:, None].to(dt)], dim=1)
        x = self.p2(self.p1(x))
        return self.prop_dec(x, r3c, r2c, out_hw)


class IPNet(nn.Module):
    def __init__(self, dtype=torch.bfloat16):
        super().__init__()
        self.frame_enc = VOSEncoder(3, dtype=dtype)
        self.interaction = InteractionNet(dtype)
        self.propagation = PropagationNet(dtype)


def init_ipnet_params(seed: int = 0) -> Dict[str, torch.Tensor]:
    """Seeded initial weights of :class:`IPNet`
    (:func:`~ivosw_tpu_torch.models.vos.layers.flax_style_init`)."""
    return flax_style_init(IPNet(), seed)


def ref_vector(r4a: torch.Tensor, anno_prob: torch.Tensor) -> torch.Tensor:
    """Masked global-average conditioning vector per object, in float32:
    r4a [C, h16, w16], anno_prob [O, H, W] → [O, C]; the mask is the
    probabilities resized to /16, the denominator its sum clamped at 1e-3."""
    m = resize_bilinear(anno_prob, r4a.shape[-2:])[:, None]  # [O, 1, h16, w16]
    num = (r4a[None].float() * m).sum(dim=(2, 3))
    den = torch.clamp_min(m.sum(dim=(2, 3)), 1e-3)
    return num / den


# ----------------------------------------------------------------- state --
@dataclass
class _IPState:
    feats: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]  # r4/r3/r2 [T, C, h, w]
    num_objects: int
    hw: Tuple[int, int]
    prob_maps: torch.Tensor  # [T, O, H, W] float32, previous round's
    frame_cache: torch.Tensor  # [T, 3, H, W] float32 frames (interaction input)
    annotated: List[int] = field(default_factory=list)
    round: int = 0


class IPNetAdapter:
    """VOS adapter around IPNet (``begin_sequence`` / ``segment``).

    ``qa_dtype`` is the storage type of the returned ``all_P``
    (``cfg.assess_net.bf16_inputs``); labels are computed before the cast."""

    name = "ipnet"

    def __init__(self, net: IPNet, encode_chunk: int = 8, scribble_dilation: int = 3,
                 qa_dtype=torch.float32, device=None):
        self.device = resolve_device(device)
        self.net = net.to(self.device).eval()
        self.encode_chunk = encode_chunk
        self.scribble_dilation = scribble_dilation
        self.qa_dtype = qa_dtype

    @classmethod
    def create(cls, seed: int = 0, ckpt_dir: Optional[str] = None,
               qa_dtype=torch.float32, device=None):
        """``{ckpt_dir}/ipnet.pt`` (a state dict of :class:`IPNet`) when it
        exists, else :func:`init_ipnet_params` ``(seed)``."""
        device = resolve_device(device)  # raises before building without a GPU
        net = backbone_weights(IPNet(), ckpt_dir, IPNET_CKPT, seed)
        return cls(net, qa_dtype=qa_dtype, device=device)

    # -------------------------------------------------------------------- #
    @torch.no_grad()
    def begin_sequence(self, frames, num_objects: int) -> _IPState:
        """frames [T, H, W, 3] float (host array or tensor on the adapter's
        device): one upload, features of every frame in ``encode_chunk``
        batches."""
        dev = self.device
        frames, feats = encode_clip(self.net.frame_enc, frames, self.encode_chunk, dev)
        t, h, w = frames.shape[0], frames.shape[2], frames.shape[3]
        return _IPState(
            feats=feats,
            num_objects=num_objects,
            hw=(h, w),
            prob_maps=torch.zeros((t, num_objects, h, w), dtype=torch.float32, device=dev),
            frame_cache=frames,
        )

    @torch.no_grad()
    def segment(self, state: _IPState, scribbles: Dict, annotated_frame: int,
                n_interaction: int):
        """One round → (labels [T, H, W] uint8 host array, all_P
        [T, O+1, H, W] in ``qa_dtype`` on the device, state)."""
        state.round = n_interaction
        t = state.prob_maps.shape[0]
        h, w = state.hw
        o = state.num_objects
        a = int(annotated_frame)
        net = self.net

        # ---- interaction on the annotated frame ----
        scrib = scribble_masks_per_object(
            scribbles, (h, w), a, o, dilation=self.scribble_dilation
        )  # [O+1, H, W]
        pos = scrib[1:]
        neg = np.clip(scrib.sum(axis=0)[None] - pos, 0.0, 1.0)
        pos_neg = torch.from_numpy(np.stack([pos, neg])).to(self.device)
        img = state.frame_cache[a][None].expand(o, 3, h, w)
        anno_prob = torch.sigmoid(
            net.interaction(img, pos_neg[0], pos_neg[1], state.prob_maps[a])
        )  # [O, H, W] float32

        r4s, r3s, r2s = state.feats
        ref_vec = ref_vector(r4s[a], anno_prob)
        prev_annotated = np.array(state.annotated, dtype=np.int64)
        state.annotated.append(a)

        # ---- propagation, backward then forward, fused by Get_weight ----
        order, reset, valid = prop_order(t, a)
        fuse_w = get_weight(t, prev_annotated, a).astype(np.float32)
        carry = anno_prob
        for k, f in enumerate(order.tolist()):
            if reset[k] > 0:
                carry = anno_prob
            expand = lambda x: x[f][None].expand((o,) + x.shape[1:])
            logit = net.propagation(expand(r4s), expand(r3s), expand(r2s), ref_vec, carry,
                                    (h, w))
            if valid[k] > 0:
                w_f = fuse_w[f]  # float32, and 1 − w in float32, as the JAX package
                fused = float(w_f) * torch.sigmoid(logit) + float(1 - w_f) * state.prob_maps[f]
                state.prob_maps[f] = fused
                carry = fused
        state.prob_maps[a] = anno_prob

        labels, all_p = labels_and_probs(state.prob_maps, self.qa_dtype)
        return labels.cpu().numpy(), all_p, state
