"""TAPNet: interaction-and-transfer VOS backbone (ATNet family), in torch.

Counterpart of ``ivosw_tpu/models/vos/tapnet.py``. An interaction network
(A-Net) segments the scribbled frame from image + (prev-mask,
positive-scribble, negative-scribble) channels; a transfer network (T-Net)
propagates masks frame by frame, matching each frame's features against
every annotated frame so far and reading the previous frame's mask; each
round's result is α-blended with the previous round's probabilities.

On the device of the adapter, for the whole sequence: the frames, their
features (encoded once per sequence, in chunks), the annotated-frame memory
ring (``MAX_ROUNDS_MEM`` slots, slot ``len(annotated) % 8``), the
probability maps, and the ``all_P`` handed to the QA pass (in ``qa_dtype``).
Only the scribble masks go up and the uint8 labels come down per round. The
JAX package's ``lax.scan`` round is a loop over :func:`prop_order`: the
carry restarts from the annotated frame's probabilities at the seam
between the backward and forward passes, and an invalid step keeps the
previous round's map.

Modules take NCHW tensors and compute in bfloat16 (parameters float32),
with the JAX package's rounding points (:mod:`.layers`). ``TAPNet``'s
submodules carry the flax tree's names, so the flax params convert by a
layout change (:func:`ivosw_tpu_torch.utils.convert.tapnet_state_dict_from_numpy`).
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
    global_match_readout,
    labels_and_probs,
    resize_bilinear,
)

MAX_ROUNDS_MEM = 8  # annotated-frame memory capacity
SMALLEST_ALPHA = 0.5
TAPNET_CKPT = "tapnet.pt"


# ------------------------------------------------------------------ model --
class ANet(nn.Module):
    """Interaction net: (image ⊕ 3 interaction channels) → mask logit."""

    def __init__(self, dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.enc6 = VOSEncoder(6, dtype=dtype)
        self.dec_a = VOSDecoder(256, 128, 64, dtype=dtype)

    def forward(self, img, interaction):
        """img, interaction [O, 3, H, W] → (float32 logit [O, H, W], r4)."""
        x = torch.cat([img, interaction], dim=1).to(self.dtype)
        r4, r3, r2 = self.enc6(x)
        return self.dec_a(r4, r3, r2, img.shape[-2:]), r4


class FrameEncoder(nn.Module):
    """Image-only encoder, run once per sequence over all frames."""

    def __init__(self, dtype=torch.bfloat16):
        super().__init__()
        self.enc3 = VOSEncoder(3, dtype=dtype)

    def forward(self, img):
        return self.enc3(img)


class TNet(nn.Module):
    """Transfer net: current features + memory readout + prev mask → logit."""

    def __init__(self, dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.fuse1 = ConvBlock(256 + 256 + 1, 256, 3, 1, dtype)
        self.fuse2 = ConvBlock(256, 256, 3, 1, dtype)
        self.dec_t = VOSDecoder(256, 128, 64 + 1, dtype=dtype)

    def forward(self, r4c, r3c, r2c, mem_keys, mem_valid, prev_prob, out_hw):
        """r4c [O, C, h16, w16] (r3c, r2c likewise), mem_keys [O, M, C],
        mem_valid [O, M], prev_prob [O, H, W] float32 → logit [O, H, W]."""
        dt = self.dtype
        o, c, h16, w16 = r4c.shape
        q = r4c.flatten(2).transpose(1, 2)  # [O, P, C], P row-major as flax
        readout = global_match_readout(q, mem_keys, mem_keys, mem_valid, dt)
        readout = readout.transpose(1, 2).reshape(o, c, h16, w16)
        prev16 = resize_bilinear(prev_prob, (h16, w16)).to(dt)[:, None]
        fused = torch.cat([r4c.to(dt), readout, prev16], dim=1)
        fused = self.fuse2(self.fuse1(fused))
        # prev-mask skip at /4 resolution
        prev4 = resize_bilinear(prev_prob, r2c.shape[-2:]).to(dt)[:, None]
        r2c_in = torch.cat([r2c.to(dt), prev4], dim=1)
        return self.dec_t(fused, r3c, r2c_in, out_hw)


class TAPNet(nn.Module):
    def __init__(self, dtype=torch.bfloat16):
        super().__init__()
        self.frame_encoder = FrameEncoder(dtype)
        self.anet = ANet(dtype)
        self.tnet = TNet(dtype)


def init_tapnet_params(seed: int = 0) -> Dict[str, torch.Tensor]:
    """Seeded initial weights of :class:`TAPNet`
    (:func:`~ivosw_tpu_torch.models.vos.layers.flax_style_init`)."""
    return flax_style_init(TAPNet(), seed)


# ----------------------------------------------------------------- state --
@dataclass
class _TAPState:
    feats: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]  # r4/r3/r2 [T, C, h, w]
    num_objects: int
    hw: Tuple[int, int]
    prob_maps: torch.Tensor  # [T, O, H, W] float32, previous round's
    mem_keys: torch.Tensor  # [O, MAX_ROUNDS_MEM * P, C]
    mem_valid: torch.Tensor  # [O, MAX_ROUNDS_MEM * P] float32 1/0
    frame_cache: torch.Tensor  # [T, 3, H, W] float32 frames (A-Net input)
    annotated: List[int] = field(default_factory=list)
    round: int = 0


def compute_alpha(t: int, annotated_prev: np.ndarray, annotated_now: int) -> np.ndarray:
    """Per-frame blend factors (reference utils/utils_atnet.py:126-147)."""
    alpha = np.ones(t, dtype=np.float32)
    idx = np.arange(t)
    lower = annotated_prev[annotated_prev < annotated_now]
    if len(lower) > 0:
        closest = lower.max()
        back = idx < annotated_now
        denom = max(annotated_now - closest, 1)
        alpha_b = SMALLEST_ALPHA + (1 - SMALLEST_ALPHA) * ((idx - closest) / denom)
        alpha = np.where(back, alpha_b, alpha)
    upper = annotated_prev[annotated_prev > annotated_now]
    if len(upper) > 0:
        closest = upper.min()
        fwd = idx > annotated_now
        denom = max(closest - annotated_now, 1)
        alpha_f = SMALLEST_ALPHA + (1 - SMALLEST_ALPHA) * ((closest - idx) / denom)
        alpha = np.where(fwd, alpha_f, alpha)
    return np.clip(alpha, 0.0, 1.0)


def prop_order(
    t: int, a: int, direction: str = "bwd_fwd"
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Frame order of one propagation round (length t-1), the carry-reset
    flags (1 at the seam between the two passes) and the valid flags.
    ATNet propagates backward then forward, MANet forward then backward."""
    back = list(range(a - 1, -1, -1))
    fwd = list(range(a + 1, t))
    if direction == "bwd_fwd":
        first, second = back, fwd
    elif direction == "fwd_bwd":
        first, second = fwd, back
    else:
        raise NotImplementedError(f"unknown propagation direction: {direction}")
    order = np.array(first + second, dtype=np.int32)
    reset = np.zeros(len(order), dtype=np.float32)
    if len(second) > 0:
        reset[len(first)] = 1.0
    valid = np.ones(len(order), dtype=np.float32)
    return order, reset, valid


class TAPNetAdapter:
    """VOS adapter around TAPNet (``begin_sequence`` / ``segment``).

    ``qa_dtype`` is the storage type of the returned ``all_P``
    (``cfg.assess_net.bf16_inputs``); labels are computed before the cast."""

    name = "tapnet"

    def __init__(self, net: TAPNet, encode_chunk: int = 8, scribble_dilation: int = 3,
                 qa_dtype=torch.float32, device=None):
        self.device = resolve_device(device)
        self.net = net.to(self.device).eval()
        self.encode_chunk = encode_chunk
        self.scribble_dilation = scribble_dilation
        self.qa_dtype = qa_dtype

    @classmethod
    def create(cls, seed: int = 0, ckpt_dir: Optional[str] = None,
               qa_dtype=torch.float32, device=None):
        """``{ckpt_dir}/tapnet.pt`` (a state dict of :class:`TAPNet`) when it
        exists, else :func:`init_tapnet_params` ``(seed)``."""
        device = resolve_device(device)  # raises before building without a GPU
        net = backbone_weights(TAPNet(), ckpt_dir, TAPNET_CKPT, seed)
        return cls(net, qa_dtype=qa_dtype, device=device)

    # -------------------------------------------------------------------- #
    @torch.no_grad()
    def begin_sequence(self, frames, num_objects: int) -> _TAPState:
        """frames [T, H, W, 3] float (host array or tensor on the adapter's
        device): one upload, features of every frame in ``encode_chunk``
        batches."""
        dev = self.device
        frames, feats = encode_clip(self.net.frame_encoder, frames, self.encode_chunk, dev)
        t, h, w = frames.shape[0], frames.shape[2], frames.shape[3]
        c, p = feats[0].shape[1], feats[0].shape[2] * feats[0].shape[3]
        return _TAPState(
            feats=feats,
            num_objects=num_objects,
            hw=(h, w),
            prob_maps=torch.zeros((t, num_objects, h, w), dtype=torch.float32, device=dev),
            mem_keys=torch.zeros((num_objects, MAX_ROUNDS_MEM * p, c), dtype=torch.bfloat16,
                                 device=dev),
            mem_valid=torch.zeros((num_objects, MAX_ROUNDS_MEM * p), dtype=torch.float32,
                                  device=dev),
            frame_cache=frames,
        )

    def _interaction_channels(self, state: _TAPState, scribbles: Dict, frame: int):
        """Per-object [O, 3, H, W] interaction input on the device: previous
        probability (0.5 in round 1), positive and negative scribbles
        (reference utils/utils_atnet.py:31-52; no negatives in round 1)."""
        h, w = state.hw
        o = state.num_objects
        scrib = scribble_masks_per_object(
            scribbles, (h, w), frame, o, dilation=self.scribble_dilation
        )  # [O+1, H, W]
        pos = scrib[1:]
        if state.round == 1:
            neg = np.zeros_like(pos)
        else:
            neg = np.clip(scrib.sum(axis=0)[None] - pos, 0.0, 1.0)
        pos_neg = torch.from_numpy(np.stack([pos, neg], axis=1)).to(self.device)
        if state.round == 1:
            prev = torch.full((o, 1, h, w), 0.5, dtype=torch.float32, device=self.device)
        else:
            prev = state.prob_maps[frame][:, None]
        return torch.cat([prev, pos_neg], dim=1)

    @torch.no_grad()
    def segment(self, state: _TAPState, scribbles: Dict, annotated_frame: int,
                n_interaction: int):
        """One round → (labels [T, H, W] uint8 host array, all_P
        [T, O+1, H, W] in ``qa_dtype`` on the device, state)."""
        state.round = n_interaction
        t = state.prob_maps.shape[0]
        h, w = state.hw
        o = state.num_objects
        a = int(annotated_frame)
        net = self.net

        # ---- A-Net on the annotated frame ----
        interaction = self._interaction_channels(state, scribbles, a)
        img = state.frame_cache[a][None].expand(o, 3, h, w)
        logit, anno_r4 = net.anet(img, interaction)
        anno_prob = torch.sigmoid(logit)  # [O, H, W] float32

        # ---- annotated-frame memory (ring of MAX_ROUNDS_MEM slots) ----
        p = anno_r4.shape[2] * anno_r4.shape[3]
        slot = len(state.annotated) % MAX_ROUNDS_MEM
        keys = anno_r4.flatten(2).transpose(1, 2)  # [O, P, C]
        state.mem_keys[:, slot * p:(slot + 1) * p] = keys.to(state.mem_keys.dtype)
        state.mem_valid[:, slot * p:(slot + 1) * p] = 1.0
        prev_annotated = np.array(state.annotated, dtype=np.int64)
        state.annotated.append(a)

        # ---- propagation, backward then forward ----
        order, reset, valid = prop_order(t, a)
        alpha = compute_alpha(t, prev_annotated, a)
        r4s, r3s, r2s = state.feats
        carry = anno_prob
        for k, f in enumerate(order.tolist()):
            if reset[k] > 0:
                carry = anno_prob
            expand = lambda x: x[f][None].expand((o,) + x.shape[1:])
            logit = net.tnet(expand(r4s), expand(r3s), expand(r2s), state.mem_keys,
                             state.mem_valid, carry, (h, w))
            if valid[k] > 0:
                a_t = float(alpha[f])
                blended = a_t * torch.sigmoid(logit) + (1.0 - a_t) * state.prob_maps[f]
                state.prob_maps[f] = blended
                carry = blended
        state.prob_maps[a] = anno_prob

        labels, all_p = labels_and_probs(state.prob_maps, self.qa_dtype)
        return labels.cpu().numpy(), all_p, state
