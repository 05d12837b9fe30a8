"""MatchNet: pixel-matching VOS backbone (MANet family), in torch.

Counterpart of ``ivosw_tpu/models/vos/matchnet.py``. Frame embeddings are
computed once per sequence; an interaction head segments the scribbled
frame from its embedding, the scribbles and the previous round's map; a
propagation head walks the frames forward then backward from the annotated
frame, guided at the /4 scale by

- global matching: per-object max cosine similarity against the annotated
  frame, kept per frame as a running max across rounds (initialised to −1);
- local matching: the same against the previous frame of the walk;
- the previous frame's map and this frame's map of the previous round.

On the device of the adapter, for the whole sequence: the frames'
features, the probability maps, the per-frame global maps and the
``all_P`` handed to the QA pass (in ``qa_dtype``). The JAX package's
``lax.scan`` round is a loop over :func:`prop_order` ``(t, a, "fwd_bwd")``:
the carry (probabilities and embedding) restarts from the annotated frame's
at the seam, and an invalid step keeps the previous values.

Modules take NCHW tensors and compute in bfloat16 (parameters float32),
with the JAX package's rounding points (:mod:`.layers`). ``MatchNet``'s
submodules carry the flax tree's names, so the flax params convert by a
layout change (:func:`ivosw_tpu_torch.utils.convert.matchnet_state_dict_from_numpy`).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from ivosw_tpu_torch.data.scribbles import scribble_masks_per_object
from ivosw_tpu_torch.device import resolve_device
from ivosw_tpu_torch.models.vos.layers import (
    Conv,
    ConvBlock,
    VOSEncoder,
    backbone_weights,
    encode_clip,
    flax_style_init,
    labels_and_probs,
    resize_bilinear,
    resize_like,
)
from ivosw_tpu_torch.models.vos.tapnet import prop_order

MATCHNET_CKPT = "matchnet.pt"


# ------------------------------------------------------------------ model --
class GuidedHead(nn.Module):
    """r4 context decoded up to /4, where ``guide`` planes join r2.

    guide4 [O, G, h4, w4]: scribble pos / neg + previous map (interaction,
    G=3) or global / local match + previous frame's map + previous round's
    map (propagation, G=4), in that order along dim 1."""

    def __init__(self, guide_ch: int, dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.ctx = ConvBlock(256, 256, 3, 1, dtype)
        self.mid = ConvBlock(256 + 128, 128, 3, 1, dtype)
        self.fuse = ConvBlock(128 + 64 + guide_ch, 64, 3, 1, dtype)
        self.refine = ConvBlock(64, 64, 3, 1, dtype)
        self.Conv_0 = Conv(64, 1, 3, padding=1, bias=True)  # float32

    def forward(self, emb_r4, emb_r3, emb_r2, guide4, out_hw: Tuple[int, int]):
        """→ float32 logit [O, H, W]."""
        dt = self.dtype
        x = self.ctx(emb_r4.to(dt))
        x = resize_like(x, emb_r3)
        x = self.mid(torch.cat([x, emb_r3.to(dt)], dim=1))
        x = resize_like(x, emb_r2)
        x = self.fuse(torch.cat([x, emb_r2.to(dt), guide4.to(dt)], dim=1))
        x = self.refine(x)
        logit = self.Conv_0(x.float())
        return resize_bilinear(logit, out_hw)[:, 0]


class MatchNet(nn.Module):
    def __init__(self, dtype=torch.bfloat16):
        super().__init__()
        self.emb_enc = VOSEncoder(3, dtype=dtype)
        self.int_head = GuidedHead(3, dtype)
        self.prop_head = GuidedHead(4, dtype)


def init_matchnet_params(seed: int = 0) -> Dict[str, torch.Tensor]:
    """Seeded initial weights of :class:`MatchNet`
    (:func:`~ivosw_tpu_torch.models.vos.layers.flax_style_init`)."""
    return flax_style_init(MatchNet(), seed)


def object_sim_maps(emb, ref_emb, ref_probs, dtype=torch.bfloat16):
    """Max cosine-similarity map per object: emb, ref_emb [C, h, w];
    ref_probs [O, h, w] (all at the matching scale, /4) → float32 [O, h, w].

    Each pixel's feature is L2-normalised in float32 (``+1e-6`` outside the
    norm), rounded to ``dtype`` and contracted in float32; the reference
    pixels with ``ref_probs > 0.5`` are the object's members. The JAX
    package takes the max of ``where(member, sim, −1)`` over all reference
    pixels, so an object gets

    - ``max(−1, max over its members)`` when some pixel is not a member,
    - the plain max over all pixels when every pixel is a member,
    - −1 everywhere when it has no member.

    The products are taken object by object over the members' columns, so
    no [O, P, M] tensor and no masked copy of the [P, M] product exist; the
    max is exact in any order."""
    c, h, w = emb.shape

    def normalised(x):
        x = x.reshape(c, h * w).T.float()
        x = x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-6)
        return x.to(dtype).float()

    q, k = normalised(emb), normalised(ref_emb)  # [P, C], [M, C]
    memb = ref_probs.reshape(ref_probs.shape[0], h * w) > 0.5  # [O, M]
    out = []
    for obj, n in enumerate(memb.sum(dim=1).tolist()):
        if n == 0:
            out.append(torch.full((h * w,), -1.0, dtype=torch.float32, device=emb.device))
        elif n == h * w:
            out.append(torch.matmul(q, k.T).amax(dim=-1))
        else:
            out.append(torch.matmul(q, k[memb[obj]].T).amax(dim=-1).clamp_min(-1.0))
    return torch.stack(out).reshape(-1, h, w)


# ----------------------------------------------------------------- state --
@dataclass
class _MatchState:
    feats: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]  # r4/r3/r2 [T, C, h, w]
    num_objects: int
    hw: Tuple[int, int]
    prob_maps: torch.Tensor  # [T, O, H, W] float32, previous round's
    global_map: torch.Tensor  # [T, O, h4, w4] float32, per-frame max over rounds
    annotated: List[int] = field(default_factory=list)
    round: int = 0


class MatchNetAdapter:
    """VOS adapter around MatchNet (``begin_sequence`` / ``segment``).

    ``qa_dtype`` is the storage type of the returned ``all_P``
    (``cfg.assess_net.bf16_inputs``); labels are computed before the cast."""

    name = "matchnet"

    def __init__(self, net: MatchNet, encode_chunk: int = 8, scribble_dilation: int = 3,
                 qa_dtype=torch.float32, device=None):
        self.device = resolve_device(device)
        self.net = net.to(self.device).eval()
        self.encode_chunk = encode_chunk
        self.scribble_dilation = scribble_dilation
        self.qa_dtype = qa_dtype

    @classmethod
    def create(cls, seed: int = 0, ckpt_dir: Optional[str] = None,
               qa_dtype=torch.float32, device=None):
        """``{ckpt_dir}/matchnet.pt`` (a state dict of :class:`MatchNet`)
        when it exists, else :func:`init_matchnet_params` ``(seed)``."""
        device = resolve_device(device)  # raises before building without a GPU
        net = backbone_weights(MatchNet(), ckpt_dir, MATCHNET_CKPT, seed)
        return cls(net, qa_dtype=qa_dtype, device=device)

    # -------------------------------------------------------------------- #
    @torch.no_grad()
    def begin_sequence(self, frames, num_objects: int) -> _MatchState:
        """frames [T, H, W, 3] float (host array or tensor on the adapter's
        device): one upload, embeddings of every frame in ``encode_chunk``
        batches."""
        dev = self.device
        frames, feats = encode_clip(self.net.emb_enc, frames, self.encode_chunk, dev)
        t, h, w = frames.shape[0], frames.shape[2], frames.shape[3]
        h4, w4 = feats[2].shape[-2:]
        return _MatchState(
            feats=feats,
            num_objects=num_objects,
            hw=(h, w),
            prob_maps=torch.zeros((t, num_objects, h, w), dtype=torch.float32, device=dev),
            global_map=torch.full((t, num_objects, h4, w4), -1.0, dtype=torch.float32,
                                  device=dev),
        )

    def _interact(self, r4, r3, r2, scrib_maps, prev_label, out_hw):
        """scrib_maps [O+1, H, W], prev_label [O, H, W] float32 → the
        annotated frame's probabilities [O, H, W]. The negatives are every
        other object's and the background's scribbles, in every round."""
        o = prev_label.shape[0]
        hw4 = r2.shape[-2:]
        pos = resize_bilinear(scrib_maps[1:], hw4)
        neg = resize_bilinear(torch.clamp(scrib_maps.sum(0, keepdim=True) - scrib_maps[1:],
                                          0.0, 1.0), hw4)
        prev = resize_bilinear(prev_label, hw4)
        guide4 = torch.stack([pos, neg, prev], dim=1).to(torch.bfloat16)
        expand = lambda x: x[None].expand((o,) + x.shape)
        logit = self.net.int_head(expand(r4), expand(r3), expand(r2), guide4, out_hw)
        return torch.sigmoid(logit)

    @torch.no_grad()
    def segment(self, state: _MatchState, scribbles: Dict, annotated_frame: int,
                n_interaction: int):
        """One round → (labels [T, H, W] uint8 host array, all_P
        [T, O+1, H, W] in ``qa_dtype`` on the device, state)."""
        state.round = n_interaction
        t = state.prob_maps.shape[0]
        h, w = state.hw
        o = state.num_objects
        a = int(annotated_frame)
        r4s, r3s, r2s = state.feats

        scrib = scribble_masks_per_object(
            scribbles, (h, w), a, o, dilation=self.scribble_dilation
        )
        anno_prob = self._interact(r4s[a], r3s[a], r2s[a],
                                   torch.from_numpy(scrib).to(self.device),
                                   state.prob_maps[a], (h, w))
        state.annotated.append(a)

        # ---- propagation, forward then backward (MANet's order) ----
        order, reset, valid = prop_order(t, a, direction="fwd_bwd")
        ref_emb = r2s[a]
        hw4 = ref_emb.shape[-2:]
        ref_probs4 = resize_bilinear(anno_prob, hw4)
        prev_prob, prev_emb = anno_prob, ref_emb
        expand = lambda x: x[None].expand((o,) + x.shape)
        for k, f in enumerate(order.tolist()):
            if reset[k] > 0:
                prev_prob, prev_emb = anno_prob, ref_emb
            r2c = r2s[f]
            global_new = torch.maximum(state.global_map[f], object_sim_maps(r2c, ref_emb,
                                                                            ref_probs4))
            prev4 = resize_bilinear(prev_prob, hw4)
            local = object_sim_maps(r2c, prev_emb, prev4)
            prev_round4 = resize_bilinear(state.prob_maps[f], hw4)
            guide4 = torch.stack([global_new, local, prev4, prev_round4], dim=1)
            logit = self.net.prop_head(expand(r4s[f]), expand(r3s[f]), expand(r2c),
                                       guide4.to(torch.bfloat16), (h, w))
            if valid[k] > 0:
                prob = torch.sigmoid(logit)
                state.prob_maps[f] = prob
                state.global_map[f] = global_new
                prev_prob, prev_emb = prob, r2c
        state.prob_maps[a] = anno_prob

        labels, all_p = labels_and_probs(state.prob_maps, self.qa_dtype)
        return labels.cpu().numpy(), all_p, state
