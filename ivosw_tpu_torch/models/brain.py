"""Brain: bidirectional-LSTM Q-network over the frame axis, in torch.

Counterpart of ``ivosw_tpu/models/brain.py``: per-frame 2→128→128 FC
encoder, ONE weight-shared bias-free LSTM cell run forward and backward over
the frame axis, per-frame concat of the two hidden states → ReLU → FC
256→128→1 Q-value. ``nn.LSTM(bidirectional=True)`` keeps separate weights
per direction and is a different function, so the port loops one
``nn.LSTMCell(128, 128, bias=False)``; both directions step together as
one batch of 2N rows. Masked (padded) steps pass the recurrent state
through untouched and get Q = -inf.

:func:`brain_q` is the differentiable forward (the Q-update's);
:func:`brain_forward` is the same function without gradients (inference).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

HIDDEN = 128
INPUT_FEATURES = 2  # (quality score, #times annotated)


class Brain(nn.Module):
    def __init__(self):
        super().__init__()
        h = HIDDEN
        self.enc_fc1 = nn.Linear(INPUT_FEATURES, h)
        self.enc_fc2 = nn.Linear(h, h)
        self.lstm = nn.LSTMCell(h, h, bias=False)
        self.dec_fc1 = nn.Linear(2 * h, h)
        self.dec_fc2 = nn.Linear(h, 1)


def init_brain(seed: int = 0) -> Brain:
    """Brain with torch-default init distributions, U(±1/√fan_in), drawn in
    a fixed order from ``torch.Generator().manual_seed(seed)`` (CPU)."""
    brain = Brain()
    g = torch.Generator().manual_seed(seed)
    fan_in = {
        "enc_fc1": INPUT_FEATURES, "enc_fc2": HIDDEN, "lstm": HIDDEN,
        "dec_fc1": 2 * HIDDEN, "dec_fc2": HIDDEN,
    }
    with torch.no_grad():
        for name, p in brain.named_parameters():
            bound = 1.0 / math.sqrt(fan_in[name.split(".")[0]])
            p.uniform_(-bound, bound, generator=g)
    return brain.eval()


def brain_q(
    brain: Brain, x: torch.Tensor, mask: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Q-values per frame, differentiable with respect to the Brain.

    x: [N, T, 2] state (quality, #annotations); mask: optional [N, T] with 1
    for real frames, 0 for padding. Returns [N, T]; padded positions are
    -inf so an argmax never selects them."""
    n, t, _ = x.shape
    feats = F.relu(brain.enc_fc1(x))
    feats = brain.enc_fc2(feats)  # [N, T, H]
    feats_tm = feats.transpose(0, 1)  # [T, N, H]
    if mask is None:
        mask_tm = torch.ones((t, n, 1), dtype=feats.dtype, device=feats.device)
    else:
        mask_tm = mask.transpose(0, 1)[:, :, None].to(feats.dtype)

    # rows [0, N) run forward in time, rows [N, 2N) backward
    inp = torch.cat([feats_tm, feats_tm.flip(0)], dim=1)  # [T, 2N, H]
    m = torch.cat([mask_tm, mask_tm.flip(0)], dim=1)  # [T, 2N, 1]
    h = torch.zeros((2 * n, HIDDEN), dtype=feats.dtype, device=feats.device)
    c = torch.zeros_like(h)
    hs = []
    for step in range(t):
        h_new, c_new = brain.lstm(inp[step], (h, c))
        m_t = m[step]
        h = m_t * h_new + (1.0 - m_t) * h
        c = m_t * c_new + (1.0 - m_t) * c
        hs.append(h)
    hs = torch.stack(hs)  # [T, 2N, H]
    h_fw, h_bw = hs[:, :n], hs[:, n:].flip(0)

    z = F.relu(torch.cat([h_fw, h_bw], dim=-1))  # [T, N, 2H]
    z = F.relu(brain.dec_fc1(z))
    q = brain.dec_fc2(z)[..., 0].transpose(0, 1)  # [N, T]
    if mask is not None:
        q = torch.where(mask > 0, q, torch.full_like(q, -math.inf))
    return q


@torch.no_grad()
def brain_forward(
    brain: Brain, x: torch.Tensor, mask: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """:func:`brain_q` without gradients (the inference entry)."""
    return brain_q(brain, x, mask)


def pad_to_bucket(t: int, buckets=(32, 64, 128, 256)) -> int:
    """Shape bucket for a clip of T frames (the JAX package's static shapes;
    kept so padded Q-values match it)."""
    for b in buckets:
        if t <= b:
            return b
    return ((t + 127) // 128) * 128
