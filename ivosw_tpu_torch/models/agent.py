"""DQN frame-recommendation agent, inference only.

Counterpart of the inference half of ``ivosw_tpu/models/agent.py``: the
policy Brain, the ε schedule ``eps_end + (eps_start - eps_end)·exp(-0.5·
steps/eps_decay)`` (ε = 0 outside ``phase=train``) and ε-greedy ``action``
with the JAX package's host-RNG draw order: ``host_rng.random()`` is drawn
on EVERY call, even at ε = 0. The optimizer, ``dqn_loss`` and
``update_agent`` come with the agent-training slice.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ivosw_tpu_torch.device import resolve_device
from ivosw_tpu_torch.models.brain import brain_forward, init_brain, pad_to_bucket


class Agent:
    """Holds the policy Brain on ``device`` and the ε-greedy policy."""

    def __init__(self, cfg, seed: Optional[int] = None, rng=None, device=None):
        self.cfg = cfg
        a = cfg.agent
        self.eps_start = float(a.eps_start)
        self.eps_end = float(a.eps_end)
        self.eps_decay = float(a.eps_decay)
        self.steps_done = 0
        self.device = resolve_device(device)
        seed = cfg.seed if seed is None else seed
        self.brain = init_brain(seed).to(self.device)
        self.host_rng = rng if rng is not None else np.random.default_rng(seed)

    def eps_threshold(self) -> float:
        if self.cfg.phase != "train":
            return 0.0
        return self.eps_end + (self.eps_start - self.eps_end) * math.exp(
            -0.5 * self.steps_done / self.eps_decay
        )

    def q_values(self, state: np.ndarray) -> np.ndarray:
        """Greedy Q-values for one clip (no ε, no step counting). [T]."""
        t = state.shape[0]
        t_pad = pad_to_bucket(t)
        padded = np.zeros((1, t_pad, 2), dtype=np.float32)
        padded[0, :t] = state
        mask = np.zeros((1, t_pad), dtype=np.float32)
        mask[0, :t] = 1.0
        q = brain_forward(
            self.brain,
            torch.from_numpy(padded).to(self.device),
            torch.from_numpy(mask).to(self.device),
        )
        return q[0, :t].cpu().numpy()

    def action(self, state: np.ndarray) -> int:
        """ε-greedy frame pick for one clip. state: [T, 2]."""
        self.steps_done += 1
        eps = self.eps_threshold()
        t = state.shape[0]
        rand_flag = self.host_rng.random()
        if rand_flag > eps:
            return int(self.q_values(state).argmax())
        return int(self.host_rng.integers(t))
