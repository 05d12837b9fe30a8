"""DQN frame-recommendation agent.

Counterpart of ``ivosw_tpu/models/agent.py``: policy and target Brains, the
ε schedule ``eps_end + (eps_start - eps_end)·exp(-0.5·steps/eps_decay)``
(ε = 0 outside ``phase=train``), ε-greedy ``action`` with the JAX package's
host-RNG draw order (``host_rng.random()`` on EVERY call, even at ε = 0),
and the Q-update:

- double DQN: the next action is the argmax of the POLICY net's Q-values
  on the next state, its value comes from the TARGET net, both without
  gradients;
- targets ``γ·Q_next + 0.1·reward_step`` and ``0.1·reward_done``, the two
  MSE means summed;
- ``done`` is carried in the batch but does not mask the bootstrapped term
  (the reference's quirk, kept);
- each gradient clamped to ±1 in place, then ``torch.optim.Adam`` with
  coupled L2 weight decay, the maths of the JAX package's
  ``optax.chain(clip(1), add_decayed_weights(wd), scale_by_adam, scale(-lr))``;
- after each update one ``host_rng.random() < update_rate`` draw; a hit
  sets the target to a copy of the policy;
- a rolling 32-entry loss window.

The update runs on ``agent.device``, the sampled batch uploaded for each
update. The Brain is a loop of small LSTM-cell launches (3 forward passes
of 25 cell steps and one backward per update at the config's shapes); it is
plain PyTorch, not a kernel.
"""

from __future__ import annotations

import copy
import math
from typing import Dict, Optional

import numpy as np
import torch

from ivosw_tpu_torch.data.replay import ReplayMemory, Transition
from ivosw_tpu_torch.device import resolve_device
from ivosw_tpu_torch.models.brain import Brain, brain_forward, brain_q, init_brain, pad_to_bucket

SCALE_FACTOR_STEP = 0.1
SCALE_FACTOR_DONE = 0.1
GRAD_CLIP = 1.0
BATCH_KEYS = (
    "action",
    "reward_step",
    "reward_done",
    "old_state_iou",
    "new_state_iou",
    "annotated_frames",
    "next_annotated_frames",
)


def make_optimizer(params, lr: float, weight_decay: float) -> torch.optim.Adam:
    """Adam with coupled L2 decay (``grad += wd·param``, after the caller's
    clamp, as ``add_decayed_weights`` follows ``clip`` in the JAX chain);
    bias corrections and eps as optax's ``scale_by_adam``:
    ``m̂ / (sqrt(v̂) + eps)``."""
    return torch.optim.Adam(
        params, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay
    )


def dqn_loss(brain: Brain, target: Brain, batch: Dict[str, torch.Tensor], gamma: float):
    """The double-DQN loss of one batch of tensors on the Brains' device
    (the JAX package's ``dqn_loss``); differentiable in ``brain`` only."""
    state = torch.stack([batch["old_state_iou"], batch["annotated_frames"]], dim=2)
    new_state = torch.stack(
        [batch["new_state_iou"], batch["next_annotated_frames"]], dim=2
    )
    with torch.no_grad():
        next_action = brain_q(brain, new_state).argmax(dim=1)
        q_next = brain_q(target, new_state).gather(1, next_action[:, None])
    target_step = q_next * gamma + batch["reward_step"][:, None] * SCALE_FACTOR_STEP
    target_done = batch["reward_done"][:, None] * SCALE_FACTOR_DONE

    q_sa = brain_q(brain, state).gather(1, batch["action"][:, None].long())
    loss_step = torch.mean((q_sa - target_step) ** 2)
    loss_done = torch.mean((q_sa - target_done) ** 2)
    return loss_step + loss_done


def dqn_update_step(brain, target, optimizer, batch, gamma: float) -> torch.Tensor:
    """One Q-update in place: loss, gradients, clamp to ±1, Adam step.
    Returns the loss (a 0-dim tensor on the Brain's device)."""
    optimizer.zero_grad(set_to_none=True)
    loss = dqn_loss(brain, target, batch, gamma)
    loss.backward()
    with torch.no_grad():
        for p in brain.parameters():
            p.grad.clamp_(-GRAD_CLIP, GRAD_CLIP)
    optimizer.step()
    return loss.detach()


class Agent:
    """Policy and target Brains on ``device``, the optimizer, the replay
    pool and the ε-greedy policy."""

    def __init__(self, cfg, seed: Optional[int] = None, rng=None, device=None):
        self.cfg = cfg
        a = cfg.agent
        self.memory_size = a.memory_size
        self.gamma = float(a.gamma)
        self.eps_start = float(a.eps_start)
        self.eps_end = float(a.eps_end)
        self.eps_decay = float(a.eps_decay)
        self.update_rate = float(a.update_rate)
        self.steps_done = 0
        self.device = resolve_device(device)
        seed = cfg.seed if seed is None else seed

        self.memory_pool = ReplayMemory(self.memory_size)
        self.brain = init_brain(seed).to(self.device)
        self.target = copy.deepcopy(self.brain)
        self.optimizer = make_optimizer(self.brain.parameters(), a.lr, a.weight_decay)
        self.host_rng = rng if rng is not None else np.random.default_rng(seed)

        # rolling loss window (reference models/agent.py:94-97,198-203)
        self.loss_window = []
        self.loss_position = 0
        self.loss_capacity = 32
        self.loss_avg = 0.0

    # ------------------------------------------------------------------ #
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

    def sync_target(self) -> None:
        """Target ← a copy of the policy (never an alias)."""
        self.target.load_state_dict(self.brain.state_dict())

    # ------------------------------------------------------------------ #
    def update_agent(self, batch: Optional[Dict[str, np.ndarray]]) -> Optional[float]:
        """One replay-batch Q-update. Returns the scalar loss."""
        if batch is None:
            return None
        device_batch = {
            k: torch.from_numpy(np.asarray(batch[k])).to(self.device) for k in BATCH_KEYS
        }
        loss = dqn_update_step(
            self.brain, self.target, self.optimizer, device_batch, self.gamma
        )
        loss_val = float(loss)
        self._update_avg_loss(loss_val)

        # stochastic target sync (reference models/agent.py:163-165)
        if self.host_rng.random() < self.update_rate:
            self.sync_target()
        return loss_val

    def _update_avg_loss(self, loss: float) -> None:
        if len(self.loss_window) < self.loss_capacity:
            self.loss_window.append(None)
        self.loss_window[self.loss_position] = loss
        self.loss_position = (self.loss_position + 1) % self.loss_capacity
        self.loss_avg = sum(self.loss_window) / len(self.loss_window)

    def get_avg_loss(self) -> float:
        return self.loss_avg

    # ------------------------------------------------------------------ #
    def memory(self, transition: Transition, report_save_dir: str) -> None:
        self.memory_pool.push(transition)
        self.memory_pool.push_to_csv(report_save_dir)
