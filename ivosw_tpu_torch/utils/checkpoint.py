"""Agent checkpoints with ``torch.save``.

Counterpart of the agent half of ``ivosw_tpu/utils/checkpoint.py``. A
checkpoint named ``N`` is two files in ``ckpt_dir``:

- ``N.pt``: the policy Brain's state dict (``agent.pt`` is what
  ``eval/eval_agent.py`` loads for ``method=ours``);
- ``N.train.pt``: ``{"optimizer": Adam state dict, "steps_done": int}``.

Epoch snapshots of an in-flight training run are ``agent_epoch_N``; the
plain ``agent`` is written only when the run completes. The JAX package's
own checkpoints (``agent.orbax``) and the reference's ``agent.pt`` layout
are not read here: a file in another layout fails in ``load_state_dict``.
"""

from __future__ import annotations

import os
import re
from typing import Optional

import torch

_EPOCH = re.compile(r"agent_epoch_(\d+)\.pt")
_EPOCH_FILE = re.compile(r"agent_epoch_\d+(\.train)?\.pt")


def _paths(ckpt_dir: str, name: str):
    return os.path.join(ckpt_dir, name + ".pt"), os.path.join(ckpt_dir, name + ".train.pt")


def save_agent_checkpoint(agent, ckpt_dir: str, epoch: Optional[int] = None) -> str:
    """Save the policy Brain, the optimizer state and ``steps_done``;
    returns the Brain's path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    name = "agent" if epoch is None else f"agent_epoch_{epoch}"
    brain_path, train_path = _paths(ckpt_dir, name)
    torch.save(
        {"optimizer": agent.optimizer.state_dict(), "steps_done": int(agent.steps_done)},
        train_path,
    )
    torch.save(agent.brain.state_dict(), brain_path)
    return brain_path


def load_agent_params(ckpt_dir: str, name: str = "agent", map_location="cpu"):
    """The Brain state dict of ``{ckpt_dir}/{name}.pt``, or None."""
    path = _paths(ckpt_dir, name)[0]
    if not os.path.exists(path):
        return None
    return torch.load(path, map_location=map_location, weights_only=True)


def latest_agent_epoch(ckpt_dir: str) -> Optional[int]:
    """Highest N for which ``agent_epoch_N.pt`` exists in ckpt_dir, else None."""
    best = None
    if os.path.isdir(ckpt_dir):
        for entry in os.listdir(ckpt_dir):
            m = _EPOCH.fullmatch(entry)
            if m:
                n = int(m.group(1))
                best = n if best is None else max(best, n)
    return best


def clear_agent_epoch_snapshots(ckpt_dir: str) -> int:
    """Delete the ``agent_epoch_N`` snapshots; returns how many were removed.

    Called once the plain ``agent`` checkpoint of a completed run is
    written: a leftover snapshot would make a later retrain resume past
    ``num_epochs`` and run no epoch at all."""
    removed = 0
    if os.path.isdir(ckpt_dir):
        for entry in os.listdir(ckpt_dir):
            m = _EPOCH_FILE.fullmatch(entry)
            if m:
                os.remove(os.path.join(ckpt_dir, entry))
                removed += not m.group(1)
    return removed


def restore_agent(agent, ckpt_dir: str, name: str = "agent") -> bool:
    """Bring back the policy Brain, the optimizer state and ``steps_done``
    of checkpoint ``name``, onto the agent's device; the target becomes a
    copy of the policy. Returns False when ``{name}.pt`` does not exist. A
    Brain saved without its training state (only ``{name}.pt``) restores
    the Brain and the target alone."""
    state = load_agent_params(ckpt_dir, name, map_location=agent.device)
    if state is None:
        return False
    agent.brain.load_state_dict(state)
    agent.sync_target()
    train_path = _paths(ckpt_dir, name)[1]
    if os.path.exists(train_path):
        # on the host: Adam keeps its step counts there and moves the
        # moments onto each parameter's device as it loads them
        train = torch.load(train_path, map_location="cpu", weights_only=True)
        agent.optimizer.load_state_dict(train["optimizer"])
        agent.steps_done = int(train["steps_done"])
    return True
