"""Agent pretraining data: random-policy rollouts with Eq. 3 rewards.

Counterpart of ``ivosw_tpu/train/pretrain_agent.py``: phase 'pretrain',
seed 2021, 10 epochs (unless ``num_epochs`` > 1 is given) of
``setting=wild``, ``method=random`` rollouts with the reward table read from
``{agent.save_result_dir}/{agent.reward_csv}``, so ``reward_done`` is the
normalised terminal reward; transitions are mirrored to
``{agent.save_result_dir}/{agent.pretrain_csv}``. No Q-update runs (only
phase 'train' updates).

CLI (from a directory holding ``configs/``):
``python -m ivosw_tpu_torch.train.pretrain_agent [key=value ...] [--cpu]``
"""

from __future__ import annotations

import os

from ivosw_tpu_torch.core.config import Config, load_config
from ivosw_tpu_torch.data.registry import registry_from_config
from ivosw_tpu_torch.device import resolve_device
from ivosw_tpu_torch.eval.backbones import build_backbone
from ivosw_tpu_torch.interact.recommend import RewardTable
from ivosw_tpu_torch.models.agent import Agent
from ivosw_tpu_torch.train.rollout import run_interactive_phase


def configure(cfg: Config) -> Config:
    cfg.phase = "pretrain"
    cfg.seed = 2021
    cfg.num_epochs = cfg.num_epochs if cfg.num_epochs > 1 else 10
    cfg.setting = "wild"
    cfg.method = "random"
    return cfg


def run(cfg: Config, registry=None, adapter=None, reward_table=None,
        expected_count=None, log=None, device=None):
    """The phase on ``device`` (None: CUDA, raises without one); returns
    (stats, agent)."""
    device = resolve_device(device)
    registry = registry or registry_from_config(cfg)
    adapter = adapter or build_backbone(cfg, registry, device)
    if reward_table is None:
        reward_csv = os.path.join(cfg.agent.save_result_dir, cfg.agent.reward_csv)
        reward_table = RewardTable.from_csv(reward_csv)
    agent = Agent(cfg, device=device)
    agent.memory_pool.basename_csv = cfg.agent.pretrain_csv
    stats = run_interactive_phase(
        cfg,
        registry,
        adapter,
        agent,
        reward_table=reward_table,
        subset=cfg.data.subset,
        expected_count=expected_count,
        log=log,
    )
    return stats, agent


def main(argv=None):
    import sys

    argv = argv if argv is not None else sys.argv[1:]
    cfg = configure(load_config("configs/config.yaml", [a for a in argv if "=" in a]))
    # the reference pins 30 baseline episodes per key (utils/utils_agent.py:20)
    return run(cfg, expected_count=30, device="cpu" if "--cpu" in argv else None)


if __name__ == "__main__":
    main()
