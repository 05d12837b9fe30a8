"""Agent Q-learning: ε-greedy rollouts and replay updates.

Counterpart of ``ivosw_tpu/train/train_agent.py``: phase 'train', seed
2019, 5 epochs (unless ``num_epochs`` > 1 is given), ``setting=oracle``,
``method=ours``. The replay pool is bootstrapped from
``{agent.save_result_dir}/{agent.pretrain_csv}`` with the ``sample_th``
quality-range filter, and the training set is restricted to the surviving
sequences. At each episode's end 3·rounds−1 Q-updates run on the agent's
device. An epoch snapshot (``{ckpt_dir}/agent_epoch_N``) is saved after
each epoch; a killed run resumes after its newest snapshot. On completion
``{ckpt_dir}/agent.pt`` (the policy Brain's state dict, which
``eval_agent`` loads) is written and the snapshots are removed.

CLI (from a directory holding ``configs/``):
``python -m ivosw_tpu_torch.train.train_agent [key=value ...] [--cpu]``
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
from ivosw_tpu_torch.utils.checkpoint import (
    clear_agent_epoch_snapshots,
    latest_agent_epoch,
    restore_agent,
    save_agent_checkpoint,
)


def configure(cfg: Config) -> Config:
    cfg.phase = "train"
    cfg.seed = 2019
    cfg.num_epochs = cfg.num_epochs if cfg.num_epochs > 1 else 5
    cfg.setting = "oracle"
    cfg.method = "ours"
    return cfg


def run(cfg: Config, registry=None, adapter=None, reward_table=None,
        expected_count=None, log=None, device=None):
    """The phase on ``device`` (None: CUDA, raises without one); returns
    (stats, agent)."""
    device = resolve_device(device)
    registry = registry or registry_from_config(cfg)
    adapter = adapter or build_backbone(cfg, registry, device)
    save_dir = cfg.agent.save_result_dir

    if reward_table is None:
        reward_csv = os.path.join(save_dir, cfg.agent.reward_csv)
        reward_table = RewardTable.from_csv(reward_csv)

    agent = Agent(cfg, device=device)
    pretrain_csv = os.path.join(save_dir, cfg.agent.pretrain_csv)
    seq_list = agent.memory_pool.load_from_csv(
        pretrain_csv, report_save_dir=save_dir, sample_th=cfg.agent.sample_th
    )

    # the plain agent.pt is written only on completion, so a killed run
    # never looks finished; its epoch snapshots are the resume points
    start_epoch = 1
    last = latest_agent_epoch(cfg.ckpt_dir)
    if last is not None and restore_agent(agent, cfg.ckpt_dir, name=f"agent_epoch_{last}"):
        start_epoch = last + 1
        (log.info if log else print)(
            f"resuming agent training from epoch snapshot {last} "
            f"(steps_done={agent.steps_done})"
        )

    def on_epoch_end(epoch):
        save_agent_checkpoint(agent, cfg.ckpt_dir, epoch=epoch)

    stats = run_interactive_phase(
        cfg,
        registry,
        adapter,
        agent,
        reward_table=reward_table,
        subset=cfg.data.subset,
        seq_list=seq_list,
        expected_count=expected_count,
        log=log,
        on_epoch_end=on_epoch_end,
        start_epoch=start_epoch,
    )
    save_agent_checkpoint(agent, cfg.ckpt_dir)
    clear_agent_epoch_snapshots(cfg.ckpt_dir)
    return stats, agent


def main(argv=None):
    import sys

    argv = argv if argv is not None else sys.argv[1:]
    cfg = configure(load_config("configs/config.yaml", [a for a in argv if "=" in a]))
    return run(cfg, expected_count=30, device="cpu" if "--cpu" in argv else None)


if __name__ == "__main__":
    main()
