"""Reward-baseline production: random-policy episodes → the reward table CSV.

Counterpart of ``ivosw_tpu/train/produce_reward.py``: phase 'baseline',
seed 2020, 30 epochs (unless ``num_epochs`` > 1 is given) of
``setting=wild``, ``method=random`` rollouts over the train subset in
``len_subseq``-frame windows; every transition is mirrored to
``{agent.save_result_dir}/{agent.reward_csv}`` (memory-pool schema). Its
per-(sequence, round, scribble parity) terminal qualities are the μ/σ
baseline of Eq. 3 (``goal_only_reward``).

CLI (from a directory holding ``configs/``):
``python -m ivosw_tpu_torch.train.produce_reward [key=value ...] [--cpu]``
"""

from __future__ import annotations

from ivosw_tpu_torch.core.config import Config, load_config
from ivosw_tpu_torch.data.registry import registry_from_config
from ivosw_tpu_torch.device import resolve_device
from ivosw_tpu_torch.eval.backbones import build_backbone
from ivosw_tpu_torch.models.agent import Agent
from ivosw_tpu_torch.train.rollout import run_interactive_phase


def configure(cfg: Config) -> Config:
    cfg.phase = "baseline"
    cfg.seed = 2020
    cfg.num_epochs = cfg.num_epochs if cfg.num_epochs > 1 else 30
    cfg.setting = "wild"
    cfg.method = "random"
    return cfg


def run(cfg: Config, registry=None, adapter=None, log=None, device=None):
    """The phase on ``device`` (None: CUDA, raises without one); returns
    (stats, agent)."""
    device = resolve_device(device)
    registry = registry or registry_from_config(cfg)
    adapter = adapter or build_backbone(cfg, registry, device)
    agent = Agent(cfg, device=device)
    agent.memory_pool.basename_csv = cfg.agent.reward_csv
    stats = run_interactive_phase(
        cfg, registry, adapter, agent, reward_table=None, subset=cfg.data.subset,
        log=log,
    )
    return stats, agent


def main(argv=None):
    import sys

    argv = argv if argv is not None else sys.argv[1:]
    cfg = configure(load_config("configs/config.yaml", [a for a in argv if "=" in a]))
    return run(cfg, device="cpu" if "--cpu" in argv else None)


if __name__ == "__main__":
    main()
