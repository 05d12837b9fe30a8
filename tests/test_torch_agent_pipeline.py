"""The three-stage agent pipeline (produce_reward → pretrain_agent →
train_agent) in the JAX package and in the port, on test_training_pipeline.py's
setup (2 synthetic clips, 8 frames at 64×48, FakeVOS, 3 rounds, batch 4),
and the port's agent checkpoints.

The port's train stage starts from the JAX package's initial Brain (its
``train_agent.Agent`` factory is patched here, in the test). Then:
- ``reward.csv`` and ``pretrain.csv`` are identical text;
- ``memory_pool.csv`` agrees row for row: equal text, except the reward
  cells of the bootstrap rows, which the JAX package rewrote after parsing
  them with pandas (a few float64 ulps off, within SCALAR_ATOL = 1e-15,
  test_torch_agent_replay.py);
- the per-update losses agree within LOSS_RTOL = 1e-5 and the final params
  within ``1e-3·lr·updates + 2 ulp`` (test_torch_agent_update.py's bounds).
"""

import csv
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from ivosw_tpu.core.config import Config as JaxConfig
from ivosw_tpu.data.registry import SequenceRegistry as JaxRegistry
from ivosw_tpu.models.agent import Agent as JaxAgent
from ivosw_tpu.models.vos.fake import FakeVOS as JaxFakeVOS
from ivosw_tpu.train import pretrain_agent as jax_pretrain
from ivosw_tpu.train import produce_reward as jax_produce
from ivosw_tpu.train import train_agent as jax_train
from ivosw_tpu_torch.core.config import Config
from ivosw_tpu_torch.data.registry import SequenceRegistry
from ivosw_tpu_torch.models.agent import Agent
from ivosw_tpu_torch.models.vos.fake import FakeVOS
from ivosw_tpu_torch.train import pretrain_agent, produce_reward, train_agent
from ivosw_tpu_torch.utils.checkpoint import (
    clear_agent_epoch_snapshots,
    latest_agent_epoch,
    restore_agent,
    save_agent_checkpoint,
)
from ivosw_tpu_torch.utils.convert import brain_numpy_from_state_dict, brain_state_dict_from_numpy

LOSS_RTOL = 1e-5
SCALAR_ATOL = 1e-15
SCALARS = ("reward_step", "reward_done")
CLIPS = dict(num_frames=8, image_size=(64, 48), num_objects=1, split="train", seed=1)


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads: the Brain's ops are small, and under the tier-1
    run's six workers on eight cores OpenMP spinning over more threads
    slows them many times over."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _adapter(cls, registry):
    return cls(registry, base_quality=0.3, gain=0.5, tau=1.5, max_quality=0.75)


def _cfg(cls, root, **kw):
    cfg = cls(**kw)
    cfg.data.len_subseq = 6
    cfg.davis_interactive.max_nb_interactions = 3
    cfg.agent.save_result_dir = str(root / "train")
    cfg.agent.train_batch_size = 4
    cfg.ckpt_dir = str(root / "weights")
    return cfg


def _run(pkg, root, train_epochs=1, **run_kw):
    """The three stages of one package into ``root``; returns the train
    stage's (stats, agent)."""
    produce, pretrain, train, cfg_cls, reg_cls, fake = pkg
    registry = reg_cls.synthetic(["gamma", "delta"], **CLIPS)
    cfg = produce.configure(_cfg(cfg_cls, root))
    cfg.num_epochs = 2
    produce.run(cfg, registry=registry, adapter=_adapter(fake, registry), **run_kw)
    cfg = pretrain.configure(_cfg(cfg_cls, root))
    cfg.num_epochs = 2
    pretrain.run(cfg, registry=registry, adapter=_adapter(fake, registry), **run_kw)
    cfg = train.configure(_cfg(cfg_cls, root))
    cfg.num_epochs = train_epochs
    cfg.agent.sample_th = 0.01
    return train.run(cfg, registry=registry, adapter=_adapter(fake, registry), **run_kw)


JAX_PKG = (jax_produce, jax_pretrain, jax_train, JaxConfig, JaxRegistry, JaxFakeVOS)
PORT_PKG = (produce_reward, pretrain_agent, train_agent, Config, SequenceRegistry, FakeVOS)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("agent_pipeline")
    jax_losses, losses = [], []
    jax_update, update = JaxAgent.update_agent, Agent.update_agent
    init = {}

    def jax_recording(self, batch):
        jax_losses.append(jax_update(self, batch))
        return jax_losses[-1]

    def recording(self, batch):
        losses.append(update(self, batch))
        return losses[-1]

    def jax_initial_brain(cfg, device=None):
        """The port's agent with the JAX package's initial Brain."""
        params = jax.tree.map(np.array, JaxAgent(cfg).params)
        init["params"] = params
        agent = Agent(cfg, device=device)
        agent.brain.load_state_dict(brain_state_dict_from_numpy(params))
        agent.sync_target()
        return agent

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JaxAgent, "update_agent", jax_recording)
        mp.setattr(Agent, "update_agent", recording)
        mp.setattr(train_agent, "Agent", jax_initial_brain)
        jax_stats, jax_agent = _run(JAX_PKG, root / "jax")
        stats, agent = _run(PORT_PKG, root / "port", device="cpu")
    return dict(root=root, jax=(jax_stats, jax_agent, jax_losses), init=init["params"],
                port=(stats, agent, losses))


def test_stage_csvs_are_identical(runs):
    for name in ("reward.csv", "pretrain.csv"):
        ours = open(runs["root"] / "port" / "train" / name, newline="").read()
        theirs = open(runs["root"] / "jax" / "train" / name, newline="").read()
        assert ours == theirs and ours.count("\n") == 25, name


def test_memory_pool_agrees_row_for_row(runs):
    rows = {}
    for pkg in ("port", "jax"):
        with open(runs["root"] / pkg / "train" / "memory_pool.csv", newline="") as fp:
            rows[pkg] = list(csv.reader(fp))
    header = rows["port"][0]
    assert len(rows["port"]) == len(rows["jax"]) > 20
    for ours, theirs in zip(rows["port"], rows["jax"]):
        for name, x, y in zip(header, ours, theirs):
            if x != y:
                assert name in SCALARS and abs(float(x) - float(y)) <= SCALAR_ATOL, (name, x, y)


def test_train_stage_losses_and_params_match_jax(runs):
    jax_stats, jax_agent, jax_losses = runs["jax"]
    stats, agent, losses = runs["port"]
    assert len(losses) == len(jax_losses) == 6 * (3 * 3 - 1)
    np.testing.assert_allclose(losses, jax_losses, rtol=LOSS_RTOL)
    assert stats["episodes"] == jax_stats["episodes"] == 6
    assert stats["update_loss_avg"] == pytest.approx(jax_stats["update_loss_avg"], rel=LOSS_RTOL)
    assert stats["final_quality_avg"] == jax_stats["final_quality_avg"]
    assert agent.steps_done == jax_agent.steps_done > 0
    assert agent.host_rng.random() == jax_agent.host_rng.random()

    lr, n = agent.cfg.agent.lr, len(losses)
    got = brain_numpy_from_state_dict(agent.brain.state_dict())
    ref = jax.tree.map(np.asarray, jax_agent.params)
    moved = 0.0
    for name in ref:
        for leaf in ref[name]:
            bound = 1e-3 * lr * n + 2 * np.spacing(np.abs(ref[name][leaf]))
            assert (np.abs(got[name][leaf] - ref[name][leaf]) <= bound).all(), (name, leaf)
            moved = max(moved, float(np.abs(ref[name][leaf] - runs["init"][name][leaf]).max()))
    assert moved > 10 * 1e-3 * lr * n  # the updates moved the params past the bound


def test_train_stage_writes_agent_pt(runs):
    weights = runs["root"] / "port" / "weights"
    assert sorted(os.listdir(weights)) == ["agent.pt", "agent.train.pt"]
    state = torch.load(weights / "agent.pt", weights_only=True)
    agent = runs["port"][1]
    assert state.keys() == agent.brain.state_dict().keys()


# -------------------------------------------------------------- checkpoints --
def _trained_agent(seed=3, updates=5):
    cfg = Config(phase="train", seed=seed)
    cfg.agent.lr = 1e-3
    agent = Agent(cfg, device="cpu")
    rng = np.random.default_rng(seed)
    t = 10
    for _ in range(updates):
        agent.update_agent({
            "action": rng.integers(0, t, 8).astype(np.int32),
            "reward_step": np.ones(8, np.float32),
            "reward_done": rng.normal(size=8).astype(np.float32),
            "old_state_iou": rng.random((8, t), dtype=np.float32),
            "new_state_iou": rng.random((8, t), dtype=np.float32),
            "annotated_frames": np.zeros((8, t), np.float32),
            "next_annotated_frames": np.ones((8, t), np.float32),
        })
    agent.steps_done = 17
    return agent


def test_save_and_restore_agent(tmp_path):
    agent = _trained_agent()
    save_agent_checkpoint(agent, str(tmp_path))
    fresh = Agent(Config(phase="train", seed=11), device="cpu")
    assert restore_agent(fresh, str(tmp_path))
    state = np.random.default_rng(0).random((6, 2)).astype(np.float32)
    saved_q = agent.q_values(state)
    np.testing.assert_allclose(fresh.q_values(state), saved_q, rtol=0, atol=1e-6)
    assert fresh.steps_done == 17
    ours, theirs = fresh.optimizer.state_dict(), agent.optimizer.state_dict()
    assert ours["param_groups"] == theirs["param_groups"]
    for k, st in theirs["state"].items():
        for name, value in st.items():
            assert torch.equal(ours["state"][k][name], value), (k, name)
    # the target is a copy of the restored policy
    for p, t in zip(fresh.brain.parameters(), fresh.target.parameters()):
        assert torch.equal(p, t) and p.data_ptr() != t.data_ptr()
    # both go on training the same way
    batch = {
        "action": np.zeros(4, np.int32), "reward_step": np.ones(4, np.float32),
        "reward_done": np.ones(4, np.float32),
        "old_state_iou": np.full((4, 6), 0.5, np.float32),
        "new_state_iou": np.full((4, 6), 0.6, np.float32),
        "annotated_frames": np.zeros((4, 6), np.float32),
        "next_annotated_frames": np.ones((4, 6), np.float32),
    }
    agent.sync_target()
    assert fresh.update_agent(batch) == agent.update_agent(batch)

    # a Brain saved without its training state restores the Brain alone
    os.remove(tmp_path / "agent.train.pt")
    other = Agent(Config(phase="train", seed=12), device="cpu")
    assert restore_agent(other, str(tmp_path)) and other.steps_done == 0
    np.testing.assert_allclose(other.q_values(state), saved_q, rtol=0, atol=1e-6)


def test_restore_without_checkpoint_and_foreign_layout(tmp_path):
    agent = Agent(Config(seed=0), device="cpu")
    assert not restore_agent(agent, str(tmp_path))
    assert not restore_agent(agent, str(tmp_path), name="agent_epoch_3")
    # the reference's own agent.pt layout is not read: it fails loudly
    torch.save({"fc1.weight": torch.zeros(128, 2)}, tmp_path / "agent.pt")
    with pytest.raises(RuntimeError, match="state_dict"):
        restore_agent(agent, str(tmp_path))


def test_epoch_snapshots(tmp_path):
    agent = _trained_agent(updates=1)
    assert latest_agent_epoch(str(tmp_path)) is None
    assert latest_agent_epoch(str(tmp_path / "missing")) is None
    for epoch in (1, 3, 2):
        save_agent_checkpoint(agent, str(tmp_path), epoch=epoch)
    save_agent_checkpoint(agent, str(tmp_path))
    (tmp_path / "agent_epoch_x.pt").write_bytes(b"")
    assert latest_agent_epoch(str(tmp_path)) == 3
    assert clear_agent_epoch_snapshots(str(tmp_path)) == 3
    assert latest_agent_epoch(str(tmp_path)) is None
    assert sorted(os.listdir(tmp_path)) == ["agent.pt", "agent.train.pt", "agent_epoch_x.pt"]


def test_train_agent_resumes_from_epoch_snapshot(tmp_path):
    """A killed train stage resumes after its newest epoch snapshot; the
    plain agent.pt appears only on completion and the snapshots go (as
    test_training_pipeline.py::test_train_agent_resume_from_epoch_snapshot
    for the JAX package)."""
    _, full = _run(PORT_PKG, tmp_path, train_epochs=2, device="cpu")
    weights = tmp_path / "weights"
    assert (weights / "agent.pt").exists() and latest_agent_epoch(str(weights)) is None

    # a kill after epoch 1: its snapshot present, no agent.pt
    save_agent_checkpoint(full, str(weights), epoch=1)
    os.remove(weights / "agent.pt")
    os.remove(weights / "agent.train.pt")
    assert latest_agent_epoch(str(weights)) == 1

    epochs = []
    orig = train_agent.run_interactive_phase

    def recording(*args, **kwargs):
        epochs.append(kwargs["start_epoch"])
        return orig(*args, **kwargs)

    cfg = train_agent.configure(_cfg(Config, tmp_path))
    cfg.num_epochs = 2
    cfg.agent.sample_th = 0.01
    registry = SequenceRegistry.synthetic(["gamma", "delta"], **CLIPS)
    train_agent.run_interactive_phase = recording
    try:
        _, resumed = train_agent.run(cfg, registry=registry,
                                     adapter=_adapter(FakeVOS, registry), device="cpu")
    finally:
        train_agent.run_interactive_phase = orig
    assert epochs == [2]
    assert resumed.steps_done > full.steps_done  # restored, then one more epoch
    assert (weights / "agent.pt").exists() and latest_agent_epoch(str(weights)) is None


def test_build_and_evaluate_reads_trained_agent(runs, tmp_path, monkeypatch):
    """``eval_agent.build_and_evaluate(method=ours)`` loads the trained
    ``agent.pt`` into its agent."""
    from ivosw_tpu_torch.eval import eval_agent

    ckpt = tmp_path / "weights"
    shutil.copytree(runs["root"] / "port" / "weights", ckpt)
    seen = {}

    def evaluate(cfg, registry, adapter, agent=None, **kwargs):
        seen["agent"] = agent
        return {}

    monkeypatch.setattr(eval_agent, "evaluate", evaluate)
    cfg = Config(phase="eval", setting="oracle", method="ours", vos="fake", dataset="demo",
                 ckpt_dir=str(ckpt))
    eval_agent.build_and_evaluate(cfg, device="cpu")
    state = np.random.default_rng(1).random((6, 2)).astype(np.float32)
    np.testing.assert_allclose(seen["agent"].q_values(state), runs["port"][1].q_values(state),
                               rtol=0, atol=1e-6)
