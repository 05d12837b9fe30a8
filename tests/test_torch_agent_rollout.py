"""The wild-state Q-learning rollout: ``run_interactive_phase`` with
``phase=train``, ``setting=wild``, ``method=ours`` in the JAX package and
in the port, FakeVOS on test_torch_slice.py's clip, the demo AssessNet
(BN-folded, bf16 scoring) and the demo wild agent carried across into both
policy and target, a seeded reward table and a replay pool bootstrapped
from ``train_demo/pretrain.csv`` so the episode ends with Q-updates.

Picks and rewards must be identical; the recorded (predicted) states agree
within QUALITY_ATOL = 3e-2, the bf16 scoring bound of test_torch_slice.py;
the episodes' update losses within LOSS_RTOL = 1e-5, float32 sums in
other orders (each batch drawn here comes from the bootstrapped pool's
transitions, which both sides read from the same CSV: measured 2.0e-7
relative; the predicted qualities differed by at most 8.0e-3)."""

import os

import jax
import numpy as np
import pytest
import torch

from ivosw_tpu.core.config import Config as JaxConfig
from ivosw_tpu.data.registry import SequenceRegistry as JaxRegistry
from ivosw_tpu.interact import recommend as jax_recommend
from ivosw_tpu.interact.recommend import RewardTable as JaxRewardTable
from ivosw_tpu.models.agent import Agent as JaxAgent
from ivosw_tpu.models.fold import fold_assess_variables as jax_fold
from ivosw_tpu.models.vos.fake import FakeVOS as JaxFakeVOS
from ivosw_tpu.train import rollout as jax_rollout
from ivosw_tpu.utils.checkpoint import load_pytree
from ivosw_tpu_torch.core.config import Config
from ivosw_tpu_torch.data.registry import SequenceRegistry
from ivosw_tpu_torch.interact import recommend
from ivosw_tpu_torch.interact.recommend import RewardTable
from ivosw_tpu_torch.kernels.roi_crop import roi_crop_pairs_fusedbox
from ivosw_tpu_torch.models.agent import Agent
from ivosw_tpu_torch.models.assess import AssessNet
from ivosw_tpu_torch.models.fold import fold_assess_variables
from ivosw_tpu_torch.models.vos.fake import FakeVOS
from ivosw_tpu_torch.train import rollout
from ivosw_tpu_torch.utils.convert import (
    assess_state_dict_from_numpy,
    brain_state_dict_from_numpy,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QUALITY_ATOL = 3e-2
LOSS_RTOL = 1e-5
ROUNDS = 3
BATCH = 4
CLIP = dict(num_frames=8, image_size=(64, 48), num_objects=2, split="train", seed=0)


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads: the Brain's ops are small, and under the tier-1
    run's six workers on eight cores OpenMP spinning over more threads
    slows them many times over."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def demo_weights():
    load = lambda p: load_pytree(os.path.join(REPO, "weights_demo", p), device=False)
    to_np = lambda tree: jax.tree.map(lambda x: np.asarray(x, np.float32), tree)
    return to_np(load("assess_net.orbax")), to_np(load("wild/agent.orbax")["params"])


def _table(cls):
    """Seeded baselines for the clip: 5 per (round, scribble parity)."""
    table = cls()
    rng = np.random.default_rng(3)
    for n in range(2, ROUNDS + 1):
        for scribble_iter in (1, 2, 3):
            for v in rng.uniform(0.3, 0.9, 5):
                table.add("alpha", n, scribble_iter, float(v))
    return table


def _cfg(cls, tmp_path, name):
    cfg = cls(phase="train", setting="wild", method="ours", vos="fake", seed=5)
    cfg.num_epochs = 1
    cfg.data.len_subseq = 25
    cfg.davis_interactive.max_nb_interactions = ROUNDS
    cfg.agent.train_batch_size = BATCH
    cfg.agent.update_rate = 0.5
    cfg.agent.save_result_dir = str(tmp_path / name)
    cfg.assess_net.score_chunk = 8
    return cfg


def _record(monkeypatch, rollout_module, recommend_module, agent_cls):
    """Each round's pick and predicted quality, and each update's loss."""
    picks, qualities, losses = [], [], []
    rec, pcq = rollout_module.recommend_frame, recommend_module.predict_clip_quality
    update = agent_cls.update_agent

    def recommend_frame(*args, **kwargs):
        picks.append(rec(*args, **kwargs))
        return picks[-1]

    def predict_clip_quality(*args, **kwargs):
        q, scores = pcq(*args, **kwargs)
        qualities.append(np.asarray(q))
        return q, scores

    def update_agent(self, batch):
        losses.append(update(self, batch))
        return losses[-1]

    monkeypatch.setattr(rollout_module, "recommend_frame", recommend_frame)
    monkeypatch.setattr(recommend_module, "predict_clip_quality", predict_clip_quality)
    monkeypatch.setattr(agent_cls, "update_agent", update_agent)
    return picks, qualities, losses


def _newest(pool, k):
    return [pool.memory[(pool.position - i) % pool.capacity] for i in reversed(range(k))]


def test_wild_rollout_matches_jax(demo_weights, tmp_path, monkeypatch):
    assess_vars, agent_params = demo_weights
    pool_csv = os.path.join(REPO, "train_demo", "pretrain.csv")

    jcfg = _cfg(JaxConfig, tmp_path, "jax")
    jreg = JaxRegistry.synthetic(["alpha"], **CLIP)
    jreg.sequences["alpha"].num_scribbles = 2
    jagent = JaxAgent(jcfg)
    jagent.params = jax.tree.map(jax.numpy.asarray, agent_params)
    jagent.target_params = jax.tree.map(jax.numpy.asarray, agent_params)
    jagent.memory_pool.load_from_csv(pool_csv, sample_th=0.05)
    jpicks, jq, jlosses = _record(monkeypatch, jax_rollout, jax_recommend, JaxAgent)
    jax_rollout.run_interactive_phase(
        jcfg, jreg, JaxFakeVOS(jreg), jagent, reward_table=_table(JaxRewardTable),
        assess_variables=jax_fold(assess_vars),
    )

    cfg = _cfg(Config, tmp_path, "port")
    reg = SequenceRegistry.synthetic(["alpha"], **CLIP)
    reg.sequences["alpha"].num_scribbles = 2
    agent = Agent(cfg, device="cpu")
    agent.brain.load_state_dict(brain_state_dict_from_numpy(agent_params))
    agent.sync_target()
    agent.memory_pool.load_from_csv(pool_csv, sample_th=0.05)
    net = AssessNet(fold=True)
    net.load_state_dict(fold_assess_variables(assess_state_dict_from_numpy(assess_vars)))
    picks, q, losses = _record(monkeypatch, rollout, recommend, Agent)
    launches = roi_crop_pairs_fusedbox.launches
    stats = rollout.run_interactive_phase(
        cfg, reg, FakeVOS(reg), agent, reward_table=_table(RewardTable),
        assess_net=net.eval(),
    )
    assert roi_crop_pairs_fusedbox.launches == launches  # the plain crop on the CPU

    # two episodes of ROUNDS rounds; each ends with 3·ROUNDS − 1 updates
    assert stats["episodes"] == 2 and len(picks) == 2 * ROUNDS
    assert picks == jpicks
    np.testing.assert_allclose(np.stack(q), np.stack(jq), rtol=0, atol=QUALITY_ATOL)
    assert len(losses) == len(jlosses) == 2 * (3 * ROUNDS - 1)
    np.testing.assert_allclose(losses, jlosses, rtol=LOSS_RTOL)
    assert agent.steps_done == jagent.steps_done
    assert agent.host_rng.random() == jagent.host_rng.random()

    # the rollout's transitions, the newest of the ring (the bootstrap
    # shrank its capacity to the loaded count, so they replace old ones)
    ours, ref = _newest(agent.memory_pool, 2 * (ROUNDS - 1)), _newest(
        jagent.memory_pool, 2 * (ROUNDS - 1))
    for a, b in zip(ours, ref):
        assert (a.sequence, a.scribble_iter, a.n_interaction, a.action, a.done) == (
            b.sequence, b.scribble_iter, b.n_interaction, b.action, b.done)
        assert (a.reward_step, a.reward_done) == (b.reward_step, b.reward_done)
        assert len(a.state_iou) == CLIP["num_frames"]
        np.testing.assert_allclose(a.state_iou, b.state_iou, rtol=0, atol=QUALITY_ATOL)
        np.testing.assert_allclose(a.next_state_iou, b.next_state_iou, rtol=0,
                                   atol=QUALITY_ATOL)
        np.testing.assert_array_equal(a.annotated_frames, b.annotated_frames)
        np.testing.assert_array_equal(a.next_annotated_frames, b.next_annotated_frames)
    # the states are the predicted qualities the policy acted on, not J&F
    np.testing.assert_array_equal(ours[0].state_iou, q[0].astype(np.float32))
    np.testing.assert_array_equal(ours[0].next_state_iou, q[1].astype(np.float32))
