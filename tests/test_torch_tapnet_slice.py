"""The TAPNet slice: the port's ``evaluate`` with ``vos=tapnet`` against the
JAX package's, and against the committed TAPNet result cells.

Weights are the committed demo weights (``weights_demo``: TAPNet, AssessNet,
the wild agent), read into numpy by the JAX package's loader and converted.

1. ``wild``/``ours`` on a 48×64 clip (T=8, O=2, 2 rounds), with
   ``assess_net.bf16_inputs`` off and on: per-round frame picks identical;
   predicted qualities within ``QUALITY_ATOL`` of ``test_torch_slice.py``
   (3e-2, the bf16 scoring bound); the J&F curve within
   :data:`CURVE_ATOL` (TAPNet's masks differ by a few pixels near a
   decision, ``test_torch_tapnet.py``).
2. The committed ``results/tapnet/wild/synthetic/{linspace,random}`` cells
   (``demo_registry(seed=0)``: 48×64, O=2, 48 frames, 8 rounds): frame
   picks identical to the JAX package's evaluate on the same episodes (the
   committed files do not hold the picks; without ``slow`` the JAX
   package's evaluate replays the port's masks, under ``slow`` it runs its
   own TAPNet), the
   ``session_report.csv`` rows
   in the same order, and each episode round's mean J&F (over frames and
   objects) within :data:`EPISODE_ATOL` of the committed rows'. The
   committed rows come from a TPU, and one row may differ a lot where a
   small object's mask moves by a few pixels: over all 24 episodes the JAX
   package's own CPU run differs from them by up to 0.34 (J) and 0.53 (F)
   in single rows and 0.0053 in an episode round's mean; the port by up to
   0.31, 0.53 and 0.0084. Without ``slow`` the first :data:`N_EPISODES` episodes
   in registry order (chosen for time); all 24 under the ``slow`` marker,
   which also holds the ``summary.json`` AUC and curve to :data:`AUC_ATOL`
   (measured: JAX on the CPU 1.0e-4 and 3.0e-4, the port 3.9e-5 and
   4.8e-4).
"""

import csv
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ivosw_tpu.core.config import Config as JaxConfig
from ivosw_tpu.data.demo import demo_registry as jax_demo_registry
from ivosw_tpu.data.registry import SequenceRegistry as JaxRegistry
from ivosw_tpu.eval import eval_agent as jax_eval
from ivosw_tpu.interact import recommend as jax_recommend
from ivosw_tpu.models.agent import Agent as JaxAgent
from ivosw_tpu.models.fold import fold_assess_variables as jax_fold
from ivosw_tpu.models.vos.tapnet import TAPNetAdapter as JaxTAPNetAdapter
from ivosw_tpu.utils.checkpoint import load_pytree
from ivosw_tpu_torch.core.config import Config
from ivosw_tpu_torch.data.demo import demo_registry
from ivosw_tpu_torch.data.registry import SequenceRegistry
from ivosw_tpu_torch.eval import eval_agent
from ivosw_tpu_torch.interact import recommend
from ivosw_tpu_torch.models.agent import Agent
from ivosw_tpu_torch.models.assess import AssessNet
from ivosw_tpu_torch.models.fold import fold_assess_variables
from ivosw_tpu_torch.models.vos.tapnet import TAPNet, TAPNetAdapter
from ivosw_tpu_torch.utils.convert import (
    assess_state_dict_from_numpy,
    brain_state_dict_from_numpy,
    tapnet_state_dict_from_numpy,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QUALITY_ATOL = 3e-2
CURVE_ATOL = 1e-2
EPISODE_ATOL = 0.02
AUC_ATOL = 2e-3
N_EPISODES = 2
ROUNDS = 2


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Small tensors: two intra-op threads are as fast alone, and leave the
    cores to the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _numpy(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float32), tree)


@pytest.fixture(scope="module")
def demo_weights():
    load = lambda p: _numpy(load_pytree(os.path.join(REPO, "weights_demo", p), device=False))
    tapnet = load("tapnet.orbax")
    return (tapnet.get("params", tapnet), load("assess_net.orbax"),
            load("wild/agent.orbax")["params"])


def _port_tapnet(params, qa_dtype=torch.float32):
    net = TAPNet()
    net.load_state_dict(tapnet_state_dict_from_numpy(params))
    return TAPNetAdapter(net, qa_dtype=qa_dtype, device="cpu")


def _recording(monkeypatch, eval_module, recommend_module):
    picks, qualities = [], []
    rec, pcq = eval_module.recommend_frame, recommend_module.predict_clip_quality

    def recommend_frame(*args, **kwargs):
        picks.append(rec(*args, **kwargs))
        return picks[-1]

    def predict_clip_quality(*args, **kwargs):
        q, scores = pcq(*args, **kwargs)
        qualities.append(np.asarray(q))
        return q, scores

    monkeypatch.setattr(eval_module, "recommend_frame", recommend_frame)
    monkeypatch.setattr(recommend_module, "predict_clip_quality", predict_clip_quality)
    return picks, qualities


@pytest.mark.parametrize("bf16_inputs", [False, True])
def test_tapnet_wild_ours_matches_jax(demo_weights, tmp_path, monkeypatch, bf16_inputs):
    tapnet, assess_vars, agent_params = demo_weights
    kw = dict(phase="eval", setting="wild", method="ours", vos="tapnet", seed=0)
    clip = dict(num_frames=8, image_size=(64, 48), num_objects=2, seed=0)

    jcfg = JaxConfig(**kw)
    jcfg.assess_net.score_chunk = 8
    jcfg.assess_net.bf16_inputs = bf16_inputs
    jreg = JaxRegistry.synthetic(["alpha"], **clip)
    jreg.sequences["alpha"].num_scribbles = 1
    jagent = JaxAgent(jcfg, seed=0)
    jagent.params = jax.tree.map(jnp.asarray, agent_params)
    jadapter = JaxTAPNetAdapter(jax.tree.map(jnp.asarray, tapnet),
                                qa_dtype=jnp.bfloat16 if bf16_inputs else jnp.float32)
    jpicks, jq = _recording(monkeypatch, jax_eval, jax_recommend)
    ref = jax_eval.evaluate(
        jcfg, jreg, jadapter, agent=jagent, assess_variables=jax_fold(assess_vars),
        max_nb_interactions=ROUNDS, report_save_dir=str(tmp_path / "jax"),
    )

    cfg = Config(**kw)
    cfg.assess_net.score_chunk = 8
    cfg.assess_net.bf16_inputs = bf16_inputs
    reg = SequenceRegistry.synthetic(["alpha"], **clip)
    reg.sequences["alpha"].num_scribbles = 1
    agent = Agent(cfg, seed=0, device="cpu")
    agent.brain.load_state_dict(brain_state_dict_from_numpy(agent_params))
    net = AssessNet(fold=True)
    net.load_state_dict(fold_assess_variables(assess_state_dict_from_numpy(assess_vars)))
    adapter = _port_tapnet(tapnet, torch.bfloat16 if bf16_inputs else torch.float32)
    picks, q = _recording(monkeypatch, eval_agent, recommend)
    ours = eval_agent.evaluate(
        cfg, reg, adapter, agent=agent, assess_net=net.eval(),
        max_nb_interactions=ROUNDS, report_save_dir=str(tmp_path / "port"), device="cpu",
    )

    assert len(picks) == ROUNDS and picks == jpicks
    np.testing.assert_allclose(ours["curve"]["J_AND_F"], ref["curve"]["J_AND_F"], rtol=0,
                               atol=CURVE_ATOL)
    assert len(q) == len(jq) == ROUNDS
    np.testing.assert_allclose(np.stack(q), np.stack(jq), rtol=0, atol=QUALITY_ATOL)
    assert ours["timing"]["seg_time_avg"] > 0.0


def _episodes(n):
    reg = demo_registry(seed=0)
    return [(s, i) for s in reg.subset("val") for i in range(1, reg.info(s).num_scribbles + 1)][:n]


def _cell_config(config_cls, method):
    """The demo's evaluation config (scripts/demo_ordering.py base_config)."""
    cfg = config_cls(seed=0, vos="tapnet", dataset="synthetic", phase="eval", setting="wild",
                     method=method)
    cfg.assess_net.smooth_quality = 3
    return cfg


class _Replay:
    """A VOS adapter for the JAX package's evaluate that replays the port's
    segmentations round by round, so its session, robot and policy run on
    the same masks without the JAX TAPNet."""

    name = "tapnet"

    def __init__(self, outputs):
        self.outputs = iter(outputs)

    def begin_sequence(self, frames, num_objects):
        return None

    def segment(self, state, scribbles, annotated_frame, n_interaction):
        labels, all_p = next(self.outputs)
        return labels, all_p, state


def _reproduce_cell(demo_weights, tmp_path, monkeypatch, method, n, jax_tapnet):
    """The port's evaluate on the first n episodes of a committed cell, and
    the JAX package's evaluate on the same episodes: with its own TAPNet
    (``jax_tapnet``) or replaying the port's masks (its session, robot and
    policy on the port's segmentations)."""
    tapnet = demo_weights[0]
    samples = _episodes(n)
    picks, _ = _recording(monkeypatch, eval_agent, recommend)
    adapter, segmentations = _port_tapnet(tapnet), []
    segment = adapter.segment

    def recorded(*args, **kwargs):
        labels, all_p, state = segment(*args, **kwargs)
        segmentations.append((labels, all_p.numpy()))
        return labels, all_p, state

    adapter.segment = recorded
    ours = eval_agent.evaluate(
        _cell_config(Config, method), demo_registry(seed=0), adapter,
        max_nb_interactions=8, report_save_dir=str(tmp_path / "port"), samples=samples,
        device="cpu",
    )
    jpicks, _ = _recording(monkeypatch, jax_eval, jax_recommend)
    theirs = jax_eval.evaluate(
        _cell_config(JaxConfig, method), jax_demo_registry(seed=0),
        JaxTAPNetAdapter(jax.tree.map(jnp.asarray, tapnet)) if jax_tapnet
        else _Replay(segmentations),
        max_nb_interactions=8, report_save_dir=str(tmp_path / "jax"), samples=samples,
    )
    assert len(picks) == 8 * n and picks == jpicks

    cell = os.path.join(REPO, "results", "tapnet", "wild", "synthetic", method)
    keep = {(s, str(i)) for s, i in samples}
    ref = [r for r in csv.DictReader(open(os.path.join(cell, "session_report.csv")))
           if (r["sequence"], r["scribble_idx"]) in keep]
    key = lambda r: (r["sequence"], r["scribble_idx"], r["interaction"], r["object_id"], r["frame"])

    def episode_rounds(table):
        means = {}
        for r in table:
            jf = (float(r["jaccard"]) + float(r["contour"])) / 2.0
            means.setdefault(key(r)[:3], []).append(jf)
        return np.array([np.mean(v) for v in means.values()])

    committed = json.load(open(os.path.join(cell, "summary.json")))
    measured = {}
    for side, summary in (("port", ours), ("jax", theirs))[: 2 if jax_tapnet else 1]:
        rows = list(csv.DictReader(open(tmp_path / side / "session_report.csv")))
        assert [key(r) for r in rows] == [key(r) for r in ref]
        row_diff = {}
        for c in ("jaccard", "contour"):
            a, b = max(zip(rows, ref), key=lambda ab: abs(float(ab[0][c]) - float(ab[1][c])))
            # (sequence, scribble, round, object, frame): ours, committed
            row_diff[c] = {"max_abs_diff": abs(float(a[c]) - float(b[c])), "row": key(a),
                           "values": (a[c], b[c])}
        measured[side] = {
            "row_max_abs_diff": row_diff,
            "episode_round_max_abs_diff": float(
                np.abs(episode_rounds(rows) - episode_rounds(ref)).max()),
            "auc": summary["auc"], "committed_auc": committed["auc"],
        }
    # the numbers this file's docstring quotes, shown with pytest -s
    print(f"{method} {n} episodes vs the committed cell: {measured}")
    diff = measured["port"]["episode_round_max_abs_diff"]
    assert len(episode_rounds(ref)) == 8 * n and diff <= EPISODE_ATOL, diff
    return ours, committed


@pytest.mark.parametrize("method", ["linspace", "random"])
def test_committed_tapnet_cells_first_episodes(demo_weights, tmp_path, monkeypatch, method):
    _reproduce_cell(demo_weights, tmp_path, monkeypatch, method, N_EPISODES, jax_tapnet=False)


@pytest.mark.slow
@pytest.mark.parametrize("method", ["linspace", "random"])
def test_committed_tapnet_cells_all_episodes(demo_weights, tmp_path, monkeypatch, method):
    ours, ref = _reproduce_cell(demo_weights, tmp_path, monkeypatch, method, 24, jax_tapnet=True)
    assert abs(ours["auc"] - ref["auc"]) <= AUC_ATOL
    np.testing.assert_allclose(ours["curve"]["J_AND_F"], ref["curve"]["J_AND_F"], rtol=0,
                               atol=AUC_ATOL)
