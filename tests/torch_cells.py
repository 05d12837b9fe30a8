"""The committed ``results/{vos}/{setting}/synthetic/{method}`` cells, run by
the port's ``evaluate`` on the CPU and held against the cell's rows and
against the JAX package's ``evaluate`` on the same episodes (shared by
``test_torch_{tapnet,matchnet,ipnet}_slice.py`` and
``test_torch_{tapnet,matchnet,ipnet}_cells_qa.py``); the cells read from
dataset trees (``ytbvos-demo``, ``davis-fake``: :func:`registries`,
``test_torch_dataset_cells.py``) are held the same way.

A cell is ``scripts/demo_ordering.py``'s evaluation: ``demo_registry(seed=0)``
(48×64, O=2, 48 frames, 8 rounds per episode, the 24 ``val`` episodes),
the committed demo weights (``weights_demo``: the backbone, AssessNet for
wild ``worst``/``ours``, the oracle agent for oracle ``ours``, the wild
agent for wild ``ours``), ``assess_net.smooth_quality`` 3. Weights are read
into numpy by the JAX package's loader and converted. Two settings differ
from the script's, both of which its config calls pure speed knobs: the
AssessNet is BN-folded on both sides (``assess_net.fold_inference``, the
command line's default; the script scored with the unfolded net, which the
port runs 2.5 times slower on the CPU), and ``assess_net.score_chunk`` is
16, so the 48 frames fill three blocks with no padded frame.

What is held:

- the frame picks. The JAX package's ``evaluate`` follows the port's
  picks, so both sessions walk the same episode, and at every round its own
  pick is compared with the port's. With ``jax_backbone=False`` (tier-1)
  it replays the port's segmentations and predicted qualities round by
  round, so its session, robot, smoothing and policy decide on the port's
  numbers: the picks must be equal. (AssessNet's parity is held in
  ``test_torch_tapnet_slice.py`` and ``test_torch_assess.py``; scoring
  48 frames of both objects every round in both packages made the tier-1
  run too slow.) With ``True`` (``slow``) it runs its own backbone and
  AssessNet, so the ``worst``/``ours`` picks rest on other masks and
  scores and may differ: each such flip is counted and printed (``-s``),
  and the port is held to the JAX package's own J&F on the same walk.
  The committed files do not hold the picks;
- the ``session_report.csv`` rows in the same order, and each episode
  round's mean J&F (over frames and objects) within :data:`EPISODE_ATOL`
  of the committed rows'. The committed rows come from a TPU, where one row
  may differ a lot when a small object's mask moves by a few pixels
  (``ROADMAP.md`` §3). In the ``worst`` and ``ours`` cells the TPU's picks
  rest on its own bf16 masks (oracle) or QA scores (wild), so after round
  1 the committed episode may be another walk: there round 1 is held to
  :data:`EPISODE_ATOL` and every round to :data:`WALK_EPISODE_ATOL`, set
  from the JAX package's own CPU runs; ``linspace`` and ``random`` pick
  alike on every host, and every round is held to :data:`EPISODE_ATOL`;
- over all 24 episodes (``slow``, ``jax_backbone=True``): the
  ``summary.json`` AUC and curve within :data:`AUC_ATOL` of the committed
  cell's (``linspace``/``random``). For ``worst``/``ours``: the AUC within
  :data:`WALK_AUC_ATOL` of the committed cell's, and each episode round
  within :data:`EPISODE_ATOL`, the AUC and the curve within
  :data:`AUC_ATOL` of the JAX package's own backbone on the port's walk
  (the committed curve follows the TPU's walk: matchnet wild ``worst``
  differs from it by 6.1e-3 in round 2 while the AUC is within 9.0e-4).

Tier-1 runs the first two episodes of a cell, and the first one of the
wild ``worst``/``ours`` cells (each of their rounds scores 48 frames of
both objects with the ResNet-50 AssessNet; with two the whole tier-1 run
came within 180 s of its 1470 s limit).
"""

import csv
import json
import os
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import torch

from ivosw_tpu.core.config import Config as JaxConfig
from ivosw_tpu.core.config import load_config as jax_load_config
from ivosw_tpu.data.demo import demo_registry as jax_demo_registry
from ivosw_tpu.data.registry import SequenceRegistry as JaxRegistry
from ivosw_tpu.eval import eval_agent as jax_eval
from ivosw_tpu.interact import recommend as jax_recommend
from ivosw_tpu.models.agent import Agent as JaxAgent
from ivosw_tpu.models.assess import init_assess_variables as jax_init_assess
from ivosw_tpu.models.fold import fold_assess_variables as jax_fold
from ivosw_tpu.models.vos.ipnet import IPNetAdapter as JaxIPNetAdapter
from ivosw_tpu.models.vos.fake import FakeVOS as JaxFakeVOS
from ivosw_tpu.models.vos.matchnet import MatchNetAdapter as JaxMatchNetAdapter
from ivosw_tpu.models.vos.tapnet import TAPNetAdapter as JaxTAPNetAdapter
from ivosw_tpu.utils.checkpoint import load_pytree
from ivosw_tpu_torch.core.config import Config
from ivosw_tpu_torch.core.config import load_config
from ivosw_tpu_torch.data.demo import demo_registry
from ivosw_tpu_torch.data.registry import SequenceRegistry
from ivosw_tpu_torch.eval import eval_agent
from ivosw_tpu_torch.interact import recommend
from ivosw_tpu_torch.models.agent import Agent
from ivosw_tpu_torch.models.assess import AssessNet
from ivosw_tpu_torch.models.fold import fold_assess_variables
from ivosw_tpu_torch.models.vos.fake import FakeVOS
from ivosw_tpu_torch.models.vos.ipnet import IPNet, IPNetAdapter
from ivosw_tpu_torch.models.vos.matchnet import MatchNet, MatchNetAdapter
from ivosw_tpu_torch.models.vos.tapnet import TAPNet, TAPNetAdapter
from ivosw_tpu_torch.utils.convert import (
    assess_state_dict_from_numpy,
    brain_state_dict_from_numpy,
    ipnet_state_dict_from_numpy,
    matchnet_state_dict_from_numpy,
    tapnet_state_dict_from_numpy,
)
from torch_dataset_trees import YTBVOS_DST, write_mini_davis

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EPISODE_ATOL = 0.02
# worst/ours after round 1: the committed rows follow the TPU's picks, which
# rest on its bf16 masks (oracle: their J&F) and QA scores (wild); over the
# first two episodes the JAX package's own CPU run (folded AssessNet) misses
# them by up to 0.054 in an episode round's mean (wild: tapnet 0.051 worst,
# 0.054 ours; matchnet 0.024, 0.0069; ipnet 0.019, 0.029; oracle ours:
# tapnet 0.044)
WALK_EPISODE_ATOL = 0.08
AUC_ATOL = 2e-3
# worst/ours over all 24 episodes: the JAX package's own CPU runs miss the
# committed AUC by up to 2.6e-3 (ipnet oracle worst; the other oracle cells
# 1.6e-5 to 4.7e-4), and single episode rounds by up to 0.136
WALK_AUC_ATOL = 5e-3
# committed cells whose rows the JAX package's own CPU run misses beyond
# EPISODE_ATOL even where no pick rests on the host's numbers (ROADMAP §3):
# the port is held to the JAX package's own run on the same walk instead,
# and the test fails once the JAX package reproduces the cell again.
# (vos, setting, method, dataset) → the JAX package's own gap, measured
JAX_MISSES_COMMITTED = {
    # dm-v0 scribble 1, round 3: object 2 is lost on the CPU, found on the
    # TPU (episode-round mean 0.534 against 0.754; first episode 0.2193)
    ("tapnet", "wild", "linspace", "ytbvos-demo"): 0.2193,
}
ROUNDS = 8
SMOOTH = 3  # assess_net.smooth_quality of the demo's evaluation
SCORE_CHUNK = 16  # frames per scoring block: 48 frames, no padded ones

BACKBONES = {
    "tapnet": (TAPNet, TAPNetAdapter, tapnet_state_dict_from_numpy, JaxTAPNetAdapter),
    "matchnet": (MatchNet, MatchNetAdapter, matchnet_state_dict_from_numpy, JaxMatchNetAdapter),
    "ipnet": (IPNet, IPNetAdapter, ipnet_state_dict_from_numpy, JaxIPNetAdapter),
}


@lru_cache(maxsize=None)
def demo_weights(path):
    """A tree of ``weights_demo`` as float32 numpy arrays, without a
    top-level ``"params"``."""
    tree = load_pytree(os.path.join(REPO, "weights_demo", path), device=False)
    tree = jax.tree.map(lambda x: np.asarray(x, np.float32), tree)
    return tree["params"] if "params" in tree and "batch_stats" not in tree else tree


def port_adapter(vos, params, qa_dtype=torch.float32):
    net_cls, adapter_cls, convert, _ = BACKBONES[vos]
    net = net_cls()
    net.load_state_dict(convert(params))
    return adapter_cls(net, qa_dtype=qa_dtype, device="cpu")


def recording(monkeypatch, eval_module, recommend_module):
    """Record each round's pick and predicted qualities of ``evaluate``;
    ``picks.states`` holds the per-frame values each pick rested on (the
    smoothed predicted qualities in the wild setting, else the masks' J&F)."""
    picks, qualities = Picks(), []
    rec, pcq = eval_module.recommend_frame, recommend_module.predict_clip_quality

    def recommend_frame(*args, **kwargs):
        picks.append(rec(*args, **kwargs))
        state = kwargs["mask_quality"]  # filled in place by wild worst/ours
        picks.states.append(np.array(
            kwargs["new_masks_quality"] if state is None else state, np.float64))
        return picks[-1]

    def predict_clip_quality(*args, **kwargs):
        q, scores = pcq(*args, **kwargs)
        qualities.append(np.asarray(q))
        return q, scores

    monkeypatch.setattr(eval_module, "recommend_frame", recommend_frame)
    monkeypatch.setattr(recommend_module, "predict_clip_quality", predict_clip_quality)
    return picks, qualities


class Picks(list):
    def __init__(self):
        super().__init__()
        self.states = []


# a cell's dataset → its results directory name and episode count
DATASETS = {"synthetic": ("synthetic", 24), "ytbvos-demo": ("ytbvos-demo", 24),
            "davis-fake": ("davis", 6)}


def registries(dataset, tmp_path):
    """(the port's registry, the JAX package's) of a cell's dataset: the
    demo registry (``synthetic``), the committed YouTube-VOS demo tree read
    by ``from_json`` (``ytbvos-demo``, ``scripts/demo_ytbvos.py``), or the
    mini-DAVIS tree read by ``from_davis_root``
    (``davis-fake``), written under ``tmp_path``."""
    if dataset == "synthetic":
        return demo_registry(seed=0), jax_demo_registry(seed=0)
    if dataset == "ytbvos-demo":
        path = os.path.join(YTBVOS_DST, "scb_ytbvos.json")
        return SequenceRegistry.from_json(path), JaxRegistry.from_json(path)
    root = write_mini_davis(str(tmp_path / "mini_davis"))
    return SequenceRegistry.from_davis_root(root), JaxRegistry.from_davis_root(root)


def episodes(n, registry=None):
    reg = registry or demo_registry(seed=0)
    return [(s, i) for s in reg.subset("val") for i in range(1, reg.info(s).num_scribbles + 1)][:n]


def cell_config(config_cls, vos, setting, method, dataset="synthetic"):
    """A cell's evaluation config: the demo's (scripts/demo_ordering.py and
    scripts/demo_ytbvos.py base_config), or for ``davis-fake`` the
    command line's (configs/config.yaml with the cell's overrides)."""
    if dataset == "davis-fake":
        load = load_config if config_cls is Config else jax_load_config
        cfg = load(os.path.join(REPO, "configs", "config.yaml"),
                   ["dataset=davis", f"vos={vos}", f"setting={setting}", f"method={method}"])
        cfg.phase = "eval"
        return cfg
    cfg = config_cls(seed=0, vos=vos, dataset="ytbvos" if dataset == "ytbvos-demo" else dataset,
                     phase="eval", setting=setting, method=method)
    cfg.assess_net.smooth_quality = SMOOTH
    cfg.assess_net.score_chunk = SCORE_CHUNK
    return cfg


class Replay:
    """A VOS adapter for the JAX package's evaluate that replays the port's
    segmentations round by round, so its session, robot and policy run on
    the same masks without its own backbone."""

    def __init__(self, vos, outputs):
        self.name = vos
        self.outputs = iter(outputs)

    def begin_sequence(self, frames, num_objects):
        return None

    def segment(self, state, scribbles, annotated_frame, n_interaction):
        labels, all_p = next(self.outputs)
        return labels, all_p, state


def _numpy_tree(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float32), tree)


def _policy(vos, setting, method, dataset="synthetic"):
    """(port agent, port AssessNet, JAX agent, JAX assess variables) of a
    cell; None where the cell needs none. The demo's cells use the
    committed demo weights; ``davis-fake`` the JAX command line's seeded
    init (no checkpoint), converted."""
    agent = assess_net = jax_agent = assess_vars = None
    if method == "ours":
        jcfg = cell_config(JaxConfig, vos, setting, method, dataset)
        if dataset == "davis-fake":
            jax_agent = JaxAgent(jcfg)
            brain = _numpy_tree(jax_agent.params)
        else:
            brain = demo_weights("wild/agent.orbax" if setting == "wild" else "agent.orbax")
            jax_agent = JaxAgent(jcfg, seed=0)
            jax_agent.params = jax.tree.map(jnp.asarray, brain)
        agent = Agent(cell_config(Config, vos, setting, method, dataset), seed=0, device="cpu")
        agent.brain.load_state_dict(brain_state_dict_from_numpy(brain))
    if setting == "wild" and method in ("ours", "worst"):
        if dataset == "davis-fake":
            assess_vars = _numpy_tree(jax_init_assess(jax.random.PRNGKey(0)))
        else:
            assess_vars = demo_weights("assess_net.orbax")
        assess_net = AssessNet(fold=True)
        assess_net.load_state_dict(
            fold_assess_variables(assess_state_dict_from_numpy(assess_vars)))
        assess_net.eval()
        assess_vars = jax_fold(assess_vars)
    return agent, assess_net, jax_agent, assess_vars


def _flips(method, picks, jpicks, same_inputs):
    """Rounds whose picks differ, each with both frames' values in the two
    packages' states. On the same masks and qualities (``same_inputs``) no
    pick may differ; with each package's own backbone and AssessNet the
    ``worst``/``ours`` picks rest on other numbers and may (the walk stays
    the port's)."""
    flips = []
    for i, (a, b) in enumerate(zip(picks, jpicks)):
        if a == b:
            continue
        sp, sj = picks.states[i], jpicks.states[i]
        flip = {"round_index": i, "port_pick": a, "jax_pick": b,
                "port_values": (float(sp[a]), float(sp[b])),
                "jax_values": (float(sj[a]), float(sj[b]))}
        flips.append(flip)
        assert method in ("worst", "ours") and not same_inputs, flip
    return flips


def reproduce_cell(tmp_path, monkeypatch, vos, setting, method, n, jax_backbone,
                   dataset="synthetic"):
    """The port's evaluate on the first n episodes of a committed cell, and
    the JAX package's evaluate on the same episodes, following the port's
    picks (with its own backbone when ``jax_backbone``, else replaying the
    port's segmentations). Returns what was measured."""
    held_to_jax = (vos, setting, method, dataset) in JAX_MISSES_COMMITTED
    jax_backbone = jax_backbone or held_to_jax
    registry, jax_registry = registries(dataset, tmp_path)
    samples = episodes(n, registry)
    agent, assess_net, jax_agent, assess_vars = _policy(vos, setting, method, dataset)
    picks, qualities = recording(monkeypatch, eval_agent, recommend)
    if vos == "fake":
        adapter, jax_adapter = FakeVOS(registry), JaxFakeVOS(jax_registry)
    else:
        params = demo_weights(f"{vos}.orbax")
        adapter = port_adapter(vos, params)
        jax_adapter = BACKBONES[vos][3](jax.tree.map(jnp.asarray, params))
    segmentations = []
    segment = adapter.segment

    def recorded(*args, **kwargs):
        labels, all_p, state = segment(*args, **kwargs)
        segmentations.append((labels, np.asarray(all_p)))
        return labels, all_p, state

    adapter.segment = recorded
    ours = eval_agent.evaluate(
        cell_config(Config, vos, setting, method, dataset), registry, adapter,
        agent=agent, assess_net=assess_net, max_nb_interactions=ROUNDS,
        report_save_dir=str(tmp_path / "port"), samples=samples, device="cpu",
    )
    if not jax_backbone:  # the port's predicted qualities, round by round
        port_scores = iter(qualities)
        monkeypatch.setattr(jax_recommend, "predict_clip_quality",
                            lambda *args, **kwargs: (next(port_scores), None))
    jpicks, jqualities = recording(monkeypatch, jax_eval, jax_recommend)
    jax_pick = jax_eval.recommend_frame

    def follow(*args, **kwargs):  # the JAX package's pick, then the port's
        jax_pick(*args, **kwargs)
        return picks[len(jpicks) - 1]

    monkeypatch.setattr(jax_eval, "recommend_frame", follow)
    theirs = jax_eval.evaluate(
        cell_config(JaxConfig, vos, setting, method, dataset), jax_registry,
        jax_adapter if jax_backbone else Replay(vos, segmentations),
        agent=jax_agent, assess_variables=assess_vars, max_nb_interactions=ROUNDS,
        report_save_dir=str(tmp_path / "jax"), samples=samples,
    )

    cell_dir, n_all = DATASETS[dataset]
    cell = os.path.join(REPO, "results", vos, setting, cell_dir, method)
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
    assert len(picks) == len(jpicks) == ROUNDS * n
    assert len(qualities) == len(jqualities)
    measured = {"flips": _flips(method, picks, jpicks, not jax_backbone)}
    if qualities:
        measured["quality_max_abs_diff"] = float(
            np.abs(np.stack(qualities) - np.stack(jqualities)).max())
    tables = {}
    for side, summary in (("port", ours), ("jax", theirs))[: 2 if jax_backbone else 1]:
        rows = list(csv.DictReader(open(tmp_path / side / "session_report.csv")))
        assert [key(r) for r in rows] == [key(r) for r in ref]
        tables[side] = episode_rounds(rows)
        row_diff = {}
        for c in ("jaccard", "contour"):
            a, b = max(zip(rows, ref), key=lambda ab: abs(float(ab[0][c]) - float(ab[1][c])))
            # (sequence, scribble, round, object, frame): ours, committed
            row_diff[c] = {"max_abs_diff": abs(float(a[c]) - float(b[c])), "row": key(a),
                           "values": (a[c], b[c])}
        rounds_diff = np.abs(tables[side] - episode_rounds(ref))
        measured[side] = {
            "row_max_abs_diff": row_diff,
            "episode_round_max_abs_diff": float(rounds_diff.max()),
            "round1_max_abs_diff": float(rounds_diff[::ROUNDS].max()),
            "auc": summary["auc"], "committed_auc": committed["auc"],
        }
    if jax_backbone:  # the two packages' own backbones on the same walk
        measured["port_vs_jax_episode_round_max_abs_diff"] = float(
            np.abs(tables["port"] - tables["jax"]).max())
    # the numbers the test files' docstrings quote, shown with pytest -s
    print(f"{vos} {setting}/{method} {dataset} {n} episodes vs the committed cell: {measured}")
    port = measured["port"]
    assert len(episode_rounds(ref)) == ROUNDS * n
    assert port["round1_max_abs_diff"] <= EPISODE_ATOL, measured
    if held_to_jax:
        assert measured["jax"]["episode_round_max_abs_diff"] > EPISODE_ATOL, measured
        assert measured["port_vs_jax_episode_round_max_abs_diff"] <= EPISODE_ATOL, measured
        assert_summary_close(ours, theirs, AUC_ATOL, n == n_all)
    elif method not in ("worst", "ours"):
        assert port["episode_round_max_abs_diff"] <= EPISODE_ATOL, measured
        assert_summary_close(ours, committed, AUC_ATOL, n == n_all)
    elif jax_backbone:
        assert measured["port_vs_jax_episode_round_max_abs_diff"] <= EPISODE_ATOL, measured
        assert_summary_close(ours, theirs, AUC_ATOL, n == n_all)
        assert abs(ours["auc"] - committed["auc"]) <= WALK_AUC_ATOL, measured
    else:
        assert port["episode_round_max_abs_diff"] <= WALK_EPISODE_ATOL, measured
    return measured


def assert_summary_close(ours, ref, atol, complete):
    """Over all of a cell's episodes: the AUC and the curve within ``atol``
    of the reference summary's (nothing to hold over fewer)."""
    if not complete:
        return
    assert abs(ours["auc"] - ref["auc"]) <= atol
    np.testing.assert_allclose(ours["curve"]["J_AND_F"], ref["curve"]["J_AND_F"], rtol=0,
                               atol=atol)
