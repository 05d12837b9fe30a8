"""The whole wild-setting slice: the JAX package's ``evaluate`` and the
port's, FakeVOS on the same in-memory clip, demo weights carried across.

Per-round frame picks and J&F curves must be identical; per-frame
predicted qualities agree within 3e-2, the bf16 scoring bound of
test_torch_assess.py (ResNet-50's ~53 bf16 rounding stages taken in a
different order on the two sides, √(3·53)·2⁻⁹ ≈ 2.5 % of scores of order
one)."""

import os

import jax
import numpy as np
import pytest

from ivosw_tpu.core.config import Config as JaxConfig
from ivosw_tpu.data.registry import SequenceRegistry as JaxRegistry
from ivosw_tpu.eval import eval_agent as jax_eval
from ivosw_tpu.interact import recommend as jax_recommend
from ivosw_tpu.models.agent import Agent as JaxAgent
from ivosw_tpu.models.fold import fold_assess_variables as jax_fold
from ivosw_tpu.models.vos.fake import FakeVOS as JaxFakeVOS
from ivosw_tpu.utils.checkpoint import load_pytree
from ivosw_tpu_torch.core.config import Config
from ivosw_tpu_torch.data.registry import SequenceRegistry
from ivosw_tpu_torch.eval import eval_agent
from ivosw_tpu_torch.interact import recommend
from ivosw_tpu_torch.models.agent import Agent
from ivosw_tpu_torch.models.assess import AssessNet
from ivosw_tpu_torch.models.fold import fold_assess_variables
from ivosw_tpu_torch.models.vos.fake import FakeVOS
from ivosw_tpu_torch.utils.convert import (
    assess_state_dict_from_numpy,
    brain_state_dict_from_numpy,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QUALITY_ATOL = 3e-2
ROUNDS = 3


@pytest.fixture(scope="module")
def demo_weights():
    load = lambda p: load_pytree(os.path.join(REPO, "weights_demo", p), device=False)
    to_np = lambda tree: jax.tree.map(lambda x: np.asarray(x, np.float32), tree)
    return to_np(load("assess_net.orbax")), to_np(load("wild/agent.orbax")["params"])


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


@pytest.mark.parametrize("method", ["ours", "worst"])
def test_wild_slice_matches_jax(demo_weights, tmp_path, monkeypatch, method):
    assess_vars, agent_params = demo_weights
    kw = dict(phase="eval", setting="wild", method=method, vos="fake", seed=0)
    clip = dict(num_frames=8, image_size=(64, 48), num_objects=2, seed=0)

    # JAX package: BN folded at load (fold_inference), einsum crops on CPU
    jcfg = JaxConfig(**kw)
    jcfg.assess_net.score_chunk = 8
    jreg = JaxRegistry.synthetic(["alpha"], **clip)
    jreg.sequences["alpha"].num_scribbles = 1
    jagent = JaxAgent(jcfg, seed=0)
    jagent.params = jax.tree.map(jax.numpy.asarray, agent_params)
    jpicks, jq = _recording(monkeypatch, jax_eval, jax_recommend)
    ref = jax_eval.evaluate(
        jcfg, jreg, JaxFakeVOS(jreg), agent=jagent, assess_variables=jax_fold(assess_vars),
        max_nb_interactions=ROUNDS, report_save_dir=str(tmp_path / "jax"),
    )

    # the port: same clip, weights converted, folded by the port
    cfg = Config(**kw)
    cfg.assess_net.score_chunk = 8
    reg = SequenceRegistry.synthetic(["alpha"], **clip)
    reg.sequences["alpha"].num_scribbles = 1
    agent = Agent(cfg, seed=0, device="cpu")
    agent.brain.load_state_dict(brain_state_dict_from_numpy(agent_params))
    net = AssessNet(fold=True)
    net.load_state_dict(fold_assess_variables(assess_state_dict_from_numpy(assess_vars)))
    picks, q = _recording(monkeypatch, eval_agent, recommend)
    ours = eval_agent.evaluate(
        cfg, reg, FakeVOS(reg), agent=agent, assess_net=net.eval(),
        max_nb_interactions=ROUNDS, report_save_dir=str(tmp_path / "port"), device="cpu",
    )

    assert len(picks) == ROUNDS and picks == jpicks
    assert ours["curve"] == ref["curve"]
    assert len(q) == len(jq) == ROUNDS
    np.testing.assert_allclose(np.stack(q), np.stack(jq), rtol=0, atol=QUALITY_ATOL)

    def report(d):  # davisinteractive rows without session id and timing
        lines = open(tmp_path / d / "session_report.csv").read().splitlines()
        return [",".join(line.split(",")[1:-1]) for line in lines]

    assert report("port") == report("jax")
