"""The TAPNet slice: the port's ``evaluate`` with ``vos=tapnet`` against the
JAX package's, and against the committed TAPNet result cells.

Weights are the committed demo weights (``weights_demo``: TAPNet, AssessNet,
the agents), read into numpy by the JAX package's loader and converted.

1. ``wild``/``ours`` on a 48×64 clip (T=8, O=2, 2 rounds), with
   ``assess_net.bf16_inputs`` off and on: per-round frame picks identical;
   predicted qualities within ``QUALITY_ATOL`` of ``test_torch_slice.py``
   (3e-2, the bf16 scoring bound); the J&F curve within
   :data:`CURVE_ATOL` (TAPNet's masks differ by a few pixels near a
   decision, ``test_torch_tapnet.py``).
2. The committed ``results/tapnet/{wild: linspace, random; oracle: ours,
   worst}/synthetic`` cells, held as ``torch_cells.py`` says: the first
   :data:`N_EPISODES` episodes in registry order without ``slow`` (chosen
   for time), all 24 under ``slow``. The committed rows come from a TPU,
   and one row may differ a lot where a small object's mask moves by a few
   pixels: over all 24 episodes of the wild ``linspace``/``random`` cells
   the JAX package's own CPU run differs from them by up to 0.34 (J) and
   0.53 (F) in single rows and 0.0053 in an episode round's mean; the port
   by up to 0.31, 0.53 and 0.0084; the AUC and curve (measured: JAX on the
   CPU 1.0e-4 and 3.0e-4, the port 3.9e-5 and 4.8e-4). The wild
   ``worst``/``ours`` cells are in ``test_torch_tapnet_cells_qa.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ivosw_tpu.core.config import Config as JaxConfig
from ivosw_tpu.data.registry import SequenceRegistry as JaxRegistry
from ivosw_tpu.eval import eval_agent as jax_eval
from ivosw_tpu.interact import recommend as jax_recommend
from ivosw_tpu.models.agent import Agent as JaxAgent
from ivosw_tpu.models.fold import fold_assess_variables as jax_fold
from ivosw_tpu.models.vos.tapnet import TAPNetAdapter as JaxTAPNetAdapter
from ivosw_tpu_torch.core.config import Config
from ivosw_tpu_torch.data.registry import SequenceRegistry
from ivosw_tpu_torch.eval import eval_agent
from ivosw_tpu_torch.interact import recommend
from ivosw_tpu_torch.models.agent import Agent
from ivosw_tpu_torch.models.assess import AssessNet
from ivosw_tpu_torch.models.fold import fold_assess_variables
from ivosw_tpu_torch.utils.convert import (
    assess_state_dict_from_numpy,
    brain_state_dict_from_numpy,
)
from torch_cells import demo_weights, port_adapter, recording, reproduce_cell

QUALITY_ATOL = 3e-2
CURVE_ATOL = 1e-2
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


@pytest.mark.parametrize("bf16_inputs", [False, True])
def test_tapnet_wild_ours_matches_jax(tmp_path, monkeypatch, bf16_inputs):
    tapnet, assess_vars = demo_weights("tapnet.orbax"), demo_weights("assess_net.orbax")
    agent_params = demo_weights("wild/agent.orbax")
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
    jpicks, jq = recording(monkeypatch, jax_eval, jax_recommend)
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
    adapter = port_adapter("tapnet", tapnet, torch.bfloat16 if bf16_inputs else torch.float32)
    picks, q = recording(monkeypatch, eval_agent, recommend)
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


CELLS = [
    pytest.param("wild", "linspace", id="linspace"),
    pytest.param("wild", "random", id="random"),
    pytest.param("oracle", "ours", id="oracle-ours"),
    pytest.param("oracle", "worst", id="oracle-worst"),
]


@pytest.mark.parametrize("setting,method", CELLS)
def test_committed_tapnet_cells_first_episodes(tmp_path, monkeypatch, setting, method):
    reproduce_cell(tmp_path, monkeypatch, "tapnet", setting, method, N_EPISODES,
                   jax_backbone=False)


@pytest.mark.slow
@pytest.mark.parametrize("setting,method", CELLS)
def test_committed_tapnet_cells_all_episodes(tmp_path, monkeypatch, setting, method):
    reproduce_cell(tmp_path, monkeypatch, "tapnet", setting, method, 24, jax_backbone=True)
