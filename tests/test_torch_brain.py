"""Brain Q-network and the inference agent of the port against the JAX
package (CPU). Q-values within rtol 1e-5 (float32; the two LSTM loops sum
the same products in different orders); -inf at padded steps in the same
places; ε-greedy actions identical with the same host-RNG draws."""

import os

import jax
import numpy as np
import pytest
import torch

from ivosw_tpu.core.config import Config as JaxConfig
from ivosw_tpu.models.agent import Agent as JaxAgent
from ivosw_tpu.models.brain import brain_forward as jax_brain_forward
from ivosw_tpu.models.brain import init_brain_params
from ivosw_tpu.models.brain import pad_to_bucket as jax_pad_to_bucket
from ivosw_tpu.utils.checkpoint import load_pytree
from ivosw_tpu_torch.core.config import Config
from ivosw_tpu_torch.models.agent import Agent
from ivosw_tpu_torch.models.brain import Brain, brain_forward, init_brain, pad_to_bucket
from ivosw_tpu_torch.utils.convert import brain_state_dict_from_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads: the Brain's ops are small, and under the tier-1
    run's six workers on eight cores OpenMP spinning over more threads
    slows them many times over."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _port_brain(params):
    brain = Brain()
    brain.load_state_dict(brain_state_dict_from_numpy(jax.tree.map(np.asarray, params)))
    return brain.eval()


@pytest.mark.parametrize("masked", [False, True])
def test_brain_forward_matches_jax(masked):
    params = init_brain_params(jax.random.PRNGKey(3))
    rng = np.random.default_rng(0)
    n, t = 3, 32
    x = np.stack([rng.random((n, t)), rng.integers(0, 3, (n, t))], axis=2).astype(np.float32)
    mask = None
    if masked:  # real frames [0, len): lengths 32, 20 and 1
        mask = np.zeros((n, t), np.float32)
        for i, length in enumerate((32, 20, 1)):
            mask[i, :length] = 1.0
    ref = np.asarray(jax_brain_forward(params, x, None if mask is None else mask))
    got = brain_forward(
        _port_brain(params), torch.from_numpy(x),
        None if mask is None else torch.from_numpy(mask),
    ).numpy()
    assert got.shape == (n, t)
    np.testing.assert_array_equal(np.isinf(got), np.isinf(ref))
    finite = np.isfinite(ref)
    np.testing.assert_allclose(got[finite], ref[finite], rtol=RTOL, atol=RTOL)
    assert [pad_to_bucket(k) for k in (1, 33, 300)] == [jax_pad_to_bucket(k) for k in (1, 33, 300)]


@pytest.mark.parametrize("ckpt", ["agent.orbax", "wild/agent.orbax"])
@pytest.mark.parametrize("phase", ["eval", "train"])
def test_agent_actions_and_rng_draws_match_jax(ckpt, phase):
    """Demo agent weights: the same picks, and the host RNG advanced by the
    same draws (ε = 0 at eval still draws once per action; in train the
    ε branch draws a second number)."""
    params = load_pytree(os.path.join(REPO, "weights_demo", ckpt), device=False)["params"]
    jax_agent = JaxAgent(JaxConfig(phase=phase), seed=0)
    jax_agent.params = jax.tree.map(jax.numpy.asarray, params)
    agent = Agent(Config(phase=phase), seed=0, device="cpu")
    agent.brain.load_state_dict(brain_state_dict_from_numpy(jax.tree.map(np.asarray, params)))

    rng = np.random.default_rng(1)
    for t in (8, 48, 48, 64, 70):
        state = np.stack([rng.random(t), rng.integers(0, 2, t)], axis=1).astype(np.float32)
        assert agent.action(state) == jax_agent.action(state)
        np.testing.assert_allclose(agent.q_values(state), jax_agent.q_values(state),
                                   rtol=RTOL, atol=RTOL)
    assert agent.steps_done == jax_agent.steps_done == 5
    assert agent.eps_threshold() == jax_agent.eps_threshold()
    assert agent.host_rng.random() == jax_agent.host_rng.random()


def test_init_brain_is_seeded():
    a, b, c = init_brain(0), init_brain(0), init_brain(1)
    for (name, pa), pb, pc in zip(a.named_parameters(), b.parameters(), c.parameters()):
        assert torch.equal(pa, pb) and not torch.equal(pa, pc), name
        bound = 1.0 / np.sqrt(2 if name.startswith("enc_fc1") else 256 if name.startswith("dec_fc1") else 128)
        assert float(pa.abs().max()) <= bound
