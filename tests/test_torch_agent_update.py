"""The port's Q-update against the JAX package's (CPU): the optimizer
(clip → coupled L2 decay → Adam) against the optax chain, ``dqn_loss`` and
its gradients, and 14 ``dqn_update_step``s at the config's lr and at 1e-3,
from the demo agent's params on batches drawn from the demo replay pool.

Bounds (float32; the two packages sum the same products in other orders):
- loss within LOSS_RTOL = 1e-5 (measured ≤ 4.4e-7 over the 14 steps);
- gradients within GRAD_RTOL = 1e-4 of each tensor's largest gradient;
- each parameter after 14 steps within ``1e-3·lr·steps + 2 ulp`` of the JAX
  package's (measured 3.0e-6 at lr 1e-3 against a 1.4e-5 bound, and within
  one float32 ulp of the parameter at lr 5e-6). Adam normalises each
  element, so an element whose gradient is ~0 on both sides could take a
  step of the other sign (up to 2·lr a step); no element is left out of
  the bound, and none did on these inputs."""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ivosw_tpu.core.config import Config as JaxConfig
from ivosw_tpu.data.replay import ReplayMemory as JaxReplayMemory
from ivosw_tpu.models import agent as jax_agent
from ivosw_tpu.utils.checkpoint import load_pytree
from ivosw_tpu_torch.core.config import Config
from ivosw_tpu_torch.models import agent
from ivosw_tpu_torch.models.brain import Brain
from ivosw_tpu_torch.utils.convert import brain_numpy_from_state_dict, brain_state_dict_from_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
STEPS = 14
GAMMA, WD = 0.95, 5e-4


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
def params():
    tree = load_pytree(os.path.join(REPO, "weights_demo", "agent.orbax"), device=False)
    return jax.tree.map(lambda x: np.asarray(x, np.float32), tree["params"])


@pytest.fixture(scope="module")
def batches():
    pool = JaxReplayMemory(100000)
    pool.load_from_csv(os.path.join(REPO, "train_demo", "pretrain.csv"), sample_th=0.05)
    rng = np.random.default_rng(0)
    return [pool.sample_batch(32, rng) for _ in range(STEPS)]


def _brain(params):
    brain = Brain()
    brain.load_state_dict(brain_state_dict_from_numpy(params))
    return brain


def _torch_batch(batch):
    return {k: torch.from_numpy(np.asarray(batch[k])) for k in agent.BATCH_KEYS}


def _jax_batch(batch):
    return {k: jnp.asarray(batch[k]) for k in agent.BATCH_KEYS}


def _assert_params_close(got, ref, init, lr, steps):
    for name in ref:
        for leaf in ref[name]:
            r, g = np.asarray(ref[name][leaf]), got[name][leaf]
            bound = 1e-3 * lr * steps + 2 * np.spacing(np.abs(r))
            err = np.abs(g - r)
            assert (err <= bound).all(), (
                f"{name}.{leaf}: {int((err > bound).sum())} of {err.size} elements off, "
                f"max {err.max()} (update size {np.abs(r - init[name][leaf]).max()})")


@pytest.mark.parametrize("wd", [0.0, WD])
def test_optimizer_matches_optax_chain(wd):
    """Three steps on seeded params with gradients from 1e-12 (where eps
    decides the step, without decay) to 10 (clamped to 1): the clamp, the
    coupled decay, Adam's bias corrections and eps placement agree with
    optax's chain."""
    rng = np.random.default_rng(0)
    p0 = rng.normal(0, 0.5, (4, 64)).astype(np.float32)
    scales = np.logspace(-12, 1, 64).astype(np.float32)
    grads = [(rng.normal(0, 1, (4, 64)) * scales).astype(np.float32) for _ in range(3)]
    lr = 1e-3

    opt = jax_agent.make_optimizer(lr, wd)
    jp = jnp.asarray(p0)
    state = opt.init(jp)
    for g in grads:
        updates, state = opt.update(jnp.asarray(g), state, jp)
        jp = optax.apply_updates(jp, updates)

    p = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    topt = agent.make_optimizer([p], lr, wd)
    for g in grads:
        p.grad = torch.from_numpy(g.copy()).clamp_(-agent.GRAD_CLIP, agent.GRAD_CLIP)
        topt.step()
    got, ref = p.detach().numpy(), np.asarray(jp)
    np.testing.assert_allclose(got - p0, ref - p0, rtol=1e-5, atol=2 * np.spacing(np.abs(ref)).max())
    # every element moved the same way, those whose step eps shrank too
    assert np.all(np.sign(got - p0) == np.sign(ref - p0))


def test_dqn_loss_and_grads_match_jax(params, batches):
    batch = batches[0]
    ref_loss, ref_grads = jax.value_and_grad(jax_agent.dqn_loss)(
        jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, params),
        _jax_batch(batch), GAMMA)
    brain, target = _brain(params), _brain(params)
    loss = agent.dqn_loss(brain, target, _torch_batch(batch), GAMMA)
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(ref_loss), rel=LOSS_RTOL)
    got = brain_numpy_from_state_dict({k: p.grad for k, p in brain.named_parameters()})
    for name in got:
        for leaf in got[name]:
            r = np.asarray(ref_grads[name][leaf])
            np.testing.assert_allclose(got[name][leaf], r, rtol=0,
                                       atol=GRAD_RTOL * np.abs(r).max(), err_msg=f"{name}.{leaf}")
    # no gradient reached the target
    assert all(p.grad is None for p in target.parameters())


@pytest.mark.parametrize("lr", [5e-6, 1e-3])
def test_updates_match_jax(params, batches, lr):
    """14 steps (one episode's 3·5−1) against the target's fixed params."""
    opt = jax_agent.make_optimizer(lr, WD)
    jp, jt = jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, params)
    state = opt.init(jp)
    brain, target = _brain(params), _brain(params)
    topt = agent.make_optimizer(brain.parameters(), lr, WD)
    ref_losses, losses = [], []
    for batch in batches:
        jp, state, loss = jax_agent.dqn_update_step(jp, jt, state, _jax_batch(batch), GAMMA, opt)
        ref_losses.append(float(loss))
        losses.append(float(agent.dqn_update_step(brain, target, topt, _torch_batch(batch), GAMMA)))
    np.testing.assert_allclose(losses, ref_losses, rtol=LOSS_RTOL)
    _assert_params_close(brain_numpy_from_state_dict(brain.state_dict()),
                         jax.tree.map(np.asarray, jp), params, lr, STEPS)
    # the target did not move
    for k, v in brain_state_dict_from_numpy(params).items():
        assert torch.equal(target.state_dict()[k], v)


def test_update_agent_draws_and_syncs_as_jax(params, batches):
    """``update_agent`` at update_rate 0.5: the same host-RNG draws after
    each update, so the same target syncs (the target's Q-values follow the
    JAX package's target params); the loss window as JAX's."""
    kw = dict(phase="train", seed=4)
    jcfg, cfg = JaxConfig(**kw), Config(**kw)
    for c in (jcfg, cfg):
        c.agent.update_rate = 0.5
        c.agent.lr = 1e-3
    ja = jax_agent.Agent(jcfg)
    ja.params = jax.tree.map(jnp.asarray, params)
    ja.target_params = jax.tree.map(jnp.asarray, params)
    ja.opt_state = ja.optimizer.init(ja.params)
    pa = agent.Agent(cfg, device="cpu")
    pa.brain.load_state_dict(brain_state_dict_from_numpy(params))
    pa.sync_target()

    state = np.stack([np.linspace(0.2, 0.9, 24), np.zeros(24)], 1).astype(np.float32)
    for batch in batches[:6]:
        assert pa.update_agent(batch) == pytest.approx(ja.update_agent(batch), rel=LOSS_RTOL)
        ref_target = np.asarray(jax_agent._greedy_q(ja.target_params, state[None],
                                                     np.ones((1, 24), np.float32)))[0]
        got_target = agent.brain_forward(pa.target, torch.from_numpy(state[None]))[0].numpy()
        np.testing.assert_allclose(got_target, ref_target, rtol=1e-4, atol=1e-5)
    assert pa.host_rng.random() == ja.host_rng.random()
    assert pa.get_avg_loss() == pytest.approx(ja.get_avg_loss(), rel=LOSS_RTOL)
    assert pa.update_agent(None) is None


def test_target_sync_copies():
    """After a sync the target holds equal values in its own storage: a
    later update moves the policy only."""
    cfg = Config(phase="train", seed=1)
    pa = agent.Agent(cfg, device="cpu")
    with torch.no_grad():
        for p in pa.brain.parameters():
            p.add_(0.01)
    pa.sync_target()
    before = copy.deepcopy(pa.target.state_dict())
    for p, t in zip(pa.brain.parameters(), pa.target.parameters()):
        assert torch.equal(p, t) and p.data_ptr() != t.data_ptr()
    rng = np.random.default_rng(0)
    t = 6
    batch = {
        "action": rng.integers(0, t, 4).astype(np.int32),
        "reward_step": np.ones(4, np.float32), "reward_done": np.zeros(4, np.float32),
        "old_state_iou": rng.random((4, t), dtype=np.float32),
        "new_state_iou": rng.random((4, t), dtype=np.float32),
        "annotated_frames": np.zeros((4, t), np.float32),
        "next_annotated_frames": np.ones((4, t), np.float32),
    }
    pa.update_rate = 0.0  # no sync after this update
    pa.update_agent(batch)
    for k, v in pa.target.state_dict().items():
        assert torch.equal(v, before[k])
        assert not torch.equal(v, pa.brain.state_dict()[k])
