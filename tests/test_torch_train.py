"""AssessNet training pieces of the port against the JAX package (CPU):
train-mode BatchNorm, the on-device J&F metrics, and the train step.

Tolerances and why:
- train-mode forward in float32, predictions and every running variance:
  rtol 1e-4, two float32 convolution libraries summing 53 layers in
  different orders (the float32 inference bound of test_torch_assess.py).
  A running mean is 0.1 × a batch mean of activations that largely cancel,
  so its error is held to 1e-4 of the scale of what was averaged, the
  batch's standard deviation (0.1·√var_batch per channel). Storing the
  unbiased running variance would move r5's by 0.1·var·(n/(n−1) − 1), more
  than twice the bound at batch 2 (asserted below);
- metrics: J identical, F and J&F within 1e-6 (float32 divisions);
- float32 train steps, lr 1e-2 (every update far above float32 rounding):
  - loss, diff and batch_stats of step 1: rtol 1e-3. The train-mode
    predictions agree to about 2e-4 on predictions of 0.1–0.5 (batch
    statistics of 3 samples of 48×64 frames, measured), 1e-3 relative, and
    so do the statistics of that forward;
  - step 1's updates p_after − p_before and momentum: each parameter
    within 0.2 of its norm (relative L2). The float32 gradient itself is
    only that good in the shallow layers: the port's float32 gradient of
    conv1 differs from its float64 gradient by 4–7 % at these weights
    (measured; the backward through 53 train-mode BatchNorms loses the
    digits, with either variance formula), and the JAX package's carries
    an error of the same size, so the two differ by up to twice that. The
    output layer's gradient is exact to 5e-5 in float32: fc1's update and
    momentum within 1e-4;
  - step 2 starts from parameters that differ by step 1's gradient
    error, and its gradients in the shallow layers, clamped at ±1, are no
    longer comparable element by element (measured median difference above
    100 %). Its loss and diff within 2e-2 (measured 5e-3: the loss is
    dominated by the well-conditioned deep layers), fc1's update and
    momentum within 1e-4 (measured 5e-7), and every parameter's update
    norm within 0.2 of the JAX one (the clamp bounds each element at lr);
- the bfloat16 step: |loss − loss_jax| ≤ 2·√loss·δ + δ², the squared error
  of predictions that differ by δ = 0.1. In train mode each package's bf16
  predictions sit up to 0.065 from its own float32 ones at these weights
  (measured, both packages: every layer renormalises with batch statistics
  of bf16 activations); the two roundings are independent, √2 · 0.065 <
  0.1.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ivosw_tpu.models.assess import AssessNet as JaxAssessNet
from ivosw_tpu.models.assess import assess_forward as jax_assess_forward
from ivosw_tpu.models.assess import init_assess_variables
from ivosw_tpu.ops import metrics_jax
from ivosw_tpu.train import train_assess as jax_train
from ivosw_tpu_torch.models.assess import AssessNet
from ivosw_tpu_torch.ops import metrics_device
from ivosw_tpu_torch.train.train_assess import (
    _target_metric,
    assess_train_step,
    make_assess_optimizer,
    to_device,
)
from ivosw_tpu_torch.utils.convert import (
    assess_numpy_from_state_dict,
    assess_state_dict_from_numpy,
)
from torch_port_cases import train_batch

F32_RTOL = 1e-4
LOSS_RTOL = 1e-3
UPDATE_RTOL = 0.2
FC1_RTOL = 1e-4
STEP2_LOSS_RTOL = 2e-2
METRIC_ATOL = 1e-6
BF16_PRED_ATOL = 0.1
LR = 1e-2
B, H, W = 3, 48, 64


def _np(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float32), tree)


@pytest.fixture(scope="module")
def variables():
    return _np(init_assess_variables(jax.random.PRNGKey(0)))


def _port_net(variables, dtype):
    net = AssessNet(dtype=dtype)
    net.load_state_dict(assess_state_dict_from_numpy(variables))
    return net


def _leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v) for k, v in jax.tree_util.tree_leaves_with_path(tree)}


def _rel(a, b):
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b)) / max(np.linalg.norm(b), 1e-30))


def assert_batch_stats_close(got, ref, before, rtol=F32_RTOL):
    """Running variances to ``rtol``; running means to ``rtol`` of
    0.1·√var_batch, the batch variance recovered from ``ref`` and ``before``."""
    got, ref, before = _leaves(got), _leaves(ref), _leaves(before)
    assert got.keys() == ref.keys() and len(ref) == 2 * 53
    for k in ref:
        if k.endswith("['var']"):
            np.testing.assert_allclose(got[k], ref[k], rtol=rtol, atol=0, err_msg=k)
        else:
            var = k[: -len("['mean']")] + "['var']"
            batch_var = np.maximum((ref[var] - 0.9 * before[var]) / 0.1, 0.0)
            err = np.abs(got[k] - ref[k]) / (0.1 * np.sqrt(batch_var) + 1e-12)
            assert err.max() <= rtol, (k, float(err.max()))


# ------------------------------------------------------------ train-mode BN --
def test_train_mode_batchnorm_matches_flax(variables):
    rng = np.random.default_rng(0)
    tf = rng.random((2, 256, 256, 3), dtype=np.float32)
    tp = rng.random((2, 256, 256, 1), dtype=np.float32)
    ref, mutated = JaxAssessNet(dtype=jnp.float32).apply(
        variables, tf, tp, train=True, mutable=["batch_stats"]
    )
    net = _port_net(variables, torch.float32).train()
    got = net(torch.from_numpy(tf), torch.from_numpy(tp))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=F32_RTOL, atol=F32_RTOL)

    assert_batch_stats_close(
        assess_numpy_from_state_dict(net.state_dict())["batch_stats"],
        _np(mutated["batch_stats"]), variables["batch_stats"],
    )
    ref_stats = _leaves(_np(mutated["batch_stats"]))
    # the unbiased variance would miss the bound at r5 (n = 2·8·8)
    k = "['trunk']['res5']['block2']['bn3']['var']"
    batch_var = (ref_stats[k] - 0.9 * _leaves(variables["batch_stats"])[k]) / 0.1
    unbiased = 0.9 + 0.1 * batch_var * 128 / 127
    assert np.max(np.abs(unbiased - ref_stats[k]) / ref_stats[k]) > 2 * F32_RTOL


def test_eval_mode_leaves_running_stats(variables):
    net = _port_net(variables, torch.float32).eval()
    before = {k: v.clone() for k, v in net.state_dict().items()}
    net(torch.rand(1, 64, 64, 3), torch.rand(1, 64, 64, 1))
    assert all(torch.equal(before[k], v) for k, v in net.state_dict().items())


# ------------------------------------------------------------------ metrics --
def _label_maps(seed, t=6, h=40, w=52):
    """Label maps with objects 1..2 touching every border, empty frames on
    either side and one frame empty on both."""
    rng = np.random.default_rng(seed)
    y_true = np.zeros((t, h, w), np.int32)
    y_pred = np.zeros((t, h, w), np.int32)
    for i in range(t):
        for arr in (y_true, y_pred):
            y0, x0 = rng.integers(-5, h // 2), rng.integers(-5, w // 2)
            arr[i, max(y0, 0):y0 + rng.integers(8, h), max(x0, 0):x0 + rng.integers(8, w)] = 1
            arr[i, rng.integers(0, h, 20), rng.integers(0, w, 20)] = 2
    y_true[1] = 0
    y_pred[2] = 0
    y_true[3] = y_pred[3] = 0
    y_pred[4, :, -1] = 1  # last column
    y_true[5, -1, :] = 2  # last row
    return y_true, y_pred


@pytest.mark.parametrize("seed", [0, 1])
def test_device_metrics_match_metrics_jax(seed):
    y_true, y_pred = _label_maps(seed)
    jt, jp = jnp.asarray(y_true), jnp.asarray(y_pred)
    tt, tp = torch.from_numpy(y_true), torch.from_numpy(y_pred)
    j_ref = np.asarray(metrics_jax.batched_jaccard_jax(jt, jp, nb_objects=2))
    np.testing.assert_array_equal(metrics_device.batched_jaccard_device(tt, tp, 2).numpy(), j_ref)
    f_ref = np.asarray(metrics_jax.batched_f_measure_jax(jt, jp, nb_objects=2))
    np.testing.assert_allclose(
        metrics_device.batched_f_measure_device(tt, tp, 2).numpy(), f_ref, rtol=0, atol=METRIC_ATOL
    )
    for metric in ("J", "F", "J_AND_F"):
        ref = np.asarray(metrics_jax.sequence_metric_jax(metric, jt, jp, 2))
        got = metrics_device.sequence_metric_device(metric, tt, tp, 2).numpy()
        np.testing.assert_allclose(got, ref, rtol=0, atol=METRIC_ATOL, err_msg=metric)
    b = train_batch(B, H, W, seed)
    masks = b["prob"] > jax_train.MASK_TH
    ref = np.asarray(jax_train._target_metric(jnp.asarray(b["label"]), jnp.asarray(masks), "J_AND_F"))
    got = _target_metric(torch.from_numpy(b["label"]), torch.from_numpy(masks), "J_AND_F")
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=METRIC_ATOL)


# --------------------------------------------------------------- the step --
def _jax_step_fn(optimizer, dtype):
    """The JAX package's step (train/train_assess.py:71-116) built here from
    its pieces with the net's dtype as a parameter."""

    def step(variables, opt_state, batch, lr):
        labels = batch["label"]
        masks = (batch["prob"] > jax_train.MASK_TH).astype(jnp.float32)
        target = jax.lax.stop_gradient(jax_train._target_metric(labels, masks, "J_AND_F"))
        union = jnp.sum(jnp.logical_or(labels > 0, masks > 0), axis=(-2, -1)).astype(jnp.float32)
        valid = (union > 0).astype(jnp.float32)
        n_valid = jnp.maximum(valid.sum(), 1.0)

        def loss_fn(params):
            pred, mutated = jax_assess_forward(
                {"params": params, "batch_stats": variables["batch_stats"]},
                batch["img"], batch["prob"], dtype=dtype, train=True,
            )
            pred = pred[:, 0]
            loss = jnp.sum((pred - target) ** 2 * valid) / n_valid
            diff = jnp.sum(jnp.abs(pred - target) * valid) / n_valid
            return loss, (mutated["batch_stats"], diff)

        (loss, (stats, diff)), grads = jax.value_and_grad(loss_fn, has_aux=True)(variables["params"])
        updates, new_opt = optimizer.update(grads, opt_state, variables["params"])
        gate = (valid.sum() > 0).astype(jnp.float32)
        updates = jax.tree.map(lambda u: -lr * gate * u, updates)
        opt_state = jax.tree.map(lambda n, o: gate * n + (1.0 - gate) * o, new_opt, opt_state)
        params = optax.apply_updates(variables["params"], updates)
        return {"params": params, "batch_stats": stats}, opt_state, loss, diff, valid.sum()

    return jax.jit(step)


@pytest.fixture(scope="module")
def f32_runs(variables):
    """Three steps in both packages from the same variables, batches
    train_batch(3, 48, 64, seed 10 / 11 / 12), the third all-invalid;
    the state after each step."""
    optimizer = jax_train.make_assess_optimizer(0.9, 5e-4)
    step = _jax_step_fn(optimizer, jnp.float32)
    batches = [train_batch(B, H, W, 10), train_batch(B, H, W, 11), train_batch(B, H, W, 12, invalid=(0, 1, 2))]

    jvars, jopt = jax.tree.map(jnp.asarray, variables), optimizer.init(variables["params"])
    jax_states = []
    for b in batches:
        jvars, jopt, loss, diff, n_valid = step(jvars, jopt, {k: jnp.asarray(v) for k, v in b.items()}, jnp.float32(LR))
        jax_states.append((_np(jvars), _np(jopt[2].trace), float(loss), float(diff), float(n_valid)))

    net = _port_net(variables, torch.float32)
    opt = make_assess_optimizer(net.parameters(), 0.9, 5e-4)
    port_states = []
    for b in batches:
        loss, diff, n_valid = assess_train_step(net, opt, to_device(b, "cpu"), LR)
        tree = assess_numpy_from_state_dict(net.state_dict())
        momentum = {name: opt.state[p]["momentum_buffer"].clone() for name, p in net.named_parameters()}
        mom_tree = assess_numpy_from_state_dict(momentum)["params"]
        port_states.append((tree, mom_tree, float(loss), float(diff), float(n_valid)))
    return jax_states, port_states


def _updates(states, i, init):
    prev = init if i == 0 else states[i - 1][0]["params"]
    return jax.tree.map(lambda a, b: np.asarray(a) - np.asarray(b), states[i][0]["params"], prev)


FC1 = "['fc1']['kernel']"


def _step_pair(variables, f32_runs, i):
    """(JAX, port) of step i: updates, momentum, batch_stats, loss, diff, n_valid."""
    out = []
    for states in f32_runs:
        v, mom, loss, diff, n_valid = states[i]
        out.append((_leaves(_updates(states, i, variables["params"])), _leaves(mom),
                    v["batch_stats"], loss, diff, n_valid))
    return out


def test_f32_train_step_matches_jax(variables, f32_runs):
    """Step 1: loss, diff, n_valid, per-parameter updates, momentum buffers
    and batch_stats."""
    (ju, jm, js, jloss, jdiff, jn), (pu, pm, ps, ploss, pdiff, pn) = _step_pair(variables, f32_runs, 0)
    assert pn == jn == 2.0
    np.testing.assert_allclose([ploss, pdiff], [jloss, jdiff], rtol=LOSS_RTOL)
    assert ju.keys() == pu.keys() and jm.keys() == pm.keys() == ju.keys()
    for got, ref in ((pu, ju), (pm, jm)):
        worst = max((_rel(got[k], ref[k]), k) for k in ref)
        assert worst[0] <= UPDATE_RTOL, worst
        assert _rel(got[FC1], ref[FC1]) <= FC1_RTOL
    # every parameter moves by more than 1000 float32 roundings of itself
    params = _leaves(variables["params"])
    smallest = min(np.abs(ju[k]).max() / max(np.abs(params[k]).max(), 1e-30) for k in ju)
    assert smallest > 1e3 * np.finfo(np.float32).eps
    assert_batch_stats_close(ps, js, variables["batch_stats"], LOSS_RTOL)


def test_f32_second_train_step_matches_jax(variables, f32_runs):
    """Step 2: loss, diff, n_valid, fc1's update and momentum, every
    parameter's update norm."""
    (ju, jm, _, jloss, jdiff, jn), (pu, pm, _, ploss, pdiff, pn) = _step_pair(variables, f32_runs, 1)
    assert pn == jn == 2.0
    np.testing.assert_allclose([ploss, pdiff], [jloss, jdiff], rtol=STEP2_LOSS_RTOL)
    assert _rel(pu[FC1], ju[FC1]) <= FC1_RTOL and _rel(pm[FC1], jm[FC1]) <= FC1_RTOL
    worst = max((abs(np.linalg.norm(pu[k]) / np.linalg.norm(ju[k]) - 1.0), k) for k in ju)
    assert worst[0] <= UPDATE_RTOL, worst


def test_all_invalid_batch_updates_only_bn_stats(f32_runs):
    """Third batch has no valid sample: parameters and momentum stay as
    they were after step 2, the BN running stats move, in both packages."""
    for states in f32_runs:
        (v2, m2, *_), (v3, m3, loss, _, n_valid) = states[1], states[2]
        assert n_valid == 0.0 and loss == 0.0
        for a, b in zip(jax.tree.leaves(v2["params"]), jax.tree.leaves(v3["params"])):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(jax.tree.leaves(m2), jax.tree.leaves(m3)):
            np.testing.assert_array_equal(a, b)
        moved = [not np.array_equal(a, b)
                 for a, b in zip(jax.tree.leaves(v2["batch_stats"]), jax.tree.leaves(v3["batch_stats"]))]
        assert all(moved)


def bf16_loss_bound(loss):
    return 2.0 * np.sqrt(loss) * BF16_PRED_ATOL + BF16_PRED_ATOL**2


def test_bf16_train_step_matches_jax(variables):
    """One bf16 step against the JAX package's own jitted assess_train_step."""
    b = train_batch(B, H, W, 20)
    optimizer = jax_train.make_assess_optimizer(0.9, 5e-4)
    jvars = jax.tree.map(jnp.asarray, variables)
    _, _, jloss, _, jn = jax_train.assess_train_step(
        jvars, optimizer.init(jvars["params"]), {k: jnp.asarray(v) for k, v in b.items()},
        jnp.float32(LR), optimizer,
    )
    net = _port_net(variables, torch.bfloat16)
    opt = make_assess_optimizer(net.parameters(), 0.9, 5e-4)
    loss, _, n = assess_train_step(net, opt, to_device(b, "cpu"), LR)
    assert float(n) == float(jn) == 2.0
    assert abs(float(loss) - float(jloss)) <= bf16_loss_bound(float(jloss)), (float(loss), float(jloss))
