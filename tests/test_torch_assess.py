"""AssessNet, BN folding, the weight converter and clip scoring of the port
against the JAX package (CPU).

Tolerances: float32 forwards within rtol = atol = 1e-4 of the JAX output
(two float32 convolution libraries summing 53 layers in different orders).
bfloat16 clip scores within 3e-2: each of ResNet-50's ~53 conv/BN/add stages
rounds to bf16 (half an ulp, 2⁻⁹ relative) in a different order on the two
sides, errors that add like a random walk (√(3·53)·2⁻⁹ ≈ 2.5 %) on scores of
order one."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ivosw_tpu.models.assess import AssessNet as JaxAssessNet
from ivosw_tpu.kernels import roi_pallas as jax_roi_pallas
from ivosw_tpu.models.assess import init_assess_variables, score_clip as jax_score_clip
from ivosw_tpu.models.assess import score_clip_folded as jax_score_clip_folded
from ivosw_tpu.models.fold import fold_assess_variables as jax_fold
from ivosw_tpu.utils.checkpoint import load_pytree
from ivosw_tpu_torch.models.assess import (
    AssessNet,
    mean_object_quality,
    score_clip,
    score_clip_folded,
)
from ivosw_tpu_torch.kernels.roi_crop import roi_crop_pairs_from_probs
from ivosw_tpu_torch.models.fold import fold_assess_variables
from ivosw_tpu_torch.utils.convert import assess_state_dict_from_numpy
from torch_port_cases import frames_like

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32_TOL = 1e-4
BF16_SCORE_ATOL = 3e-2


def _numpy_tree(tree):
    return jax.tree.map(lambda x: np.asarray(x, dtype=np.float32), tree)


@pytest.fixture(scope="module")
def random_variables():
    """init_assess_variables with BN statistics and affines randomised, so
    the converter's BN mapping and the fold are exercised."""
    v = _numpy_tree(init_assess_variables(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)

    def perturb(params, stats):
        for k, node in params.items():
            if "scale" in node:
                node["scale"] = rng.uniform(0.5, 1.5, node["scale"].shape).astype(np.float32)
                node["bias"] = rng.uniform(-0.2, 0.2, node["bias"].shape).astype(np.float32)
                stats[k]["mean"] = rng.uniform(-0.2, 0.2, stats[k]["mean"].shape).astype(np.float32)
                stats[k]["var"] = rng.uniform(0.5, 1.5, stats[k]["var"].shape).astype(np.float32)
            elif "kernel" not in node:
                perturb(node, stats[k])

    perturb(v["params"], v["batch_stats"])
    return v


@pytest.fixture(scope="module")
def demo_variables():
    return load_pytree(os.path.join(REPO, "weights_demo", "assess_net.orbax"), device=False)


def _port_net(variables, fold, dtype):
    net = AssessNet(dtype=dtype, fold=fold)
    net.load_state_dict(assess_state_dict_from_numpy(variables))
    return net.eval()


@pytest.mark.parametrize("fold", [False, True])
def test_assessnet_f32_matches_jax(random_variables, fold):
    rng = np.random.default_rng(1)
    tf = rng.random((2, 256, 256, 3), dtype=np.float32)
    tp = rng.random((2, 256, 256, 1), dtype=np.float32)
    variables = jax_fold(random_variables) if fold else random_variables
    ref = np.asarray(JaxAssessNet(dtype=jnp.float32, fold=fold).apply(variables, tf, tp))
    with torch.no_grad():
        got = _port_net(_numpy_tree(variables), fold, torch.float32)(
            torch.from_numpy(tf), torch.from_numpy(tp)
        ).numpy()
    assert got.shape == (2, 1) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("which", ["random", "demo"])
def test_converter_and_fold_match_jax(random_variables, demo_variables, which):
    """Unfolded and JAX-folded trees convert to strict state dicts, and the
    port's fold of the converted weights equals the JAX fold converted."""
    v = _numpy_tree(random_variables if which == "random" else demo_variables)
    unfolded = assess_state_dict_from_numpy(v)
    AssessNet(fold=False).load_state_dict(unfolded)  # strict: every key, right shapes
    ref = assess_state_dict_from_numpy(_numpy_tree(jax_fold(v)))
    got = fold_assess_variables(unfolded)
    AssessNet(fold=True).load_state_dict(got)
    assert ref.keys() == got.keys()
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(), rtol=1e-6, atol=1e-7, err_msg=k)


def test_score_clip_folded_bf16_matches_jax(demo_variables):
    """Demo weights, folded: the scoring pass (crop + bf16 encoder) on a
    4-frame, 2-object 48×64 clip, with tail chunking (chunk=3)."""
    t, o, h, w = 4, 2, 48, 64
    rng = np.random.default_rng(2)
    frames = frames_like(t, h, w, seed=3)
    probs = np.zeros((t, o, h, w), np.float32)
    for i in range(t):
        for j in range(o):
            y, x = rng.integers(0, h - 20), rng.integers(0, w - 20)
            probs[i, j, y : y + 20, x : x + 20] = rng.uniform(0.55, 0.95)
    obj_valid = np.array([1.0, 1.0], np.float32)
    folded = jax_fold(_numpy_tree(demo_variables))
    ref = np.asarray(jax_score_clip_folded(folded, frames, probs, obj_valid, impl="einsum", chunk=3))

    net = _port_net(_numpy_tree(folded), True, torch.bfloat16)
    args = (torch.from_numpy(frames), torch.from_numpy(probs), torch.from_numpy(obj_valid))
    got = score_clip_folded(net, *args, chunk=3)
    assert got.shape == (t, o) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=BF16_SCORE_ATOL)
    assert torch.equal(score_clip(net, *args, chunk=3), got)
    q = mean_object_quality(got, args[2])
    np.testing.assert_allclose(q.numpy(), got.numpy().mean(axis=1), rtol=1e-6)
    with pytest.raises(ValueError):
        score_clip_folded(_port_net(_numpy_tree(demo_variables), False, torch.bfloat16), *args)


def _clip(t, o, h, w, seed):
    """Frames and [T, O, H, W] probs with one 20×20 blob per pair."""
    rng = np.random.default_rng(seed)
    probs = np.zeros((t, o, h, w), np.float32)
    for i in range(t):
        for j in range(o):
            y, x = rng.integers(0, h - 20), rng.integers(0, w - 20)
            probs[i, j, y : y + 20, x : x + 20] = rng.uniform(0.55, 0.95)
    return frames_like(t, h, w, seed=seed + 1), probs


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_score_clip_scores_in_eval_mode_whatever_the_mode(random_variables, dtype):
    """An unfolded net (float32 parameters; float32 or bf16 compute) left
    in train mode, running stats far from identity: its scores equal the
    eval-mode scores and the JAX score_clip's on the same weights (bf16
    there; the file's bound), its running stats do not move, and it is
    handed back in train mode (measured against JAX: 0.027 in float32,
    0.014 in bf16). In train mode the same net scores more than 10 bounds
    away, so the checks bite."""
    frames, probs = _clip(4, 2, 48, 64, seed=7)
    obj_valid = np.ones(2, np.float32)
    args = (torch.from_numpy(frames), torch.from_numpy(probs), torch.from_numpy(obj_valid))
    net = _port_net(_numpy_tree(random_variables), False, getattr(torch, dtype))
    eval_scores = score_clip(net, *args)
    net.train()
    stats = {k: b.clone() for k, b in net.named_buffers() if "running" in k}
    train_scores = score_clip(net, *args)
    assert net.training and all(m.training for m in net.modules())
    assert all(torch.equal(b, stats[k]) for k, b in net.named_buffers() if "running" in k)
    assert torch.equal(train_scores, eval_scores)
    ref = np.asarray(jax_score_clip(random_variables, frames, probs, obj_valid, impl="einsum"))
    np.testing.assert_allclose(train_scores.numpy(), ref, rtol=0, atol=BF16_SCORE_ATOL)
    with torch.no_grad():
        tf, tp = roi_crop_pairs_from_probs(args[0], args[1], 256, net.dtype)
        assert float((net(tf, tp).reshape(4, 2) - eval_scores).abs().max()) > 10 * BF16_SCORE_ATOL


@pytest.mark.parametrize("inputs", ["float32", "bfloat16"])
def test_score_clip_impls_match_jax(demo_variables, inputs):
    """score_clip_folded with impl="einsum" (the two-stage round) and
    impl="pallas" (fused box) against the JAX package's with the same impl
    (its fused-box kernel in interpret mode), frames and probs in
    ``inputs`` (assess_net.bf16_inputs), demo weights, 2 frames × 2 objects
    of 48×64 passed as [T, O+1, H, W] with object offset 1."""
    frames, probs = _clip(2, 2, 48, 64, seed=5)
    obj_valid = np.ones(2, np.float32)
    jin, tin = getattr(jnp, inputs), getattr(torch, inputs)
    folded = jax_fold(_numpy_tree(demo_variables))
    net = _port_net(_numpy_tree(folded), True, torch.bfloat16)
    full = np.concatenate([1.0 - probs.max(axis=1, keepdims=True), probs], axis=1)
    args = (torch.from_numpy(frames).to(tin), torch.from_numpy(full).to(tin),
            torch.from_numpy(obj_valid))
    fused = jax_roi_pallas.roi_crop_pairs_pallas_fusedbox
    scores = {}
    for impl in ("einsum", "pallas"):
        jax_roi_pallas.roi_crop_pairs_pallas_fusedbox = (
            lambda *a, **k: fused(*a, **{**k, "interpret": True}))
        try:
            ref = np.asarray(jax_score_clip_folded(
                folded, jnp.asarray(frames).astype(jin), jnp.asarray(probs).astype(jin),
                obj_valid, impl=impl))
        finally:
            jax_roi_pallas.roi_crop_pairs_pallas_fusedbox = fused
        scores[impl] = score_clip_folded(net, *args, obj_offset=1, impl=impl)
        assert scores[impl].shape == (2, 2) and scores[impl].dtype == torch.float32
        np.testing.assert_allclose(scores[impl].numpy(), ref, rtol=0, atol=BF16_SCORE_ATOL)
    np.testing.assert_allclose(scores["einsum"].numpy(), scores["pallas"].numpy(), rtol=0,
                               atol=BF16_SCORE_ATOL)
