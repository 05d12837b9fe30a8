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
from ivosw_tpu.models.assess import init_assess_variables, score_clip_folded as jax_score_clip_folded
from ivosw_tpu.models.fold import fold_assess_variables as jax_fold
from ivosw_tpu.utils.checkpoint import load_pytree
from ivosw_tpu_torch.models.assess import (
    AssessNet,
    mean_object_quality,
    score_clip,
    score_clip_folded,
)
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
