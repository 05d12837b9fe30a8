"""IPNet in the port (``models/vos/ipnet.py``) against the JAX package's.

- ``get_weight``: equal.
- The frame encoder, the interaction net and the propagation net on the
  converted ``init_ipnet_params(0)`` at 48×64: float32 outputs within 1e-4
  of the largest; bfloat16 within :data:`BF16_RTOL` of the largest (the
  encoder's one-ulp flips compound, ``test_torch_vos_layers.py``).
- ``begin_sequence`` on T=6 frames in chunks of 4: the JAX package pads
  the last chunk with zero frames, the port does not (GroupNorm works per
  sample): the features agree within :data:`BF16_RTOL`.
- ``ref_vector`` against ``_ref_vector``, with an object whose mask is
  empty (the 1e-3 clamp): within 1e-5 of the largest (float32 sums in
  other orders).
- The adapter over 3 rounds (48×64, T=6, O=2) with the trained demo
  weights and the same scribbles on both sides: probabilities within
  :data:`PROB_ATOL` (measured 1.1e-2 in float32 storage, 1.2e-2 in
  bfloat16), labels equal except at pixels
  within :data:`PROB_ATOL` of a decision (measured: 0 to 3 of 18,432
  pixels per round), the annotated frames equal.
- The converter: the flax trees (seeded init and ``weights_demo``) load
  strictly, hold 112 leaves and 8.70 M parameters, and the module's state
  dict laid back out (OIHW → HWIO) is the flax tree again.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ivosw_tpu.data.registry import SequenceRegistry as JaxRegistry
from ivosw_tpu.data.scribbles import merge_scribbles
from ivosw_tpu.interact.robot import ScribbleRobot as JaxRobot
from ivosw_tpu.models.vos import ipnet as J
from ivosw_tpu.utils.checkpoint import load_pytree
from ivosw_tpu_torch.models.vos import ipnet as T
from ivosw_tpu_torch.utils.convert import ipnet_state_dict_from_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BF16_RTOL = 2.0**-4
PROB_ATOL = 2.0**-5
LABEL_SHARE = 0.005


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Small tensors: two intra-op threads are as fast alone, and leave the
    cores to the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _numpy(tree):
    tree = tree.get("params", tree)
    return jax.tree.map(lambda x: np.asarray(x, np.float32), tree)


@pytest.fixture(scope="module")
def trained_params():
    return _numpy(load_pytree(os.path.join(REPO, "weights_demo", "ipnet.orbax"), device=False))


@pytest.fixture(scope="module")
def init_params():
    return _numpy(J.init_ipnet_params(0, hw=(48, 64)))


def _net(params, dtype=torch.bfloat16):
    net = T.IPNet(dtype)
    net.load_state_dict(ipnet_state_dict_from_numpy(params))
    return net.eval()


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x, np.float32).transpose(0, 3, 1, 2)))


def _close(ours, ref, rtol):
    ref = np.asarray(jnp.asarray(ref).astype(jnp.float32))
    ours = ours.float().numpy()
    assert ours.shape == ref.shape
    assert np.abs(ours - ref).max() <= rtol * np.abs(ref).max()


@pytest.mark.parametrize("prev,now", [
    ([], 3), ([0], 4), ([5], 1), ([0, 8], 4), ([2, 3, 7], 5), ([1], 1), ([9], 9), ([0, 3], 6),
])
def test_get_weight_matches_jax(prev, now):
    prev = np.array(prev, dtype=np.int64)
    ours, ref = T.get_weight(10, prev, now), J.get_weight(10, prev, now)
    np.testing.assert_array_equal(ours, ref)
    assert ours.dtype == ref.dtype


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encoder_and_heads_match_jax(init_params, dtype):
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    rtol = 1e-4 if dtype == "float32" else BF16_RTOL
    rng = np.random.default_rng(5)
    h, w, o = 48, 64, 2
    img = rng.random((o, h, w, 3)).astype(np.float32)
    pos, neg = ((rng.random((2, o, h, w)) < 0.2).astype(np.float32))
    prev = rng.random((o, h, w)).astype(np.float32)
    jnet, net = J.IPNet(dtype=jdt), _net(init_params, tdt)
    apply = lambda *args, method: jnet.apply({"params": init_params}, *args, method=method)

    ref_feats = apply(img, method=J.IPNet.encode)
    ref_logit = apply(img, pos, neg, prev, method=J.IPNet.interact)
    with torch.no_grad():
        feats = net.frame_enc(_nchw(img))
        logit = net.interaction(_nchw(img), *(torch.from_numpy(x) for x in (pos, neg, prev)))
    for ours, ref in zip(feats, ref_feats):
        assert ours.dtype == tdt
        _close(ours, np.asarray(ref.astype(jnp.float32)).transpose(0, 3, 1, 2), rtol)
    assert logit.dtype == torch.float32
    _close(logit, ref_logit, rtol)

    # the propagation net on the JAX encoder's features, so it is held alone
    ref_vec = rng.normal(size=(o, 256)).astype(np.float32)
    ref_p = apply(*ref_feats, ref_vec, prev, (h, w), method=J.IPNet.propagate)
    to_t = lambda a: _nchw(np.asarray(a.astype(jnp.float32))).to(tdt)
    with torch.no_grad():
        p_logit = net.propagation(*(to_t(f) for f in ref_feats), torch.from_numpy(ref_vec),
                                  torch.from_numpy(prev), (h, w))
    assert p_logit.dtype == torch.float32
    _close(p_logit, ref_p, rtol)


def test_begin_sequence_features_match_jax(init_params):
    """The JAX package zero-pads the last encoder chunk (6 frames in chunks
    of 4); the port encodes the 2 frames alone."""
    frames = np.random.default_rng(6).random((6, 48, 64, 3), dtype=np.float32)
    jstate = J.IPNetAdapter(jax.tree.map(jnp.asarray, init_params), encode_chunk=4
                            ).begin_sequence(frames, 2)
    state = T.IPNetAdapter(_net(init_params), encode_chunk=4, device="cpu"
                           ).begin_sequence(frames, 2)
    for ours, ref in zip(state.feats, jstate.feats):
        _close(ours, np.asarray(ref.astype(jnp.float32)).transpose(0, 3, 1, 2), BF16_RTOL)
    np.testing.assert_array_equal(state.frame_cache.permute(0, 2, 3, 1).numpy(), frames)


def test_ref_vector_matches_jax():
    rng = np.random.default_rng(7)
    r4a = rng.normal(size=(3, 4, 256)).astype(np.float32)  # [h16, w16, C]
    prob = rng.random((3, 48, 64)).astype(np.float32)
    prob[1] = 0.0  # an empty mask: the denominator is clamped at 1e-3
    prob[2] = (prob[2] > 0.7).astype(np.float32)
    ref = np.asarray(J._ref_vector(jnp.asarray(r4a), jnp.asarray(prob)))
    ours = T.ref_vector(torch.from_numpy(r4a.transpose(2, 0, 1).copy()), torch.from_numpy(prob))
    assert ours.dtype == torch.float32 and ours.shape == (3, 256)
    assert np.abs(ours.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()
    np.testing.assert_array_equal(ours[1].numpy(), 0.0)
    # bf16 features: summed as float32, as the JAX package
    r4b = torch.from_numpy(r4a.transpose(2, 0, 1).copy()).to(torch.bfloat16)
    refb = np.asarray(J._ref_vector(jnp.asarray(r4a, jnp.bfloat16), jnp.asarray(prob)))
    oursb = T.ref_vector(r4b, torch.from_numpy(prob))
    assert oursb.dtype == torch.float32
    assert np.abs(oursb.numpy() - refb).max() <= 1e-5 * np.abs(refb).max()


def _decision_margin(all_p):
    """[T, H, W] distance of each pixel's label decision from a flip: the
    winning object probability from 0.5, and from the runner-up."""
    fg = np.sort(np.asarray(all_p[:, 1:], np.float32), axis=1)
    margin = np.abs(fg[:, -1] - 0.5)
    if fg.shape[1] > 1:
        margin = np.minimum(margin, fg[:, -1] - fg[:, -2])
    return margin


@pytest.mark.parametrize("qa_dtype", ["float32", "bfloat16"])
def test_adapter_rounds_match_jax(trained_params, qa_dtype):
    jdt = jnp.float32 if qa_dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if qa_dtype == "float32" else torch.bfloat16
    reg = JaxRegistry.synthetic(["s"], num_frames=6, image_size=(64, 48), num_objects=2, seed=3)
    frames, gt = reg.load_images("s"), reg.load_annotations("s")
    jax_adapter = J.IPNetAdapter(jax.tree.map(jnp.asarray, trained_params), qa_dtype=jdt)
    adapter = T.IPNetAdapter(_net(trained_params), qa_dtype=tdt, device="cpu")
    jstate, state = jax_adapter.begin_sequence(frames, 2), adapter.begin_sequence(frames, 2)
    robot = JaxRobot(seed=0)
    masks, scribbles = np.zeros_like(gt), None
    for n, frame in enumerate([2, 5, 0], start=1):
        new = robot.interact("s", masks, gt, 2, frame=frame)
        scribbles = new if scribbles is None else merge_scribbles(scribbles, new)
        ref_labels, ref_p, jstate = jax_adapter.segment(jstate, scribbles, frame, n)
        labels, all_p, state = adapter.segment(state, scribbles, frame, n)
        ref_p = np.asarray(ref_p.astype(jnp.float32))
        assert labels.dtype == np.uint8 and all_p.dtype == tdt and all_p.shape == (6, 3, 48, 64)
        assert np.abs(all_p.float().numpy() - ref_p).max() <= PROB_ATOL
        flipped = labels != ref_labels
        assert flipped.mean() <= LABEL_SHARE
        assert (_decision_margin(ref_p)[flipped] <= PROB_ATOL).all()
        assert state.annotated == jstate.annotated
        masks = ref_labels


def test_converter_round_trip(init_params, trained_params):
    for params in (init_params, trained_params):
        leaves = jax.tree.leaves(params)
        net = _net(params)
        state = net.state_dict()
        assert len(state) == len(leaves) == 112
        assert sum(v.numel() for v in state.values()) == sum(x.size for x in leaves)
        back = {}
        for key, value in state.items():
            *path, leaf = key.split(".")
            node = back
            for name in path:
                node = node.setdefault(name, {})
            x = value.numpy()
            if leaf == "weight" and x.ndim == 4:
                node["kernel"] = x.transpose(2, 3, 1, 0)
            else:
                node["scale" if leaf == "weight" else leaf] = x
        jax.tree.map(np.testing.assert_array_equal, back, params)
    assert sum(x.size for x in jax.tree.leaves(trained_params)) == 8_702_498
    # with the top-level "params" of a flax variables dict
    wrapped = ipnet_state_dict_from_numpy({"params": init_params})
    assert all(torch.equal(wrapped[k], v) for k, v in _net(init_params).state_dict().items())


def test_create_loads_checkpoint_or_seeded_init(tmp_path):
    """No ipnet.pt: the seeded init (deterministic per seed); with one: it."""
    a = T.IPNetAdapter.create(seed=0, ckpt_dir=str(tmp_path), device="cpu")
    b = T.IPNetAdapter.create(seed=0, ckpt_dir=None, device="cpu")
    c = T.IPNetAdapter.create(seed=1, device="cpu")
    for (name, x), y, z in zip(a.net.state_dict().items(), b.net.state_dict().values(),
                               c.net.state_dict().values()):
        assert torch.equal(x, y)
        if name.endswith("Conv_0.weight"):
            assert not torch.equal(x, z)
            fan_in = x.shape[1] * x.shape[2] * x.shape[3]
            assert abs(float(x.std()) * np.sqrt(fan_in) - 1.0) < 0.25  # LeCun normal
    state = {k: torch.full_like(v, 0.5) for k, v in a.net.state_dict().items()}
    torch.save(state, tmp_path / T.IPNET_CKPT)
    d = T.IPNetAdapter.create(seed=0, ckpt_dir=str(tmp_path), device="cpu")
    assert all(torch.equal(v, state[k]) for k, v in d.net.state_dict().items())
