"""MatchNet in the port (``models/vos/matchnet.py``) against the JAX package's.

- The embedding encoder and both guided heads on the converted
  ``init_matchnet_params(0)`` at 48×64: float32 outputs within 1e-4 of the
  largest; bfloat16 within :data:`BF16_RTOL` of the largest.
  ``begin_sequence`` on T=6 frames in chunks of 4 (the JAX package pads
  the last chunk with zero frames, the port does not): within
  :data:`BF16_RTOL`.
- ``object_sim_maps`` against ``_object_sim_maps`` with an empty object, an
  object covering every pixel and a partial one: on seeded features within
  :data:`SIM_ATOL` (bf16-rounded operands of float32 norms taken in other
  orders; measured 6.0e-8); on features built so that every similarity is
  −|v̂|² < −1, exactly, showing the three cases apart: −1 for the empty
  object, the plain max (below −1) for the full one, the −1 floor for the
  partial one. No tensor the function makes holds more than P·M values.
- The adapter over 3 rounds (48×64, T=6, O=2) with the trained demo
  weights and the same scribbles on both sides: probabilities within
  :data:`PROB_ATOL` (measured 1.4e-2 in float32 storage and in bfloat16),
  labels equal except at pixels within :data:`PROB_ATOL` of a decision
  (measured: 1 to 4 of 18,432 pixels per round), ``state.global_map``
  within :data:`GLOBAL_ATOL` (measured 7.3e-3), the annotated frames equal.
- The converter: the flax trees (seeded init and ``weights_demo``) load
  strictly, hold 70 leaves and 5.13 M parameters, and the module's state
  dict laid back out (OIHW → HWIO) is the flax tree again.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ivosw_tpu.data.registry import SequenceRegistry as JaxRegistry
from ivosw_tpu.data.scribbles import merge_scribbles
from ivosw_tpu.interact.robot import ScribbleRobot as JaxRobot
from ivosw_tpu.models.vos import matchnet as J
from ivosw_tpu.utils.checkpoint import load_pytree
from ivosw_tpu_torch.models.vos import matchnet as T
from ivosw_tpu_torch.utils.convert import matchnet_state_dict_from_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BF16_RTOL = 2.0**-4
PROB_ATOL = 2.0**-5
GLOBAL_ATOL = 2.0**-6
SIM_ATOL = 2.0**-8
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
    return _numpy(load_pytree(os.path.join(REPO, "weights_demo", "matchnet.orbax"),
                              device=False))


@pytest.fixture(scope="module")
def init_params():
    return _numpy(J.init_matchnet_params(0, hw=(48, 64)))


def _net(params, dtype=torch.bfloat16):
    net = T.MatchNet(dtype)
    net.load_state_dict(matchnet_state_dict_from_numpy(params))
    return net.eval()


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x, np.float32).transpose(0, 3, 1, 2)))


def _close(ours, ref, rtol):
    ref = np.asarray(jnp.asarray(ref).astype(jnp.float32))
    ours = ours.float().numpy()
    assert ours.shape == ref.shape
    assert np.abs(ours - ref).max() <= rtol * np.abs(ref).max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encoder_and_heads_match_jax(init_params, dtype):
    """The guide planes keep the JAX package's order along the channels:
    a swap would read the converted weights of other channels."""
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    rtol = 1e-4 if dtype == "float32" else BF16_RTOL
    rng = np.random.default_rng(8)
    h, w, o = 48, 64, 2
    img = rng.random((1, h, w, 3)).astype(np.float32)
    jnet, net = J.MatchNet(dtype=jdt), _net(init_params, tdt)
    apply = lambda *args, method: jnet.apply({"params": init_params}, *args, method=method)
    ref_feats = apply(img, method=J.MatchNet.encode)
    with torch.no_grad():
        feats = net.emb_enc(_nchw(img))
    for ours, ref in zip(feats, ref_feats):
        assert ours.dtype == tdt
        _close(ours, np.asarray(ref.astype(jnp.float32)).transpose(0, 3, 1, 2), rtol)

    # the heads on the JAX encoder's features, so each is held alone
    bcast = [jnp.broadcast_to(f, (o,) + f.shape[1:]) for f in ref_feats]
    to_t = lambda a: _nchw(np.asarray(a.astype(jnp.float32))).to(tdt)
    for head, method, g in ((net.int_head, J.MatchNet.interact, 3),
                            (net.prop_head, J.MatchNet.propagate, 4)):
        guide = rng.uniform(-1.0, 1.0, (o, h // 4, w // 4, g)).astype(np.float32)
        ref_logit = apply(*bcast, jnp.asarray(guide, jnp.bfloat16), (h, w), method=method)
        with torch.no_grad():
            logit = head(*(to_t(f) for f in bcast),
                         _nchw(guide).to(torch.bfloat16), (h, w))
        assert logit.dtype == torch.float32
        _close(logit, ref_logit, rtol)


def test_begin_sequence_features_match_jax(init_params):
    """The JAX package zero-pads the last encoder chunk (6 frames in chunks
    of 4); the port encodes the 2 frames alone."""
    frames = np.random.default_rng(6).random((6, 48, 64, 3), dtype=np.float32)
    jstate = J.MatchNetAdapter(jax.tree.map(jnp.asarray, init_params), encode_chunk=4
                               ).begin_sequence(frames, 2)
    state = T.MatchNetAdapter(_net(init_params), encode_chunk=4, device="cpu"
                              ).begin_sequence(frames, 2)
    for ours, ref in zip(state.feats, jstate.feats):
        _close(ours, np.asarray(ref.astype(jnp.float32)).transpose(0, 3, 1, 2), BF16_RTOL)
    np.testing.assert_array_equal(state.global_map.numpy(), np.asarray(jstate.global_map))


class _LargestTensor(TorchDispatchMode):
    """The largest number of values any op returns inside the mode."""

    def __init__(self):
        super().__init__()
        self.largest = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for x in out if isinstance(out, (tuple, list)) else (out,):
            if isinstance(x, torch.Tensor):
                self.largest = max(self.largest, x.numel())
        return out


def _sim_case(emb, ref_emb, probs):
    """(port, JAX) similarity maps: emb, ref_emb [h, w, C], probs [O, h, w];
    checks that no op of the port made a tensor beyond P·M values."""
    ref = np.asarray(J._object_sim_maps(jnp.asarray(emb), jnp.asarray(ref_emb),
                                        jnp.asarray(probs)))
    chw = lambda x: torch.from_numpy(np.ascontiguousarray(x.transpose(2, 0, 1)))
    with _LargestTensor() as mode:
        ours = T.object_sim_maps(chw(emb), chw(ref_emb), torch.from_numpy(probs))
    p = emb.shape[0] * emb.shape[1]
    assert mode.largest <= p * p < probs.shape[0] * p * p
    assert ours.dtype == torch.float32 and ours.shape == ref.shape
    return ours.numpy(), ref


def test_object_sim_maps_match_jax():
    rng = np.random.default_rng(9)
    h, w, c = 12, 16, 64
    emb = rng.normal(size=(h, w, c)).astype(np.float32)
    ref_emb = rng.normal(size=(h, w, c)).astype(np.float32)
    probs = np.stack([
        np.zeros((h, w), np.float32),  # empty
        np.ones((h, w), np.float32),  # every pixel a member
        (rng.random((h, w)) < 0.3).astype(np.float32),  # partial
    ])
    ours, ref = _sim_case(emb, ref_emb, probs)
    assert np.abs(ours - ref).max() <= SIM_ATOL
    np.testing.assert_array_equal(ours[0], -1.0)
    assert (ours[2] >= -1.0).all()

    # every similarity −|v̂|² (v̂ = (1,1,1)/√3 rounded to bf16) is below −1
    v = np.ones((h, w, 3), np.float32)
    ours, ref = _sim_case(v, -v, probs)
    np.testing.assert_array_equal(ours, ref)
    plain = -3.0 * float(torch.tensor(1.0 / np.sqrt(3.0), dtype=torch.bfloat16)) ** 2
    np.testing.assert_array_equal(ours[0], -1.0)  # no member
    np.testing.assert_allclose(ours[1], plain, rtol=1e-6)  # all members: the plain max
    assert plain < -1.0
    np.testing.assert_array_equal(ours[2], -1.0)  # the floor of the non-members


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
    jax_adapter = J.MatchNetAdapter(jax.tree.map(jnp.asarray, trained_params), qa_dtype=jdt)
    adapter = T.MatchNetAdapter(_net(trained_params), qa_dtype=tdt, device="cpu")
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
        gm = np.asarray(jstate.global_map)
        assert state.global_map.shape == gm.shape
        assert np.abs(state.global_map.numpy() - gm).max() <= GLOBAL_ATOL
        assert state.annotated == jstate.annotated
        masks = ref_labels


def test_converter_round_trip(init_params, trained_params):
    for params in (init_params, trained_params):
        leaves = jax.tree.leaves(params)
        net = _net(params)
        state = net.state_dict()
        assert len(state) == len(leaves) == 70
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
    assert sum(x.size for x in jax.tree.leaves(trained_params)) == 5_127_394
    wrapped = matchnet_state_dict_from_numpy({"params": init_params})
    assert all(torch.equal(wrapped[k], v) for k, v in _net(init_params).state_dict().items())


def test_create_loads_checkpoint_or_seeded_init(tmp_path):
    """No matchnet.pt: the seeded init (deterministic per seed); with one: it."""
    a = T.MatchNetAdapter.create(seed=0, ckpt_dir=str(tmp_path), device="cpu")
    b = T.MatchNetAdapter.create(seed=0, ckpt_dir=None, device="cpu")
    c = T.MatchNetAdapter.create(seed=1, device="cpu")
    for (name, x), y, z in zip(a.net.state_dict().items(), b.net.state_dict().values(),
                               c.net.state_dict().values()):
        assert torch.equal(x, y)
        if name.endswith("Conv_0.weight"):
            assert not torch.equal(x, z)
            fan_in = x.shape[1] * x.shape[2] * x.shape[3]
            assert abs(float(x.std()) * np.sqrt(fan_in) - 1.0) < 0.25  # LeCun normal
    state = {k: torch.full_like(v, 0.5) for k, v in a.net.state_dict().items()}
    torch.save(state, tmp_path / T.MATCHNET_CKPT)
    d = T.MatchNetAdapter.create(seed=0, ckpt_dir=str(tmp_path), device="cpu")
    assert all(torch.equal(v, state[k]) for k, v in d.net.state_dict().items())
