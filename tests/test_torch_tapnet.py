"""TAPNet in the port (``models/vos/tapnet.py``) against the JAX package's.

- ``prop_order`` and ``compute_alpha``: equal.
- A-Net and T-Net on converted ``init_tapnet_params(0)``: float32 logits
  within 1e-4 of the largest (measured ≤ 2e-6); bfloat16 within
  :data:`BF16_LOGIT_RTOL` of the largest (the encoder's one-ulp flips
  compound, ``test_torch_vos_layers.py``; measured ≤ 1.1e-2).
- The adapter over 3 rounds (48×64, T=6, O=2) with the trained demo weights
  and the same scribbles on both sides: probabilities within
  :data:`PROB_ATOL` (measured 8.6e-3 in float32 storage, 1.2e-2 in
  bfloat16), labels equal except at pixels within :data:`PROB_ATOL` of a
  decision (the winning probability near 0.5, or the two objects' near
  each other; measured: 3 to 7 of 18,432 pixels per round), the memory
  validity and the annotated frames equal.
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
from ivosw_tpu.models.vos import tapnet as J
from ivosw_tpu.utils.checkpoint import load_pytree
from ivosw_tpu_torch.models.vos import tapnet as T
from ivosw_tpu_torch.utils.convert import tapnet_state_dict_from_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BF16_LOGIT_RTOL = 2.0**-4
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
    return _numpy(load_pytree(os.path.join(REPO, "weights_demo", "tapnet.orbax"), device=False))


@pytest.fixture(scope="module")
def init_params():
    return _numpy(J.init_tapnet_params(0))


def _net(params, dtype=torch.bfloat16):
    net = T.TAPNet(dtype)
    net.load_state_dict(tapnet_state_dict_from_numpy(params))
    return net.eval()


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x, np.float32).transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("t,a", [(6, 2), (4, 0), (4, 3), (1, 0), (9, 8), (9, 4)])
@pytest.mark.parametrize("direction", ["bwd_fwd", "fwd_bwd"])
def test_prop_order_matches_jax(t, a, direction):
    for ours, ref in zip(T.prop_order(t, a, direction), J.prop_order(t, a, direction)):
        np.testing.assert_array_equal(ours, ref)
        assert ours.dtype == ref.dtype


@pytest.mark.parametrize("prev,now", [
    ([], 3), ([0], 4), ([5], 1), ([0, 8], 4), ([2, 3, 7], 5), ([1], 1), ([9], 9),
])
def test_compute_alpha_matches_jax(prev, now):
    prev = np.array(prev, dtype=np.int64)
    ours, ref = T.compute_alpha(10, prev, now), J.compute_alpha(10, prev, now)
    np.testing.assert_array_equal(ours, ref)
    assert ours.dtype == ref.dtype


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_anet_tnet_match_jax(init_params, dtype):
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    rng = np.random.default_rng(4)
    h, w, o = 48, 64, 2
    img = rng.random((o, h, w, 3)).astype(np.float32)
    inter = (rng.random((o, h, w, 3)) < 0.3).astype(np.float32)
    jnet = J.TAPNet(dtype=jdt)
    net = _net(init_params, tdt)
    rtol = 1e-4 if dtype == "float32" else BF16_LOGIT_RTOL

    def close(ours, ref):
        ref = np.asarray(ref.astype(jnp.float32))
        assert np.abs(ours - ref).max() <= rtol * np.abs(ref).max()

    ref_logit, ref_r4 = jnet.apply({"params": init_params}, img, inter, method=J.TAPNet.interact)
    with torch.no_grad():
        logit, r4 = net.anet(_nchw(img), _nchw(inter))
    assert logit.dtype == torch.float32 and r4.dtype == tdt
    close(logit.numpy(), ref_logit)

    # T-Net on the JAX encoder's features and memory, so it is held alone
    feats = jnet.apply({"params": init_params}, img[:1], method=J.TAPNet.encode_frames)
    mem = jnp.concatenate([ref_r4.reshape(o, -1, 256)] * 2, axis=1)
    valid = np.zeros((o, mem.shape[1]), np.float32)
    valid[:, : mem.shape[1] // 2] = 1.0
    prev = rng.random((o, h, w)).astype(np.float32)
    bcast = [jnp.broadcast_to(f, (o,) + f.shape[1:]) for f in feats]
    ref_t = jnet.apply({"params": init_params}, *bcast, mem, jnp.asarray(valid), prev, (h, w),
                       method=J.TAPNet.transfer)
    to_t = lambda a: _nchw(np.asarray(a.astype(jnp.float32))).to(tdt)
    with torch.no_grad():
        t_logit = net.tnet(*(to_t(f) for f in bcast),
                           torch.from_numpy(np.asarray(mem.astype(jnp.float32))).to(tdt),
                           torch.from_numpy(valid), torch.from_numpy(prev), (h, w))
    close(t_logit.numpy(), ref_t)


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
    jax_adapter = J.TAPNetAdapter(jax.tree.map(jnp.asarray, trained_params), qa_dtype=jdt)
    adapter = T.TAPNetAdapter(_net(trained_params), qa_dtype=tdt, device="cpu")
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
        np.testing.assert_array_equal(state.mem_valid.numpy(), jstate.mem_valid)
        assert state.annotated == jstate.annotated
        masks = ref_labels


def test_create_loads_checkpoint_or_seeded_init(tmp_path):
    """No tapnet.pt: the seeded init (deterministic per seed); with one: it."""
    a = T.TAPNetAdapter.create(seed=0, ckpt_dir=str(tmp_path), device="cpu")
    b = T.TAPNetAdapter.create(seed=0, ckpt_dir=None, device="cpu")
    c = T.TAPNetAdapter.create(seed=1, device="cpu")
    for (name, x), y, z in zip(a.net.state_dict().items(), b.net.state_dict().values(),
                               c.net.state_dict().values()):
        assert torch.equal(x, y)
        if name.endswith("Conv_0.weight"):
            assert not torch.equal(x, z)
            fan_in = x.shape[1] * x.shape[2] * x.shape[3]
            assert abs(float(x.std()) * np.sqrt(fan_in) - 1.0) < 0.25  # LeCun normal
    state = {k: torch.full_like(v, 0.5) for k, v in a.net.state_dict().items()}
    torch.save(state, tmp_path / T.TAPNET_CKPT)
    d = T.TAPNetAdapter.create(seed=0, ckpt_dir=str(tmp_path), device="cpu")
    assert all(torch.equal(v, state[k]) for k, v in d.net.state_dict().items())
