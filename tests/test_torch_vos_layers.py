"""The VOS building blocks of the port (``models/vos/layers.py``) against
the JAX package's, on the same seeded inputs and converted flax params.

Tolerances:
- float32 blocks, encoder and decoder: 1e-4 relative to the largest output
  (two float32 convolution libraries summing in different orders; measured
  ≤ 3.5e-6);
- bfloat16 blocks: one block agrees but for a few values one ulp apart (the
  GroupNorm statistics' float32 sums run in another order, so a value on a
  rounding boundary goes the other way): at most 2⁻⁶ of the largest output,
  and at most 1 % of the values differ (measured ≤ 5.2e-3 and ≤ 0.23 %).
  Through the 13-conv encoder those flips compound (measured: up to 53 % of
  r4's values differ by one or two ulps, 1.1e-2 of the largest value), so
  the encoder and the decoder are held to 2⁻⁴ of the largest output;
- ``resize_bilinear`` against ``jax.image.resize``: bfloat16 equal, float32
  1e-6 relative (the weights' normalising sum, one ulp);
- ``global_match_readout``: 2⁻⁷ relative in bfloat16 (float32 logits of
  bf16 operands, one rounding of the weights and of the readout);
- ``labels_and_probs``: equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ivosw_tpu.models.vos import layers as J
from ivosw_tpu_torch.models.vos import layers as L
from ivosw_tpu_torch.utils.convert import tapnet_state_dict_from_numpy

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
SIZES = [(48, 64), (50, 70)]
F32_RTOL = 1e-4
BF16_BLOCK_RTOL, BF16_BLOCK_SHARE = 2.0**-6, 0.01
BF16_DEEP_RTOL = 2.0**-4


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Small tensors: two intra-op threads are as fast alone, and leave the
    cores to the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x, np.float32).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.float().numpy().transpose(0, 2, 3, 1)


def _params(variables):
    return tapnet_state_dict_from_numpy(jax.tree.map(np.asarray, variables["params"]))


def _check(ours, ref, dtype, deep=False):
    ours, ref = np.asarray(ours, np.float32), np.asarray(ref, np.float32)
    assert ours.shape == ref.shape
    scale = float(np.abs(ref).max())
    err = np.abs(ours - ref)
    if dtype == "float32":
        assert err.max() <= F32_RTOL * scale
    elif deep:
        assert err.max() <= BF16_DEEP_RTOL * scale
    else:
        assert err.max() <= BF16_BLOCK_RTOL * scale
        assert (err > 0).mean() <= BF16_BLOCK_SHARE


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("hw", SIZES)
@pytest.mark.parametrize("block", ["conv7s2", "conv3", "res_same", "res_down"])
def test_blocks_match_jax(block, hw, dtype):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(hw[1])
    cin = 3 if block == "conv7s2" else 32
    x = rng.standard_normal((2,) + hw + (cin,)).astype(np.float32)
    jm, tm = {
        "conv7s2": (J.ConvBlock(32, 7, 2, jdt), L.ConvBlock(cin, 32, 7, 2, tdt)),
        "conv3": (J.ConvBlock(64, 3, 1, jdt), L.ConvBlock(cin, 64, 3, 1, tdt)),
        "res_same": (J.ResBlock(32, 1, jdt), L.ResBlock(cin, 32, 1, tdt)),
        "res_down": (J.ResBlock(64, 2, jdt), L.ResBlock(cin, 64, 2, tdt)),
    }[block]
    # a block's input is already in its dtype (the identity residual keeps it)
    xj = jnp.asarray(x).astype(jdt)
    variables = jm.init(jax.random.PRNGKey(1), xj)
    # GroupNorm affines away from identity, so the converter's mapping shows
    variables = jax.tree.map(
        lambda a: a * (1.0 + 0.1 * rng.standard_normal(a.shape).astype(np.float32)), variables
    )
    ref = np.asarray(jm.apply(variables, xj).astype(jnp.float32))
    tm.load_state_dict(_params(variables))
    with torch.no_grad():
        out = tm(_nchw(x).to(tdt))
    assert out.dtype == tdt
    _check(_nhwc(out), ref, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("hw", SIZES)
def test_encoder_decoder_match_jax(hw, dtype):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(0)
    x = rng.random((2,) + hw + (3,)).astype(np.float32)
    jenc = J.VOSEncoder(dtype=jdt)
    venc = jenc.init(jax.random.PRNGKey(0), jnp.asarray(x))
    refs = jenc.apply(venc, jnp.asarray(x))
    enc = L.VOSEncoder(3, dtype=tdt)
    enc.load_state_dict(_params(venc))
    with torch.no_grad():
        feats = enc(_nchw(x))
    for ours, ref in zip(feats, refs):
        assert ours.dtype == tdt
        _check(_nhwc(ours), np.asarray(ref.astype(jnp.float32)), dtype, deep=True)

    # the decoder on the JAX encoder's features, so it is held on its own
    jdec = J.VOSDecoder(dtype=jdt)
    r4, r3, r2 = refs
    vdec = jdec.init(jax.random.PRNGKey(2), r4, r3, r2, hw)
    ref_logit = np.asarray(jdec.apply(vdec, r4, r3, r2, hw))
    dec = L.VOSDecoder(256, 128, 64, dtype=tdt)
    dec.load_state_dict(_params(vdec))
    to_t = lambda a: _nchw(np.asarray(a.astype(jnp.float32))).to(tdt)
    with torch.no_grad():
        logit = dec(to_t(r4), to_t(r3), to_t(r2), hw)
    assert logit.dtype == torch.float32 and logit.shape == (2,) + hw
    _check(logit.numpy(), ref_logit, dtype, deep=True)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shapes", [
    ((3, 4), (6, 8)), ((4, 5), (7, 13)), ((13, 18), (50, 70)), ((12, 16), (48, 64)),
    ((48, 64), (3, 4)), ((50, 70), (13, 18)), ((50, 70), (4, 5)), ((48, 64), (48, 16)),
])
def test_resize_matches_jax_image_resize(shapes, dtype):
    """Up- and downsampling (antialiased), odd sizes, one axis unchanged."""
    jdt, tdt = DTYPES[dtype]
    (ih, iw), (oh, ow) = shapes
    x = np.random.default_rng(ih * iw).standard_normal((2, ih, iw, 3)).astype(np.float32)
    ref = np.asarray(
        jax.image.resize(jnp.asarray(x).astype(jdt), (2, oh, ow, 3), "bilinear").astype(jnp.float32)
    )
    out = L.resize_bilinear(_nchw(x).to(tdt), (oh, ow))
    assert out.dtype == tdt and out.shape == (2, 3, oh, ow)
    if dtype == "bfloat16":
        np.testing.assert_array_equal(_nhwc(out), ref)
    else:
        np.testing.assert_allclose(_nhwc(out), ref, rtol=0, atol=1e-6 * np.abs(ref).max())


@pytest.mark.parametrize("dtype", DTYPES)
def test_global_match_readout_matches_jax(dtype):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(5)
    q = rng.standard_normal((2, 12, 32)).astype(np.float32)
    k = rng.standard_normal((2, 40, 32)).astype(np.float32)
    valid = (rng.random((2, 40)) < 0.6).astype(np.float32)
    valid[:, 0] = 1.0
    ref = np.asarray(J.global_match_readout(q, k, k, valid, jdt).astype(jnp.float32))
    out = L.global_match_readout(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(k),
                                 torch.from_numpy(valid), tdt)
    assert out.dtype == tdt
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=0,
                               atol=2.0**-7 * np.abs(ref).max())


@pytest.mark.parametrize("dtype", DTYPES)
def test_labels_and_probs_match_jax(dtype):
    """Ties (equal objects, exactly 0.5) included; labels come from the
    float32 maps before the cast."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(9)
    probs = rng.choice(np.float32([0.2, 0.5, 0.50390625, 0.7, 0.9]), size=(3, 3, 8, 10))
    probs[:, 1] = np.where(rng.random((3, 8, 10)) < 0.3, probs[:, 0], probs[:, 1])
    ref_labels, ref_p = J.labels_and_probs(jnp.asarray(probs), dtype=jdt)
    labels, all_p = L.labels_and_probs(torch.from_numpy(probs), tdt)
    assert labels.dtype == torch.uint8 and all_p.dtype == tdt
    np.testing.assert_array_equal(labels.numpy(), np.asarray(ref_labels))
    np.testing.assert_array_equal(all_p.float().numpy(), np.asarray(ref_p.astype(jnp.float32)))
