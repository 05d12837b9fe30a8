"""The port's VOS trainer (``ivosw_tpu_torch/train/train_vos.py``) against
the JAX package's, for what all three families share: the window stream,
the cv2-free mask degradation, the losses' elements, the guide resize, the
similarity maps' gradient at ties, the B-window step, resume, the written
checkpoint and the device policy. ``torch_train_vos_cases.py`` states the
inputs and bounds; the per-family files hold each window loss."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_train_vos_cases as cases
from ivosw_tpu.models.vos.matchnet import _object_sim_maps as jax_sim_maps
from ivosw_tpu.train import train_vos as jax_tv
from ivosw_tpu_torch.core.config import Config
from ivosw_tpu_torch.models.vos.layers import resize_bilinear
from ivosw_tpu_torch.models.vos.matchnet import object_sim_maps
from ivosw_tpu_torch.train import train_vos as tv


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads leave the cores to the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def assert_windows_equal(ours, theirs):
    assert ours.keys() == theirs.keys()
    for k in ours:
        a, b = np.asarray(ours[k]), np.asarray(theirs[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert np.array_equal(a, b), k


@pytest.mark.parametrize("window", [3, 5])
def test_window_stream_is_bit_equal(window):
    """16 windows of each package's stream, same seed and registry: every
    array equal, round-1 and round-2 windows both drawn."""
    ours, theirs = cases.windows(16, seed=4, window=window)
    for a, b in zip(ours, theirs):
        assert_windows_equal(a, b)
    assert {float(w["mem2_valid"]) for w in ours} == {0.0, 1.0}


def test_window_stream_on_demo_clips():
    """The demo generator's clips (48 frames, objects entering and leaving
    through the churn window) in both packages: equal windows."""
    from ivosw_tpu.data.demo import demo_training_registry as jax_pool
    from ivosw_tpu.interact.robot import ScribbleRobot as JaxRobot
    from ivosw_tpu_torch.data.demo import demo_training_registry
    from ivosw_tpu_torch.interact.robot import ScribbleRobot

    reg, jreg = demo_training_registry(n_clips=2, seed=1), jax_pool(n_clips=2, seed=1)
    ours = tv.sample_windows(reg, reg.subset("train"), np.random.default_rng(2), 5,
                             ScribbleRobot(seed=2))
    theirs = jax_tv.sample_windows(jreg, jreg.subset("train"), np.random.default_rng(2), 5,
                                   JaxRobot(seed=2))
    for _ in range(12):
        assert_windows_equal(next(ours), next(theirs))


def test_degrade_masks_matches_cv2():
    """``_degrade_masks`` without cv2 against the JAX package's (cv2's
    erode/dilate with their default border) over 240 seeds, on masks that
    touch every border: equal maps and the generators left in the same
    state."""
    base = np.zeros((3, 4, 24, 32), np.float32)
    base[0, :, :9, :12] = 1.0  # top-left corner
    base[1, :, 10:, 20:] = 1.0  # bottom-right corner
    base[2, :, 5:19, 7:25] = 1.0  # inside
    base[2, 1, :, 0] = 1.0  # left edge line
    for seed in range(240):
        gt = base if seed % 2 else np.roll(base, seed, axis=3)
        r1, r2 = np.random.default_rng(seed), np.random.default_rng(seed)
        ours, theirs = tv._degrade_masks(gt, r1), jax_tv._degrade_masks(gt, r2)
        assert ours.dtype == theirs.dtype and np.array_equal(ours, theirs), seed
        assert r1.random() == r2.random(), seed
        assert np.array_equal(tv._prev_labels(ours), jax_tv._prev_labels(theirs))


def test_bce_matches_jax():
    """Both cross-entropies and their gradients, logits from −30 to 30 and
    probabilities on and past the clip's ends."""
    rng = np.random.default_rng(0)
    logit = np.concatenate([rng.normal(0, 4, 200), [-30.0, 30.0, 0.0]]).astype(np.float32)
    prob = np.concatenate([rng.random(200), [0.0, 1.0, 1e-7]]).astype(np.float32)
    target = (rng.random(203) < 0.5).astype(np.float32)
    for ours, theirs, x in ((tv.bce_with_logits, jax_tv.bce_with_logits, logit),
                            (tv.bce_probs, jax_tv.bce_probs, prob)):
        xt = torch.from_numpy(x).requires_grad_()
        value = ours(xt, torch.from_numpy(target))
        value.sum().backward()
        jvalue, jgrad = jax.value_and_grad(lambda v: theirs(v, target).sum())(jnp.asarray(x))
        np.testing.assert_allclose(value.detach().numpy(), theirs(x, target), rtol=1e-6,
                                   atol=1e-7)
        np.testing.assert_allclose(float(value.sum()), float(jvalue), rtol=1e-6)
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgrad), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("hw,hw4", [((48, 64), (12, 16)), ((192, 256), (48, 64))])
def test_guide_resize_matches_jax_image_resize(hw, hw4):
    """MatchNet's guides: [O, H, W] float32 planes to /4 by the port's
    ``resize_bilinear`` and by ``jax.image.resize(…, "bilinear")`` as the
    JAX trainer calls it: equal within one float32 ulp of 1."""
    x = np.random.default_rng(1).random((3,) + hw).astype(np.float32)
    x[:, : hw[0] // 3] = (x[:, : hw[0] // 3] > 0.5)  # binary scribble-like rows
    ours = resize_bilinear(torch.from_numpy(x), hw4).numpy()
    theirs = np.asarray(jax.image.resize(jnp.asarray(x), (3,) + hw4, "bilinear"))
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=2.0**-23)


def test_object_sim_maps_gradient_splits_ties_as_jax():
    """Features with exact ties: two query pixels identical, two member
    reference pixels identical (so each query's max is tied between two
    members), an object whose members are every pixel, and one without
    members. The gradient with respect to both feature maps equals
    ``jax.grad`` of the JAX package's ``_object_sim_maps``: the max's
    cotangent is split evenly among tied entries in both. (Where a maximum
    is exactly −1 the two differ by construction — the JAX package's max
    also ties with its −1 fill, ``clamp_min(−1)`` passes the whole
    cotangent — and these features keep every maximum above −1.)"""
    rng = np.random.default_rng(3)
    c, h, w = 8, 4, 6
    emb = rng.normal(size=(c, h, w)).astype(np.float32)
    ref = rng.normal(size=(c, h, w)).astype(np.float32)
    emb[:, 1, 2] = emb[:, 0, 0]  # tied queries
    ref[:, 2, 3] = ref[:, 1, 1]  # tied members
    ref[:, 3, 5] = ref[:, 1, 1]
    probs = np.zeros((3, h, w), np.float32)
    probs[0, 1, 1] = probs[0, 2, 3] = probs[0, 3, 5] = 0.9
    probs[0, 0, :3] = 0.7
    probs[1] = 1.0  # every pixel a member
    weights = rng.normal(size=(3, h, w)).astype(np.float32)

    e, r = torch.from_numpy(emb).requires_grad_(), torch.from_numpy(ref).requires_grad_()
    out = object_sim_maps(e, r, torch.from_numpy(probs))
    (out * torch.from_numpy(weights)).sum().backward()

    def jax_fn(a, b):
        return (jax_sim_maps(a, b, jnp.asarray(probs)) * weights).sum()

    to_hwc = lambda x: jnp.asarray(np.ascontiguousarray(x.transpose(1, 2, 0)))
    jout = jax_sim_maps(to_hwc(emb), to_hwc(ref), jnp.asarray(probs))
    ga, gb = jax.grad(jax_fn, argnums=(0, 1))(to_hwc(emb), to_hwc(ref))
    assert float(np.asarray(jout)[0].min()) > -1.0
    # float32 products summed in other orders: one ulp
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), rtol=0, atol=1e-7)
    for got, ref_grad in ((e.grad, ga), (r.grad, gb)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref_grad).transpose(2, 0, 1),
                                   rtol=1e-5, atol=1e-6)
    # the tied members share the cotangent: equal gradients
    np.testing.assert_array_equal(r.grad[:, 2, 3].numpy(), r.grad[:, 3, 5].numpy())
    assert float(r.grad[:, 2, 3].abs().sum()) > 0


def test_dp_step_matches_jax():
    """``vos_train_step_dp`` over B=2 windows (TAPNet, one round-2 and one
    round-1 window) against the JAX package's, jitted without a mesh: the
    mean loss and the params after one Adam step, within the single step's
    bounds."""
    import optax

    ours, theirs = cases.windows(4)
    pick = [0, 3]  # round 2, round 1
    assert [float(ours[i]["mem2_valid"]) for i in pick] == [1.0, 0.0]
    params = cases.jax_params("tapnet")
    opt = optax.adam(cases.LR)
    stacked = {k: np.stack([theirs[i][k] for i in pick]) for k in theirs[0]}
    p1, _, jloss = jax_tv.vos_train_step_dp(jax.tree.map(jnp.copy, params), opt.init(params),
                                            cases.jax_batch(stacked), opt,
                                            jax_tv.tapnet_window_loss)
    net = cases.port_net("tapnet", params)
    before = {n: p.detach().clone() for n, p in net.named_parameters()}
    batch = tv.upload_window({k: np.stack([ours[i][k] for i in pick]) for k in ours[0]}, "cpu")
    loss = float(tv.vos_train_step_dp(net, tv.make_vos_optimizer(net.parameters(), cases.LR),
                                      batch, tv.tapnet_window_loss))
    share = cases.assert_step_close(before, dict(net.named_parameters()),
                                    cases.CONVERT["tapnet"](cases.numpy_tree(p1)))
    print("dp step", loss, float(jloss), "far share", share)
    assert abs(loss - float(jloss)) <= cases.LOSS_RTOL * abs(float(jloss))
    assert share <= cases.STEP_FLIP_SHARE


def _small_run(tmp_path, name, **kw):
    reg, _ = cases.registries()
    cfg = Config(seed=0, vos=kw.pop("vos", "tapnet"), ckpt_dir=str(tmp_path / name))
    return tv.run(cfg, registry=reg, window=3, lr=cases.LR, device="cpu", **kw)


def test_resume_is_bit_equal(tmp_path, monkeypatch):
    """A run killed after its third step and resumed from the step-2
    snapshot ends with the same params as an uninterrupted run, bit for
    bit; completion removes the snapshot and writes ``tapnet.pt``."""
    params = cases.CONVERT["tapnet"](cases.numpy_tree(cases.jax_params("tapnet")))
    straight = _small_run(tmp_path, "straight", num_steps=5, params=params, save_every=2,
                          resume_path=str(tmp_path / "straight.partial.pt"))
    snapshot = tmp_path / "partial.pt"
    step, calls = tv.vos_train_step, []

    def killed_after_three(*args, **kwargs):
        calls.append(1)
        if len(calls) > 3:
            raise KeyboardInterrupt
        return step(*args, **kwargs)

    monkeypatch.setattr(tv, "vos_train_step", killed_after_three)
    with pytest.raises(KeyboardInterrupt):
        _small_run(tmp_path, "resumed", num_steps=5, params=params, save_every=2,
                   resume_path=str(snapshot))
    monkeypatch.setattr(tv, "vos_train_step", step)
    assert snapshot.exists() and torch.load(snapshot, weights_only=True)["step"] == 2
    resumed = _small_run(tmp_path, "resumed", num_steps=5, params=params, save_every=2,
                         resume_path=str(snapshot))
    assert not snapshot.exists()
    assert resumed["losses"] == straight["losses"][2:]
    for k, v in straight["params"].items():
        assert torch.equal(v, resumed["params"][k]), k
    written = torch.load(tmp_path / "resumed" / "tapnet.pt", weights_only=True)
    assert all(torch.equal(written[k], v) for k, v in straight["params"].items())


@pytest.mark.parametrize("vos", ["tapnet", "matchnet", "ipnet"])
def test_adapter_loads_the_written_checkpoint(tmp_path, vos):
    """``run`` writes ``{ckpt_dir}/{family}.pt``; the family's adapter
    ``create(ckpt_dir=…)`` loads exactly those weights and segments with
    them."""
    from ivosw_tpu_torch.eval.backbones import build_backbone

    out = _small_run(tmp_path, "w", vos=vos, num_steps=1, save_every=1)
    cfg = Config(seed=5, vos=vos, ckpt_dir=str(tmp_path / "w"))
    reg, _ = cases.registries()
    adapter = build_backbone(cfg, reg, "cpu")
    state = adapter.net.state_dict()
    assert state.keys() == out["params"].keys()
    for k, v in out["params"].items():
        assert torch.equal(state[k], v), k
    frames, gt = reg.load_images("tv-a"), reg.load_annotations("tv-a")
    from ivosw_tpu_torch.interact.robot import ScribbleRobot

    scribbles = ScribbleRobot(seed=0).interact("tv-a", np.zeros_like(gt), gt, 2, frame=2)
    labels, all_p, _ = adapter.segment(adapter.begin_sequence(frames, 2), scribbles, 2, 1)
    assert labels.shape == gt.shape and bool(torch.isfinite(all_p).all())


def test_trainer_refuses_cpu_fallback(monkeypatch, tmp_path):
    """device=None means CUDA: without a GPU ``run`` and the CLI raise; the
    CLI trains on the host only with ``--cpu``."""
    reg, _ = cases.registries()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tv.run(Config(vos="ipnet"), registry=reg, num_steps=1)
    monkeypatch.chdir(tmp_path)
    argv = ["vos=tapnet", "dataset=demo", "num_steps=1", "window=3",
            f"ckpt_dir={tmp_path / 'w'}"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tv.main(argv)
    stats = tv.main(argv + ["--cpu"])
    assert np.isfinite(stats["loss_avg"]) and (tmp_path / "w" / "tapnet.pt").exists()
