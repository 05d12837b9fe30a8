"""The VOS trainer of the port against the JAX package's
(``ivosw_tpu/train/train_vos.py``), shared by ``test_torch_train_vos*.py``.

Inputs: two synthetic 48×64 clips with two objects (``SequenceRegistry.
synthetic``, 6 frames, seed 9) and K=3 windows drawn by both packages'
``sample_windows`` from ``np.random.default_rng(0)`` (the tests hold them
bit-equal first). Weights: the JAX package's seeded init (``hw=(48, 64)``)
as float32 numpy arrays, converted by ``utils/convert.py``; the JAX
gradients are converted by the same converter.

Bounds, from measurement at these sizes (the tests print what they
measure with ``-s``):

- bfloat16 nets. The two packages round the backward's bf16 cotangents at
  the same points but sum in other orders; in each package bf16 gradients
  are only good to a median of 7 % and a worst tensor of 20-21 % (relative
  L2) against its own float32 gradients (TAPNet, first round-2 window). The
  port against the JAX package measured a median 5.9-8.5 % and a worst
  tensor 14.7-19.2 % over the three families, the loss within 4.7e-4
  relative. Held: every tensor within :data:`GRAD_RTOL`, the median within
  :data:`GRAD_MEDIAN_RTOL`, the loss within :data:`LOSS_RTOL`.
- float32 nets (the JAX modules subclassed with ``dtype=float32`` in the
  test only): the loss within 3.4e-7 relative (:data:`F32_LOSS_RTOL`);
  TAPNet and IPNet gradients within 3.1e-6 per tensor from the port's
  seeded init, held to :data:`F32_GRAD_RTOL` plus the tensor's own
  sensitivity to one ulp of image noise (:func:`check_float32_grads`). MatchNet keeps bf16 similarity operands and guide
  planes in both packages (``_object_sim_maps``, the guides' cast), so a
  few guide values round the other way: 3.0e-3 per tensor, held to
  :data:`F32_MATCHNET_GRAD_RTOL`.
- One Adam step from the same params: the first step moves each element
  by ``lr·g/(|g| + ε)``, about ±lr, so an element whose gradient's sign
  differs between the packages moves the other way: every element within
  ``2·lr`` (plus float32 rounding of the params) of the JAX package's, and
  the share of elements further apart than ``lr/100`` under
  :data:`STEP_FLIP_SHARE` (measured 3.0-4.9 %).
- ``run`` for 3 steps: the first loss within :data:`LOSS_RTOL`, every loss
  within :data:`RUN_LOSS_RTOL` (measured 1.6e-3), the final params within
  ``2·lr·3`` (after the first step most elements differ by more than
  lr/100: Adam's normalised steps follow each gradient's sign).
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp
import optax

from ivosw_tpu.data.registry import SequenceRegistry as JaxRegistry
from ivosw_tpu.interact.robot import ScribbleRobot as JaxRobot
from ivosw_tpu.models.vos import ipnet as jax_ipnet
from ivosw_tpu.models.vos import matchnet as jax_matchnet
from ivosw_tpu.models.vos import tapnet as jax_tapnet
from ivosw_tpu.train import train_vos as jax_tv
from ivosw_tpu_torch.data.registry import SequenceRegistry
from ivosw_tpu_torch.interact.robot import ScribbleRobot
from ivosw_tpu_torch.train import train_vos as tv
from ivosw_tpu_torch.utils.convert import (
    ipnet_state_dict_from_numpy,
    matchnet_state_dict_from_numpy,
    tapnet_state_dict_from_numpy,
)

LOSS_RTOL = 2e-3
GRAD_RTOL = 0.3
GRAD_MEDIAN_RTOL = 0.12
F32_LOSS_RTOL = 1e-6
F32_GRAD_RTOL = 1e-4
F32_MATCHNET_GRAD_RTOL = 1e-2
STEP_FLIP_SHARE = 0.1
RUN_LOSS_RTOL = 5e-3
LR = 3e-4
WINDOW = 3
HW = (48, 64)
CONVERT = {
    "tapnet": tapnet_state_dict_from_numpy,
    "matchnet": matchnet_state_dict_from_numpy,
    "ipnet": ipnet_state_dict_from_numpy,
}
_SYNTH = dict(num_frames=6, image_size=(64, 48), num_objects=2, split="train", seed=9)


def registries():
    """(the port's, the JAX package's) two-clip training registry."""
    names = ["tv-a", "tv-b"]
    return SequenceRegistry.synthetic(names, **_SYNTH), JaxRegistry.synthetic(names, **_SYNTH)


def windows(n, seed=0, window=WINDOW, round2_prob=0.5):
    """n windows of each package's stream from the same seed → (port's,
    JAX package's) lists of host dicts."""
    reg, jreg = registries()
    ours = tv.sample_windows(reg, reg.subset("train"), np.random.default_rng(seed), window,
                             ScribbleRobot(seed=seed), round2_prob=round2_prob)
    theirs = jax_tv.sample_windows(jreg, jreg.subset("train"), np.random.default_rng(seed),
                                   window, JaxRobot(seed=seed), round2_prob=round2_prob)
    return [next(ours) for _ in range(n)], [next(theirs) for _ in range(n)]


def jax_batch(window):
    return {k: jnp.asarray(v) for k, v in window.items()}


def numpy_tree(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float32), tree)


def jax_params(family, seed=0):
    """The JAX package's seeded init of ``family`` (a tree of jax arrays)."""
    return jax_tv._family(family)[0](seed, hw=HW)


def port_net(family, params, dtype=torch.bfloat16):
    """The port's net of ``family`` with the converted JAX params."""
    net = tv._family(family)[0](dtype=dtype)
    net.load_state_dict(CONVERT[family](numpy_tree(params)))
    return net


def port_loss_and_grads(family, net, window):
    net.zero_grad(set_to_none=True)
    loss = tv._family(family)[2](net, tv.upload_window(window, "cpu"))
    loss.backward()
    return float(loss.detach()), {n: p.grad.detach().clone() for n, p in net.named_parameters()}


def jax_loss_and_grads(family, params, window, value_and_grad=None):
    value_and_grad = value_and_grad or jax.jit(jax.value_and_grad(jax_tv._family(family)[1]))
    loss, grads = value_and_grad(params, jax_batch(window))
    return float(loss), CONVERT[family](numpy_tree(grads))


def grad_errors(got, ref):
    """Per-tensor relative L2 error of the port's gradients."""
    return {n: float((got[n] - ref[n]).norm() / ref[n].norm().clamp_min(1e-30)) for n in ref}


class Float32JaxModules:
    """Context: the JAX package's nets built in float32 (subclasses with
    ``dtype=float32`` put in place of the classes the window losses
    instantiate), for the test that holds float32 gradients."""

    def __enter__(self):
        class TAPNet32(jax_tapnet.TAPNet):
            dtype: jnp.dtype = jnp.float32

        class MatchNet32(jax_matchnet.MatchNet):
            dtype: jnp.dtype = jnp.float32

        class IPNet32(jax_ipnet.IPNet):
            dtype: jnp.dtype = jnp.float32

        self.saved = (jax_tv.TAPNet, jax_matchnet.MatchNet, jax_ipnet.IPNet)
        jax_tv.TAPNet, jax_matchnet.MatchNet, jax_ipnet.IPNet = TAPNet32, MatchNet32, IPNet32
        return self

    def __exit__(self, *exc):
        jax_tv.TAPNet, jax_matchnet.MatchNet, jax_ipnet.IPNet = self.saved


def share_adam(monkeypatch):
    """Make ``optax.adam`` return one transformation per learning rate, so
    the JAX package's jitted step (static in its optimizer) compiles once
    for the step test and for ``run``; returns that ``optax.adam``."""
    cache, adam = {}, optax.adam
    monkeypatch.setattr(optax, "adam", lambda lr: cache.setdefault(lr, adam(lr)))
    return optax.adam


def check_window_grads(family):
    """bf16 window loss and gradients on a round-2 and a round-1 window."""
    wins, jwins = windows(4)
    picked = [i for i in range(4) if wins[i]["mem2_valid"] == 1][:1] + \
             [i for i in range(4) if wins[i]["mem2_valid"] == 0][:1]
    assert len(picked) == 2, "the seeded stream must hold both kinds of window"
    params = jax_params(family)
    net = port_net(family, params)
    vg = jax.jit(jax.value_and_grad(jax_tv._family(family)[1]))
    for i in picked:
        loss, grads = port_loss_and_grads(family, net, wins[i])
        jloss, jgrads = jax_loss_and_grads(family, params, jwins[i], vg)
        errs = grad_errors(grads, jgrads)
        worst = max(errs, key=errs.get)
        measured = {"mem2_valid": float(wins[i]["mem2_valid"]),
                    "loss_rel": abs(loss - jloss) / abs(jloss),
                    "grad_median": float(np.median(list(errs.values()))),
                    "grad_worst": (worst, errs[worst])}
        print(family, "bf16", measured)
        assert abs(loss - jloss) <= LOSS_RTOL * abs(jloss), measured
        assert errs[worst] <= GRAD_RTOL, measured
        assert measured["grad_median"] <= GRAD_MEDIAN_RTOL, measured


def ulp_noise(window, seed=1):
    """``window`` with each image value moved by one float32 ulp at random."""
    noisy = dict(window)
    flip = np.random.default_rng(seed).random(window["img"].shape) < 0.5
    noisy["img"] = (window["img"] * (1 + flip * 2.0**-23)).astype(np.float32)
    return noisy


def check_float32_grads(family):
    """float32 nets in both packages, same window (round 2), same params.
    Each tensor is held to the bound plus twice what one ulp of image noise
    moves the port's own gradient of that tensor: at the JAX package's
    seeded init a few TAPNet tensors (the frame encoder's last blocks,
    3×4 pixels at /16) move 9.4e-3 under such noise, and differ from the
    JAX package's by as much; the others agree within 1e-6."""
    wins, jwins = windows(1)
    assert wins[0]["mem2_valid"] == 1
    params = jax_params(family)
    net = port_net(family, params, torch.float32)
    with Float32JaxModules():
        jloss, jgrads = jax_loss_and_grads(family, params, jwins[0])
    loss, grads = port_loss_and_grads(family, net, wins[0])
    noise = grad_errors(port_loss_and_grads(family, net, ulp_noise(wins[0]))[1], grads)
    errs = grad_errors(grads, jgrads)
    bound = F32_MATCHNET_GRAD_RTOL if family == "matchnet" else F32_GRAD_RTOL
    over = {n: (e, noise[n]) for n, e in errs.items() if e > bound + 2 * noise[n]}
    worst = max(errs, key=errs.get)
    print(family, "float32 loss", abs(loss - jloss) / abs(jloss), "worst", worst, errs[worst],
          "its ulp noise", noise[worst], "median", np.median(list(errs.values())))
    assert abs(loss - jloss) <= F32_LOSS_RTOL * abs(jloss)
    assert not over, over


def assert_step_close(before, got, ref, lr=LR, steps=1):
    """Params after ``steps`` Adam steps from the same ``before``: every
    element within 2·lr·steps (+ float32 rounding) of the reference, and
    few elements further apart than lr/100 (see the module notes)."""
    far = total = 0
    for n, r in ref.items():
        diff = (got[n] - r).abs()
        slack = 2 * lr * steps + 4 * torch.finfo(torch.float32).eps * before[n].abs()
        assert bool((diff <= slack + 1e-12).all()), (n, float(diff.max()))
        far += int((diff > lr / 100).sum())
        total += diff.numel()
    return far / total


def check_step_and_run(family, monkeypatch, tmp_path):
    """One ``vos_train_step`` from the same params on the same window, then
    ``run`` for 3 steps in both packages from the same params: the loss
    sequence and the final params."""
    from ivosw_tpu.core.config import Config as JaxConfig
    from ivosw_tpu_torch.core.config import Config

    adam = share_adam(monkeypatch)
    loss_fn = jax_tv._family(family)[1]
    params = jax_params(family)
    wins, jwins = windows(1)
    opt = adam(LR)
    p1, _, jloss = jax_tv.vos_train_step(jax.tree.map(jnp.copy, params), opt.init(params),
                                         jax_batch(jwins[0]), opt, loss_fn)
    net = port_net(family, params)
    before = {n: p.detach().clone() for n, p in net.named_parameters()}
    loss = float(tv.vos_train_step(net, tv.make_vos_optimizer(net.parameters(), LR),
                                   tv.upload_window(wins[0], "cpu"), tv._family(family)[2]))
    got = {n: p.detach() for n, p in net.named_parameters()}
    share = assert_step_close(before, got, CONVERT[family](numpy_tree(p1)))
    print(family, "step", loss, float(jloss), "far share", share)
    assert abs(loss - float(jloss)) <= LOSS_RTOL * abs(float(jloss))
    assert share <= STEP_FLIP_SHARE

    jlosses, step = [], jax_tv.vos_train_step

    def recorded(*args, **kwargs):
        out = step(*args, **kwargs)
        jlosses.append(float(out[2]))
        return out

    monkeypatch.setattr(jax_tv, "vos_train_step", recorded)
    reg, jreg = registries()
    jcfg = JaxConfig(seed=0, vos=family, ckpt_dir=str(tmp_path / "jax"))
    theirs = jax_tv.run(jcfg, registry=jreg, num_steps=3, window=WINDOW, lr=LR,
                        params=jax.tree.map(jnp.copy, params), save_every=3)
    cfg = Config(seed=0, vos=family, ckpt_dir=str(tmp_path / "port"))
    ours = tv.run(cfg, registry=reg, num_steps=3, window=WINDOW, lr=LR,
                  params=CONVERT[family](numpy_tree(params)), save_every=3, device="cpu")
    rel = np.abs(np.array(ours["losses"]) - jlosses) / np.abs(jlosses)
    share = assert_step_close(before, ours["params"],
                              CONVERT[family](numpy_tree(theirs["params"])), steps=3)
    print(family, "run", ours["losses"], jlosses, "far share", share)
    assert rel[0] <= LOSS_RTOL and rel.max() <= RUN_LOSS_RTOL, rel
    assert (tmp_path / "port" / f"{family}.pt").exists()
