"""``train_assess.run(resume_path=…)`` against an uninterrupted run and
against the JAX package's resume, on the dump trees of
``test_torch_train_slice.py`` (its fixtures, shared by import)."""

import os

import jax
import numpy as np
import pytest
import torch

from ivosw_tpu.core.config import Config as JaxConfig
from ivosw_tpu.train import train_assess as jax_train
from ivosw_tpu_torch.core.config import Config
from ivosw_tpu_torch.models.assess import AssessNet
from ivosw_tpu_torch.train import train_assess
from ivosw_tpu_torch.utils.convert import assess_state_dict_from_numpy
from test_torch_train_slice import _recorder, dumps, variables  # noqa: F401 (fixtures)


class _Interrupted(Exception):
    pass


def _interrupt_after(monkeypatch, module, n):
    """Make ``module.assess_train_step`` raise on its (n+1)-th call, as a
    run killed after n steps."""
    step, calls = module.assess_train_step, []

    def killed(*args, **kwargs):
        if len(calls) == n:
            raise _Interrupted
        calls.append(1)
        return step(*args, **kwargs)

    monkeypatch.setattr(module, "assess_train_step", killed)


def test_train_assess_resume_matches_uninterrupted_and_jax(variables, dumps, tmp_path,
                                                            monkeypatch):
    """``run(resume_path=…)`` over 2 epochs at batch 16 (2 steps an epoch),
    killed after N = 2 steps and resumed from the epoch-boundary snapshot:
    the final weights equal an uninterrupted run of the port bit for bit (a
    restart at an epoch boundary re-seeds that epoch's order and
    augmentations; inside an epoch both packages resume with fresh
    augmentation draws, by design), and the JAX package's run interrupted
    and resumed the same way within test_torch_train.py's float32 bounds
    for a step after the first: the resumed steps' losses within
    STEP2_LOSS_RTOL, and the norm of every parameter's update (final −
    initial) within UPDATE_RTOL of the JAX package's. Both nets
    compute in float32 here (in bf16 single updates are not comparable,
    as test_torch_train.py's bf16 step compares only the loss); the
    snapshot is removed on completion."""
    import functools

    from test_torch_train import STEP2_LOSS_RTOL, UPDATE_RTOL, _leaves

    from ivosw_tpu.models.assess import assess_forward as jax_assess_forward
    from ivosw_tpu_torch.utils.convert import assess_numpy_from_state_dict

    jreg, preg, jax_dir, port_dir = dumps
    epochs, per_epoch = 2, 2
    # float32 on both sides: the JAX step re-jitted over a float32 forward
    monkeypatch.setattr(jax_train, "assess_forward",
                        functools.partial(jax_assess_forward, dtype=jax.numpy.float32))
    monkeypatch.setattr(jax_train, "assess_train_step", jax.jit(
        jax_train.assess_train_step.__wrapped__, static_argnames=("optimizer", "metric")))

    def port_net():
        net = AssessNet(dtype=torch.float32)
        net.load_state_dict(assess_state_dict_from_numpy(variables))
        return net

    def cfg_for(cls, name):
        cfg = cls(seed=0)
        cfg.assess_net.train_batch_size = 16
        cfg.ckpt_dir = str(tmp_path / name)
        return cfg

    whole = train_assess.run(cfg_for(Config, "whole"), registry=preg, save_result_dir=port_dir,
                             num_epochs=epochs, net=port_net(), device="cpu")

    resume = str(tmp_path / "resume.pt")
    with monkeypatch.context() as m:
        _interrupt_after(m, train_assess, per_epoch)
        with pytest.raises(_Interrupted):
            train_assess.run(cfg_for(Config, "port"), registry=preg, save_result_dir=port_dir,
                             num_epochs=epochs, net=port_net(), device="cpu",
                             resume_path=resume, save_every=100)
    assert torch.load(resume, weights_only=True)["epoch"] == 2
    port_steps = _recorder(monkeypatch, train_assess)
    resumed = train_assess.run(cfg_for(Config, "port"), registry=preg, save_result_dir=port_dir,
                               num_epochs=epochs, net=port_net(), device="cpu",
                               resume_path=resume, save_every=100)
    assert len(port_steps) == per_epoch and not os.path.exists(resume)
    final = resumed["net"].state_dict()
    for k, v in whole["net"].state_dict().items():
        assert torch.equal(v, final[k]), k

    jax_resume = str(tmp_path / "jax_resume")
    with monkeypatch.context() as m:
        _interrupt_after(m, jax_train, per_epoch)
        with pytest.raises(_Interrupted):
            jax_train.run(cfg_for(JaxConfig, "jax"), registry=jreg, save_result_dir=jax_dir,
                          num_epochs=epochs, variables=jax.tree.map(jax.numpy.asarray, variables),
                          resume_path=jax_resume, save_every=100)
    jax_steps = _recorder(monkeypatch, jax_train)
    out = jax_train.run(cfg_for(JaxConfig, "jax"), registry=jreg, save_result_dir=jax_dir,
                        num_epochs=epochs, variables=jax.tree.map(jax.numpy.asarray, variables),
                        resume_path=jax_resume, save_every=100)
    assert len(jax_steps) == per_epoch and not os.path.exists(jax_resume)
    np.testing.assert_allclose([l for _, l in port_steps], [l for _, l in jax_steps],
                               rtol=STEP2_LOSS_RTOL)
    init = _leaves(variables["params"])
    ours = _leaves(assess_numpy_from_state_dict(final)["params"])
    theirs = _leaves(jax.tree.map(lambda x: np.asarray(x, np.float32), out["variables"])["params"])
    # measured: 0.060 at conv1_p
    worst = max((abs(np.linalg.norm(ours[k] - init[k]) / np.linalg.norm(theirs[k] - init[k]) - 1.0),
                 k) for k in init)
    assert worst[0] <= UPDATE_RTOL, worst
