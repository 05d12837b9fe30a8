"""The AssessNet training slice, the JAX package against the port (CPU):
``pretrain_assess.run``, ``generate_qa_data.run`` and ``train_assess.run``
from the same seeds and the same initial variables
(``init_assess_variables(PRNGKey(0))`` carried across), bf16 nets.

Tolerances and why:
- host batches and dump trees: identical (the same numpy draws; 8-bit
  PNGs), augmented batches as in test_torch_qa_data.py (img/prob within
  1e-5 of cv2, labels identical but at .5 ties);
- each step's loss: |loss − loss_jax| ≤ 2·√loss·δ + δ², δ = 0.1, the bf16
  train-mode prediction bound derived in test_torch_train.py. At the
  configured lr (5e-6) no weight moves by more than 5e-6 per step (lr ×
  the ±1 clamp, plus weight decay), so every step stays within the first
  step's bound.
"""

import os

import jax
import numpy as np
import pytest
import torch

from ivosw_tpu.core.config import Config as JaxConfig
from ivosw_tpu.data.demo import demo_training_registry as jax_demo_training_registry
from ivosw_tpu.data.registry import SequenceRegistry as JaxRegistry
from ivosw_tpu.models.assess import init_assess_variables
from ivosw_tpu.models.vos.fake import FakeVOS as JaxFakeVOS
from ivosw_tpu.train import generate_qa_data as jax_generate
from ivosw_tpu.train import pretrain_assess as jax_pretrain
from ivosw_tpu.train import train_assess as jax_train
from ivosw_tpu_torch.core.config import Config
from ivosw_tpu_torch.data.demo import demo_training_registry
from ivosw_tpu_torch.data.registry import SequenceRegistry
from ivosw_tpu_torch.eval.eval_agent import load_weights
from ivosw_tpu_torch.models.assess import AssessNet, init_assess_net
from ivosw_tpu_torch.models.vos.fake import FakeVOS
from ivosw_tpu_torch.train import generate_qa_data, pretrain_assess, train_assess
from ivosw_tpu_torch.utils.convert import assess_state_dict_from_numpy
from torch_port_cases import assert_labels_match_but_ties, record_augmentations

BF16_PRED_ATOL = 0.1
IMG_ATOL = 1e-5


def bf16_loss_bound(loss):
    return 2.0 * np.sqrt(loss) * BF16_PRED_ATOL + BF16_PRED_ATOL**2


@pytest.fixture(scope="module")
def variables():
    return jax.tree.map(lambda x: np.asarray(x, np.float32),
                        init_assess_variables(jax.random.PRNGKey(0)))


def _port_net(variables):
    net = AssessNet(dtype=torch.bfloat16)
    net.load_state_dict(assess_state_dict_from_numpy(variables))
    return net


def _recorder(monkeypatch, module, name="assess_train_step"):
    """Wrap ``module.assess_train_step``: record each step's host batch and
    loss."""
    steps = []
    step = getattr(module, name)

    def recorded(*args, **kwargs):
        batch = args[2] if len(args) > 2 else kwargs["batch"]
        out = step(*args, **kwargs)
        steps.append(({k: np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v)
                       for k, v in batch.items()}, float(out[-3])))
        return out

    monkeypatch.setattr(module, name, recorded)
    return steps


def _assert_losses_close(got, ref):
    assert len(got) == len(ref) > 0
    for a, b in zip(got, ref):
        assert np.isfinite(a) and abs(a - b) <= bf16_loss_bound(b), (got, ref)


def test_pretrain_assess_matches_jax(variables, tmp_path, monkeypatch):
    """3 steps at batch 2 on two 48×64 demo clips: identical host batches,
    losses within the bf16 bound, the checkpoint in tmp_path."""
    jax_steps = _recorder(monkeypatch, jax_pretrain)
    port_steps = _recorder(monkeypatch, pretrain_assess)
    jcfg, cfg = JaxConfig(), Config()
    jcfg.ckpt_dir, cfg.ckpt_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_pretrain.run(jcfg, registry=jax_demo_training_registry(n_clips=2, seed=1),
                     num_steps=3, batch_size=2, variables=jax.tree.map(jax.numpy.asarray, variables))
    out = pretrain_assess.run(cfg, registry=demo_training_registry(n_clips=2, seed=1),
                              num_steps=3, batch_size=2, net=_port_net(variables), device="cpu")
    assert len(port_steps) == len(jax_steps) == 3
    for (pb, _), (jb, _) in zip(port_steps, jax_steps):
        for k in jb:
            np.testing.assert_array_equal(pb[k], jb[k])
    _assert_losses_close([l for _, l in port_steps], [l for _, l in jax_steps])
    assert out["losses"] == [l for _, l in port_steps]
    assert os.path.exists(os.path.join(cfg.ckpt_dir, pretrain_assess.PRETEXT_CKPT))


@pytest.fixture(scope="module")
def dumps(tmp_path_factory):
    """generate_qa_data from both packages on the synthetic registry of
    tests/test_qa_pipeline.py: 2 clips × 2 rounds × 5 frames × 2 objects."""
    kw = dict(num_frames=5, image_size=(64, 48), num_objects=2, split="train", seed=2)
    jreg = JaxRegistry.synthetic(["qa-a", "qa-b"], **kw)
    preg = SequenceRegistry.synthetic(["qa-a", "qa-b"], **kw)
    root = tmp_path_factory.mktemp("qa_slice")
    samples = [("qa-a", 1), ("qa-b", 1)]
    jcfg = jax_generate.configure(JaxConfig())
    jcfg.davis_interactive.max_nb_interactions = 2
    cfg = generate_qa_data.configure(Config())
    cfg.davis_interactive.max_nb_interactions = 2
    jstats = jax_generate.run(jcfg, registry=jreg, adapter=JaxFakeVOS(jreg, max_quality=0.8),
                              samples=samples, save_result_dir=str(root / "jax"))
    stats = generate_qa_data.run(cfg, registry=preg, adapter=FakeVOS(preg, max_quality=0.8),
                                 samples=samples, save_result_dir=str(root / "port"))
    assert stats == {**jstats, "save_result_dir": str(root / "port")}
    return jreg, preg, str(root / "jax"), str(root / "port")


def test_generate_qa_data_matches_jax(dumps):
    """The same dump tree: file list and pixel values."""
    from PIL import Image

    _, _, jax_dir, port_dir = dumps
    rel = lambda root: sorted(os.path.relpath(os.path.join(d, f), root)
                              for d, _, fs in os.walk(root) for f in fs)
    assert rel(port_dir) == rel(jax_dir) and len(rel(port_dir)) == 40
    for name in rel(jax_dir):
        np.testing.assert_array_equal(np.asarray(Image.open(os.path.join(port_dir, name))),
                                      np.asarray(Image.open(os.path.join(jax_dir, name))))


def test_train_assess_matches_jax(variables, dumps, tmp_path, monkeypatch):
    """One epoch at batch 4 on the dumps: identical augmented batches (to
    the augmentation tolerances), losses within the bf16 bound, and the
    saved assess_net.pt loads through eval_agent's weight loader."""
    jreg, preg, jax_dir, port_dir = dumps
    records = record_augmentations(monkeypatch)
    jax_steps = _recorder(monkeypatch, jax_train)
    port_steps = _recorder(monkeypatch, train_assess)
    jcfg, cfg = JaxConfig(), Config()
    for c in (jcfg, cfg):
        c.assess_net.train_batch_size = 4
    jcfg.ckpt_dir, cfg.ckpt_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_train.run(jcfg, registry=jreg, save_result_dir=jax_dir, num_epochs=1,
                  variables=jax.tree.map(jax.numpy.asarray, variables))
    out = train_assess.run(cfg, registry=preg, save_result_dir=port_dir, num_epochs=1,
                           net=_port_net(variables), device="cpu")
    assert len(port_steps) == len(jax_steps) == 10
    for k in ("img", "prob"):
        got = np.stack([b[k] for b, _ in port_steps])
        ref = np.stack([b[k] for b, _ in jax_steps])
        np.testing.assert_allclose(got, ref, rtol=0, atol=IMG_ATOL)
    labels = lambda steps: np.concatenate([b["label"] for b, _ in steps])
    assert_labels_match_but_ties(labels(port_steps), labels(jax_steps), records)
    _assert_losses_close([l for _, l in port_steps], [l for _, l in jax_steps])

    loaded = init_assess_net(seed=1)
    assert load_weights(loaded, cfg.ckpt_dir, "assess_net.pt")
    trained = out["net"].state_dict()
    assert all(torch.equal(v, trained[k]) for k, v in loaded.state_dict().items())
