"""One VOS training step of each family on the card against the same step
on the host (``ivosw_tpu_torch/train/train_vos.py``).

Marked ``requires_cuda``: without a CUDA device they skip (the decision is
taken inside the fixture, never at import). On a machine with the card:
``python -m pytest -m requires_cuda tests/test_torch_train_vos_cuda.py``.
This file imports no JAX. The bounds are those the CPU tests hold the
port to against the JAX package (``torch_train_vos_cases.py``, where each
is measured; ``chip_smoke.py``'s ``vos_train_small`` phases use them too):
the loss within :data:`LOSS_RTOL` relative, every parameter's gradient
within :data:`GRAD_RTOL` relative L2 (bf16 gradients are good to ~20 % in
their worst tensor against float32), after the Adam step every element
within 2·lr of the host's and at most :data:`FLIP_SHARE` of them further
apart than lr/100."""

import numpy as np
import pytest
import torch

from ivosw_tpu_torch.data.registry import SequenceRegistry
from ivosw_tpu_torch.interact.robot import ScribbleRobot
from ivosw_tpu_torch.train import train_vos as tv

pytestmark = pytest.mark.requires_cuda

LOSS_RTOL = 2e-3
GRAD_RTOL = 0.3
FLIP_SHARE = 0.1
LR = 3e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ivosw_tpu_torch.device import resolve_device

    return resolve_device(None)


@pytest.mark.parametrize("vos", ["tapnet", "matchnet", "ipnet"])
@pytest.mark.parametrize("round2_prob", [0.0, 1.0])
def test_train_step_card_matches_host(cuda, vos, round2_prob):
    reg = SequenceRegistry.synthetic(["a", "b"], num_frames=6, image_size=(64, 48),
                                     num_objects=2, split="train", seed=9)
    window = next(tv.sample_windows(reg, reg.subset("train"), np.random.default_rng(0), 3,
                                    ScribbleRobot(seed=0), round2_prob=round2_prob))
    net_cls, init_fn, loss_fn, _ = tv._family(vos)
    init = init_fn(0)
    out = {}
    for device in (cuda, torch.device("cpu")):
        net = net_cls()
        net.load_state_dict(init)
        net.to(device)
        opt = tv.make_vos_optimizer(net.parameters(), LR)
        loss = float(tv.vos_train_step(net, opt, tv.upload_window(window, device), loss_fn))
        out[device.type] = (loss, {n: (p.grad.cpu(), p.detach().cpu())
                                   for n, p in net.named_parameters()})
    (loss_c, card), (loss_h, host) = out["cuda"], out["cpu"]
    assert abs(loss_c - loss_h) <= LOSS_RTOL * abs(loss_h)
    far = total = 0
    for n, (g, p) in host.items():
        assert float((card[n][0] - g).norm() / g.norm().clamp_min(1e-30)) <= GRAD_RTOL, n
        diff = (card[n][1] - p).abs()
        slack = 2 * LR + 4 * torch.finfo(torch.float32).eps * init[n].abs()
        assert bool((diff <= slack + 1e-12).all()), n
        far += int((diff > LR / 100).sum())
        total += diff.numel()
    assert far / total <= FLIP_SHARE
