"""IPNet's window loss, gradients, Adam step and 3-step ``run`` in the
port against the JAX package (``torch_train_vos_cases.py`` states the
inputs and the bounds)."""

import pytest
import torch

import torch_train_vos_cases as cases


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads leave the cores to the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def test_ipnet_window_loss_and_grads():
    cases.check_window_grads("ipnet")


def test_ipnet_float32_grads():
    cases.check_float32_grads("ipnet")


def test_ipnet_train_step_and_run(monkeypatch, tmp_path):
    cases.check_step_and_run("ipnet", monkeypatch, tmp_path)
