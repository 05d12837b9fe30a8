"""The committed ``results/matchnet/{oracle,wild}/synthetic/*`` cells reproduced
by the port's ``evaluate`` with ``vos=matchnet`` on the CPU (``torch_cells.py``
says what is held, and how).

Without ``slow``: the first :data:`N_EPISODES` episodes of each cell, the
JAX package's evaluate replaying the port's masks. Under ``slow``: all 24
episodes, the JAX package with its own matchnet, and the AUC and curve.
"""

import pytest
import torch

from torch_cells import reproduce_cell

N_EPISODES = 2
CELLS = [("oracle", "ours"), ("oracle", "worst"), ("wild", "linspace"), ("wild", "random")]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Small tensors: two intra-op threads are as fast alone, and leave the
    cores to the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("setting,method", CELLS)
def test_committed_matchnet_cells_first_episodes(tmp_path, monkeypatch, setting, method):
    reproduce_cell(tmp_path, monkeypatch, "matchnet", setting, method, N_EPISODES,
                   jax_backbone=False)


@pytest.mark.slow
@pytest.mark.parametrize("setting,method", CELLS)
def test_committed_matchnet_cells_all_episodes(tmp_path, monkeypatch, setting, method):
    reproduce_cell(tmp_path, monkeypatch, "matchnet", setting, method, 24, jax_backbone=True)
