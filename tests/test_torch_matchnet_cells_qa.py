"""The committed ``results/matchnet/wild/synthetic/{worst,ours}`` cells, whose
picks rest on AssessNet's predicted qualities, reproduced by the port's
``evaluate`` with ``vos=matchnet`` on the CPU (``torch_cells.py`` says what
is held, and how). Apart from the other cells for time: each round scores
all 48 frames of both objects with the ResNet-50 AssessNet.

Without ``slow``: the first :data:`N_EPISODES` episodes of each cell, the
JAX package's evaluate replaying the port's masks and predicted
qualities. Under ``slow``: all 24 episodes, the JAX package with its own
matchnet and AssessNet, and the AUC and curve.
"""

import pytest
import torch

from torch_cells import reproduce_cell

N_EPISODES = 1  # for time: the tier-1 run's limit (torch_cells.py)
CELLS = [("wild", "worst"), ("wild", "ours")]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads leave the cores to the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("setting,method", CELLS)
def test_committed_matchnet_qa_cells_first_episodes(tmp_path, monkeypatch, setting, method):
    reproduce_cell(tmp_path, monkeypatch, "matchnet", setting, method, N_EPISODES,
                   jax_backbone=False)


@pytest.mark.slow
@pytest.mark.parametrize("setting,method", CELLS)
def test_committed_matchnet_qa_cells_all_episodes(tmp_path, monkeypatch, setting, method):
    reproduce_cell(tmp_path, monkeypatch, "matchnet", setting, method, 24, jax_backbone=True)
