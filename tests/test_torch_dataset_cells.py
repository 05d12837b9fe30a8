"""The committed cells read from dataset trees, run by the port's
``evaluate`` on the CPU and held as ``torch_cells.py`` holds the synthetic
ones (picks equal to the JAX package's on the same walk, rows within
``EPISODE_ATOL`` / ``WALK_EPISODE_ATOL`` of the committed episode rounds;
over all episodes the AUC and curve within ``AUC_ATOL`` /
``WALK_AUC_ATOL``):

- ``results/{tapnet,matchnet,ipnet}/{oracle,wild}/ytbvos-demo/*``
  (``scripts/demo_ytbvos.py``): the committed tree ``train_demo/ytbvos_dst``
  read by both packages' ``from_json`` (q95 JPEG frames, palette PNG
  annotations, round 1 of every episode from ``Scribbles/<seq>/00N.json``),
  the demo weights as the script loads them;
- ``results/fake/{oracle,wild}/davis/*``: the mini-DAVIS
  tree (``tests/torch_dataset_trees.py``) read by ``from_davis_root``,
  FakeVOS, and the JAX command line's seeded agent and AssessNet
  (no checkpoint), converted.

Tier-1 runs the first episode of six cells; all 22 cells, over all their
episodes, run under ``slow``.
"""

import pytest
import torch

from torch_cells import reproduce_cell


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Small tensors: two intra-op threads are as fast alone, and leave the
    cores to the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


FIRST_EPISODE = [
    pytest.param("tapnet", "oracle", "ours", "ytbvos-demo", id="ytbvos-tapnet-oracle-ours"),
    pytest.param("tapnet", "wild", "linspace", "ytbvos-demo", id="ytbvos-tapnet-linspace"),
    pytest.param("matchnet", "wild", "linspace", "ytbvos-demo", id="ytbvos-matchnet-linspace"),
    pytest.param("ipnet", "wild", "linspace", "ytbvos-demo", id="ytbvos-ipnet-linspace"),
    pytest.param("fake", "wild", "random", "davis-fake", id="davis-fake-random"),
    pytest.param("fake", "oracle", "ours", "davis-fake", id="davis-fake-oracle-ours"),
]


@pytest.mark.parametrize("vos,setting,method,dataset", FIRST_EPISODE)
def test_committed_dataset_cells_first_episode(tmp_path, monkeypatch, vos, setting, method,
                                               dataset):
    reproduce_cell(tmp_path, monkeypatch, vos, setting, method, 1, jax_backbone=False,
                   dataset=dataset)


YTBVOS_CELLS = [("oracle", "ours"), ("oracle", "worst"), ("wild", "linspace"),
                ("wild", "random"), ("wild", "worst"), ("wild", "ours")]
ALL_CELLS = [
    pytest.param(vos, setting, method, "ytbvos-demo", 24, id=f"ytbvos-{vos}-{setting}-{method}")
    for vos in ("tapnet", "matchnet", "ipnet") for setting, method in YTBVOS_CELLS
] + [
    pytest.param("fake", setting, method, "davis-fake", 6, id=f"davis-fake-{setting}-{method}")
    for setting, method in (("oracle", "ours"), ("wild", "ours"), ("wild", "random"),
                            ("wild", "worst"))
]


@pytest.mark.slow
@pytest.mark.parametrize("vos,setting,method,dataset,n", ALL_CELLS)
def test_committed_dataset_cells_all_episodes(tmp_path, monkeypatch, vos, setting, method,
                                              dataset, n):
    reproduce_cell(tmp_path, monkeypatch, vos, setting, method, n, jax_backbone=True,
                   dataset=dataset)
