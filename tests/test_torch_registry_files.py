"""The port's file readers (``ivosw_tpu_torch/data/registry.py``) against
the JAX package's on the same trees: the committed YouTube-VOS demo tree
(``train_demo/ytbvos_dst``, read by ``from_json`` and ``from_davis_root``)
and the mini-DAVIS tree written with PIL. The
``SequenceInfo`` records are equal and every loader is bit-equal, float32
frames included; ``registry_from_config`` reaches both datasets, and the
evaluation CLI writes the JAX CLI's ``summary.json`` over a DAVIS tree."""

import dataclasses
import json
import os
import shutil

import numpy as np
import pytest

from ivosw_tpu.core.config import Config as JaxConfig
from ivosw_tpu.data.registry import SequenceRegistry as JaxRegistry
from ivosw_tpu.data.registry import registry_from_config as jax_registry_from_config
from ivosw_tpu_torch.core.config import Config
from ivosw_tpu_torch.data.registry import SequenceRegistry, registry_from_config
from torch_dataset_trees import REPO, YTBVOS_DST, write_mini_davis


@pytest.fixture(scope="module")
def mini_davis(tmp_path_factory):
    return write_mini_davis(str(tmp_path_factory.mktemp("davis") / "mini_davis"))


def _open(kind, tree):
    if kind == "json":
        path = os.path.join(tree, "scb_ytbvos.json")
        return SequenceRegistry.from_json(path, root=tree), JaxRegistry.from_json(path, root=tree)
    return SequenceRegistry.from_davis_root(tree), JaxRegistry.from_davis_root(tree)


def assert_registries_equal(ours, theirs, every_frame=True):
    assert ours.root == theirs.root
    assert {k: dataclasses.asdict(v) for k, v in ours.sequences.items()} == \
        {k: dataclasses.asdict(v) for k, v in theirs.sequences.items()}
    for split in ("train", "val", "trainval"):
        assert ours.subset(split) == theirs.subset(split)
    for name in ours.sequences:
        frames, ref = ours.load_images(name), theirs.load_images(name)
        assert frames.dtype == ref.dtype == np.float32 and np.array_equal(frames, ref)
        anns, ref_anns = ours.load_annotations(name), theirs.load_annotations(name)
        assert anns.dtype == ref_anns.dtype == np.uint8 and np.array_equal(anns, ref_anns)
    fresh, fresh_ref = type(ours)(root=ours.root, sequences=ours.sequences), \
        type(theirs)(root=theirs.root, sequences=theirs.sequences)
    for name, info in ours.sequences.items():  # one-frame loaders, uncached
        for t in range(info.num_frames) if every_frame else (0, info.num_frames - 1):
            assert np.array_equal(fresh.load_image_frame(name, t),
                                  fresh_ref.load_image_frame(name, t))
            assert np.array_equal(fresh.load_annotation_frame(name, t),
                                  fresh_ref.load_annotation_frame(name, t))
    assert not fresh._img_cache and not fresh._ann_cache


@pytest.mark.parametrize("kind", ["json", "davis_root"])
def test_ytbvos_demo_tree_reads_as_the_jax_package(kind):
    ours, theirs = _open(kind, YTBVOS_DST)
    assert len(ours.sequences) == 8
    assert_registries_equal(ours, theirs, every_frame=False)


def test_mini_davis_tree_reads_as_the_jax_package(mini_davis):
    ours, theirs = _open("davis_root", mini_davis)
    assert ours.subset("val") == ["toy-car", "toy-dog"]
    assert ours.info("toy-car").image_size == (64, 48) and ours.info("toy-car").num_objects == 2
    assert_registries_equal(ours, theirs)


def test_lru_caches_as_the_jax_package():
    """The registry keeps the last ``cache_sequences`` clips: a cached clip
    is the same array; the oldest one is dropped first."""
    ours, theirs = _open("json", YTBVOS_DST)
    names = ours.subset("val")[:3]
    for reg in (ours, theirs):
        first = reg.load_images(names[0])
        assert reg.load_images(names[0]) is first
        reg.load_images(names[1])
        reg.load_images(names[2])
        assert list(reg._img_cache) == names[1:]
        assert np.shares_memory(reg.load_image_frame(names[2], 5), reg._img_cache[names[2]])
    assert list(ours._img_cache) == list(theirs._img_cache)


@pytest.mark.parametrize("dataset", ["davis", "ytbvos"])
def test_registry_from_config(mini_davis, dataset):
    configs = []
    for cls in (Config, JaxConfig):
        cfg = cls(dataset=dataset)
        cfg.data.root_dir_davis = mini_davis
        cfg.data.root_dir_scribble_youtube_vos = YTBVOS_DST
        configs.append(cfg)
    ours, theirs = registry_from_config(configs[0]), jax_registry_from_config(configs[1])
    assert ours.root == (mini_davis if dataset == "davis" else YTBVOS_DST)
    assert_registries_equal(ours, theirs, every_frame=False)


def test_from_davis_root_without_a_tree_raises(tmp_path):
    """A root without ImageSets/2017/{train,val}.txt no longer raises: it
    gives an empty registry, as the JAX package's does."""
    ours, theirs = _open("davis_root", str(tmp_path))
    assert ours.subset("val") == theirs.subset("val") == []
    assert_registries_equal(ours, theirs)


def test_eval_cli_over_a_davis_tree_writes_the_jax_summary(tmp_path, monkeypatch, mini_davis):
    """``python -m ivosw_tpu_torch.eval.eval_agent dataset=davis
    data.root_dir_davis=<tree> vos=fake setting=wild method=random --cpu``
    and the JAX package's CLI on the same tree write the same
    ``summary.json``."""
    from ivosw_tpu.eval.eval_agent import main as jax_main
    from ivosw_tpu_torch.eval.eval_agent import main

    argv = ["dataset=davis", f"data.root_dir_davis={mini_davis}", "vos=fake", "setting=wild",
            "method=random"]
    out = {}
    for side, run, extra in (("port", main, ["--cpu"]), ("jax", jax_main, [])):
        os.makedirs(tmp_path / side)
        shutil.copytree(os.path.join(REPO, "configs"), tmp_path / side / "configs")
        monkeypatch.chdir(tmp_path / side)
        run(argv + extra)
        out[side] = open("results/fake/wild/davis/random/summary.json").read()
    assert out["port"] == out["jax"]
    summary = json.loads(out["port"])
    assert len(summary["curve"]["J_AND_F"]) == 8 and summary["auc"] > 0.9
