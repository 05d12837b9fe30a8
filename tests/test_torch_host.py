"""Host side of the port (no cv2, no yaml, no native library) against the
JAX package: exact equality throughout: scribbles, metrics, config, demo
clips and whole evaluation sessions that need no AssessNet."""

import dataclasses
import json
import os

import numpy as np
import pytest

from ivosw_tpu.core.config import load_config as jax_load_config
from ivosw_tpu.data import demo as jax_demo
from ivosw_tpu.data.registry import SequenceRegistry as JaxRegistry
from ivosw_tpu.data.replay import Transition as JaxTransition
from ivosw_tpu.eval.eval_agent import evaluate as jax_evaluate
from ivosw_tpu.interact.robot import ScribbleRobot as JaxRobot
from ivosw_tpu.models.vos.fake import FakeVOS as JaxFakeVOS
from ivosw_tpu.ops import metrics as jax_metrics
from ivosw_tpu_torch.core.config import Config, load_config, parse_simple_yaml
from ivosw_tpu_torch.data import demo
from ivosw_tpu_torch.data.registry import SequenceRegistry
from ivosw_tpu_torch.data.replay import Transition
from ivosw_tpu_torch.eval.eval_agent import evaluate
from ivosw_tpu_torch.interact.robot import ScribbleRobot
from ivosw_tpu_torch.models.vos.fake import FakeVOS
from ivosw_tpu_torch.ops import metrics

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _edge_clips(seed):
    """Label clips whose objects touch every image edge and corner, plus
    wrapped synthetic blobs: the cases where cv2's erode border matters."""
    rng = np.random.default_rng(seed)
    t, h, w = 4, 40, 56
    gt = np.zeros((t, h, w), np.uint8)
    gt[0, :12, :15] = 1  # top-left corner
    gt[0, 30:, 40:] = 2  # bottom-right corner
    gt[1, :, :6] = 1  # full left column band
    gt[1, 10:20, 50:] = 2  # right edge
    gt[2, :3, 10:40] = 1  # thin strip on the top edge (erodes away inside)
    gt[2, 20:34, 20:34] = 2
    gt[3] = JaxRegistry.synthetic(["x"], num_frames=1, image_size=(w, h), seed=seed)._synthetic["x"][1][0]
    pred = np.where(rng.random(gt.shape) < 0.6, gt, 0).astype(np.int32)
    pred[:, 5:15, 25:45] = 2  # false positives for background scribbles
    return gt, pred


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_robot_matches_cv2_robot(seed):
    gt, pred = _edge_clips(seed)
    for prediction in (np.zeros_like(pred), pred):
        for frame in range(gt.shape[0]):
            for kw in ({}, {"min_nb_nodes": 2, "nb_points": 7}):
                ours = ScribbleRobot(seed=seed, **kw).interact("s", prediction, gt, 2, frame)
                ref = JaxRobot(seed=seed, **kw).interact("s", prediction, gt, 2, frame)
                assert ours == ref, (frame, kw)


@pytest.mark.parametrize("bound_th", [0.008, 2])
def test_metrics_match_exactly(bound_th):
    gt, pred = _edge_clips(3)
    rng = np.random.default_rng(4)
    noisy = np.where(rng.random(gt.shape) < 0.1, rng.integers(0, 3, gt.shape), pred)
    for p in (pred, noisy, np.zeros_like(pred), gt.astype(np.int32)):
        for avg in (True, False):
            np.testing.assert_array_equal(
                metrics.batched_jaccard(gt, p, avg, 2),
                jax_metrics.batched_jaccard(gt, p, avg, 2),
            )
            np.testing.assert_array_equal(
                metrics.batched_f_measure(gt, p, avg, 2, bound_th=bound_th),
                jax_metrics.batched_f_measure(gt, p, avg, 2, bound_th=bound_th),
            )
        for m in ("J", "F", "J_AND_F"):
            np.testing.assert_array_equal(
                metrics.sequence_metric(m, gt, p, 2), jax_metrics.sequence_metric(m, gt, p, 2)
            )
    curve = [0.2, 0.5, 0.7, 0.71]
    assert metrics.auc_from_curve(curve) == jax_metrics.auc_from_curve(curve)


def test_config_matches_yaml_loaded_jax_config():
    path = os.path.join(REPO, "configs", "config.yaml")
    overrides = ["agent.lr=1e-4", "setting=oracle", "assess_net.fold_inference=false"]
    for ov in ([], overrides):
        ours = dataclasses.asdict(load_config(path, ov))
        ref = dataclasses.asdict(jax_load_config(path, ov))
        assert ours == ref
        assert {k: type(v) for k, v in ours.items()} == {k: type(v) for k, v in ref.items()}
    with pytest.raises(KeyError):
        load_config(path, ["settng=wild"])
    assert parse_simple_yaml("a: 1  # c\nb:\n  c: x\n  d: 0.5\ne: true\n") == {
        "a": 1, "b": {"c": "x", "d": 0.5}, "e": True,
    }
    with pytest.raises(ValueError):
        parse_simple_yaml("a:\n  b:\n    c: 1\n")


def test_demo_generator_and_synthetic_registry_bitexact():
    ours, ref = demo.demo_registry(seed=2), jax_demo.demo_registry(seed=2)
    info = lambda reg: {k: dataclasses.asdict(v) for k, v in reg.sequences.items()}
    assert info(ours) == info(ref)
    for name in ref.sequences:
        for a, b in zip(ours._synthetic[name], ref._synthetic[name]):
            np.testing.assert_array_equal(a, b)
    s1 = SequenceRegistry.synthetic(["a", "b"], num_frames=5, seed=3)
    s2 = JaxRegistry.synthetic(["a", "b"], num_frames=5, seed=3)
    for name in ("a", "b"):
        np.testing.assert_array_equal(s1.load_images(name), s2.load_images(name))
        np.testing.assert_array_equal(s1.load_annotations(name), s2.load_annotations(name))
    row = dict(sequence="a", scribble_iter=1, n_interaction=0, n_interaction_next=1,
               action=3, reward_step=1.0, reward_done=0.5, done=False,
               state_iou=np.arange(3.0), next_state_iou=np.ones(3),
               annotated_frames=np.zeros(3), next_annotated_frames=np.ones(3))
    assert Transition(**row).to_row() == JaxTransition(**row).to_row()


@pytest.mark.parametrize(
    "setting,method", [("oracle", "worst"), ("wild", "random"), ("wild", "linspace")]
)
def test_sessions_without_assessnet_match_jax(tmp_path, setting, method):
    """Whole evaluations through session, robot, FakeVOS, metrics and the
    policy layer: identical curves and identical davisinteractive reports."""
    from ivosw_tpu.core.config import Config as JaxConfig

    kw = dict(phase="eval", setting=setting, method=method, vos="fake")
    reg = SequenceRegistry.synthetic(["a", "b"], num_frames=10, seed=0)
    jreg = JaxRegistry.synthetic(["a", "b"], num_frames=10, seed=0)
    for r in (reg, jreg):
        r.sequences["b"].num_scribbles = 1
    ours = evaluate(Config(**kw), reg, FakeVOS(reg), max_nb_interactions=4,
                    report_save_dir=str(tmp_path / "port"), device="cpu")
    ref = jax_evaluate(JaxConfig(**kw), jreg, JaxFakeVOS(jreg), max_nb_interactions=4,
                       report_save_dir=str(tmp_path / "jax"))
    assert ours["curve"] == ref["curve"] and ours["auc"] == ref["auc"]
    strip = lambda rows: [{k: v for k, v in r.items() if k != "timestamp"} for r in rows]
    assert strip(ours["report"]) == strip(ref["report"])

    def report(d):
        lines = open(tmp_path / d / "session_report.csv").read().splitlines()
        return [",".join(line.split(",")[1:-1]) for line in lines]  # drop id, timing

    assert report("port") == report("jax")


def test_cli_runs_on_the_demo_registry_and_guards_results(tmp_path, monkeypatch):
    """``python -m ivosw_tpu_torch.eval.eval_agent`` from a checkout root:
    config file + overrides, demo registry, default results tree, and the
    refusal to overwrite a summary that is already there."""
    import shutil

    from ivosw_tpu_torch.eval.eval_agent import main

    shutil.copytree(os.path.join(REPO, "configs"), tmp_path / "configs")
    monkeypatch.chdir(tmp_path)
    argv = ["dataset=demo", "vos=fake", "setting=wild", "method=random", "eval_rounds=2", "--cpu"]
    summary = main(argv)
    assert len(summary["curve"]["J_AND_F"]) == 2
    assert (tmp_path / "results/fake/wild/demo/random/summary.json").exists()
    with pytest.raises(FileExistsError):
        main(argv)
    # the config's default dataset=davis reads data/DAVIS under the cwd: none
    # here, so the registry is empty and the run evaluates nothing, as the JAX
    # package's CLI does (its summary: an empty curve, AUC 0)
    empty = main(["vos=fake", "--cpu"])
    assert empty["curve"] == {"J_AND_F": []} and empty["auc"] == 0.0
    with open(tmp_path / "results/fake/wild/davis/ours/summary.json") as fp:
        assert json.load(fp) == {"auc": 0.0, "curve": {"J_AND_F": []}}
