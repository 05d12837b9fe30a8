"""The port's davisinteractive shim (``ivosw_tpu_torch/compat/davisinteractive.py``)
against the JAX package's: the ``Davis`` facade's class-level ``dataset``
dict, its sequences and loaders, and a reference-style session loop
(``tests/test_compat.py``'s) driving FakeVOS with random frame picks,
whose report rows are the JAX shim's row for row."""

import numpy as np
import pytest

from ivosw_tpu.compat import davisinteractive as jax_shim
from ivosw_tpu.models.vos.fake import FakeVOS as JaxFakeVOS
from ivosw_tpu_torch.compat import davisinteractive as shim
from ivosw_tpu_torch.models.vos.fake import FakeVOS
from torch_dataset_trees import YTBVOS_DST, write_mini_davis


@pytest.fixture(scope="module")
def mini_davis(tmp_path_factory):
    return write_mini_davis(str(tmp_path_factory.mktemp("davis") / "mini_davis"))


@pytest.mark.parametrize("tree", ["mini_davis", "ytbvos"])
def test_davis_facade_is_the_jax_shims(request, tree):
    root = request.getfixturevalue("mini_davis") if tree == "mini_davis" else YTBVOS_DST
    ours = shim.Davis(davis_root=root)
    ours_dataset = shim.Davis.dataset
    theirs = jax_shim.Davis(davis_root=root)
    assert ours_dataset == jax_shim.Davis.dataset and len(ours_dataset) > 0
    for subset in ("train", "val", "trainval"):
        assert ours.get_sequences(subset) == theirs.get_sequences(subset)
    name = ours.get_sequences("val")[0]
    assert np.array_equal(ours.load_annotations(name), theirs.load_annotations(name))
    assert np.array_equal(ours.load_images(name), theirs.load_images(name))


def test_shim_surface():
    assert shim.batched_jaccard is not None and shim.batched_f_measure is not None
    assert callable(shim.scribbles.annotated_frames)


def _session_rows(module, fake_cls, root, report_dir, seed=0):
    """FakeVOS, wild ``random``: each round a seeded random frame; returns
    the report rows without their session id and timing."""
    rng = np.random.default_rng(seed)
    davis = module.Davis(davis_root=root)
    adapter = fake_cls(davis.registry)
    with module.DavisInteractiveSession(
        host="localhost", davis_root=root, subset="val", metric_to_optimize="J_AND_F",
        max_nb_interactions=4, max_time=None, report_save_dir=report_dir,
    ) as sess:
        sess.connector.service.robot.min_nb_nodes = 4
        while sess.next():
            sequence, scribbles, first = sess.get_scribbles(only_last=False)
            af = module.scribbles.annotated_frames(sess.sample_last_scribble)
            if first:
                info = davis.registry.info(sequence)
                state = adapter.begin_sequence(None, info.num_objects, sequence=sequence)
                n, frame = 0, af[0]
            n += 1
            if af and frame not in af:
                frame = af[-1]
            masks, _, state = adapter.segment(state, scribbles, frame, n)
            frame = int(rng.integers(0, info.num_frames))
            sess.submit_masks(np.asarray(masks), next_scribble_frame_candidates=[frame])
        summary = sess.get_global_summary()
        rows = sess.get_report()
    strip = [{k: v for k, v in r.items() if k not in ("session_id", "timing", "timestamp")}
             for r in rows]
    return strip, summary


@pytest.mark.parametrize("tree", ["mini_davis", "ytbvos"])
def test_fake_random_session_reports_as_the_jax_shim(request, tmp_path, tree):
    root = request.getfixturevalue("mini_davis") if tree == "mini_davis" else YTBVOS_DST
    ours, ours_summary = _session_rows(shim, FakeVOS, root, str(tmp_path / "port"))
    theirs, their_summary = _session_rows(jax_shim, JaxFakeVOS, root, str(tmp_path / "jax"))
    assert len(ours) > 0 and ours == theirs
    assert ours_summary["curve"] == their_summary["curve"]
