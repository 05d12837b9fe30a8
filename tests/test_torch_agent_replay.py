"""The port's replay pool and reward table against the JAX package's, on
the demo pipeline's CSVs (``train_demo/pretrain.csv`` and ``reward.csv``).

The JAX package reads the CSVs with pandas, the port with the ``csv``
module and ``float()``. The vectors ('/'-joined fields) are parsed by the
same ``float()`` on both sides and compare equal; the scalar reward
columns are parsed by pandas' own float parser in the JAX package, which
misses the correctly rounded value on some fields (406 of the 1440
``reward_done`` fields of pretrain.csv, by up to 4.4e-16: a few float64
ulps), so they are compared at float32, where they are equal, and within
SCALAR_ATOL = 1e-15 in float64. A rewritten CSV therefore differs from the
JAX package's only in those fields' last digits: the rewrite test counts
the rows and holds each differing cell to the same bound."""

import os

import numpy as np
import pytest

from ivosw_tpu.data import replay as jax_replay
from ivosw_tpu.interact import recommend as jax_recommend
from ivosw_tpu_torch.data import replay
from ivosw_tpu_torch.interact import recommend

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRETRAIN = os.path.join(REPO, "train_demo", "pretrain.csv")
REWARD = os.path.join(REPO, "train_demo", "reward.csv")
SAMPLE_TH = 0.05
VECTORS = ("state_iou", "next_state_iou", "annotated_frames", "next_annotated_frames")
SCALARS = ("reward_step", "reward_done")
SCALAR_ATOL = 1e-15


def _assert_same_transition(a, b):
    for name in ("sequence", "scribble_iter", "n_interaction", "n_interaction_next", "action",
                 "done"):
        assert getattr(a, name) == getattr(b, name), name
    assert type(a.done) is bool
    for name in SCALARS:
        assert np.float32(getattr(a, name)) == np.float32(getattr(b, name)), name
        assert abs(getattr(a, name) - getattr(b, name)) <= SCALAR_ATOL, name
    for name in VECTORS:
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name), err_msg=name)


@pytest.fixture(scope="module")
def pools():
    ref = jax_replay.ReplayMemory(100000)
    ref_seqs = ref.load_from_csv(PRETRAIN, sample_th=SAMPLE_TH)
    got = replay.ReplayMemory(100000)
    seqs = got.load_from_csv(PRETRAIN, sample_th=SAMPLE_TH)
    return (got, seqs), (ref, ref_seqs)


def test_load_from_csv_matches_jax(pools):
    (got, seqs), (ref, ref_seqs) = pools
    assert seqs == ref_seqs and got.seq_list == ref.seq_list and len(seqs) == 12
    assert got.capacity == ref.capacity == len(got) == len(ref)
    assert got.position == ref.position
    for a, b in zip(got.memory, ref.memory):
        _assert_same_transition(a, b)


@pytest.mark.parametrize("capacity,sample_th,kept", [
    (100, SAMPLE_TH, 8), (300, 0.0, 12), (7, 0.0, 1), (100000, 0.3, 3), (500, 0.2, 6)])
def test_load_cuts_to_capacity_before_the_filter(capacity, sample_th, kept):
    """``df[:capacity]`` first (the first 100 rows hold 8 of the 12
    sequences), then the filter (0.2 and 0.3 drop some of the 12); the
    capacity shrinks to the surviving count."""
    ref = jax_replay.ReplayMemory(capacity)
    got = replay.ReplayMemory(capacity)
    seqs = got.load_from_csv(PRETRAIN, sample_th=sample_th)
    assert seqs == ref.load_from_csv(PRETRAIN, sample_th=sample_th)
    assert len(seqs) == kept
    assert got.capacity == ref.capacity == len(got) <= capacity
    for a, b in zip(got.memory, ref.memory):
        _assert_same_transition(a, b)


@pytest.mark.parametrize("sample_th", [1.0, 0.99])
def test_load_rejects_a_bad_threshold(sample_th):
    """A threshold of 1 or more, or one no sequence passes, raises (the JAX
    package asserts)."""
    with pytest.raises(ValueError, match="sample_th"):
        replay.ReplayMemory(100).load_from_csv(PRETRAIN, sample_th=sample_th)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sample_batch_matches_jax(pools, seed):
    (got, _), (ref, _) = pools
    rng_a, rng_b = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(3):
        a, b = got.sample_batch(32, rng_a), ref.sample_batch(32, rng_b)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            if k in ("reward_step", "reward_done"):  # float32 of 1-ulp float64s
                np.testing.assert_array_equal(a[k], b[k].astype(np.float32), err_msg=k)
            else:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert rng_a.random() == rng_b.random()


def test_sample_batch_mixed_lengths_draws_as_jax():
    """A pool of 24-frame and 8-frame transitions: the length group is
    drawn first (weighted by the eligible groups' counts), then the batch;
    a group smaller than the batch is not eligible; too small a pool gives
    None."""
    rng = np.random.default_rng(5)

    def transition(mod, t, i):
        return mod.Transition(
            sequence=f"s{i % 3}", scribble_iter=1, n_interaction=i % 4, n_interaction_next=i % 4 + 1,
            action=int(rng.integers(t)), reward_step=1.0, reward_done=float(rng.normal()),
            done=bool(i % 2), state_iou=rng.random(t, dtype=np.float32),
            next_state_iou=rng.random(t, dtype=np.float32),
            annotated_frames=np.zeros(t, np.float32), next_annotated_frames=np.ones(t, np.float32))

    lengths = [24] * 40 + [8] * 12 + [5] * 3
    got, ref = replay.ReplayMemory(100), jax_replay.ReplayMemory(100)
    for i, t in enumerate(lengths):
        tr = transition(replay, t, i)
        got.push(tr)
        ref.push(jax_replay.Transition(**vars(tr)))
    rng_a, rng_b = np.random.default_rng(9), np.random.default_rng(9)
    for _ in range(20):
        a, b = got.sample_batch(8, rng_a), ref.sample_batch(8, rng_b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert got.sample_batch(41, rng_a) is None and ref.sample_batch(41, rng_b) is None
    assert got.sample_batch(100, rng_a) is None
    assert rng_a.random() == rng_b.random()


def test_rewrite_csv_matches_jax_text(pools, tmp_path):
    """The full dump in pandas' layout. Rows whose text differs are those
    where pandas parsed a reward a few float64 ulps off (printed with
    ``-s``): each differing cell is a reward column, its two values within
    SCALAR_ATOL."""
    (got, _), (ref, _) = pools
    got.rewrite_csv(str(tmp_path / "port"))
    ref.rewrite_csv(str(tmp_path / "jax"))
    ours = open(tmp_path / "port" / "memory_pool.csv").read().split("\n")
    theirs = open(tmp_path / "jax" / "memory_pool.csv").read().split("\n")
    assert len(ours) == len(theirs) == len(got) + 2  # header, rows, final newline
    assert ours[0] == theirs[0]
    header = ours[0].split(",")
    differing = []
    for line_a, line_b in zip(ours, theirs):
        if line_a == line_b:
            continue
        cells_a, cells_b = line_a.split(","), line_b.split(",")
        differing.append(int(cells_a[0]))
        for name, x, y in zip(header, cells_a, cells_b):
            if x != y:
                assert name in SCALARS, (name, x, y)
                assert abs(float(x) - float(y)) <= SCALAR_ATOL, (x, y)
    # the port writes what it read: its values round-trip through the text
    back = replay.ReplayMemory(100000)
    back.load_from_csv(str(tmp_path / "port" / "memory_pool.csv"))
    for a, b in zip(back.memory, got.memory):
        assert (a.reward_step, a.reward_done) == (b.reward_step, b.reward_done)
    print(f"{len(differing)} of {len(got)} rows differ from pandas' text: {differing}")
    assert len(differing) < len(got) // 2


def test_push_to_csv_matches_jax_text(pools, tmp_path):
    (got, _), (ref, _) = pools
    a, b = replay.ReplayMemory(10), jax_replay.ReplayMemory(10)
    for i in range(12):  # past the capacity: the ring overwrites
        tr = got.memory[i]
        a.push(tr)
        a.push_to_csv(str(tmp_path / "port"))
        b.push(jax_replay.Transition(**vars(tr)))
        b.push_to_csv(str(tmp_path / "jax"))
    assert (open(tmp_path / "port" / "memory_pool.csv", newline="").read()
            == open(tmp_path / "jax" / "memory_pool.csv", newline="").read())
    assert a.position == b.position and len(a) == len(b) == 10


@pytest.fixture(scope="module")
def tables():
    return recommend.RewardTable.from_csv(REWARD), jax_recommend.RewardTable.from_csv(REWARD)


def test_reward_table_matches_jax(tables):
    got, ref = tables
    assert len(got) == len(ref) > 0
    keys = sorted({(r["sequence"], r["n_interaction_next"], r["scribble_iter"])
                   for r in ref._records})
    for seq, n, scribble_iter in keys:
        np.testing.assert_array_equal(got.baseline(seq, n, scribble_iter),
                                      ref.baseline(seq, n, scribble_iter))
    # the scribble-iter parity: iterations 1, 4, 7, ... share one baseline
    seq, n, _ = keys[0]
    np.testing.assert_array_equal(got.baseline(seq, n, 1), got.baseline(seq, n, 4))
    assert len(got.baseline(seq, n, 1)) == 30


def test_goal_only_reward_matches_jax(tables):
    got, ref = tables
    rng = np.random.default_rng(0)
    seqs = sorted({r["sequence"] for r in ref._records})
    for i in range(40):
        seq, n, it = seqs[i % len(seqs)], int(rng.integers(2, 6)), int(rng.integers(1, 7))
        iou = rng.random(24)
        repeat = bool(i % 2)
        count = len(ref.baseline(seq, n, it))
        for table, jtable, expected in ((got, ref, count), (got, ref, None), (None, None, None)):
            assert recommend.goal_only_reward(seq, n, it, repeat, iou, table, expected) == \
                jax_recommend.goal_only_reward(seq, n, it, repeat, iou, jtable, expected)
        # the strict count raises on both sides
        with pytest.raises(ValueError, match="baseline count"):
            recommend.goal_only_reward(seq, n, it, repeat, iou, got, expected_count=count + 1)
        with pytest.raises(AssertionError):
            jax_recommend.goal_only_reward(seq, n, it, repeat, iou, ref, expected_count=count + 1)
    # degenerate baselines
    flat = recommend.RewardTable()
    for _ in range(3):
        flat.add("s", 2, 1, 0.5)
    assert recommend.goal_only_reward("s", 2, 1, False, np.ones(3), flat) == (1.0, 0.0)
    assert recommend.goal_only_reward("t", 2, 1, True, np.ones(3), flat) == (-1.0, 0.0)
