"""Frame-recommendation policy layer.

Counterpart of ``ivosw_tpu/interact/recommend.py``:
``select_next_frame``, ``gen_subseq``, ``smooth_clip_quality``, the
setting×method dispatch ``recommend_frame``, the reward table with Eq. 3's
``goal_only_reward`` and the per-round ``agent_business`` are copies; in the
wild setting :func:`predict_clip_quality` scores all T×O pairs on the
device of the frames through :func:`ivosw_tpu_torch.models.assess.score_clip`,
in fixed-size frame chunks (the padded tail is scored and dropped, as the
JAX package's static-shape chunks are). The sequence-parallel mesh path
comes with the parallelism slice.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ivosw_tpu_torch.data.replay import Transition, read_csv_rows
from ivosw_tpu_torch.device import check_on_device
from ivosw_tpu_torch.models.assess import score_clip

FRAME_CHUNK = 32


# ----------------------------------------------------------------- reward --
class RewardTable:
    """Baseline episode statistics backing Eq. 3's normalised terminal reward.

    Produced by the reward-production phase (random-policy epochs,
    ``train/produce_reward.py``); keyed by (sequence, terminal interaction
    round, scribble-iter mod 3) as the reference's ``goal_only_reward``
    filters its table (utils/utils_agent.py:11-20)."""

    def __init__(self):
        self._records: List[Dict] = []

    def add(self, sequence: str, n_interaction_next: int, scribble_iter: int,
            next_state_iou_mean: float) -> None:
        self._records.append(
            dict(
                sequence=sequence,
                n_interaction_next=int(n_interaction_next),
                scribble_iter=int(scribble_iter),
                iou=float(next_state_iou_mean),
            )
        )

    @classmethod
    def from_csv(cls, path: str) -> "RewardTable":
        """Load a reference-format reward.csv (memory-pool schema)."""
        table = cls()
        for row in read_csv_rows(path):
            iou = np.mean([float(v) for v in row["next_state_iou"].split("/")])
            table.add(
                row["sequence"],
                int(row["n_interaction_next"]),
                int(row["scribble_iter"]),
                iou,
            )
        return table

    def baseline(
        self, sequence: str, n_interaction: int, scribble_iter: int
    ) -> np.ndarray:
        vals = [
            r["iou"]
            for r in self._records
            if r["sequence"] == sequence
            and r["n_interaction_next"] == n_interaction
            and (r["scribble_iter"] - 1) % 3 == (scribble_iter - 1) % 3
        ]
        return np.asarray(vals, dtype=np.float64)

    def __len__(self):
        return len(self._records)


def goal_only_reward(
    sequence: str,
    n_interaction: int,
    scribble_iter: int,
    repeat_selection: bool,
    iou_new: np.ndarray,
    table: Optional[RewardTable] = None,
    expected_count: Optional[int] = None,
) -> Tuple[float, float]:
    """reward_step = ±1 (repeat penalty); reward_done = Eq. 3
    ``(J&F − μ − σ)/σ`` against the baseline episodes (σ with ddof=1).
    ``expected_count`` checks the baseline count (the reference pins 30;
    the JAX package asserts it, the port raises ``ValueError``).
    Fewer than two baselines or σ < 1e-6 give reward_done 0."""
    reward_step = 1.0 if not repeat_selection else -1.0
    if table is None:
        return reward_step, 0.0
    prev = table.baseline(sequence, n_interaction, scribble_iter)
    if expected_count is not None and len(prev) != expected_count:
        raise ValueError(
            f"baseline count {len(prev)} != {expected_count} for "
            f"{sequence}/{n_interaction}/{scribble_iter}"
        )
    if len(prev) < 2 or prev.std(ddof=1) < 1e-6:
        return reward_step, 0.0
    metric = float(np.mean(iou_new))
    mean, std = prev.mean(), prev.std(ddof=1)
    reward_done = (metric - mean - std) / std
    return reward_step, float(reward_done)


# ---------------------------------------------------------------- selects --
def select_next_frame(
    frame_value: np.ndarray,
    metric: str = "min",
    prev_frames: Optional[Sequence[int]] = None,
    rng: Optional[np.random.Generator] = None,
) -> int:
    """Pick a frame by value (reference utils/utils_agent.py:38-74).

    'worst'/'min': lowest value; 'max': highest; 'random': uniform;
    'prob': softmax-weighted draw. prev_frames excludes already-annotated
    frames by scanning the argsort (falling back to global argmin when all
    frames were used)."""
    frame_value = np.asarray(frame_value, dtype=np.float64)
    nb_frames = len(frame_value)
    rng = rng or np.random.default_rng()

    if metric == "random":
        return int(rng.integers(nb_frames))

    if metric == "prob":
        z = frame_value - frame_value.max()
        p = np.exp(z) / np.exp(z).sum()
        return int(rng.choice(nb_frames, p=p))

    if metric == "max":
        frame_value = -frame_value

    if prev_frames is not None:
        order = frame_value.argsort()
        i = 0
        while i < nb_frames and order[i] in prev_frames:
            i += 1
        if i == nb_frames:
            return int(frame_value.argmin())
        return int(order[i])
    return int(frame_value.argmin())


def gen_subseq(
    first_frame: int, n_frame: int, len_subseq: int, subseq_style: str = "consecutive"
) -> List[int]:
    """Subsequence generators (reference utils/utils_agent.py:131-157):
    'consecutive' centres a window on the first scribbled frame; 'equal'
    spreads len_subseq frames evenly while excluding the first frame."""
    if subseq_style == "consecutive":
        assert n_frame >= len_subseq
        i_start = max(0, first_frame - len_subseq + 1)
        i_end = first_frame - max((first_frame + len_subseq) - n_frame, 0)
        i = int((i_start + i_end) / 2)
        return list(range(i, i + len_subseq))
    if subseq_style == "equal":
        start, end = 0, n_frame - 1
        if (end - start + 1) < len_subseq + 1:
            return list(range(len_subseq))
        subseq = np.linspace(start, n_frame - 1, num=len_subseq + 1).astype(int)
        for _ in range(n_frame + 1):
            if first_frame in subseq:
                break
            subseq = subseq + 1
        if first_frame != subseq[-1]:
            return list(subseq[:-1])
        return list(subseq[1:])
    raise NotImplementedError(subseq_style)


# -------------------------------------------------------------- QA fusion --
def predict_clip_quality(
    assess_net,
    all_F,
    all_P,
    n_objects: int,
    chunk: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Predicted quality for every frame of a clip.

    all_F: [T, H, W, 3] frames, a tensor on the scoring device (uploaded
    once per sequence by the caller, in bfloat16 under
    ``assess_net.bf16_inputs``) or a host array; all_P: [T, O+1, H, W]
    probabilities with background channel 0 (adapter output: a tensor that
    stays on the device, as TAPNet's, or a host array, uploaded here once
    per call), passed whole to the crop kernel with object offset 1 (no
    strided copy of the object planes). Both keep their dtype (float32 or
    bfloat16). Returns (per-frame mean quality [T], per-object scores
    [T, n_objects]).

    chunk: frames per scoring block; None → FRAME_CHUNK
    (cfg.assess_net.score_chunk). A tensor argument on another device than
    the net's raises rather than being copied across."""
    chunk = int(chunk) if chunk else FRAME_CHUNK
    device = next(assess_net.parameters()).device
    check_on_device(device, all_F=all_F, all_P=all_P)
    all_F = torch.as_tensor(all_F, device=device)
    all_P = torch.as_tensor(all_P, device=device)
    obj_valid = torch.ones((n_objects,), dtype=torch.float32, device=device)

    t = all_F.shape[0]
    chunks = []
    for start in range(0, t, chunk):
        end = min(start + chunk, t)
        n = end - start
        f_chunk = all_F[start:end]
        p_chunk = all_P[start:end]
        if n < chunk:  # pad the tail to the chunk shape
            f_chunk = torch.cat([f_chunk, f_chunk.new_zeros((chunk - n,) + f_chunk.shape[1:])])
            p_chunk = torch.cat([p_chunk, p_chunk.new_zeros((chunk - n,) + p_chunk.shape[1:])])
        s = score_clip(assess_net, f_chunk, p_chunk, obj_valid, obj_offset=1)
        chunks.append(s[:n])
    scores = torch.cat(chunks, dim=0).float().cpu().numpy()
    return scores.mean(axis=1), scores


def smooth_clip_quality(quality: np.ndarray, k: int) -> np.ndarray:
    """Odd-window moving average with edge replication; k<=1 is identity.

    State-denoising option for the wild setting (cfg.assess_net.
    smooth_quality; default 1 = reference behaviour): per-frame QA
    prediction error is roughly independent across frames while true
    quality structure is contiguous, so a short box filter raises the
    rank fidelity of the recommendation state."""
    if k <= 1:
        return quality
    if k % 2 == 0:
        k += 1
    pad = k // 2
    padded = np.pad(quality.astype(np.float32), pad, mode="edge")
    kernel = np.full((k,), 1.0 / k, dtype=np.float32)
    return np.convolve(padded, kernel, mode="valid")


# ------------------------------------------------------------- recommend --
def recommend_frame(
    cfg,
    assess_net,
    agent,
    n_frame: int,
    n_objects: int,
    all_F: Optional[np.ndarray],
    all_P: Optional[np.ndarray],
    new_masks_quality: np.ndarray,
    prev_frames: Optional[List[int]],
    annotated_frames_list: List[int],
    mask_quality: Optional[np.ndarray],
    first_frame: int,
    max_nb_interactions: int,
    rng: Optional[np.random.Generator] = None,
) -> int:
    """Dispatch over setting×method.

    oracle: the agent/worst policy sees the TRUE per-frame metric.
    wild: 'worst'/'ours' first predict per-frame quality with the fused
    AssessNet pass (writes into mask_quality in place, like the reference).
    """
    setting, method = cfg.setting, cfg.method
    rng = rng or np.random.default_rng()

    if setting == "oracle":
        if method == "worst":
            return select_next_frame(
                new_masks_quality, metric="worst", prev_frames=prev_frames, rng=rng
            )
        if method == "ours":
            counts = np.zeros(len(new_masks_quality), dtype=np.float32)
            for i in annotated_frames_list:
                counts[i] += 1
            state = np.stack([new_masks_quality, counts], axis=1).astype(np.float32)
            return int(agent.action(state))
        raise NotImplementedError(f"oracle/{method}")

    if setting == "wild":
        if method == "random":
            return select_next_frame(new_masks_quality, metric="random", rng=rng)
        if method == "linspace":
            next_frame = prev_frames[0]
            len_subseq = min(max_nb_interactions, n_frame)
            subseq = gen_subseq(first_frame, n_frame, len_subseq, "equal")
            for i in subseq:
                if i not in prev_frames:
                    return int(i)
            return int(next_frame)
        if method in ("worst", "ours"):
            pred_quality, _ = predict_clip_quality(
                assess_net,
                all_F,
                all_P,
                n_objects,
                chunk=int(getattr(cfg.assess_net, "score_chunk", 0)) or None,
            )
            pred_quality = smooth_clip_quality(
                pred_quality, int(getattr(cfg.assess_net, "smooth_quality", 1))
            )
            if mask_quality is not None:
                mask_quality[:] = pred_quality
            if method == "worst":
                return select_next_frame(
                    pred_quality, metric="worst", prev_frames=prev_frames, rng=rng
                )
            counts = np.zeros(n_frame, dtype=np.float32)
            for i in annotated_frames_list:
                counts[i] += 1
            state = np.stack([pred_quality, counts], axis=1).astype(np.float32)
            return int(agent.action(state))
        raise NotImplementedError(f"wild/{method}")

    raise NotImplementedError(setting)


# --------------------------------------------------------- agent business --
def agent_business(
    cfg,
    agent,
    max_nb_interactions: int,
    n_interaction: int,
    first_scribble: bool,
    old_masks_metric: np.ndarray,
    new_masks_metric: np.ndarray,
    old_frame: int,
    sequence: str,
    scribble_iter: int,
    repeat_selection: bool,
    reward_table: Optional[RewardTable],
    annotated_frames_list: List[int],
    next_frame: int,
    report_save_dir: str,
    expected_count: Optional[int] = None,
    state_override=None,
):
    """Per-round transition collection and episode-end Q-updates
    (reference utils/utils_agent.py:207-256).

    Returns (mean update loss, reward_step, reward_done). In phase 'train'
    the final round of an episode runs ``max_nb_interactions·3 − 1`` replay
    updates, each on a batch drawn from the agent's host RNG; other phases
    only record. (The JAX function's unused ``num_updates`` and
    ``batch_sampler`` options are left out.) ``state_override=(old_state,
    new_state)`` records those per-frame quality arrays as the transition's
    state and next state instead of the true metrics (the wild fine-tune's
    predicted states); rewards stay ground-truth J&F."""
    agent_loss = 0.0
    reward_step, reward_done = 0.0, 0.0
    if first_scribble or cfg.phase == "eval":
        return agent_loss, reward_step, reward_done

    reward_step, reward_done = goal_only_reward(
        sequence,
        n_interaction,
        scribble_iter,
        repeat_selection,
        new_masks_metric,
        table=reward_table,
        expected_count=expected_count,
    )
    t = len(new_masks_metric)
    counts = np.zeros(t, dtype=np.float32)
    for i in annotated_frames_list:
        counts[i] += 1
    next_counts = counts.copy()
    next_counts[next_frame] += 1
    done = n_interaction >= max_nb_interactions

    state_arr, next_state_arr = (
        state_override if state_override is not None
        else (old_masks_metric, new_masks_metric)
    )
    agent.memory(
        Transition(
            sequence=sequence,
            scribble_iter=scribble_iter,
            n_interaction=n_interaction - 1,
            n_interaction_next=n_interaction,
            action=int(old_frame),
            reward_step=reward_step,
            reward_done=reward_done,
            done=done,
            state_iou=np.asarray(state_arr, dtype=np.float32),
            next_state_iou=np.asarray(next_state_arr, dtype=np.float32),
            annotated_frames=counts,
            next_annotated_frames=next_counts,
        ),
        report_save_dir,
    )

    if n_interaction == max_nb_interactions and cfg.phase == "train":
        losses = []
        for _ in range(max_nb_interactions * 3 - 1):
            batch = agent.memory_pool.sample_batch(
                cfg.agent.train_batch_size, agent.host_rng
            )
            loss = agent.update_agent(batch)
            if loss is not None:
                losses.append(loss)
        agent_loss = float(np.mean(losses)) if losses else 0.0

    return agent_loss, reward_step, reward_done
