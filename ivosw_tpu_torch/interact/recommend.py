"""Frame-recommendation policy layer.

Counterpart of ``ivosw_tpu/interact/recommend.py`` for evaluation:
``select_next_frame``, ``gen_subseq``, ``smooth_clip_quality`` and the
setting×method dispatch ``recommend_frame`` are copies; in the wild setting
:func:`predict_clip_quality` scores all T×O pairs on the device of the
frames through :func:`ivosw_tpu_torch.models.assess.score_clip`, in
fixed-size frame chunks (the padded tail is scored and dropped, as the JAX
package's static-shape chunks are). The reward table and ``agent_business``
come with the agent-training slice; the sequence-parallel mesh path with
the parallelism slice.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ivosw_tpu_torch.device import check_on_device
from ivosw_tpu_torch.models.assess import score_clip

FRAME_CHUNK = 32


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
