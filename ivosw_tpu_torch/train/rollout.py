"""Shared interactive-rollout loop of the agent training phases.

Counterpart of ``ivosw_tpu/train/rollout.py``. Per epoch a session over
the train subset; per episode:

- a ``len_subseq``-frame consecutive window centred on the first scribbled
  frame (``gen_subseq``); the backbone segments the window, the metric is
  taken on the window's ground truth, and frame indices are window-local;
- ``recommend_frame`` picks the next local frame (the random policy for the
  baseline and pretrain phases, the ε-greedy agent for train);
- when the robot annotated a fallback frame, the loop follows it;
- the window's masks are spliced into the full-length ground truth before
  ``submit_masks``, so the robot scribbles inside the window;
- ``repeat_selection``: the chosen frame is not among the least-annotated;
- ``agent_business`` records the transition (Eq. 3 reward against the
  baseline table) and, in phase 'train', runs 3·rounds−1 Q-updates at the
  end of the episode.

With ``setting=wild``, ``method=ours`` and an ``assess_net``, the policy
acts on AssessNet-predicted qualities (the fused-box crop kernel on a CUDA
device), and the transitions record those same predicted states. The clip's
frames are uploaded once per episode to the AssessNet's device, in bfloat16
under ``assess_net.bf16_inputs`` (as the evaluation driver uploads them).
"""

from __future__ import annotations

import copy
import inspect
from typing import List, Optional

import numpy as np
import torch

from ivosw_tpu_torch.core.config import Config
from ivosw_tpu_torch.data.scribbles import annotated_frames as scrib_frames
from ivosw_tpu_torch.interact.recommend import (
    RewardTable,
    agent_business,
    gen_subseq,
    recommend_frame,
)
from ivosw_tpu_torch.interact.robot import ScribbleRobot, robot_from_config
from ivosw_tpu_torch.interact.session import InteractiveSession
from ivosw_tpu_torch.models.vos.protocol import begin_sequence_compat
from ivosw_tpu_torch.ops.metrics import sequence_metric
from ivosw_tpu_torch.utils.misc import AverageMeter, create_stream_logger, set_random_seed


def run_interactive_phase(
    cfg: Config,
    registry,
    adapter,
    agent,
    reward_table: Optional[RewardTable] = None,
    subset: str = "train",
    seq_list: Optional[List[str]] = None,
    assess_net=None,
    robot: Optional[ScribbleRobot] = None,
    log=None,
    expected_count: Optional[int] = None,
    on_epoch_end=None,
    start_epoch: int = 1,
):
    """Run cfg.num_epochs of interactive rollouts; returns summary stats.

    ``start_epoch`` resumes a killed run at that epoch (1-based): each epoch
    reseeds its session and robot with ``cfg.seed + epoch``. A resumed run
    differs from an uninterrupted one as the JAX package's does: the replay
    pool holds no transitions of the finished epochs, the exploration RNG
    restarts, and the target equals the policy at the resume point."""
    log = log or create_stream_logger(f"train/{cfg.phase}")
    rng = set_random_seed(cfg.seed)
    metric_to_optimize = cfg.davis_interactive.metric
    max_rounds = cfg.davis_interactive.max_nb_interactions
    report_dir = cfg.agent.save_result_dir
    wild_states = cfg.setting == "wild" and cfg.method == "ours" and assess_net is not None
    needs_frames = cfg.setting == "wild" and cfg.method in ("ours", "worst")
    frame_dtype = (
        torch.bfloat16 if getattr(cfg.assess_net, "bf16_inputs", False) else torch.float32
    )

    seen_seq: dict = {}
    loss_meter = AverageMeter()
    final_quality = AverageMeter()

    for epoch in range(start_epoch, cfg.num_epochs + 1):
        with InteractiveSession(
            registry,
            subset=subset,
            metric_to_optimize=metric_to_optimize,
            max_nb_interactions=max_rounds,
            max_time=cfg.davis_interactive.max_time_per_interaction or None,
            robot=robot or robot_from_config(cfg, seed=cfg.seed + epoch),
            seed=cfg.seed + epoch,
        ) as sess:
            if seq_list is not None:
                sess.samples = [s for s in sess.samples if s[0] in seq_list]
            while sess.next():
                sequence, scribbles, first_scribble = sess.get_scribbles(
                    only_last=False
                )
                af = scrib_frames(sess.sample_last_scribble)

                if first_scribble:
                    assert len(af) > 0
                    seen_seq[sequence] = seen_seq.get(sequence, 0) + 1
                    info = registry.info(sequence)
                    gt_original = registry.load_annotations(sequence)
                    # real backbones segment from frames; a fake that takes
                    # the window's ground truth needs none unless AssessNet
                    # scores them
                    adapter_takes_gt = "gt" in inspect.signature(
                        adapter.begin_sequence
                    ).parameters
                    frames_original = (
                        registry.load_images(sequence)
                        if needs_frames or not adapter_takes_gt
                        else None
                    )
                    n_objects = info.num_objects
                    first_global = af[0]
                    len_subseq = min(cfg.data.len_subseq, info.num_frames)
                    subseq = gen_subseq(first_global, info.num_frames, len_subseq)
                    n_frame = len_subseq
                    next_frame = subseq.index(first_global)
                    first_frame = next_frame
                    gt_masks = gt_original[subseq]
                    clip_frames = (
                        frames_original[subseq] if frames_original is not None else None
                    )
                    score_frames = clip_frames
                    if needs_frames and assess_net is not None:
                        # one upload per episode; each round's scoring
                        # pass reads the frames from device memory
                        score_frames = torch.as_tensor(clip_frames).to(frame_dtype).to(
                            next(assess_net.parameters()).device
                        )
                    prev_frames = [next_frame]
                    annotated_frames_list = [next_frame]
                    n_interaction = 1
                    # wild/ours: Q-updates train on the states the policy
                    # acts on; recommend_frame writes them into pred_buf
                    pred_buf = (
                        np.zeros(n_frame, dtype=np.float32) if wild_states else None
                    )
                    old_pred = None
                    new_pred = None
                    state = begin_sequence_compat(
                        adapter, clip_frames, n_objects, sequence=sequence, gt=gt_masks
                    )
                    old_frame = None
                    old_metric = None
                    repeat_selection = None
                    new_masks_metric = None
                else:
                    if af and subseq[next_frame] not in af and af[-1] in subseq:
                        # the robot annotated a fallback frame; follow it
                        next_frame = subseq.index(af[-1])
                    counts = np.zeros(len(new_masks_metric))
                    for i in annotated_frames_list:
                        counts[i] += 1
                    repeat_selection = next_frame not in list(
                        np.where(counts == counts.min())[0]
                    )
                    annotated_frames_list.append(next_frame)
                    old_frame = next_frame
                    old_metric = new_masks_metric
                    old_pred = new_pred
                    n_interaction += 1

                # the accumulated scribbles cut to the training window
                scribbles_local = {
                    "sequence": sequence,
                    "scribbles": [scribbles["scribbles"][i] for i in subseq],
                }

                masks, all_P, state = adapter.segment(
                    state, scribbles_local, next_frame, n_interaction
                )
                new_masks_metric = sequence_metric(
                    metric_to_optimize, gt_masks, masks, n_objects
                )

                next_frame = recommend_frame(
                    cfg,
                    assess_net,
                    agent,
                    n_frame=n_frame,
                    n_objects=n_objects,
                    all_F=score_frames,
                    all_P=all_P,
                    new_masks_quality=new_masks_metric,
                    prev_frames=prev_frames,
                    annotated_frames_list=copy.deepcopy(annotated_frames_list),
                    mask_quality=pred_buf,
                    first_frame=first_frame,
                    max_nb_interactions=max_rounds,
                    rng=rng,
                )
                if wild_states:
                    new_pred = pred_buf.copy()
                prev_frames.append(next_frame)

                submit = gt_original.copy()
                submit[subseq] = masks
                sess.submit_masks(
                    submit, next_scribble_frame_candidates=[subseq[next_frame]]
                )

                loss, r_step, r_done = agent_business(
                    cfg,
                    agent,
                    max_rounds,
                    n_interaction,
                    first_scribble,
                    old_metric,
                    new_masks_metric,
                    old_frame,
                    sequence,
                    seen_seq[sequence],
                    repeat_selection,
                    reward_table,
                    annotated_frames_list,
                    next_frame,
                    report_dir,
                    expected_count=expected_count,
                    state_override=(
                        (old_pred, new_pred)
                        if wild_states and old_pred is not None
                        else None
                    ),
                )
                if loss:
                    loss_meter.update(loss)
                if n_interaction == max_rounds:
                    final_quality.update(float(new_masks_metric.mean()))
                    log.info(
                        f"ep{epoch} {sequence}_{seen_seq[sequence]} "
                        f"{metric_to_optimize}:{new_masks_metric.mean() * 100:.2f} "
                        f"r_step:{r_step:+.1f} r_done:{r_done:+.2f} "
                        f"loss:{loss:.4f}"
                    )
        if on_epoch_end is not None:
            on_epoch_end(epoch)

    return {
        "final_quality_avg": final_quality.avg,
        "update_loss_avg": loss_meter.avg,
        "episodes": final_quality.count,
    }
