"""Interactive evaluation driver.

Counterpart of ``ivosw_tpu/eval/eval_agent.py``: interactive session over
the chosen subset, the setting×method policy matrix, per-round timing /
quality / correlation logging, and a
``results/{VOS}/{setting}/{dataset}/{method}/summary.json`` artifact holding
the AUC and the J&F-vs-round curve.

CLI: ``python -m ivosw_tpu_torch.eval.eval_agent [key=value ...] [--force]
[--cpu]``, e.g. ``dataset=demo vos=fake setting=wild method=ours``; it runs
on CUDA unless ``--cpu`` is given. Weights: ``agent.pt``
and ``assess_net.pt`` in ``ckpt_dir`` (torch state dicts of ``Brain`` and of
an unfolded ``AssessNet``) when present, else seeded random weights. The
data-parallel sweep (``evaluate_dp``) comes with the parallelism slice.
"""

from __future__ import annotations

import copy
import json
import os
import time
from typing import Optional

import numpy as np
import torch

from ivosw_tpu_torch.core.config import Config
from ivosw_tpu_torch.data.scribbles import annotated_frames
from ivosw_tpu_torch.device import check_on_device, resolve_device
from ivosw_tpu_torch.interact.recommend import recommend_frame
from ivosw_tpu_torch.interact.robot import ScribbleRobot, robot_from_config
from ivosw_tpu_torch.interact.session import InteractiveSession
from ivosw_tpu_torch.models.vos.protocol import begin_sequence_compat
from ivosw_tpu_torch.ops.metrics import auc_from_curve, sequence_metric
from ivosw_tpu_torch.utils.misc import AverageMeter, create_stream_logger, set_random_seed


def _sample_rng(seed: int, sequence: str, scribble_idx: int) -> np.random.Generator:
    """Per-sample RNG, derived from the sample identity alone — stochastic
    method decisions (method=random) are reproducible AND invariant to how
    samples are sharded across devices/processes."""
    import zlib

    return np.random.default_rng(
        np.random.SeedSequence([seed, zlib.crc32(sequence.encode()), scribble_idx])
    )


def _default_report_dir(vos_name: str, cfg: Config, overwrite: bool) -> str:
    """The reference's results-tree layout, guarded against silent clobber.

    ``evaluate()`` callers that do not pass an explicit ``report_save_dir``
    land in the repository's ``results/`` tree, whose summaries are
    committed; refuse to default onto an existing summary.json unless
    ``overwrite=True``.
    """
    report_save_dir = os.path.join(
        "results", vos_name, cfg.setting, cfg.dataset, cfg.method
    )
    summary = os.path.join(report_save_dir, "summary.json")
    if os.path.exists(summary) and not overwrite:
        raise FileExistsError(
            f"refusing to overwrite committed artifact {summary}: pass an "
            f"explicit report_save_dir (e.g. under /tmp for probes) or "
            f"overwrite=True (CLI: --force)"
        )
    return report_save_dir


def evaluate(
    cfg: Config,
    registry,
    adapter,
    agent=None,
    assess_net=None,
    subset: str = "val",
    max_nb_interactions: int = 8,
    report_save_dir: Optional[str] = None,
    robot: Optional[ScribbleRobot] = None,
    log=None,
    vos_name: Optional[str] = None,
    samples=None,
    overwrite: bool = False,
    device=None,
):
    """Run the full interactive evaluation; returns the summary dict.

    ``assess_net``: the AssessNet scoring the wild setting's worst/ours
    methods, already on ``device`` (as is the agent's Brain; either on
    another device raises); frames go to ``device`` once per sequence.
    ``device=None`` means CUDA (raises without a GPU).
    ``samples``: optional explicit (sequence, scribble_idx) list."""
    device = resolve_device(device)
    check_on_device(device, assess_net=assess_net, agent=getattr(agent, "brain", None))
    if getattr(cfg.assess_net, "bf16_inputs", False):
        raise NotImplementedError(
            "assess_net.bf16_inputs: the crop kernel reads float32 frames "
            "and prob maps (bf16 inputs are a later slice)"
        )
    log = log or create_stream_logger("eval")
    set_random_seed(cfg.seed)
    metric_to_optimize = cfg.davis_interactive.metric
    vos_name = vos_name or getattr(adapter, "name", "vos")
    allow_repeat = cfg.davis_interactive.allow_repeat
    # worst/linspace never revisit frames (reference eval_agent_atnet.py:121,146)
    if cfg.method in ("worst", "linspace"):
        allow_repeat = 0

    if report_save_dir is None:
        report_save_dir = _default_report_dir(vos_name, cfg, overwrite)
    os.makedirs(report_save_dir, exist_ok=True)

    quality_meter = AverageMeter()
    seg_meter = AverageMeter()
    rec_meter = AverageMeter()
    corr_meter = AverageMeter()
    seen_seq: dict = {}

    max_time = cfg.davis_interactive.max_time_per_interaction or None
    with InteractiveSession(
        registry,
        subset=subset,
        metric_to_optimize=metric_to_optimize,
        max_nb_interactions=max_nb_interactions,
        max_time=max_time,
        report_save_dir=report_save_dir,
        robot=robot or robot_from_config(cfg, seed=cfg.seed),
        seed=cfg.seed,
    ) as sess:
        if samples is not None:
            sess.samples = list(samples)
        while sess.next():
            sequence, scribbles, first_scribble = sess.get_scribbles(only_last=False)
            af = annotated_frames(sess.sample_last_scribble)

            if first_scribble:
                seen_seq[sequence] = seen_seq.get(sequence, 0) + 1
                rng = _sample_rng(cfg.seed, sequence, sess.current_sample[1])
                info = registry.info(sequence)
                gt_masks = registry.load_annotations(sequence)
                all_F = registry.load_images(sequence)
                if cfg.setting == "wild" and cfg.method in ("ours", "worst"):
                    # one upload per sequence; every round's scoring pass
                    # then reads the frames from device memory
                    all_F_dev = torch.as_tensor(all_F, dtype=torch.float32, device=device)
                else:
                    all_F_dev = all_F
                n_frame = info.num_frames
                n_objects = info.num_objects
                assert len(af) > 0
                next_frame = first_frame = af[0]
                prev_frames = None if allow_repeat > 0 else [next_frame]
                annotated_frames_list = [next_frame]
                n_interaction = 1
                mask_quality_pred = (
                    np.zeros(n_frame)
                    if cfg.setting == "wild" and cfg.method in ("ours", "worst")
                    else None
                )
                state = begin_sequence_compat(
                    adapter, all_F, n_objects, sequence=sequence
                )
            else:
                if af and next_frame not in af:
                    # the robot found nothing to correct on the recommended
                    # frame and annotated its fallback instead — segment the
                    # frame that actually carries the new scribbles
                    next_frame = af[-1]
                annotated_frames_list.append(next_frame)
                n_interaction += 1

            seg_tic = time.perf_counter()
            masks, all_P, state = adapter.segment(
                state, scribbles, next_frame, n_interaction
            )
            seg_meter.update(time.perf_counter() - seg_tic)

            new_masks_metric = sequence_metric(
                metric_to_optimize, gt_masks, masks, n_objects
            )

            rec_tic = time.perf_counter()
            next_frame = recommend_frame(
                cfg,
                assess_net,
                agent,
                n_frame=n_frame,
                n_objects=n_objects,
                all_F=all_F_dev,
                all_P=all_P,
                new_masks_quality=new_masks_metric,
                prev_frames=prev_frames,
                annotated_frames_list=copy.deepcopy(annotated_frames_list),
                mask_quality=mask_quality_pred,
                first_frame=first_frame,
                max_nb_interactions=max_nb_interactions,
                rng=rng,
            )
            rec_meter.update(time.perf_counter() - rec_tic)
            if prev_frames is not None:
                prev_frames.append(next_frame)

            sess.submit_masks(masks, next_scribble_frame_candidates=[next_frame])

            corr = (
                float(np.corrcoef(new_masks_metric, mask_quality_pred)[0, 1])
                if mask_quality_pred is not None
                and np.std(mask_quality_pred) > 0
                and np.std(new_masks_metric) > 0
                else float("nan")
            )
            if not np.isnan(corr):
                corr_meter.update(corr)
            log.info(
                f"avg_{metric_to_optimize}: {new_masks_metric.mean() * 100:.2f} "
                f"seg:{seg_meter.val:.2f}s rec:{rec_meter.val:.2f}s "
                f"next:{next_frame:3d} corr:{corr:.2f} "
                f"seq:{sequence}_{seen_seq[sequence]} "
                f"[{n_interaction}/{max_nb_interactions}]"
            )
            if n_interaction == max_nb_interactions:
                quality_meter.update(float(new_masks_metric.mean()) * 100)

        global_summary = sess.get_global_summary()

    curve = global_summary["curve"][metric_to_optimize][:-1]
    auc = auc_from_curve(curve)
    log.info(f"# final avg {metric_to_optimize}: {quality_meter.avg:.4f}")
    log.info(f"# global_summary: auc:{auc * 100:.4f}")

    summary = {"auc": auc, "curve": {metric_to_optimize: curve}}
    with open(os.path.join(report_save_dir, "summary.json"), "w") as fp:
        json.dump(summary, fp)
    summary["timing"] = {
        "seg_time_avg": seg_meter.avg,
        "rec_time_avg": rec_meter.avg,
    }
    summary["report"] = sess.get_report()
    return summary


def load_weights(module: torch.nn.Module, ckpt_dir: str, name: str) -> bool:
    """Load ``{ckpt_dir}/{name}`` (a state dict saved with ``torch.save``)
    into ``module`` when the file exists; returns whether it did."""
    path = os.path.join(ckpt_dir, name)
    if not os.path.exists(path):
        return False
    module.load_state_dict(torch.load(path, map_location="cpu", weights_only=True))
    return True


def build_and_evaluate(cfg: Config, overwrite: bool = False, device=None):
    """Config-driven wiring: registry + backbone + (agent, AssessNet)."""
    if cfg.eval_dp_shards > 1 or cfg.eval_sp_shards > 1:
        raise NotImplementedError(
            "eval_dp_shards / eval_sp_shards > 1: the parallelism slice is not ported yet"
        )
    from ivosw_tpu_torch.data.registry import registry_from_config
    from ivosw_tpu_torch.eval.backbones import build_backbone
    from ivosw_tpu_torch.models.agent import Agent
    from ivosw_tpu_torch.models.assess import AssessNet, init_assess_net
    from ivosw_tpu_torch.models.fold import fold_assess_variables

    device = resolve_device(device)
    registry = registry_from_config(cfg)

    agent = None
    assess_net = None
    if cfg.method == "ours":
        agent = Agent(cfg, device=device)
        load_weights(agent.brain, cfg.ckpt_dir, "agent.pt")
    if cfg.setting == "wild" and cfg.method in ("ours", "worst"):
        assess_net = init_assess_net(cfg.seed)
        load_weights(assess_net, cfg.ckpt_dir, "assess_net.pt")
        if cfg.assess_net.fold_inference:
            folded = AssessNet(fold=True)
            folded.load_state_dict(fold_assess_variables(assess_net.state_dict()))
            assess_net = folded
        assess_net = assess_net.to(device).eval()

    return evaluate(
        cfg,
        registry,
        build_backbone(cfg, registry),
        agent=agent,
        assess_net=assess_net,
        max_nb_interactions=cfg.eval_rounds,
        vos_name=cfg.vos,
        overwrite=overwrite,
        device=device,
    )


def main(argv=None):
    import sys

    from ivosw_tpu_torch.core.config import load_config

    argv = argv if argv is not None else sys.argv[1:]
    overrides = [a for a in argv if "=" in a]
    cfg = load_config("configs/config.yaml", overrides)
    cfg.phase = "eval"
    return build_and_evaluate(
        cfg, overwrite="--force" in argv, device="cpu" if "--cpu" in argv else None
    )


if __name__ == "__main__":
    main()
