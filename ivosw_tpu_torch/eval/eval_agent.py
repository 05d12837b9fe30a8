"""Interactive evaluation driver.

Counterpart of ``ivosw_tpu/eval/eval_agent.py``: interactive session over
the chosen subset, the setting×method policy matrix, per-round timing /
quality / correlation logging, and a
``results/{VOS}/{setting}/{dataset}/{method}/summary.json`` artifact holding
the AUC and the J&F-vs-round curve.

CLI: ``python -m ivosw_tpu_torch.eval.eval_agent [key=value ...] [--force]
[--cpu]``, e.g. ``dataset=demo vos=fake setting=wild method=ours`` or
``dataset=demo vos=tapnet setting=wild method=ours
assess_net.bf16_inputs=true``; it runs on CUDA unless ``--cpu`` is given. Weights: ``agent.pt``,
``assess_net.pt`` and the backbone's ``tapnet.pt``, ``matchnet.pt`` or
``ipnet.pt`` in ``ckpt_dir`` (torch state dicts of ``Brain``, of an
unfolded ``AssessNet`` and of ``TAPNet``, ``MatchNet`` or ``IPNet``) when
present, else seeded random weights; ``agent.pt`` and ``assess_net.pt`` may
also be the reference's released files (its own layout, converted by
:mod:`ivosw_tpu_torch.utils.torch_import`). ``eval_dp_shards`` > 1 runs
the data-parallel sweep (:func:`evaluate_dp`), ``eval_sp_shards`` > 1
splits each scoring chunk's frames over that many devices; the two
exclude each other.
"""

from __future__ import annotations

import contextlib
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
    another device raises); frames go to ``device`` once per sequence, in
    bfloat16 when ``cfg.assess_net.bf16_inputs`` is set (as the JAX
    package's upload).
    ``device=None`` means CUDA (raises without a GPU).
    ``samples``: optional explicit (sequence, scribble_idx) list."""
    device = resolve_device(device)
    check_on_device(device, assess_net=assess_net, agent=getattr(agent, "brain", None))
    # bf16_inputs halves the frames' upload and every round's reads of them
    frame_dtype = (
        torch.bfloat16 if getattr(cfg.assess_net, "bf16_inputs", False) else torch.float32
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
                    all_F_dev = torch.as_tensor(all_F).to(frame_dtype).to(device)
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


def _agent_on(agent, device):
    """A shard's own agent: a shallow copy whose Brain is a replica on
    ``device`` (the Brain itself there; evaluation only reads it), with its
    own step count and its own copy of the host RNG, so shard threads share
    no state that ``Agent.action`` writes."""
    from ivosw_tpu_torch.parallel.mesh import replica_on

    if agent is None:
        return None
    other = copy.copy(agent)
    other.brain = replica_on(agent.brain, device)
    other.device = device
    other.host_rng = copy.deepcopy(agent.host_rng)
    return other


def evaluate_dp(
    cfg: Config,
    registry,
    adapter_factory,
    n_shards: Optional[int] = None,
    devices=None,
    agent=None,
    assess_net=None,
    subset: str = "val",
    max_nb_interactions: int = 8,
    report_save_dir: Optional[str] = None,
    vos_name: Optional[str] = None,
    log=None,
    overwrite: bool = False,
):
    """Data-parallel interactive evaluation: sequences sharded over devices.

    The (sequence, scribble) samples split round-robin into one shard per
    device (``devices``: default every CUDA device; a device may repeat);
    each shard runs :func:`evaluate` in its own thread with its own adapter
    (``adapter_factory(device)``) and replicas of the Brain and AssessNet
    on its device, and the rounds merge into exactly the curve a
    single-device run over all samples gives (the per-sample RNG makes even
    ``method=random`` shard-invariant). Threads on one card share its
    default stream, so their work runs in launch order. Writes
    ``summary.json`` (and each shard's report under ``shard{i}``); the
    returned summary also holds the shards' report rows (``report``)."""
    import concurrent.futures

    from ivosw_tpu_torch.interact.recommend import data_parallel_shard
    from ivosw_tpu_torch.parallel.mesh import replica_on

    log = log or create_stream_logger("eval_dp")
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        if not devices:
            raise RuntimeError("no CUDA device available; pass devices=['cpu', ...]")
    devices = [resolve_device(d) for d in devices]
    n = min(n_shards or len(devices), len(devices))
    vos_name = vos_name or cfg.vos
    metric = cfg.davis_interactive.metric
    if report_save_dir is None:
        report_save_dir = _default_report_dir(vos_name, cfg, overwrite)
    os.makedirs(report_save_dir, exist_ok=True)

    samples = [
        (seq, i)
        for seq in registry.subset(subset)
        for i in range(1, registry.info(seq).num_scribbles + 1)
    ]
    shards = [samples[i::n] for i in range(n)]

    def run_shard(i: int):
        if not shards[i]:
            return None
        dev = devices[i]
        with data_parallel_shard(), (
            torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()
        ):
            return evaluate(
                cfg,
                registry,
                adapter_factory(dev),
                agent=_agent_on(agent, dev),
                assess_net=None if assess_net is None else replica_on(assess_net, dev),
                subset=subset,
                max_nb_interactions=max_nb_interactions,
                report_save_dir=os.path.join(report_save_dir, f"shard{i}"),
                vos_name=vos_name,
                samples=shards[i],
                log=log,
                device=dev,
            )

    with concurrent.futures.ThreadPoolExecutor(max_workers=n) as pool:
        results = [r for r in pool.map(run_shard, range(n)) if r is not None]

    rows = [row for r in results for row in r["report"]]
    rounds = sorted({row["interaction"] for row in rows})
    curve = [
        float(np.mean([row["value"] for row in rows if row["interaction"] == r]))
        for r in rounds
    ]
    auc = auc_from_curve(curve)
    log.info(f"# dp sweep ({n} shards): auc:{auc * 100:.4f}")
    summary = {"auc": auc, "curve": {metric: curve}}
    with open(os.path.join(report_save_dir, "summary.json"), "w") as fp:
        json.dump(summary, fp)
    summary["n_shards"] = n
    summary["report"] = rows
    return summary


def load_weights(module: torch.nn.Module, ckpt_dir: str, name: str, convert=None) -> bool:
    """Load ``{ckpt_dir}/{name}`` (a state dict saved with ``torch.save``)
    into ``module`` when the file exists; returns whether it did.
    ``convert(state_dict, path)`` maps another layout onto the module's
    first (the reference's ``agent.pt`` and ``assess_net.pt``)."""
    path = os.path.join(ckpt_dir, name)
    if not os.path.exists(path):
        return False
    state = torch.load(path, map_location="cpu", weights_only=True)
    module.load_state_dict(convert(state, path) if convert else state)
    return True


def build_and_evaluate(cfg: Config, overwrite: bool = False, device=None):
    """Config-driven wiring: registry + backbone + (agent, AssessNet).

    ``eval_dp_shards`` > 1 runs :func:`evaluate_dp` over as many CUDA
    devices as there are, up to that count (copies of the CPU for a CPU
    run); ``eval_sp_shards`` > 1 needs that many devices (checked before
    anything runs). The two together raise ``ValueError``."""
    if cfg.eval_dp_shards > 1 and cfg.eval_sp_shards > 1:
        raise ValueError(
            "eval_dp_shards and eval_sp_shards are exclusive: DP assigns one "
            "sequence per device; SP shards one sequence's frames over them"
        )
    from ivosw_tpu_torch.interact.recommend import _sp_mesh
    from ivosw_tpu_torch.data.registry import registry_from_config
    from ivosw_tpu_torch.eval.backbones import build_backbone
    from ivosw_tpu_torch.models.agent import Agent
    from ivosw_tpu_torch.models.assess import AssessNet, init_assess_net
    from ivosw_tpu_torch.models.fold import fold_assess_variables
    from ivosw_tpu_torch.utils.torch_import import assess_state_dict, brain_state_dict

    device = resolve_device(device)
    _sp_mesh(cfg.eval_sp_shards, device)
    registry = registry_from_config(cfg)

    agent = None
    assess_net = None
    if cfg.method == "ours":
        agent = Agent(cfg, device=device)
        load_weights(agent.brain, cfg.ckpt_dir, "agent.pt", brain_state_dict)
    if cfg.setting == "wild" and cfg.method in ("ours", "worst"):
        assess_net = init_assess_net(cfg.seed)
        load_weights(assess_net, cfg.ckpt_dir, "assess_net.pt", assess_state_dict)
        if cfg.assess_net.fold_inference:
            folded = AssessNet(fold=True)
            folded.load_state_dict(fold_assess_variables(assess_net.state_dict()))
            assess_net = folded
        assess_net = assess_net.to(device).eval()

    if cfg.eval_dp_shards > 1:
        n = cfg.eval_dp_shards
        devices = ([device] * n if device.type != "cuda" else
                   [torch.device("cuda", i) for i in range(min(n, torch.cuda.device_count()))])
        return evaluate_dp(
            cfg,
            registry,
            lambda d: build_backbone(cfg, registry, d),
            n_shards=n,
            devices=devices,
            agent=agent,
            assess_net=assess_net,
            max_nb_interactions=cfg.eval_rounds,
            vos_name=cfg.vos,
            overwrite=overwrite,
        )
    return evaluate(
        cfg,
        registry,
        build_backbone(cfg, registry, device),
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
