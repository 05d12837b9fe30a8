"""QA training-data generator: interactive oracle/worst rollouts → PNG dumps.

Counterpart of ``ivosw_tpu/train/generate_qa_data.py``: runs the
interactive loop over the registry's ``subset`` (on DAVIS, the 60 fixed
(sequence, scribble) samples of :mod:`ivosw_tpu_torch.data.qa_samples`)
with setting=oracle, method=worst, allow_repeat=0 and seed 0, and dumps
every round's per-object probability maps as PNGs through
:func:`ivosw_tpu_torch.data.qa_dataset.save_seg_preds`. The port's VOS
backbones run on the host (``vos=fake``), so this stage does no device work.

CLI (from a directory holding ``configs/``; writes
``data/quality_assessment/`` under it):
``python -m ivosw_tpu_torch.train.generate_qa_data dataset=demo vos=fake [key=value ...]``
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np

from ivosw_tpu_torch.core.config import Config, load_config
from ivosw_tpu_torch.data.qa_dataset import save_seg_preds
from ivosw_tpu_torch.data.registry import registry_from_config
from ivosw_tpu_torch.data.scribbles import annotated_frames
from ivosw_tpu_torch.eval.backbones import build_backbone
from ivosw_tpu_torch.interact.recommend import select_next_frame
from ivosw_tpu_torch.interact.robot import robot_from_config
from ivosw_tpu_torch.interact.session import InteractiveSession
from ivosw_tpu_torch.models.vos.protocol import begin_sequence_compat
from ivosw_tpu_torch.ops.metrics import sequence_metric
from ivosw_tpu_torch.utils.misc import create_stream_logger, set_random_seed


def configure(cfg: Config) -> Config:
    cfg.phase = "eval"  # no agent transitions are recorded
    cfg.seed = 0
    cfg.setting = "oracle"
    cfg.method = "worst"
    cfg.davis_interactive.allow_repeat = 0
    return cfg


def run(
    cfg: Config,
    registry=None,
    adapter=None,
    samples: Optional[List[Tuple[str, int]]] = None,
    save_result_dir: str = os.path.join("data", "quality_assessment"),
    subset: str = "train",
    log=None,
):
    log = log or create_stream_logger("generate_qa_data")
    rng = set_random_seed(cfg.seed)
    registry = registry or registry_from_config(cfg)
    adapter = adapter or build_backbone(cfg, registry)
    metric_to_optimize = cfg.davis_interactive.metric
    max_rounds = cfg.davis_interactive.max_nb_interactions

    if samples is None and cfg.dataset == "davis":
        from ivosw_tpu_torch.data.qa_samples import samples as fixture_samples

        samples = [s for s in fixture_samples if s[0] in registry.sequences]

    seen_seq: dict = {}
    n_dumped = 0
    with InteractiveSession(
        registry,
        subset=subset,
        metric_to_optimize=metric_to_optimize,
        max_nb_interactions=max_rounds,
        robot=robot_from_config(cfg, seed=cfg.seed),
        seed=cfg.seed,
    ) as sess:
        if samples is not None:
            sess.samples = list(samples)
        while sess.next():
            sequence, scribbles, first_scribble = sess.get_scribbles(only_last=False)
            af = annotated_frames(sess.sample_last_scribble)
            if first_scribble:
                seen_seq[sequence] = seen_seq.get(sequence, 0) + 1
                info = registry.info(sequence)
                gt_masks = registry.load_annotations(sequence)
                next_frame = af[0]
                prev_frames = [next_frame]
                n_interaction = 1
                state = begin_sequence_compat(
                    adapter,
                    registry.load_images(sequence),
                    info.num_objects,
                    sequence=sequence,
                )
            else:
                n_interaction += 1

            masks, all_p, state = adapter.segment(state, scribbles, next_frame, n_interaction)
            metric = sequence_metric(metric_to_optimize, gt_masks, masks, info.num_objects)
            save_seg_preds(
                np.asarray(all_p),
                dict(
                    sequence=sequence,
                    n_interaction=n_interaction,
                    scribble_iter=seen_seq[sequence],
                ),
                save_result_dir,
            )
            n_dumped += all_p.shape[0] * (all_p.shape[1] - 1)

            next_frame = select_next_frame(
                metric, metric="worst", prev_frames=prev_frames, rng=rng
            )
            prev_frames.append(next_frame)
            sess.submit_masks(masks, next_scribble_frame_candidates=[next_frame])
            log.info(
                f"{sequence}_{seen_seq[sequence]} [{n_interaction}/{max_rounds}] "
                f"{metric_to_optimize}:{metric.mean() * 100:.2f} dumped:{n_dumped}"
            )
    return {"dumped_prob_maps": n_dumped, "save_result_dir": save_result_dir}


def main(argv=None):
    import sys

    argv = argv if argv is not None else sys.argv[1:]
    cfg = configure(load_config("configs/config.yaml", [a for a in argv if "=" in a]))
    return run(cfg)


if __name__ == "__main__":
    main()
