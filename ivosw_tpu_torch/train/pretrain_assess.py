"""AssessNet pretext pretraining on synthetic mask degradations.

Counterpart of ``ivosw_tpu/train/pretrain_assess.py``: for a random
(clip, frame, object) of the registry it fabricates a degraded mask of
known quality (shift, erosion/dilation, whole-object miss, false-positive
blobs, partial drops) and regresses AssessNet onto the true J&F of that
degradation, with :func:`ivosw_tpu_torch.train.train_assess.assess_train_step`.
The degradations draw from one numpy generator in the JAX package's order,
so the two packages build the same batches from the same seed.

The morphology is scipy's: ``binary_erosion(…, border_value=1)`` and
``binary_dilation(…, border_value=0)`` with a 3×3 square, which equal
``cv2.erode`` / ``cv2.dilate`` with their default borders.

CLI (from a directory holding ``configs/``; writes ``ckpt_dir`` under it):
``python -m ivosw_tpu_torch.train.pretrain_assess [num_steps=N] [batch_size=B] [key=value ...] [--cpu]``
→ ``{ckpt_dir}/assess_pretext.pt`` (the unfolded net's state dict), which
``train_assess.run(net=...)`` takes as its start.
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np
from scipy import ndimage

from ivosw_tpu_torch.core.config import Config, load_config
from ivosw_tpu_torch.device import resolve_device
from ivosw_tpu_torch.train.train_assess import (
    assess_train_step,
    build_net,
    make_assess_optimizer,
    save_assess_checkpoint,
    to_device,
)
from ivosw_tpu_torch.utils.misc import AverageMeter, create_stream_logger, set_random_seed

PRETEXT_CKPT = "assess_pretext.pt"
_SQUARE = np.ones((3, 3), dtype=bool)


def degrade_mask(mask: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """One plausible wrong prediction for a binary mask [H, W] → prob map.

    The degradations span the quality axis: near-identity (high J&F),
    shifts and morphology (mid), misses and spurious blobs (low)."""
    h, w = mask.shape
    prob = mask.astype(np.float32)
    mode = rng.random()
    if mode < 0.08:  # total miss
        prob = np.zeros_like(prob)
    elif mode < 0.16:  # hallucination elsewhere: random blob, object gone
        prob = np.zeros_like(prob)
        by, bx = int(rng.integers(0, h)), int(rng.integers(0, w))
        r = int(rng.integers(h // 8, h // 3))
        yy, xx = np.ogrid[:h, :w]
        prob[(yy - by) ** 2 + (xx - bx) ** 2 < r * r] = 1.0
    else:
        if rng.random() < 0.8:  # shift
            max_shift = max(2, h // rng.integers(6, 24))
            dy, dx = rng.integers(-max_shift, max_shift + 1, size=2)
            prob = np.roll(prob, (int(dy), int(dx)), axis=(0, 1))
        iters = int(rng.integers(0, 4))
        if iters:
            fg = prob.astype(np.uint8) > 0
            if rng.random() < 0.5:
                fg = ndimage.binary_erosion(fg, _SQUARE, iterations=iters, border_value=1)
            else:
                fg = ndimage.binary_dilation(fg, _SQUARE, iterations=iters, border_value=0)
            prob = fg.astype(np.float32)
        if rng.random() < 0.3:  # partial drop: zero a random half-plane strip
            if rng.random() < 0.5:
                cut = int(rng.integers(0, h))
                prob[:cut] = 0.0
            else:
                cut = int(rng.integers(0, w))
                prob[:, cut:] = 0.0
        if rng.random() < 0.4:  # false-positive blob
            by, bx = int(rng.integers(0, h)), int(rng.integers(0, w))
            r = int(rng.integers(2, max(3, h // 6)))
            yy, xx = np.ogrid[:h, :w]
            prob[(yy - by) ** 2 + (xx - bx) ** 2 < r * r] = 1.0
    conf = 0.82 + 0.17 * rng.random()  # above train_assess.MASK_TH
    return prob * conf


def sample_batches(
    registry, sequences, rng: np.random.Generator, batch_size: int
) -> Iterator[dict]:
    """Infinite {img, prob, label} host batches of synthetic degradations."""
    while True:
        imgs, probs, labels = [], [], []
        while len(imgs) < batch_size:
            seq = sequences[int(rng.integers(len(sequences)))]
            frames = registry.load_images(seq)
            anns = registry.load_annotations(seq)
            t = int(rng.integers(frames.shape[0]))
            n_obj = int(anns.max())
            if n_obj == 0:
                continue
            obj = int(rng.integers(1, n_obj + 1))
            label = (anns[t] == obj).astype(np.float32)
            if label.sum() == 0:
                continue
            imgs.append(frames[t].astype(np.float32))
            probs.append(degrade_mask(label, rng))
            labels.append(label)
        yield {
            "img": np.stack(imgs),
            "prob": np.stack(probs),
            "label": np.stack(labels),
        }


def run(
    cfg: Config,
    registry=None,
    num_steps: int = 1500,
    batch_size: Optional[int] = None,
    net=None,
    log=None,
    device=None,
):
    from ivosw_tpu_torch.data.registry import registry_from_config

    device = resolve_device(device)
    log = log or create_stream_logger("pretrain_assess")
    rng = set_random_seed(cfg.seed)
    registry = registry or registry_from_config(cfg)
    sequences = registry.subset(cfg.data.subset)
    a = cfg.assess_net
    batch_size = batch_size or a.train_batch_size
    net = build_net(cfg, net, device)
    optimizer = make_assess_optimizer(net.parameters(), a.momentum, a.weight_decay)

    metric = cfg.davis_interactive.metric
    stream = sample_batches(registry, sequences, rng, batch_size)
    loss_meter = AverageMeter()
    losses = []
    for step in range(1, num_steps + 1):
        batch = next(stream)
        loss, diff, _ = assess_train_step(net, optimizer, to_device(batch, device), a.lr, metric)
        losses.append(float(loss))
        loss_meter.update(losses[-1])
        if step % 50 == 0 or step == 1:
            log.info(
                f"step {step}/{num_steps} loss {losses[-1]:.4f} "
                f"({loss_meter.avg:.4f}) diff {float(diff):.4f}"
            )
    pretext = save_assess_checkpoint(net, cfg.ckpt_dir, PRETEXT_CKPT)
    log.info(f"pretext weights saved to {pretext}")
    return {"loss_avg": loss_meter.avg, "losses": losses, "net": net}


def main(argv=None):
    import sys

    argv = argv if argv is not None else sys.argv[1:]
    run_keys = {"num_steps": int, "batch_size": int}
    run_kwargs = {}
    cfg_overrides = []
    for arg in argv:
        if "=" not in arg:
            continue
        key, value = arg.split("=", 1)
        if key in run_keys:
            run_kwargs[key] = run_keys[key](value)
        else:
            cfg_overrides.append(arg)
    cfg = load_config("configs/config.yaml", cfg_overrides)
    return run(cfg, device="cpu" if "--cpu" in argv else None, **run_kwargs)


if __name__ == "__main__":
    main()
