"""AssessNet (QA model) trainer: masked MSE regression of per-frame J&F.

Counterpart of ``ivosw_tpu/train/train_assess.py``. Per sample the target
is the J&F between the object's label and the binarised prob map
(prob > :data:`MASK_TH`); samples whose label ∪ mask is empty are left out
of the loss. SGD with momentum 0.9 and weight decay 5e-4 on gradients
clamped element-wise to ±1, the learning rate decayed by γ = 0.95 per epoch
(ExponentialLR); a checkpoint every 10 epochs and after the last.

One step (:func:`assess_train_step`) runs on the tensors' device: the
train-mode forward through the crop kernel (the BN running stats updated in
place), the J&F target on the device (:mod:`ivosw_tpu_torch.ops.metrics_device`),
the masked loss, a backward pass with respect to the parameters only, the
clamp and the SGD update. Augmentation stays on the host
(:mod:`ivosw_tpu_torch.data.augment`).

CLI (from a directory holding ``configs/``; writes ``ckpt_dir`` under it):
``python -m ivosw_tpu_torch.train.train_assess [key=value ...] [--cpu]``
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from ivosw_tpu_torch.core.config import Config, load_config
from ivosw_tpu_torch.device import check_on_device, resolve_device
from ivosw_tpu_torch.models.assess import assess_forward, init_assess_net
from ivosw_tpu_torch.ops.metrics_device import (
    batched_f_measure_device,
    batched_jaccard_device,
)
from ivosw_tpu_torch.utils.misc import AverageMeter, create_stream_logger, set_random_seed

MASK_TH = 0.8  # prob maps binarise at 0.8 for the target (reference quality_assessment.py:244)
GRAD_CLIP = 1.0
ASSESS_CKPT = "assess_net.pt"


def make_assess_optimizer(params, momentum: float, weight_decay: float) -> torch.optim.SGD:
    """torch SGD with the maths of the JAX package's
    ``optax.chain(clip(1), add_decayed_weights(wd), trace(momentum))``: the
    caller clamps each gradient to ±1 first (:func:`assess_train_step`),
    SGD adds ``wd · param`` and keeps ``buf = momentum · buf + g`` (its first
    step stores ``g``, as optax's trace starting at 0 does). The learning
    rate is set in the param group at every step."""
    return torch.optim.SGD(
        params, lr=0.0, momentum=momentum, dampening=0.0, nesterov=False,
        weight_decay=weight_decay,
    )


def _target_metric(labels: torch.Tensor, masks: torch.Tensor, metric: str) -> torch.Tensor:
    """Per-sample J / F / J&F between the binary label and the binary mask."""
    lab = labels.to(torch.int32)
    msk = masks.to(torch.int32)
    if metric == "J":
        return batched_jaccard_device(lab, msk, 1)[:, 0]
    if metric == "F":
        return batched_f_measure_device(lab, msk, 1)[:, 0]
    j = batched_jaccard_device(lab, msk, 1)[:, 0]
    f = batched_f_measure_device(lab, msk, 1)[:, 0]
    return 0.5 * j + 0.5 * f


def assess_train_step(net, optimizer, batch, lr: float, metric: str = "J_AND_F"):
    """One step on a batch of tensors on the net's device: img [B,H,W,3],
    prob [B,H,W], label [B,H,W]. Returns (loss, diff, n_valid) tensors.

    A batch with no valid sample leaves the parameters and the momentum as
    they were (no optimizer step), but its forward has updated the BN
    running stats, as the JAX step returns its new batch stats whatever
    the gate."""
    labels = batch["label"]
    with torch.no_grad():
        masks = batch["prob"] > MASK_TH
        target = _target_metric(labels, masks, metric)
        union = ((labels > 0) | masks).sum(dim=(-2, -1)).float()
        valid = (union > 0).float()
        n_valid = valid.sum()
        denom = torch.clamp_min(n_valid, 1.0)

    pred = assess_forward(net, batch["img"], batch["prob"], train=True)[:, 0]
    loss = torch.sum((pred - target) ** 2 * valid) / denom
    diff = torch.sum(torch.abs(pred - target) * valid) / denom
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    if n_valid.item() > 0:
        for group in optimizer.param_groups:
            group["lr"] = lr
            for p in group["params"]:
                if p.grad is not None:
                    p.grad.clamp_(-GRAD_CLIP, GRAD_CLIP)
        optimizer.step()
    return loss.detach(), diff.detach(), n_valid


def to_device(batch, device) -> dict:
    """Host numpy batch → tensors on ``device``."""
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def save_assess_checkpoint(net, ckpt_dir: str, name: str = ASSESS_CKPT) -> str:
    """The unfolded net's state dict (CPU tensors) → ``{ckpt_dir}/{name}``;
    ``assess_net.pt`` is the file ``eval_agent`` loads."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, name)
    torch.save({k: v.detach().cpu() for k, v in net.state_dict().items()}, path)
    return path


def build_net(cfg: Config, net, device: torch.device):
    """The net to train: ``net`` as given (it must lie on ``device``), else
    a bf16 AssessNet moved there: with ``assess_net.imagenet_ckpt`` its stem
    and trunk from that torchvision ``resnet50`` state dict (a missing or
    unreadable file raises ``FileNotFoundError``), otherwise seeded."""
    if net is None:
        if cfg.assess_net.imagenet_ckpt:
            from ivosw_tpu_torch.utils.torch_import import init_assess_from_imagenet

            return init_assess_from_imagenet(cfg.assess_net.imagenet_ckpt, cfg.seed).to(device)
        return init_assess_net(cfg.seed).to(device)
    check_on_device(device, net=net)
    return net


def run(
    cfg: Config,
    registry=None,
    save_result_dir: str = os.path.join("data", "quality_assessment"),
    net=None,
    num_epochs: Optional[int] = None,
    log=None,
    resume_path: Optional[str] = None,
    save_every: int = 200,
    device=None,
):
    """Train on the dump tree under ``save_result_dir``.

    ``resume_path``: a ``{model, optimizer, epoch, step}`` snapshot is saved
    there (``torch.save``) every ``save_every`` steps and at each epoch
    boundary, and removed on completion; if it exists, training resumes
    from it, re-drawing the epoch's batch order and skipping the consumed
    prefix without loading it (fresh augmentation draws)."""
    from ivosw_tpu_torch.data.augment import QAAugmentPipeline
    from ivosw_tpu_torch.data.qa_dataset import QARegressionDataset
    from ivosw_tpu_torch.data.registry import registry_from_config

    device = resolve_device(device)
    log = log or create_stream_logger("train_assess")
    set_random_seed(cfg.seed)
    registry = registry or registry_from_config(cfg)
    a = cfg.assess_net
    num_epochs = num_epochs or a.num_epochs
    net = build_net(cfg, net, device)
    optimizer = make_assess_optimizer(net.parameters(), a.momentum, a.weight_decay)

    start_epoch, start_step = 1, 0
    if resume_path and os.path.exists(resume_path):
        snap = torch.load(resume_path, map_location=device, weights_only=True)
        net.load_state_dict(snap["model"])
        optimizer.load_state_dict(snap["optimizer"])
        start_epoch, start_step = int(snap["epoch"]), int(snap["step"])
        log.info(f"restored {resume_path} (epoch {start_epoch} step {start_step})")

    def snapshot(epoch, step):
        torch.save(
            {"model": net.state_dict(), "optimizer": optimizer.state_dict(),
             "epoch": epoch, "step": step},
            resume_path,
        )

    metric = cfg.davis_interactive.metric
    # the resize target follows the data: the registry's most common size
    sizes = [info.image_size for info in registry.sequences.values()]
    size_wh = max(set(sizes), key=sizes.count) if sizes else (854, 480)
    loss_meter = AverageMeter()
    for epoch in range(start_epoch, num_epochs + 1):
        lr = a.lr * (a.gamma ** (epoch - 1))  # ExponentialLR
        transform = QAAugmentPipeline(size_wh=size_wh, seed=cfg.seed + epoch)
        dataset = QARegressionDataset(
            registry, save_result_dir, transform=transform, seed=cfg.seed + epoch
        )
        epoch_loss = AverageMeter()
        skip = start_step if epoch == start_epoch else 0
        for i, batch in enumerate(dataset.batches(a.train_batch_size, skip=skip), start=skip):
            loss, diff, n_valid = assess_train_step(
                net, optimizer, to_device(batch, device), lr, metric
            )
            if resume_path and (i + 1) % save_every == 0:
                snapshot(epoch, i + 1)
            if float(n_valid) == 0:
                continue
            loss_meter.update(float(loss))
            epoch_loss.update(float(loss))
            log.info(
                f"Epoch [{epoch}/{num_epochs}][{i}] loss:{float(loss):.4f} "
                f"diff:{float(diff):.4f} lr:{lr:.2e}"
            )
        log.info(f"* Epoch {epoch}: loss {epoch_loss.avg:.6f}")
        if resume_path and epoch < num_epochs:
            snapshot(epoch + 1, 0)  # the next restart begins the next epoch
        if epoch % 10 == 0 or epoch == num_epochs:
            save_assess_checkpoint(net, cfg.ckpt_dir)
    if resume_path and os.path.exists(resume_path):
        os.remove(resume_path)
    return {"loss_avg": loss_meter.avg, "net": net}


def main(argv=None):
    import sys

    argv = argv if argv is not None else sys.argv[1:]
    cfg = load_config("configs/config.yaml", [a for a in argv if "=" in a])
    return run(cfg, device="cpu" if "--cpu" in argv else None)


if __name__ == "__main__":
    main()
