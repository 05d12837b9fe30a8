"""VOS backbone trainer (TAPNet, MatchNet, IPNet), in torch.

Counterpart of ``ivosw_tpu/train/train_vos.py``. A training sample is a
K-frame window with the annotated frame at index 0 (drawn forward or
reversed with equal probability). One step runs the family's window loss
on the trainer's device: the interaction pass on the scribbled frame (and,
on round-2 windows, on frame K−1 as a second annotated frame), then a
propagation loop over frames 1..K−1 carrying the net's own predictions (no
teacher forcing), the per-frame loss against the object masks, one
backward pass through the whole loop, and an Adam step with optax's
defaults.

Windows are built on the host (:func:`sample_windows`) by the same robot
the evaluation session uses, from one ``np.random.Generator`` in the JAX
package's draw order, so the same seed gives the same windows; the trainer
uploads each window's arrays. The families' losses call the nets'
submodules directly (the adapters run under ``torch.no_grad``); the JAX
package's ``lax.scan`` over frames is a Python loop whose carry keeps the
graph.

The final weights are ``{ckpt_dir}/{family}.pt``, the state dict the
family's adapter loads (``TAPNetAdapter.create(ckpt_dir=…)`` and the
others). With ``resume_path`` a ``{params, opt_state, step}`` snapshot is
written there every ``save_every`` steps and removed on completion.

CLI (from a directory holding ``configs/``; writes ``ckpt_dir`` under it):
``python -m ivosw_tpu_torch.train.train_vos vos=tapnet|matchnet|ipnet [key=value ...] [--cpu]``
"""

from __future__ import annotations

import os
import time
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch
import torch.nn.functional as F
from scipy import ndimage

from ivosw_tpu_torch.core.config import Config, load_config
from ivosw_tpu_torch.device import resolve_device
from ivosw_tpu_torch.utils.misc import AverageMeter, create_stream_logger, set_random_seed

_SQUARE = np.ones((3, 3), dtype=bool)


def bce_with_logits(logit, target):
    """Element-wise binary cross-entropy of logits, by ``log_sigmoid`` of
    both signs."""
    return -(target * F.logsigmoid(logit) + (1.0 - target) * F.logsigmoid(-logit))


def bce_probs(prob, target, eps: float = 1e-6):
    """Binary cross-entropy of probabilities clipped to [eps, 1 − eps] (the
    losses after a blend, which mixes probabilities)."""
    prob = torch.clamp(prob, eps, 1.0 - eps)
    return -(target * torch.log(prob) + (1.0 - target) * torch.log1p(-prob))


# ------------------------------------------------------------- windows --
def _degrade_masks(gt_onehot: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Plausible previous-round probability maps from ground truth
    [O, K, H, W]: per object a total miss (10 %), else a random shift, 0–2
    iterations of a 3×3 binary erosion or dilation, and a confidence in
    [0.55, 0.95). Draws per object: miss, shift, iterations, operation,
    confidence. The border changes nothing (erosion treats outside pixels
    as set, dilation as clear), as cv2's default border does."""
    o, k, h, w = gt_onehot.shape
    prev = np.zeros_like(gt_onehot, dtype=np.float32)
    max_shift = max(2, h // 16)
    for i in range(o):
        if rng.random() < 0.1:
            continue
        dy, dx = rng.integers(-max_shift, max_shift + 1, size=2)
        m = np.roll(gt_onehot[i], (int(dy), int(dx)), axis=(1, 2))
        iters = int(rng.integers(0, 3))
        if iters:
            if rng.random() < 0.5:
                op = lambda f: ndimage.binary_erosion(f, _SQUARE, iters, border_value=1)
            else:
                op = lambda f: ndimage.binary_dilation(f, _SQUARE, iters, border_value=0)
            m = np.stack([op(f > 0) for f in m]).astype(np.float32)
        conf = 0.55 + 0.4 * rng.random()
        prev[i] = m * conf
    return prev


def _prev_labels(prev_round: np.ndarray) -> np.ndarray:
    """[O, K, H, W] prob maps → [K, H, W] labels (argmax + 1, 0 where every
    object is below 0.5)."""
    best = prev_round.max(axis=0)
    label = prev_round.argmax(axis=0).astype(np.int32) + 1
    return np.where(best >= 0.5, label, 0).astype(np.int32)


def sample_windows(
    registry,
    sequences,
    rng: np.random.Generator,
    window: int,
    robot,
    scribble_dilation: int = 3,
    round2_prob: float = 0.5,
) -> Iterator[Dict[str, np.ndarray]]:
    """Endless stream of training windows on the host: a dict of numpy
    arrays holding what every family reads (interaction channels for
    TAPNet, per-object positive and negative scribbles for IPNet, the
    scribble planes for MatchNet).

    With probability ``round2_prob`` a window is a round-2 episode: a
    degraded previous-round prediction drives the robot's corrective
    scribbles on frames 0 and K−1, the interaction channels are
    [previous probability, positive, negative] (else [0.5, positive, 0]),
    frame K−1 is a second annotated frame, and the blend ramps toward it
    (``alpha`` for TAPNet, ``fuse_w`` for IPNet) are active."""
    from ivosw_tpu_torch.data.scribbles import scribble_masks_per_object
    from ivosw_tpu_torch.models.vos.ipnet import get_weight
    from ivosw_tpu_torch.models.vos.tapnet import compute_alpha

    fruitless = 0
    while True:
        if fruitless > 100 * max(len(sequences), 1):
            raise ValueError(
                f"no training window drawn after {fruitless} attempts — "
                f"are all clips shorter than window={window} or object-free?"
            )
        seq = sequences[int(rng.integers(len(sequences)))]
        frames = registry.load_images(seq)
        gt = registry.load_annotations(seq)
        t = frames.shape[0]
        if t < window:
            fruitless += 1
            continue
        start = int(rng.integers(0, t - window + 1))
        img = frames[start : start + window]
        g = gt[start : start + window]
        if rng.random() < 0.5:  # reversed windows train backward propagation
            img = img[::-1].copy()
            g = g[::-1].copy()
        n_obj = int(g.max())
        if n_obj == 0:
            fruitless += 1
            continue
        h, w = g.shape[1:]
        gt_onehot = np.zeros((n_obj, window, h, w), dtype=np.float32)
        for obj in range(1, n_obj + 1):
            gt_onehot[obj - 1] = (g == obj).astype(np.float32)

        round2 = rng.random() < round2_prob
        if round2:
            prev_round = _degrade_masks(gt_onehot, rng)
            prev_lab = _prev_labels(prev_round)
            alpha = compute_alpha(window, np.array([window - 1]), 0)
            fuse_w = get_weight(window, np.array([window - 1]), 0)
        else:
            prev_round = np.full_like(gt_onehot, 0.5)
            prev_lab = np.zeros_like(g)
            alpha = np.ones(window, dtype=np.float32)
            fuse_w = np.ones(window, dtype=np.float32)

        scrib = robot.interact(seq, prev_lab, g, n_obj, frame=0)
        maps = scribble_masks_per_object(scrib, (h, w), 0, n_obj, dilation=scribble_dilation)
        if round2:
            scrib2 = robot.interact(seq, prev_lab, g, n_obj, frame=window - 1)
            maps2 = scribble_masks_per_object(
                scrib2, (h, w), window - 1, n_obj, dilation=scribble_dilation
            )
        else:
            maps2 = np.zeros_like(maps)
        any_scrib = maps.sum(axis=0)
        any_scrib2 = maps2.sum(axis=0)
        interaction = np.zeros((n_obj, h, w, 3), dtype=np.float32)
        interaction2 = np.zeros((n_obj, h, w, 3), dtype=np.float32)
        pos = np.zeros((n_obj, h, w), dtype=np.float32)
        neg = np.zeros((n_obj, h, w), dtype=np.float32)
        for obj in range(1, n_obj + 1):
            pos[obj - 1] = maps[obj]
            neg[obj - 1] = np.clip(any_scrib - maps[obj], 0.0, 1.0)
            if round2:
                interaction[obj - 1] = np.stack(
                    [prev_round[obj - 1, 0], maps[obj], neg[obj - 1]], axis=-1
                )
                interaction2[obj - 1] = np.stack(
                    [prev_round[obj - 1, -1], maps2[obj],
                     np.clip(any_scrib2 - maps2[obj], 0.0, 1.0)],
                    axis=-1,
                )
            else:
                interaction[obj - 1] = np.stack(
                    [np.full((h, w), 0.5, np.float32), maps[obj], np.zeros((h, w), np.float32)],
                    axis=-1,
                )
        yield {
            "img": img.astype(np.float32),
            "gt": gt_onehot,
            "interaction": interaction,
            "interaction2": interaction2,
            "prev_round": prev_round,
            "alpha": alpha.astype(np.float32),
            "fuse_w": fuse_w.astype(np.float32),
            "mem2_valid": np.float32(1.0 if round2 else 0.0),
            "pos": pos,
            "neg": neg,
            "pos2": maps2[1:].astype(np.float32),
            "neg2": np.clip(any_scrib2[None] - maps2[1:], 0.0, 1.0).astype(np.float32),
            "scrib_maps": maps.astype(np.float32),
            "scrib_maps2": maps2.astype(np.float32),
        }


def upload_window(window: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A window's host arrays → tensors on ``device`` (``mem2_valid`` stays
    0-d)."""
    return {k: torch.as_tensor(np.asarray(v)).to(device) for k, v in window.items()}


# --------------------------------------------------------------- losses --
def _expand(x: torch.Tensor, o: int) -> torch.Tensor:
    """One frame's [C, h, w] features → [O, C, h, w] (a view)."""
    return x[None].expand((o,) + x.shape)


def tapnet_window_loss(net, batch) -> torch.Tensor:
    """One TAPNet episode: the A-Net on frame 0 (and on frame K−1 under
    ``mem2_valid``), the memory keys of both passes' r4, the T-Net over
    frames 1..K−1 carrying its α-blended probabilities, the blend applied
    before :func:`bce_probs`; the interaction losses plus the mean over
    steps.

    batch (tensors): img [K, H, W, 3], gt [O, K, H, W], interaction /
    interaction2 [O, H, W, 3], prev_round [O, K, H, W], alpha [K],
    mem2_valid []."""
    img = batch["img"].permute(0, 3, 1, 2)
    gt = batch["gt"]
    o, k = gt.shape[0], img.shape[0]
    hw = img.shape[-2:]
    mem2 = batch["mem2_valid"]
    alpha = batch["alpha"]
    prev_round = batch["prev_round"]

    anno_logit, anno_r4 = net.anet(_expand(img[0], o), batch["interaction"].permute(0, 3, 1, 2))
    loss = bce_with_logits(anno_logit, gt[:, 0]).mean()
    anno_prob = torch.sigmoid(anno_logit)
    anno2_logit, anno2_r4 = net.anet(_expand(img[-1], o),
                                     batch["interaction2"].permute(0, 3, 1, 2))
    loss = loss + mem2 * bce_with_logits(anno2_logit, gt[:, -1]).mean()

    r4s, r3s, r2s = net.frame_encoder(img)
    p = anno_r4.shape[2] * anno_r4.shape[3]
    mem_keys = torch.cat(
        [anno_r4.flatten(2).transpose(1, 2), anno2_r4.flatten(2).transpose(1, 2)], dim=1
    )
    mem_valid = torch.cat(
        [torch.ones((o, p), dtype=torch.float32, device=img.device), mem2.expand(o, p)], dim=1
    )
    carry, steps = anno_prob, []
    for t in range(1, k):
        logit = net.tnet(_expand(r4s[t], o), _expand(r3s[t], o), _expand(r2s[t], o), mem_keys,
                         mem_valid, carry, hw)
        carry = alpha[t] * torch.sigmoid(logit) + (1.0 - alpha[t]) * prev_round[:, t]
        steps.append(bce_probs(carry, gt[:, t]).mean())
    return loss + torch.stack(steps).mean()


def matchnet_window_loss(net, batch) -> torch.Tensor:
    """One MatchNet episode at the /4 matching scale: the interaction head
    on frame 0 (and on frame K−1, the prior round's anchor, under
    ``mem2_valid``), then the propagation head over frames 1..K−1 guided by
    ``[global map, local map, previous frame's map, previous round's map]``
    (in that order, rounded to bfloat16). Each frame's global map is the
    running max of its similarity to frame 0's members and, on round-2
    windows, to the anchor's (else −1).

    batch: img [K, H, W, 3], gt [O, K, H, W], scrib_maps / scrib_maps2
    [O+1, H, W], prev_round [O, K, H, W], mem2_valid []."""
    from ivosw_tpu_torch.models.vos.layers import resize_bilinear
    from ivosw_tpu_torch.models.vos.matchnet import object_sim_maps

    img = batch["img"].permute(0, 3, 1, 2)
    gt = batch["gt"]
    o, k = gt.shape[0], img.shape[0]
    hw = img.shape[-2:]
    mem2 = batch["mem2_valid"]
    prev_round = batch["prev_round"] * mem2  # round 1: zeros, as the adapter's first round

    r4s, r3s, r2s = net.emb_enc(img)
    hw4 = r2s.shape[-2:]

    def interact_at(idx, scrib, prev_full):
        pos = resize_bilinear(scrib[1:], hw4)
        neg = resize_bilinear(torch.clamp(scrib.sum(0, keepdim=True) - scrib[1:], 0.0, 1.0), hw4)
        guide4 = torch.stack([pos, neg, resize_bilinear(prev_full, hw4)], dim=1)
        return net.int_head(_expand(r4s[idx], o), _expand(r3s[idx], o), _expand(r2s[idx], o),
                            guide4.to(torch.bfloat16), hw)

    anno_logit = interact_at(0, batch["scrib_maps"], prev_round[:, 0])
    loss = bce_with_logits(anno_logit, gt[:, 0]).mean()
    anno_prob = torch.sigmoid(anno_logit)
    ref_probs4 = resize_bilinear(anno_prob, hw4)
    anno2_logit = interact_at(k - 1, batch["scrib_maps2"], prev_round[:, -1])
    loss = loss + mem2 * bce_with_logits(anno2_logit, gt[:, -1]).mean()
    if float(mem2) > 0:  # the prior round's anchor; round-1 windows floor at −1
        prior_probs4 = resize_bilinear(torch.sigmoid(anno2_logit), hw4)
        gm_prior = [object_sim_maps(r2s[t], r2s[-1], prior_probs4) for t in range(1, k)]
    else:
        gm_prior = [torch.full((o,) + tuple(hw4), -1.0, device=img.device)] * (k - 1)

    prev_prob, prev_emb, steps = anno_prob, r2s[0], []
    for t in range(1, k):
        r2c = r2s[t]
        gmap = torch.maximum(gm_prior[t - 1], object_sim_maps(r2c, r2s[0], ref_probs4))
        prev4 = resize_bilinear(prev_prob, hw4)
        lmap = object_sim_maps(r2c, prev_emb, prev4)
        guide4 = torch.stack([gmap, lmap, prev4, resize_bilinear(prev_round[:, t], hw4)], dim=1)
        logit = net.prop_head(_expand(r4s[t], o), _expand(r3s[t], o), _expand(r2c, o),
                              guide4.to(torch.bfloat16), hw)
        steps.append(bce_with_logits(logit, gt[:, t]).mean())
        prev_prob, prev_emb = torch.sigmoid(logit), r2c
    return loss + torch.stack(steps).mean()


def ipnet_window_loss(net, batch) -> torch.Tensor:
    """One IPNet episode: the interaction net on frame 0 (fed
    ``prev_round · mem2_valid``) and on frame K−1 under ``mem2_valid``, the
    reference vector of frame 0's r4 under its probabilities, then the
    propagation net over frames 1..K−1, each step fused with the previous
    round's map by ``fuse_w`` in float32 as the inference loop does, the
    loss on the fused probabilities.

    batch: img [K, H, W, 3], gt [O, K, H, W], pos / neg / pos2 / neg2
    [O, H, W], prev_round [O, K, H, W], fuse_w [K], mem2_valid []."""
    from ivosw_tpu_torch.models.vos.ipnet import ref_vector

    img = batch["img"].permute(0, 3, 1, 2)
    gt = batch["gt"]
    o, k = gt.shape[0], img.shape[0]
    hw = img.shape[-2:]
    mem2 = batch["mem2_valid"]
    prev_round = batch["prev_round"]
    fuse_w = batch["fuse_w"]

    anno_logit = net.interaction(_expand(img[0], o), batch["pos"], batch["neg"],
                                 prev_round[:, 0] * mem2)
    loss = bce_with_logits(anno_logit, gt[:, 0]).mean()
    anno_prob = torch.sigmoid(anno_logit)
    anno2_logit = net.interaction(_expand(img[-1], o), batch["pos2"], batch["neg2"],
                                  prev_round[:, -1] * mem2)
    loss = loss + mem2 * bce_with_logits(anno2_logit, gt[:, -1]).mean()

    r4s, r3s, r2s = net.frame_enc(img)
    ref_vec = ref_vector(r4s[0], anno_prob)
    carry, steps = anno_prob, []
    for t in range(1, k):
        logit = net.propagation(_expand(r4s[t], o), _expand(r3s[t], o), _expand(r2s[t], o),
                                ref_vec, carry, hw)
        carry = fuse_w[t] * torch.sigmoid(logit) + (1.0 - fuse_w[t]) * prev_round[:, t]
        steps.append(bce_probs(carry, gt[:, t]).mean())
    return loss + torch.stack(steps).mean()


# ---------------------------------------------------------------- steps --
def make_vos_optimizer(params, lr: float) -> torch.optim.Adam:
    """``optax.adam(lr)``: β 0.9 / 0.999, ε 1e-8 added outside the square
    root of the bias-corrected second moment."""
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)


def vos_train_step(net, optimizer, batch, loss_fn: Callable) -> torch.Tensor:
    """One window: the loss, its gradients, one optimizer step. Returns the
    loss (a detached tensor on the net's device)."""
    optimizer.zero_grad(set_to_none=True)
    loss = loss_fn(net, batch)
    loss.backward()
    optimizer.step()
    return loss.detach()


def vos_train_step_dp(replicas, optimizer, blocks, loss_fn: Callable) -> torch.Tensor:
    """One optimizer step over B windows split into ``blocks``, one per
    replica of the net (:func:`ivosw_tpu_torch.parallel.mesh.shard_batch`
    and ``replicate``; every entry of a block has a leading window axis).
    ``replicas[0]`` is the net that ``optimizer`` steps; the others first
    take its parameters and buffers. Each replica accumulates the gradients
    of its windows' losses / B, one window at a time, the gradients are
    summed onto ``replicas[0]``, and one optimizer step runs there: the
    gradients of the mean of the B losses, as the JAX package's vmapped
    step. Returns the mean loss on the first replica's device."""
    net = replicas[0]
    with torch.no_grad():
        for other in replicas[1:]:
            for dst, src in zip(other.state_dict().values(), net.state_dict().values()):
                dst.copy_(src)
    optimizer.zero_grad(set_to_none=True)
    for other in replicas[1:]:
        other.zero_grad(set_to_none=True)
    b = sum(block["img"].shape[0] for block in blocks)
    device = next(net.parameters()).device
    total = torch.zeros((), device=device)
    for replica, block in zip(replicas, blocks):
        for i in range(block["img"].shape[0]):
            loss = loss_fn(replica, {k: v[i] for k, v in block.items()}) / b
            loss.backward()
            total += loss.detach().to(device)
    with torch.no_grad():
        for other in replicas[1:]:
            for p0, p in zip(net.parameters(), other.parameters()):
                if p.grad is not None:
                    g = p.grad.to(device)
                    p0.grad = g if p0.grad is None else p0.grad.add_(g)
    optimizer.step()
    return total


# ------------------------------------------------------------------ run --
def _family(name: str):
    """``cfg.vos`` → (net class, seeded init, window loss, checkpoint name);
    ``fake`` trains TAPNet, as in the JAX package."""
    if name in ("tapnet", "fake"):
        from ivosw_tpu_torch.models.vos.tapnet import TAPNet, init_tapnet_params

        return TAPNet, init_tapnet_params, tapnet_window_loss, "tapnet"
    if name == "matchnet":
        from ivosw_tpu_torch.models.vos.matchnet import MatchNet, init_matchnet_params

        return MatchNet, init_matchnet_params, matchnet_window_loss, "matchnet"
    if name == "ipnet":
        from ivosw_tpu_torch.models.vos.ipnet import IPNet, init_ipnet_params

        return IPNet, init_ipnet_params, ipnet_window_loss, "ipnet"
    raise NotImplementedError(name)


def _host_state(net) -> Dict[str, torch.Tensor]:
    return {k: v.detach().cpu().clone() for k, v in net.state_dict().items()}


def _save(obj, path: str) -> None:
    """``torch.save`` through a temporary file, so a killed run never
    leaves a half-written checkpoint."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def run(
    cfg: Config,
    registry=None,
    num_steps: int = 2000,
    window: int = 4,
    lr: float = 1e-4,
    params: Optional[Dict[str, torch.Tensor]] = None,
    log=None,
    save_every: int = 500,
    round2_prob: float = 0.5,
    resume_path: Optional[str] = None,
    dp_windows: int = 0,
    device=None,
    timings: Optional[Dict[str, list]] = None,
    mesh=None,
):
    """Train the family of ``cfg.vos`` on ``device`` (None: CUDA, raises
    without one) from ``params`` (a state dict; None: its seeded init).

    ``dp_windows`` > 1 takes that many windows per step, split over the
    devices of ``mesh`` (1-D ('data',); default ``[device]``; ``device``
    defaults to its first), one :func:`vos_train_step_dp` each;
    ``dp_windows`` must be a multiple of the mesh's size. The final weights go to
    ``{ckpt_dir}/{family}.pt``; without ``resume_path`` the same file is
    also written every ``save_every`` steps. With ``resume_path`` a
    ``{params, opt_state, step}`` snapshot is written there every
    ``save_every`` steps instead, and a run that finds one resumes from it,
    the window stream fast-forwarded past the windows already consumed, so
    an interrupted and resumed run takes the same windows as an
    uninterrupted one; the snapshot is removed when the run completes.

    ``timings``, when given, collects per step the host's window building
    (``window_s``), the upload (``upload_s``) and the step up to the
    loss's read-back (``step_s``). Returns ``{"loss_avg", "losses",
    "params"}`` (``params``: the final state dict on the host)."""
    from ivosw_tpu_torch.data.registry import registry_from_config
    from ivosw_tpu_torch.interact.robot import ScribbleRobot

    use_dp = dp_windows and dp_windows > 1
    if use_dp:
        from ivosw_tpu_torch.parallel.mesh import make_mesh, replicate, shard_batch

        if mesh is None:
            mesh = make_mesh(devices=[resolve_device(device)])
        if dp_windows % mesh.shape["data"] != 0:
            raise ValueError(
                f"dp_windows={dp_windows} must be a multiple of the data-mesh "
                f"size {mesh.shape['data']}"
            )
        device = mesh.axis_devices("data")[0] if device is None else device
    device = resolve_device(device)
    log = log or create_stream_logger("train_vos")
    rng = set_random_seed(cfg.seed)
    registry = registry or registry_from_config(cfg)
    sequences = registry.subset(cfg.data.subset)
    robot = ScribbleRobot(seed=cfg.seed)

    net_cls, init_fn, loss_fn, ckpt_name = _family(cfg.vos)
    net = net_cls()
    net.load_state_dict(params if params is not None else init_fn(cfg.seed))
    net.to(device).train()
    optimizer = make_vos_optimizer(net.parameters(), lr)
    per_step = dp_windows if use_dp else 1
    if use_dp:
        replicas = replicate(mesh, net)
        if replicas[0] is not net:
            raise ValueError(f"the net is on {device}, the mesh's first device is "
                             f"{mesh.axis_devices('data')[0]}")

    stream = sample_windows(registry, sequences, rng, window, robot, round2_prob=round2_prob)
    start_step = 0
    if resume_path and os.path.exists(resume_path):
        snap = torch.load(resume_path, map_location="cpu", weights_only=True)
        start_step = int(snap["step"])
        net.load_state_dict(snap["params"])
        optimizer.load_state_dict(snap["opt_state"])
        for _ in range(start_step * per_step):
            next(stream)
        log.info(f"resumed from {resume_path} at step {start_step}")

    ckpt_path = os.path.join(cfg.ckpt_dir, f"{ckpt_name}.pt")
    loss_meter, losses = AverageMeter(), []
    for step in range(start_step + 1, num_steps + 1):
        t0 = time.perf_counter()
        windows = [next(stream) for _ in range(per_step)]
        t1 = time.perf_counter()
        if use_dp:
            blocks = shard_batch(mesh, {k: np.stack([w[k] for w in windows])
                                        for k in windows[0]})
        else:
            batch = upload_window(windows[0], device)
        if timings is not None and device.type == "cuda":
            torch.cuda.synchronize(device)
        t2 = time.perf_counter()
        if use_dp:
            losses.append(float(vos_train_step_dp(replicas, optimizer, blocks, loss_fn)))
        else:
            losses.append(float(vos_train_step(net, optimizer, batch, loss_fn)))
        if timings is not None:
            t3 = time.perf_counter()
            for key, s in (("window_s", t1 - t0), ("upload_s", t2 - t1), ("step_s", t3 - t2)):
                timings.setdefault(key, []).append(s)
        loss_meter.update(losses[-1])
        if step % 50 == 0 or step == 1:
            log.info(f"step {step}/{num_steps} loss {losses[-1]:.4f} ({loss_meter.avg:.4f})")
        if step % save_every == 0 and step < num_steps:
            if resume_path:
                _save({"params": _host_state(net), "opt_state": optimizer.state_dict(),
                       "step": step}, resume_path)
            else:
                _save(_host_state(net), ckpt_path)
    final = _host_state(net)
    _save(final, ckpt_path)
    if resume_path and os.path.exists(resume_path):
        os.remove(resume_path)
    return {"loss_avg": loss_meter.avg, "losses": losses, "params": final}


def main(argv=None):
    import sys

    argv = argv if argv is not None else sys.argv[1:]
    # run() knobs ride the same key=value surface but are not config fields
    run_keys = {"num_steps": int, "window": int, "lr": float, "save_every": int,
                "round2_prob": float, "dp_windows": int}
    run_kwargs, cfg_overrides = {}, []
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
