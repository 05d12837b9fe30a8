#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``ivosw_tpu_torch``) on one GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card, ``nvcc`` (``$CUDA_HOME/bin`` or ``PATH``) and the
repository's sources; it exits non-zero without printing a result when any
of them is missing or when any phase fails. Each phase prints one JSON line
with its own seconds:

0. device: ``torch.cuda.get_device_name`` and nvidia-smi's name/power limit;
1. build: every CUDA source of the port, one ``nvcc`` each, in parallel;
2. kernel: the fused-box ROI crop kernel against its plain torch version
   on seeded prob maps with empty, tiny, border-touching and out-of-range
   masks, O=3 objects (+ background plane, object offset 1), 480×854, 256²
   bf16 crops: box mismatches (must be 0), crop error (bf16 bound and
   float32 bound), kernel / plain / library / bound times, and the call's
   device time alone (``device_ms``, box pass, box reduction and crop pass
   apart in ``device_ms_by_kernel``) with ``bound_share`` (bound over device
   time). Once at the
   shape of one launch on the main path (T=32 frames, the scoring chunk;
   these numbers fill the kernel table) and once on the whole T=64 clip;
3. small: the wild/ours loop on a 48×64 clip (T=8, O=2, 3 rounds) on the
   card (crop kernel) and on the host (plain crop), AssessNet in float32:
   frame picks and J&F curves must be identical and predicted qualities
   agree to 1e-4 relative;
4. slice: the port's main path, ``evaluate`` with ``vos=fake``,
   ``setting=wild``, ``method=ours`` on one 480×854 demo clip with T=64,
   O=3, 4 rounds, seeded full-width ResNet-50 AssessNet (BN-folded) and
   Brain. The crop kernel's launch count is zeroed just before and read
   just after, and must equal rounds·ceil(T/32). One more QA round is
   timed and profiled (``qa_profile``: device activity only, over
   PROFILE_CALLS rounds, means per round; the crop kernels' traced
   launches beside the wrapper's count, and the phase fails if the
   wrapper launched but none of its kernels was traced);
5. kernel_roi_crop: the crop kernel with given boxes (AssessNet training)
   against its plain torch version at the training path's shape, B=32
   images of 480×854 with C=4 channels (frame + prob) and boxes from
   empty, tiny, border-touching and out-of-range masks, 256² float32 crops:
   crop error (float32 bound), kernel / plain / library / bound times,
   ``device_ms`` and ``bound_share``;
6. train_small: two ``assess_train_step``s of a float32 AssessNet on 48×64
   images, batch 4, lr 1e-2, on the card (crop kernel) and on the host
   (plain crop) from the same weights: losses and parameter updates agree
   to the stated relative bounds;
7. train: the training path, ``pretrain_assess.run`` on two 480×854 demo
   clips (16 frames, 3 objects), batch 32, seeded full-width ResNet-50
   AssessNet in bf16, 8 steps. The crop kernel's launch count is zeroed
   just before and read just after, and must be 8; losses finite. Step
   times, peak device memory and the host's batch-building time; one more
   step, its batch already on the card, is profiled (``train_profile``, as
   ``qa_profile``);
8. train_assess: ``generate_qa_data.run`` (FakeVOS) on one 480×854 clip
   (T=8, O=2, 2 rounds: 32 prob maps as PNGs) into a temporary directory,
   then one ``train_assess.run`` epoch at batch 32: one launch per batch,
   finite losses, ``assess_net.pt`` written;
9. kernel_bf16_inputs: the fused-box kernel as in 2 (T=32) with bf16
   frames and prob maps (``assess_net.bf16_inputs``): box mismatches 0,
   crop error under the bf16 bound;
10. kernel_roi_crop_pairs: the given-box pair kernel (the two-stage round's
   crop) against its plain version at one launch of that round, T=32, O=3
   (+ background plane, object offset 1), 480×854, 256² bf16 crops of bf16
   inputs, boxes from ``mask_to_yxhw`` of the seeded maps of 2 plus boxes
   out of range; and in float32; and the bf16 case with bf16 boxes (each
   edge rounded to bf16 in the kernel). Error, kernel / plain / library
   (``affine_grid`` + ``grid_sample``) / bound times, ``device_ms`` and
   ``bound_share``; the traced call must hold the pair kernel alone (the
   wrapper converts no box with torch launches);
11. kernel_roi_crop_pairs_premat: the matrix crop likewise (bf16 at the
   full shape, float32 at T=4), with bilinear matrices and with seeded
   random dense ones; library time ``torch.bmm`` of the two stages; the
   bf16 kernel's achieved TFLOP/s, its bound over its time
   (``bound_share``), the device time of its two stages and of the
   library's products and layout change (``torch.profiler``), and its time
   on the same crop with W zero-padded to 856, where every row is 16-byte
   aligned (``aligned_kernel_ms``);
12. tapnet_small, matchnet_small, ipnet_small: for each backbone one seeded
   net (``build_backbone``) and one 3-round episode (48×64, T=8, O=2, the
   same scribbles) on the card and on the host: probabilities within a
   stated bound, labels equal but within that bound of a decision, flipped
   pixels under a stated share;
13. tapnet_slice: the slice's main path, ``evaluate`` with ``vos=tapnet``,
   ``setting=wild``, ``method=ours``, ``assess_net.bf16_inputs=True`` on one
   480×854 demo clip (T=64, O=3, 3 rounds), seeded TAPNet, AssessNet
   (BN-folded) and Brain. The fused-box kernel's launch count is zeroed
   just before and read just after, and must equal rounds·ceil(T/32).
   ``seg_time_avg``, ``rec_time_avg``, QA ms per round, peak memory; one
   more TAPNet round split into encoder / A-Net / propagation, and one QA
   round profiled (``tapnet_qa_profile``: no host-to-device copy of prob
   maps may appear);
14. two_stage: on the last round's TAPNet ``all_P`` (bf16, on the card) and
   the bf16 frames, ``score_clip_folded`` with ``impl="einsum"`` (boxes,
   then the given-box pair kernel) and with ``impl="pallas"`` (fused box),
   chunk by chunk, then the Brain's pick: scores agree within the bf16
   bound, the pair kernel's launches (zeroed just before) equal
   ceil(T/32); both rounds timed;
15. agent_update: 20 Q-updates of the Brain at full width (H=128, batch 32,
   T=25 frames, the config's lr, weight decay and γ) on batches drawn from
   a pool of 64 seeded transitions, on the card and from the same params
   and batches on the host: losses and parameters within the CPU tests'
   bounds, the same host-RNG draws; median ms per update and a profile of
   one update (kernels per update, idle shares);
16. agent_pipeline: ``produce_reward`` → ``pretrain_agent`` →
   ``train_agent`` ``run`` on the card at the CPU tests' size (2 synthetic
   clips, 8 frames at 64×48, FakeVOS, 3 rounds, batch 4): the agent on the
   card, Q-updates ran, ``agent.pt`` reloads through
   ``eval_agent.load_weights`` to the same Q-values;
17. agent_wild: the wild-state Q-learning rollout (``run_interactive_phase``
   with ``phase=train``, ``setting=wild``, ``method=ours``) on 2 demo clips
   at 480×854 (48 frames, 3 objects, 25-frame windows, 5 rounds), seeded
   TAPNet and the BN-folded bf16 AssessNet with ``bf16_inputs``, the pool
   bootstrapped with 64 seeded transitions and a seeded reward table. The
   fused-box kernel's launch count is zeroed just before and read just
   after and must cover every round; at least 14 Q-updates (3·5 − 1 per
   episode) must run on the card. Per round seg and rec ms, each episode's
   update ms, peak memory;
18. matchnet_slice, ipnet_slice: the main path with the other two
   backbones, as tapnet_slice (``evaluate``, ``setting=wild``,
   ``method=ours``, ``assess_net.bf16_inputs=True``, one 480×854 demo clip,
   T=64, O=3, 3 rounds, seeded backbone from ``build_backbone``, AssessNet
   and Brain): the fused-box launches, zeroed just before and read just
   after, must equal rounds·ceil(T/32); ``seg_time_avg``,
   ``rec_time_avg``, peak memory, and one more round split into encoder /
   interaction / propagation (and MatchNet's similarity maps).
19. vos_train_small_tapnet, _matchnet, _ipnet: one ``vos_train_step`` of
   each backbone (``train/train_vos.py``) at 48×64 (K=3, O=2, a seeded
   round-2 window, lr 3e-4) on the card and on the host from the same
   seeded weights: the loss, each parameter's gradient (relative L2) and
   the parameters after the Adam step within the CPU tests' bounds against
   the JAX package;
20. vos_train_tapnet, _matchnet, _ipnet: ``train_vos.run`` of each
   backbone on the card at the HD demo tier (192×256, up to 3 objects,
   ``demo_training_registry(seed=1)``, 4 clips, window 5, lr 3e-4,
   ``round2_prob`` 0.5, 30 steps from the seeded init): median step ms
   (the step up to the loss's read-back), host window-building and upload
   ms, peak memory, the crop kernels' launches during the run (none: the
   trainer runs no kernel of the port), the loss on a round-2 window of a
   fifth, held-out clip before and after (it must fall), 3 steps profiled
   (kernels per step, compute and device idle shares); the written
   ``{family}.pt`` is loaded by the family's adapter (``build_backbone``)
   and segments one 192×256 round;
21. vos_train_dp: a TAPNet ``run`` with ``dp_windows=2`` for 3 steps.

Then it prints the kernel table (one JSON object; each kernel's launches
are those of its path's run: the TAPNet slice for the fused-box kernel
(the FakeVOS slice's, the agent rollout's and the MatchNet and IPNet
slices' under keys of their own), the
training run for the crop kernel, the two-stage round for the pair kernel;
the matrix crop is on no path; the fused-box, crop and pair kernels' rows
also carry ``device_ms`` and ``bound_share``), the card's name and power limit as
nvidia-smi gives them, and, last, the result line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import logging
import math
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
T_CLIP, O, H, W, S = 64, 3, 480, 854, 256  # the slice's clip
ROUNDS = 4
BLOB = 128  # distractor blob side of the demo clip at 480p
SEED = 0
# the small-clip check runs AssessNet in float32 on card and host: crops
# agree to 1e-5 and cuDNN / oneDNN float32 convolutions sum in different
# orders, so scores agree to this relative bound (the port's float32
# AssessNet is held to 1e-4 of the JAX package's in the tests)
QUALITY_RTOL = 1e-4
B_TRAIN = 32  # assess_net.train_batch_size
TRAIN_STEPS = 8
# train_small: card (cuDNN) and host (oneDNN) float32 steps sum the same
# convolutions in other orders; the bounds are those of the CPU test against
# the JAX package (tests/test_torch_train.py, where each is derived): step 1
# loss within 1e-3, each parameter's update (p_after - p_before) within 0.2
# of its norm (float32 gradients of the shallow layers through 53 train-mode
# BatchNorms are good to a few per cent), fc1's within 1e-4; step 2 loss
# within 2e-2, fc1's update within 1e-4, every update norm within 0.2
LOSS_RTOL, STEP2_LOSS_RTOL = 1e-3, 2e-2
UPDATE_RTOL, FC1_RTOL = 0.2, 1e-4
FP32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
BF16_FLOPS = 989e12  # H100 SXM dense bf16 on the tensor cores
# the two-stage and fused-box rounds score the same pairs through crops that
# round differently (2^-6 at most): scores agree within the bf16 scoring
# bound of the CPU tests (tests/test_torch_assess.py), 3e-2 of the scores'
# size (bf16 rounding errors are relative; a seeded net's scores are not of
# order one)
SCORE_ATOL = 3e-2
# tapnet_small, matchnet_small, ipnet_small: card (cuDNN bf16) and host
# (float32 sums of bf16 operands) convolutions round a few values the other
# way, and the flips compound through the encoder (tests/test_torch_tapnet.py,
# test_torch_matchnet.py and test_torch_ipnet.py hold the port against the
# JAX package on the host to the same bound): probabilities within
# VOS_PROB_ATOL; a label may differ only where the winning probability lies
# within VOS_PROB_ATOL of 0.5 or of the runner-up, and on at most
# VOS_LABEL_SHARE of the pixels. A seeded, untrained net leaves most pixels
# that near a decision (on the host: 82-95 % for TAPNet and IPNet); seeded
# MatchNet's heads barely tell the objects apart, leaving the two objects
# within VOS_PROB_ATOL of each other on 99.99-100 % of the pixels, where a
# flip is a coin toss: its bound is half of them
VOS_PROB_ATOL = 2.0**-5
VOS_LABEL_SHARE = {"tapnet": 0.05, "matchnet": 0.5, "ipnet": 0.05}
VOS_ROUNDS = 3
# the modules of one backbone round timed apart in the slice phases:
# (interaction, propagation) submodules of the net
VOS_SPLIT = {"matchnet": ("int_head", "prop_head"), "ipnet": ("interaction", "propagation")}
# torch.profiler's tracer (kineto) drops a few device records per window as
# out of its capture window (3-10 of ~2400 in a QA round, by its own log),
# mostly the window's first: once both crop launches of a one-round TAPNet
# window, and the first of three FakeVOS uploads. A profile therefore traces
# this many consecutive calls, reports means per call, and shows each crop
# kernel's traced launches beside the wrapper's count.
PROFILE_CALLS = 5
# the kernels of csrc/roi_crop_fusedbox.cu, csrc/roi_crop.cu and
# csrc/roi_crop_pairs.cu, by name in the profiler's device events
FUSEDBOX_KERNELS = ("fusedbox_box_kernel", "fusedbox_reduce_kernel", "fusedbox_crop_kernel")
ROI_CROP_KERNELS = ("roi_crop_kernel",)
PAIR_KERNELS = ("pair_crop_kernel",)
# agent training: the Q-update at the config's widths (Brain H=128,
# agent.train_batch_size, data.len_subseq), the wild rollout's episodes
AGENT_T = 25
AGENT_UPDATES = 20
AGENT_POOL = 64
AGENT_ROUNDS = 5
AGENT_CLIPS = 2
AGENT_FRAMES = 48
# card vs host Q-updates: the bounds of the CPU tests against the JAX package
# (tests/test_torch_agent_update.py): losses within 1e-5 relative, each
# parameter within 1e-3·lr·updates + 2 ulp of the host's
AGENT_LOSS_RTOL = 1e-5
# VOS training (train_vos): one step at 48×64 (K=3, O=2) on the card and on
# the host from the same seeded weights and window, held to the bounds of
# the CPU tests against the JAX package (tests/torch_train_vos_cases.py,
# where each is measured): the loss within VOS_STEP_LOSS_RTOL relative;
# every parameter's gradient within VOS_GRAD_RTOL relative L2 (bf16
# gradients are good to ~20 % in their worst tensor against float32 in
# either package); after the Adam step every element within 2·lr of the
# host's (a gradient whose sign differs moves it the other way) and at most
# VOS_STEP_FLIP_SHARE of them further apart than lr/100
VOS_STEP_LOSS_RTOL = 2e-3
VOS_GRAD_RTOL = 0.3
VOS_STEP_FLIP_SHARE = 0.1
# then the JAX package's largest VOS training configuration: the HD demo
# tier (192×256, 3 objects), window 5, lr 3e-4, round2_prob 0.5
# (scripts/demo_ordering.py), cut to VOS_TRAIN_CLIPS clips and
# VOS_TRAIN_STEPS steps from the seeded init for time (the demo trains 3500
# steps on 160 clips); VOS_PROFILE_STEPS steps profiled; a TAPNet run with
# 2 windows a step for VOS_DP_STEPS steps
VOS_TRAIN_CLIPS = 4
VOS_TRAIN_STEPS = 30
VOS_TRAIN_WINDOW = 5
VOS_TRAIN_LR = 3e-4
VOS_PROFILE_STEPS = 3
VOS_DP_STEPS = 3


def log_phase(name: str, tic: float, **fields) -> None:
    print(json.dumps({"phase": name, "seconds": time.perf_counter() - tic, **fields}), flush=True)


def card_bandwidth(name: str) -> float:
    """Device memory bytes/s from NVIDIA's data sheet (H100 SXM, HBM3)."""
    if "H100" in name and "HBM3" in name:
        return 3.35e12
    raise ValueError(f"no memory rate known for {name!r}: add its data-sheet value")


def cuda_ms(fn, iters: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def make_probs(torch, device, T):
    """[T, O+1, H, W] float32 prob maps with background plane 0: per pair a
    seeded case among empty, single pixel, tiny blob, border-touching box,
    full frame, large box, scattered noise."""
    g = torch.Generator(device=device).manual_seed(SEED)
    probs = torch.rand((T, O + 1, H, W), generator=g, device=device) * 0.5
    cpu = torch.Generator().manual_seed(SEED)
    rint = lambda lo, hi: int(torch.randint(lo, hi, (1,), generator=cpu))
    for t in range(T):
        for o in range(1, O + 1):
            plane = probs[t, o]
            case = (t * O + o) % 7
            if case == 1:
                plane[rint(0, H), rint(0, W)] = 0.9
            elif case == 2:
                y, x = rint(0, H - 5), rint(0, W - 5)
                plane[y : y + 5, x : x + 5] = 0.75
            elif case == 3:
                plane[: rint(1, H // 3), W - rint(1, W // 2) :] = 0.6
            elif case == 4:
                plane[:] = 0.99
            elif case == 5:
                y, x = rint(0, H // 2), rint(0, W // 2)
                plane[y : y + rint(50, H // 2), x : x + rint(50, W // 2)] = 0.8
            elif case == 6:
                plane.masked_fill_(torch.rand((H, W), generator=g, device=device) > 0.999, 0.7)
    probs[:, 0] = (1.0 - probs[:, 1:].sum(dim=1)).clamp(0.0, 1.0)
    return probs


def frame_bytes_needed(boxes, T):
    """Bytes of frame pixels the crops' non-zero taps touch (union per
    frame over its objects), read once: what this run's data needs."""
    from ivosw_tpu_torch.ops.roi import _interp_matrix

    rows = (_interp_matrix(boxes[:, 0], boxes[:, 1], H, S) > 0).any(dim=1).reshape(T, O, H)
    cols = (_interp_matrix(boxes[:, 2], boxes[:, 3], W, S) > 0).any(dim=1).reshape(T, O, W)
    pix = (rows[:, :, :, None] & cols[:, :, None, :]).any(dim=1)  # [T, H, W]
    return int(pix.sum()) * 3 * 4


def crop_bytes_needed(boxes, H, W, C):
    """Bytes of input pixels the crops' non-zero taps touch, per image,
    read once: what this run's boxes need."""
    from ivosw_tpu_torch.ops.roi import _interp_matrix

    rows = (_interp_matrix(boxes[:, 0], boxes[:, 1], H, S) > 0).any(dim=1).sum(dim=1)
    cols = (_interp_matrix(boxes[:, 2], boxes[:, 3], W, S) > 0).any(dim=1).sum(dim=1)
    return int((rows * cols).sum()) * C * 4


def affine_library_crop(torch, nchw, boxes):
    """One PyTorch call for the same crop: ``affine_grid`` +
    ``grid_sample(align_corners=True, zeros)`` on (ymin, ymax, xmin, xmax)
    boxes over an NCHW input → NCHW crops."""
    import torch.nn.functional as F

    n, c, h, w = nchw.shape
    ymin, ymax, xmin, xmax = boxes.unbind(dim=1)
    theta = torch.zeros((n, 2, 3), device=nchw.device)
    theta[:, 0, 0] = (xmax - xmin) / (w - 1)
    theta[:, 0, 2] = (xmin + xmax - (w - 1)) / (w - 1)
    theta[:, 1, 1] = (ymax - ymin) / (h - 1)
    theta[:, 1, 2] = (ymin + ymax - (h - 1)) / (h - 1)
    grid = F.affine_grid(theta, [n, c, S, S], align_corners=True)
    return F.grid_sample(nchw, grid, mode="bilinear", padding_mode="zeros",
                         align_corners=True)


def phase_kernel(torch, dev, kinfo, T, inputs=None):
    """The fused-box kernel at T frames; ``inputs`` bf16 casts the frames
    and prob maps first (assess_net.bf16_inputs)."""
    from ivosw_tpu_torch.kernels.roi_crop import (
        BF16_CROP_ATOL,
        F32_CROP_ATOL,
        roi_crop_pairs_fusedbox,
        roi_crop_pairs_fusedbox_reference,
    )
    from ivosw_tpu_torch.ops.roi import mask_to_yxhw, yxhw_to_minmax

    tic = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    frames = torch.rand((T, H, W, 3), generator=g, device=dev)
    probs = make_probs(torch, dev, T)
    inputs = inputs or torch.float32
    frames, probs = frames.to(inputs), probs.to(inputs)
    kw = dict(obj_offset=1, num_objects=O)

    errs = {}
    for dtype, atol in ((torch.bfloat16, BF16_CROP_ATOL), (torch.float32, F32_CROP_ATOL)):
        out, boxes = roi_crop_pairs_fusedbox(frames, probs, S, dtype, return_boxes=True, **kw)
        ref, ref_boxes = roi_crop_pairs_fusedbox_reference(
            frames, probs, S, dtype, return_boxes=True, **kw
        )
        torch.cuda.synchronize()
        mismatches = int((boxes != ref_boxes).any(dim=1).sum())
        err = float((out.float() - ref.float()).abs().max())
        if mismatches or not err <= atol:
            raise AssertionError(
                f"kernel vs plain ({dtype}): {mismatches} box mismatches, "
                f"max abs err {err} (bound {atol})"
            )
        errs[str(dtype)] = (mismatches, err, atol)
        del out, ref

    # library yardstick: mask_to_yxhw + affine grid + grid_sample on the
    # same boxes, from an NCHW [T·O, 4, H, W] input built outside the timing
    planes = probs[:, 1:]
    nchw = torch.cat(
        [frames.permute(0, 3, 1, 2)[:, None].expand(T, O, 3, H, W),
         planes[:, :, None]], dim=2,
    ).reshape(T * O, 4, H, W).float()

    def library():
        yxhw = mask_to_yxhw((planes > 0.5).reshape(T * O, H, W), 1.5)
        return affine_library_crop(torch, nchw, torch.stack(yxhw_to_minmax(yxhw), dim=1))

    lib_out = library().permute(0, 2, 3, 1)
    ref32 = roi_crop_pairs_fusedbox_reference(frames, probs, S, torch.float32, **kw)
    library_err = float((lib_out - ref32).abs().max())
    del lib_out, ref32

    before = roi_crop_pairs_fusedbox.launches
    kernel_ms = cuda_ms(lambda: roi_crop_pairs_fusedbox(frames, probs, S, torch.bfloat16, **kw), 20)
    plain_ms = cuda_ms(
        lambda: roi_crop_pairs_fusedbox_reference(frames, probs, S, torch.bfloat16, **kw), 3
    )
    library_ms = cuda_ms(library, 3)
    # device time alone, each of the call's kernels apart
    split = device_ms_by_kernel(
        torch, lambda: roi_crop_pairs_fusedbox(frames, probs, S, torch.bfloat16, **kw))
    device_ms = sum(v["ms"] for v in split.values())
    timing_launches = roi_crop_pairs_fusedbox.launches - before

    _, boxes = roi_crop_pairs_fusedbox(frames, probs, S, torch.bfloat16, return_boxes=True, **kw)
    bw = card_bandwidth(kinfo["name"])
    bytes_probs = T * O * H * W * probs.element_size()  # every pixel of each plane
    bytes_frames = frame_bytes_needed(boxes, T) // 4 * frames.element_size()
    bytes_out = T * O * S * S * 4 * 2 + T * O * 4 * 4
    flops = T * O * S * S * 4 * 2 * 4  # 4 taps × 4 channels, multiply + add
    bytes_total = bytes_probs + bytes_frames + bytes_out
    bound_ms = max(bytes_total / bw, flops / FP32_FLOPS) * 1e3
    log_phase(
        "kernel" if inputs == torch.float32 else "kernel_bf16_inputs", tic,
        shape={"T": T, "O": O, "H": H, "W": W, "S": S}, inputs=str(inputs),
        box_mismatches=errs["torch.bfloat16"][0],
        max_abs_err_bf16=errs["torch.bfloat16"][1], bound_bf16=errs["torch.bfloat16"][2],
        max_abs_err_f32=errs["torch.float32"][1], bound_f32=errs["torch.float32"][2],
        library_max_abs_err_vs_f32_plain=library_err,
        kernel_ms=kernel_ms, device_ms=device_ms, plain_ms=plain_ms, library_ms=library_ms,
        bound_ms=bound_ms, bound_share=bound_ms / device_ms, device_ms_by_kernel=split,
        bytes={"probs": bytes_probs, "frames": bytes_frames, "out": bytes_out},
        timing_launches=timing_launches,
    )
    return {
        "max_abs_err": errs["torch.bfloat16"][1], "ms": kernel_ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "library_ms": library_ms, "device_ms": device_ms,
        "bound_share": bound_ms / device_ms,
    }


def run_eval(torch, dev, registry, assess_net, agent, rounds, subset, cfg, adapter=None):
    """evaluate() with each round's frame pick and predicted qualities
    recorded (wrappers around the driver's recommend_frame and the policy
    layer's predict_clip_quality); FakeVOS unless an adapter is given."""
    from ivosw_tpu_torch.eval import eval_agent
    from ivosw_tpu_torch.interact import recommend
    from ivosw_tpu_torch.models.vos.fake import FakeVOS

    picks, qualities = [], []
    orig_rec, orig_pcq = eval_agent.recommend_frame, recommend.predict_clip_quality

    def rec(*args, **kwargs):
        picks.append(orig_rec(*args, **kwargs))
        return picks[-1]

    def pcq(*args, **kwargs):
        q, scores = orig_pcq(*args, **kwargs)
        qualities.append(q.copy())
        return q, scores

    log = logging.getLogger("chip_smoke.eval")
    log.handlers = [logging.NullHandler()]
    log.propagate = False
    eval_agent.recommend_frame, recommend.predict_clip_quality = rec, pcq
    try:
        with tempfile.TemporaryDirectory() as out:
            summary = eval_agent.evaluate(
                cfg, registry, adapter or FakeVOS(registry), agent=agent, assess_net=assess_net,
                subset=subset, max_nb_interactions=rounds, report_save_dir=out,
                device=dev, log=log,
            )
    finally:
        eval_agent.recommend_frame, recommend.predict_clip_quality = orig_rec, orig_pcq
    return summary, picks, qualities


def make_models(torch, dev, cfg, seed, dtype=None):
    from ivosw_tpu_torch.models.agent import Agent
    from ivosw_tpu_torch.models.assess import AssessNet, init_assess_net
    from ivosw_tpu_torch.models.fold import fold_assess_variables

    net = init_assess_net(seed)
    folded = AssessNet(fold=True, dtype=dtype or torch.bfloat16)
    folded.load_state_dict(fold_assess_variables(net.state_dict()))
    return folded.to(dev).eval(), Agent(cfg, seed=seed, device=dev)


def phase_small(torch, dev):
    """Card vs host on a small clip: identical picks and curves."""
    import numpy as np

    from ivosw_tpu_torch.core.config import Config
    from ivosw_tpu_torch.data.registry import SequenceRegistry

    tic = time.perf_counter()
    registry = SequenceRegistry.synthetic(["s0"], num_frames=8, image_size=(64, 48),
                                          num_objects=2, seed=SEED)
    registry.sequences["s0"].num_scribbles = 1
    results = {}
    for device in (dev, torch.device("cpu")):
        cfg = Config(phase="eval", setting="wild", method="ours", vos="fake", seed=SEED)
        assess_net, agent = make_models(torch, device, cfg, SEED, torch.float32)
        summary, picks, qualities = run_eval(
            torch, device, registry, assess_net, agent, 3, "val", cfg
        )
        results[device.type] = (summary, qualities, picks)
    (s_gpu, q_gpu, p_gpu), (s_cpu, q_cpu, p_cpu) = results["cuda"], results["cpu"]
    q_gpu, q_cpu = np.asarray(q_gpu), np.asarray(q_cpu)
    q_err = float(np.max(np.abs(q_gpu - q_cpu)))
    bound = QUALITY_RTOL * max(1.0, float(np.max(np.abs(q_cpu))))
    if p_gpu != p_cpu or s_gpu["curve"] != s_cpu["curve"] or not q_err <= bound:
        raise AssertionError(
            f"card vs host: picks {p_gpu} vs {p_cpu}, curves {s_gpu['curve']} vs "
            f"{s_cpu['curve']}, quality max abs diff {q_err} (bound {bound})"
        )
    log_phase("small", tic, picks=p_gpu, curve=s_gpu["curve"]["J_AND_F"],
              quality_max_abs_diff=q_err, bound=bound)


def phase_slice(torch, dev, kinfo):
    import numpy as np

    from ivosw_tpu_torch.core.config import Config
    from ivosw_tpu_torch.data.demo import DemoSpec, demo_training_registry
    from ivosw_tpu_torch.interact.recommend import FRAME_CHUNK, predict_clip_quality
    from ivosw_tpu_torch.kernels.roi_crop import roi_crop_pairs_fusedbox
    from ivosw_tpu_torch.models.vos.fake import FakeVOS

    tic = time.perf_counter()
    spec = DemoSpec(h=H, w=W, num_frames=T_CLIP, num_objects=O, blob=BLOB)
    registry = demo_training_registry(n_clips=1, seed=SEED, spec=spec)
    cfg = Config(phase="eval", setting="wild", method="ours", vos="fake",
                 dataset="demo", seed=SEED)
    assess_net, agent = make_models(torch, dev, cfg, SEED)
    setup_s = time.perf_counter() - tic

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    roi_crop_pairs_fusedbox.launches = 0
    summary, _, qualities = run_eval(torch, dev, registry, assess_net, agent, ROUNDS,
                                     "train", cfg)
    launches = roi_crop_pairs_fusedbox.launches
    peak_bytes = torch.cuda.max_memory_allocated(dev)

    rounds = len(summary["report"])
    expected = rounds * math.ceil(T_CLIP / FRAME_CHUNK)
    curve = summary["curve"]["J_AND_F"]
    q = np.asarray(qualities)
    if launches != expected or launches == 0:
        raise AssertionError(f"crop kernel launched {launches}x, expected {expected}")
    if q.shape != (rounds, T_CLIP) or not np.isfinite(q).all():
        raise AssertionError(f"predicted qualities {q.shape} not finite [rounds, T_CLIP]")
    if len(curve) != rounds or not all(0.0 <= v <= 1.0 for v in curve):
        raise AssertionError(f"J&F curve {curve} malformed for {rounds} rounds")

    # QA time of one round (crop kernel + AssessNet + host copy of scores)
    name = registry.subset("train")[0]
    adapter = FakeVOS(registry)
    state = adapter.begin_sequence(registry.load_images(name), O, sequence=name)
    _, all_p, _ = adapter.segment(state, {"scribbles": [[]] * T_CLIP}, 0, 1)
    frames = torch.as_tensor(registry.load_images(name), device=dev)
    qa_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        predict_clip_quality(assess_net, frames, all_p, O)
        torch.cuda.synchronize()
        qa_ms.append((time.perf_counter() - t0) * 1e3)
    profile = profile_device(
        torch, lambda: predict_clip_quality(assess_net, frames, all_p, O), float(np.median(qa_ms)),
        launched=[(roi_crop_pairs_fusedbox, FUSEDBOX_KERNELS)],
    )

    log_phase(
        "slice", tic, setup_seconds=setup_s, rounds=rounds, launches=launches,
        expected_launches=expected, curve=curve, auc=summary["auc"],
        rec_time_avg_s=summary["timing"]["rec_time_avg"],
        seg_time_avg_s=summary["timing"]["seg_time_avg"],
        qa_ms_per_round=qa_ms, peak_memory_bytes=peak_bytes,
        card=kinfo["name"], power_limit=kinfo["power_limit"],
    )
    print(json.dumps({"phase": "qa_profile", **profile}), flush=True)
    return launches


def profile_device(torch, fn, wall_ms: float, launched=(), top: int = 10,
                   calls: int = PROFILE_CALLS):
    """torch.profiler over ``calls`` consecutive calls of ``fn`` (QA
    rounds, train steps; after a profiled warm-up that pays the tracer's
    start-up), device activity only, means per call: the device time of
    each kernel and copy, the copies' (memcpy / memset) sum apart from the
    compute kernels' sum, and the share of the calls' own wall time in
    which no compute kernel ran, and in which neither a kernel nor a copy
    ran. ``wall_ms`` (an unprofiled call's time) is reported beside it: the
    pageable upload's rate varies from call to call. One stream runs the
    calls, so device activities do not overlap. ``launched``: (wrapper,
    kernel names) pairs, the port's crop kernels launched through ctypes;
    for each, its launches and the traced launches of each kernel are
    reported, and the phase raises when the wrapper launched but none of
    its kernels was traced."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        counts = [wrapper.launches for wrapper, _ in launched]
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            profiled_ms = (time.perf_counter() - t0) * 1e3 / calls
    device = [
        e for e in prof.key_averages()
        if e.device_time_total > 0 and not e.key.startswith("Activity Buffer")
    ]
    device.sort(key=lambda e: e.device_time_total, reverse=True)
    ms = lambda e: e.device_time_total / 1e3 / calls
    crop = {}
    for (wrapper, names), count in zip(launched, counts):
        n = wrapper.launches - count
        traced = [e for e in device if any(k in e.key for k in names)]
        if n and not traced:
            raise AssertionError(
                f"{wrapper.__name__} launched {n}x in the profiled calls, but no kernel "
                f"{names} was traced among {sum(e.count for e in device)} device events")
        crop[wrapper.__name__] = {
            "launches": n, "ms": sum(ms(e) for e in traced),
            "traced": {k: sum(e.count for e in traced if k in e.key) for k in names},
        }
    is_copy = lambda e: e.key.startswith(("Memcpy", "Memset"))
    copy_ms = sum(ms(e) for e in device if is_copy(e))
    compute_ms = sum(ms(e) for e in device if not is_copy(e))
    return {
        "wall_ms": wall_ms,
        "profiled_calls": calls,
        "profiled_wall_ms": profiled_ms,
        "compute_ms": compute_ms,
        "copy_ms": copy_ms,
        "compute_idle_share": 1.0 - compute_ms / profiled_ms,
        "kernels_per_call": sum(e.count for e in device if not is_copy(e)) / calls,
        "device_idle_share": 1.0 - (compute_ms + copy_ms) / profiled_ms,
        "crop_kernels": crop,
        "top": [
            {"name": e.key[:90], "calls": e.count, "device_ms": ms(e)} for e in device[:top]
        ],
        "copies": [
            {"name": e.key[:90], "calls": e.count, "device_ms": ms(e)}
            for e in device if is_copy(e)
        ],
    }


def phase_kernel_roi_crop(torch, dev, kinfo):
    """The crop kernel with given boxes at the training path's shape."""
    from ivosw_tpu_torch.kernels.roi_crop import F32_CROP_ATOL, roi_crop, roi_crop_reference
    from ivosw_tpu_torch.ops.roi import mask_to_yxhw, yxhw_to_minmax

    tic = time.perf_counter()
    C = 4
    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    planes = make_probs(torch, dev, B_TRAIN)[:, 1].contiguous()  # cycles the 7 mask cases
    images = torch.cat([torch.rand((B_TRAIN, H, W, 3), generator=g, device=dev),
                        planes[..., None]], dim=-1).contiguous()
    yxhw = mask_to_yxhw(planes > 0.5, 1.5)
    out = roi_crop(images, yxhw, S)
    ref = roi_crop_reference(images, yxhw, S)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    if not err <= F32_CROP_ATOL:
        raise AssertionError(f"roi_crop vs plain: max abs err {err} (bound {F32_CROP_ATOL})")
    del out, ref

    boxes = torch.stack(yxhw_to_minmax(yxhw), dim=1)
    nchw = images.permute(0, 3, 1, 2).contiguous()
    library_err = float((affine_library_crop(torch, nchw, boxes).permute(0, 2, 3, 1)
                         - roi_crop_reference(images, yxhw, S)).abs().max())
    before = roi_crop.launches
    kernel_ms = cuda_ms(lambda: roi_crop(images, yxhw, S), 20)
    plain_ms = cuda_ms(lambda: roi_crop_reference(images, yxhw, S), 3)
    library_ms = cuda_ms(lambda: affine_library_crop(torch, nchw, boxes), 5)
    split = device_ms_by_kernel(torch, lambda: roi_crop(images, yxhw, S))
    device_ms = sum(v["ms"] for v in split.values())
    timing_launches = roi_crop.launches - before

    bytes_in = crop_bytes_needed(boxes, H, W, C)
    bytes_out = B_TRAIN * S * S * C * 4 + B_TRAIN * 4 * 4
    flops = B_TRAIN * S * S * C * 4 * 2  # 4 taps per channel, multiply + add
    bound_ms = max((bytes_in + bytes_out) / card_bandwidth(kinfo["name"]),
                   flops / FP32_FLOPS) * 1e3
    log_phase(
        "kernel_roi_crop", tic, shape={"B": B_TRAIN, "H": H, "W": W, "C": C, "S": S},
        max_abs_err_f32=err, bound_f32=F32_CROP_ATOL,
        library_max_abs_err_vs_plain=library_err,
        kernel_ms=kernel_ms, device_ms=device_ms, plain_ms=plain_ms, library_ms=library_ms,
        bound_ms=bound_ms, bound_share=bound_ms / device_ms, device_ms_by_kernel=split,
        bytes={"in": bytes_in, "out": bytes_out}, timing_launches=timing_launches,
    )
    return {"max_abs_err": err, "ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "library_ms": library_ms, "device_ms": device_ms,
            "bound_share": bound_ms / device_ms}


def train_batch(b, h, w, seed):
    """Seeded {img, prob, label} host batch: rectangles as labels, their
    shifted copies at confidence 0.82-0.99 over noise as prob maps; sample
    1 has no label and no prob above 0.8 (left out of the loss). A copy of
    ``tests/torch_port_cases.py::train_batch``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    img = rng.random((b, h, w, 3), dtype=np.float32)
    prob = (rng.random((b, h, w)) * 0.3).astype(np.float32)
    label = np.zeros((b, h, w), np.float32)
    for i in range(b):
        if i == 1:
            continue
        y0, x0 = rng.integers(0, h // 2), rng.integers(0, w // 2)
        hh, ww = rng.integers(h // 6, h // 2), rng.integers(w // 6, w // 2)
        label[i, y0:y0 + hh, x0:x0 + ww] = 1.0
        dy, dx = rng.integers(-3, 4, size=2)
        shifted = np.roll(label[i], (int(dy), int(dx)), axis=(0, 1))
        prob[i] = np.clip(shifted * rng.uniform(0.82, 0.99) + prob[i] * 0.5, 0.0, 1.0)
    return {"img": img, "prob": prob, "label": label}


def phase_train_small(torch, dev):
    """Two float32 train steps on the card and on the host, same weights."""
    from ivosw_tpu_torch.models.assess import init_assess_net
    from ivosw_tpu_torch.train.train_assess import (
        assess_train_step,
        make_assess_optimizer,
        to_device,
    )

    tic = time.perf_counter()
    batches = [train_batch(4, 48, 64, SEED + k) for k in range(2)]
    runs = {}
    for device in (dev, torch.device("cpu")):
        net = init_assess_net(SEED, dtype=torch.float32).to(device)
        opt = make_assess_optimizer(net.parameters(), 0.9, 5e-4)
        steps = []
        for b in batches:
            before = {k: v.detach().clone() for k, v in net.named_parameters()}
            loss = float(assess_train_step(net, opt, to_device(b, device), 1e-2)[0])
            updates = {k: (v.detach() - before[k]).cpu() for k, v in net.named_parameters()}
            steps.append((loss, updates))
        runs[device.type] = steps

    def rel(a, b):
        return float((a - b).norm() / b.norm().clamp_min(1e-30))

    report = {}
    for i, ((l_gpu, u_gpu), (l_cpu, u_cpu)) in enumerate(zip(runs["cuda"], runs["cpu"])):
        loss_rel = abs(l_gpu - l_cpu) / max(abs(l_cpu), 1e-12)
        fc1_rel = rel(u_gpu["fc1.weight"], u_cpu["fc1.weight"])
        if i == 0:  # element by element
            worst = max(rel(u_gpu[k], u_cpu[k]) for k in u_cpu)
        else:  # norms: the shallow gradients, clamped at ±1, no longer compare
            worst = max(abs(float(u_gpu[k].norm() / u_cpu[k].norm()) - 1.0) for k in u_cpu)
        bound = LOSS_RTOL if i == 0 else STEP2_LOSS_RTOL
        report[f"step{i + 1}"] = {"loss_card": l_gpu, "loss_host": l_cpu, "loss_rel_diff": loss_rel,
                                  "loss_bound": bound, "fc1_update_rel_diff": fc1_rel,
                                  "worst_update_rel_diff": worst}
        if not (loss_rel <= bound and fc1_rel <= FC1_RTOL and worst <= UPDATE_RTOL):
            raise AssertionError(f"card vs host train step {i + 1}: {report[f'step{i + 1}']} "
                                 f"(update bound {UPDATE_RTOL}, fc1 bound {FC1_RTOL})")
    log_phase("train_small", tic, update_bound=UPDATE_RTOL, fc1_bound=FC1_RTOL, **report)


def phase_train(torch, dev, kinfo):
    """The training path: pretrain_assess.run at batch 32, 480×854."""
    import numpy as np

    from ivosw_tpu_torch.core.config import Config
    from ivosw_tpu_torch.data.demo import DemoSpec, demo_training_registry
    from ivosw_tpu_torch.kernels.roi_crop import roi_crop
    from ivosw_tpu_torch.train import pretrain_assess

    tic = time.perf_counter()
    spec = DemoSpec(h=H, w=W, num_frames=16, hard_len=2, churn_len=2, num_objects=3,
                    blob=BLOB)
    registry = demo_training_registry(n_clips=2, seed=SEED, spec=spec)
    cfg = Config(dataset="demo", seed=SEED)
    setup_s = time.perf_counter() - tic

    # time each step, the host's batch building and the upload (wrappers
    # around the trainer's own functions; every step ends in a host read of
    # its loss)
    step_s, batch_s, upload_s = [], [], []
    orig_step, orig_batches = pretrain_assess.assess_train_step, pretrain_assess.sample_batches
    orig_upload = pretrain_assess.to_device

    def timed_upload(*args, **kwargs):
        t0 = time.perf_counter()
        out = orig_upload(*args, **kwargs)
        torch.cuda.synchronize()
        upload_s.append(time.perf_counter() - t0)
        return out

    def timed_step(*args, **kwargs):
        t0 = time.perf_counter()
        out = orig_step(*args, **kwargs)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        return out

    def timed_batches(*args, **kwargs):
        stream = orig_batches(*args, **kwargs)
        while True:
            t0 = time.perf_counter()
            batch = next(stream)
            batch_s.append(time.perf_counter() - t0)
            yield batch

    log = logging.getLogger("chip_smoke.train")
    log.handlers = [logging.NullHandler()]
    log.propagate = False
    with tempfile.TemporaryDirectory() as ckpt:
        cfg.ckpt_dir = ckpt
        pretrain_assess.assess_train_step = timed_step
        pretrain_assess.sample_batches = timed_batches
        pretrain_assess.to_device = timed_upload
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            run_tic = time.perf_counter()
            roi_crop.launches = 0
            result = pretrain_assess.run(cfg, registry=registry, num_steps=TRAIN_STEPS,
                                         batch_size=B_TRAIN, log=log, device=dev)
            launches = roi_crop.launches
            run_s = time.perf_counter() - run_tic
        finally:
            pretrain_assess.assess_train_step = orig_step
            pretrain_assess.sample_batches = orig_batches
            pretrain_assess.to_device = orig_upload
        peak_bytes = torch.cuda.max_memory_allocated(dev)
        saved = os.path.exists(os.path.join(ckpt, pretrain_assess.PRETEXT_CKPT))
    losses = result["losses"]
    # one more step, its batch already on the card, profiled (after the
    # launch count was read)
    from ivosw_tpu_torch.train.train_assess import make_assess_optimizer

    net = result["net"]
    opt = make_assess_optimizer(net.parameters(), cfg.assess_net.momentum,
                                cfg.assess_net.weight_decay)
    stream = orig_batches(registry, registry.subset("train"), np.random.default_rng(SEED),
                          B_TRAIN)
    device_batch = orig_upload(next(stream), dev)
    profile = profile_device(
        torch, lambda: orig_step(net, opt, device_batch, cfg.assess_net.lr),
        float(np.median(step_s[2:])) * 1e3, launched=[(roi_crop, ROI_CROP_KERNELS)],
    )
    if launches != TRAIN_STEPS:
        raise AssertionError(f"crop kernel launched {launches}x in {TRAIN_STEPS} steps")
    if len(losses) != TRAIN_STEPS or not np.isfinite(losses).all() or not saved:
        raise AssertionError(f"losses {losses}, checkpoint written: {saved}")
    steady = step_s[2:]
    log_phase(
        "train", tic, setup_seconds=setup_s, run_seconds=run_s, steps=TRAIN_STEPS,
        batch=B_TRAIN, launches=launches, losses=losses,
        step_ms=[x * 1e3 for x in step_s], median_step_ms_3_to_8=float(np.median(steady)) * 1e3,
        batch_build_ms=[x * 1e3 for x in batch_s],
        median_batch_build_ms_3_to_8=float(np.median(batch_s[2:])) * 1e3,
        upload_ms=[x * 1e3 for x in upload_s],
        median_upload_ms_3_to_8=float(np.median(upload_s[2:])) * 1e3,
        # the rest of the run: the net's seeded init and move, the checkpoint
        run_setup_and_save_seconds=run_s - sum(step_s) - sum(batch_s) - sum(upload_s),
        peak_memory_bytes=peak_bytes, card=kinfo["name"], power_limit=kinfo["power_limit"],
    )
    print(json.dumps({"phase": "train_profile", **profile}), flush=True)
    return launches


def phase_train_assess(torch, dev):
    """generate_qa_data → one train_assess epoch at 480×854, batch 32."""
    import numpy as np

    from ivosw_tpu_torch.core.config import Config
    from ivosw_tpu_torch.data.registry import SequenceRegistry
    from ivosw_tpu_torch.kernels.roi_crop import roi_crop
    from ivosw_tpu_torch.models.vos.fake import FakeVOS
    from ivosw_tpu_torch.train import generate_qa_data, train_assess

    tic = time.perf_counter()
    registry = SequenceRegistry.synthetic(["qa-0"], num_frames=8, image_size=(W, H),
                                          num_objects=2, split="train", seed=SEED)
    log = logging.getLogger("chip_smoke.train_assess")
    log.handlers = [logging.NullHandler()]
    log.propagate = False
    losses = []
    orig_step = train_assess.assess_train_step

    def recorded_step(*args, **kwargs):
        out = orig_step(*args, **kwargs)
        losses.append(float(out[0]))
        return out

    with tempfile.TemporaryDirectory() as work:
        cfg = generate_qa_data.configure(Config(dataset="demo", vos="fake"))
        cfg.davis_interactive.max_nb_interactions = 2
        stats = generate_qa_data.run(
            cfg, registry=registry, adapter=FakeVOS(registry, max_quality=0.8), samples=[("qa-0", 1)],
            save_result_dir=os.path.join(work, "qa"), log=log,
        )
        gen_s = time.perf_counter() - tic
        cfg = Config(dataset="demo", seed=SEED, ckpt_dir=os.path.join(work, "weights"))
        cfg.assess_net.train_batch_size = B_TRAIN
        train_assess.assess_train_step = recorded_step
        try:
            roi_crop.launches = 0
            train_assess.run(cfg, registry=registry, save_result_dir=os.path.join(work, "qa"),
                             num_epochs=1, log=log, device=dev)
            launches = roi_crop.launches
        finally:
            train_assess.assess_train_step = orig_step
        saved = os.path.exists(os.path.join(cfg.ckpt_dir, train_assess.ASSESS_CKPT))
    n_batches = stats["dumped_prob_maps"] // B_TRAIN
    if stats["dumped_prob_maps"] != 32 or launches != n_batches or len(losses) != n_batches:
        raise AssertionError(f"{stats['dumped_prob_maps']} prob maps, {launches} launches, "
                             f"{len(losses)} steps; expected 32 maps and {n_batches} of each")
    if not np.isfinite(losses).all() or not saved:
        raise AssertionError(f"losses {losses}, assess_net.pt written: {saved}")
    log_phase("train_assess", tic, generate_seconds=gen_s,
              dumped_prob_maps=stats["dumped_prob_maps"], batches=n_batches,
              launches=launches, losses=losses)


def pair_case(torch, dev, T, inputs):
    """Frames and [T, O+1, H, W] prob maps (make_probs) in ``inputs``, and
    yxhw boxes of their masks with the last three pairs' boxes moved far
    outside the image, across its bottom edge and around it."""
    from ivosw_tpu_torch.ops.roi import mask_to_yxhw

    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    frames = torch.rand((T, H, W, 3), generator=g, device=dev).to(inputs)
    probs = make_probs(torch, dev, T).to(inputs)
    yxhw = mask_to_yxhw((probs[:, 1:].float() > 0.5).reshape(T * O, H, W), 1.5)
    yxhw[-3:] = torch.tensor([[-40.0, -60.0, 20.0, 30.0], [H + 3.0, W / 2, 50.0, 25.0],
                              [H / 2, W / 2, 4.0 * H, 4.0 * W]], device=dev)
    return frames, probs, yxhw


def pair_bytes_needed(boxes, T, itemsize):
    """Bytes of frame pixels (union per frame) and of plane pixels (per
    pair) that the crops' non-zero taps touch, read once."""
    from ivosw_tpu_torch.ops.roi import _interp_matrix

    rows = (_interp_matrix(boxes[:, 0], boxes[:, 1], H, S) > 0).any(dim=1).reshape(T, O, H)
    cols = (_interp_matrix(boxes[:, 2], boxes[:, 3], W, S) > 0).any(dim=1).reshape(T, O, W)
    pix = rows[:, :, :, None] & cols[:, :, None, :]  # [T, O, H, W]
    return int(pix.any(dim=1).sum()) * 3 * itemsize + int(pix.sum()) * itemsize


def phase_kernel_roi_crop_pairs(torch, dev, kinfo, T):
    """The given-box pair kernel at one launch of the two-stage round."""
    from ivosw_tpu_torch.kernels.roi_crop import (
        F32_CROP_ATOL,
        PAIR_BF16_ATOL,
        roi_crop_pairs,
        roi_crop_pairs_reference,
    )
    from ivosw_tpu_torch.ops.roi import yxhw_to_minmax

    tic = time.perf_counter()
    kw = dict(obj_offset=1, num_objects=O)
    errs = {}
    for dtype, atol in ((torch.bfloat16, PAIR_BF16_ATOL), (torch.float32, F32_CROP_ATOL)):
        frames, probs, yxhw = pair_case(torch, dev, T, dtype)
        out = roi_crop_pairs(frames, probs, yxhw, S, dtype, **kw)
        ref = roi_crop_pairs_reference(frames, probs, yxhw, S, dtype, **kw)
        torch.cuda.synchronize()
        err = float((out.float() - ref.float()).abs().max())
        if not err <= atol:
            raise AssertionError(f"pair kernel vs plain ({dtype}): max abs err {err} (bound {atol})")
        errs[dtype] = (err, atol)
        del out, ref
    # bf16 boxes: the edges rounded to bf16 in the kernel, as in the plain version
    frames, probs, yxhw = pair_case(torch, dev, T, torch.bfloat16)
    yxhw = yxhw.to(torch.bfloat16)
    out = roi_crop_pairs(frames, probs, yxhw, S, torch.bfloat16, **kw)
    ref = roi_crop_pairs_reference(frames, probs, yxhw, S, torch.bfloat16, **kw)
    torch.cuda.synchronize()
    err = float((out.float() - ref.float()).abs().max())
    if not err <= PAIR_BF16_ATOL:
        raise AssertionError(f"pair kernel vs plain (bf16 boxes): max abs err {err} "
                             f"(bound {PAIR_BF16_ATOL})")
    errs["bf16_boxes"] = (err, PAIR_BF16_ATOL)
    del out, ref

    frames, probs, yxhw = pair_case(torch, dev, T, torch.bfloat16)
    boxes = torch.stack(yxhw_to_minmax(yxhw), dim=1)
    nchw = torch.cat([frames.permute(0, 3, 1, 2)[:, None].expand(T, O, 3, H, W),
                      probs[:, 1:, None]], dim=2).reshape(T * O, 4, H, W).float()
    before = roi_crop_pairs.launches
    kernel_ms = cuda_ms(lambda: roi_crop_pairs(frames, probs, yxhw, S, torch.bfloat16, **kw), 20)
    plain_ms = cuda_ms(
        lambda: roi_crop_pairs_reference(frames, probs, yxhw, S, torch.bfloat16, **kw), 3)
    library_ms = cuda_ms(lambda: affine_library_crop(torch, nchw, boxes), 3)
    # device time alone; the traced call must hold the pair kernel and no
    # other kernel (the wrapper makes no torch launch)
    split = device_ms_by_kernel(
        torch, lambda: roi_crop_pairs(frames, probs, yxhw, S, torch.bfloat16, **kw))
    if len(split) != 1 or PAIR_KERNELS[0] not in next(iter(split)):
        raise AssertionError(f"roi_crop_pairs traced {sorted(split)}, expected {PAIR_KERNELS} "
                             "alone")
    device_ms = sum(v["ms"] for v in split.values())
    timing_launches = roi_crop_pairs.launches - before

    bytes_in = pair_bytes_needed(boxes, T, 2)
    bytes_out = T * O * S * S * 4 * 2 + T * O * 4 * 4
    flops = T * O * S * S * 4 * 2 * 4  # 4 taps × 4 channels, multiply + add
    bound_ms = max((bytes_in + bytes_out) / card_bandwidth(kinfo["name"]),
                   flops / FP32_FLOPS) * 1e3
    log_phase(
        "kernel_roi_crop_pairs", tic, shape={"T": T, "O": O, "H": H, "W": W, "S": S},
        inputs="torch.bfloat16",
        max_abs_err_bf16=errs[torch.bfloat16][0], bound_bf16=errs[torch.bfloat16][1],
        max_abs_err_f32=errs[torch.float32][0], bound_f32=errs[torch.float32][1],
        max_abs_err_bf16_boxes=errs["bf16_boxes"][0],
        kernel_ms=kernel_ms, device_ms=device_ms, plain_ms=plain_ms, library_ms=library_ms,
        bound_ms=bound_ms, bound_share=bound_ms / device_ms, device_ms_by_kernel=split,
        bytes={"in": bytes_in, "out": bytes_out}, timing_launches=timing_launches,
    )
    return {"max_abs_err": errs[torch.bfloat16][0], "ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": library_ms,
            "device_ms": device_ms, "bound_share": bound_ms / device_ms}


def device_ms_by_kernel(torch, fn, calls: int = 5, tries: int = 3):
    """Mean device ms of each kernel ``fn`` launches and the launches the
    trace holds, over ``calls`` calls after one warm-up (``torch.profiler``,
    device activity only). The mean is over the launches traced (see
    PROFILE_CALLS). The tracer sometimes loses a short window's records
    altogether: an empty trace is taken again, up to ``tries`` windows,
    and raises after that."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(tries):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        split = {e.key[:90]: {"ms": e.device_time_total / 1e3 / e.count, "launches": e.count}
                 for e in prof.key_averages() if e.device_time_total > 0}
        if split:
            return split
    raise AssertionError(f"no device activity traced in {tries} windows of {calls} calls")


def bmm_library_crop(torch, x, ry, rx):
    """The matrix crop as two ``torch.bmm`` (cuBLAS) stages over the pairs:
    [P, S, H] @ [P, H, W·4], then [P, S, W] @ [P, W, S·4] → [P, S, S, 4];
    x is the per-pair [P, H, W, 4] input (frame channels and plane)."""
    p, s, h = ry.shape
    w = rx.shape[2]
    tmp = torch.bmm(ry, x.reshape(p, h, w * 4))  # [P, S, W·4]
    tmp = tmp.reshape(p, s, w, 4).permute(0, 2, 1, 3).reshape(p, w, s * 4)
    return torch.bmm(rx, tmp).reshape(p, s, s, 4)


def phase_kernel_roi_crop_pairs_premat(torch, dev, kinfo, T):
    """The matrix crop: bilinear matrices from the boxes and seeded random
    dense ones, bf16 at one launch's shape, float32 at T=4."""
    from ivosw_tpu_torch.kernels.roi_crop import (
        F32_CROP_ATOL,
        PAIR_BF16_ATOL,
        PREMAT_BF16_ATOL,
        PREMAT_F32_RTOL,
        interp_matrices,
        roi_crop_pairs_premat,
        roi_crop_pairs_premat_reference,
    )

    tic = time.perf_counter()
    kw = dict(obj_offset=1, num_objects=O)
    errs = {}
    for dtype, t in ((torch.bfloat16, T), (torch.float32, 4)):
        frames, probs, yxhw = pair_case(torch, dev, t, dtype)
        g = torch.Generator(device=dev).manual_seed(SEED + 4)
        bilinear = interp_matrices(yxhw, H, W, S, dtype)
        dense = (torch.rand((t * O, S, H), generator=g, device=dev).mul_(2.0 / H).to(dtype),
                 torch.rand((t * O, S, W), generator=g, device=dev).mul_(2.0 / W).to(dtype))
        for name, (ry, rx) in (("bilinear", bilinear), ("random", dense)):
            out = roi_crop_pairs_premat(frames, probs, dtype=dtype, ry=ry, rx=rx, **kw)
            ref = roi_crop_pairs_premat_reference(frames, probs, ry, rx, dtype, **kw)
            torch.cuda.synchronize()
            err = float((out.float() - ref.float()).abs().max())
            if dtype == torch.float32:
                atol = max(F32_CROP_ATOL, PREMAT_F32_RTOL * float(ref.float().abs().max()))
            else:
                atol = PAIR_BF16_ATOL if name == "bilinear" else PREMAT_BF16_ATOL
            if not err <= atol:
                raise AssertionError(f"premat kernel vs plain ({dtype}, {name}): "
                                     f"max abs err {err} (bound {atol})")
            errs[f"{name}_{str(dtype)[6:]}"] = {"max_abs_err": err, "bound": atol}
            del out, ref

    frames, probs, yxhw = pair_case(torch, dev, T, torch.bfloat16)
    ry, rx = interp_matrices(yxhw, H, W, S, torch.bfloat16)
    x = torch.cat([frames.repeat_interleave(O, dim=0), probs[:, 1:].reshape(T * O, H, W, 1)],
                  dim=-1)
    before = roi_crop_pairs_premat.launches
    kernel_ms = cuda_ms(
        lambda: roi_crop_pairs_premat(frames, probs, dtype=torch.bfloat16, ry=ry, rx=rx, **kw), 20)
    plain_ms = cuda_ms(
        lambda: roi_crop_pairs_premat_reference(frames, probs, ry, rx, torch.bfloat16, **kw), 3)
    library_ms = cuda_ms(lambda: bmm_library_crop(torch, x, ry, rx), 20)
    # the same crop with W padded by zeros to a multiple of 8: every operand's
    # rows 16-byte aligned, so every copy is a 16-byte one (1708-byte rows
    # take 4-byte copies)
    pw = -W % 8
    padded = (torch.nn.functional.pad(frames, (0, 0, 0, pw)),
              torch.nn.functional.pad(probs, (0, pw)), torch.nn.functional.pad(rx, (0, pw)))
    aligned_ms = cuda_ms(lambda: roi_crop_pairs_premat(
        padded[0], padded[1], dtype=torch.bfloat16, ry=ry, rx=padded[2], **kw), 20)
    split = {  # the kernel's two stages; the library's two products and layout change
        "kernel": device_ms_by_kernel(torch, lambda: roi_crop_pairs_premat(
            frames, probs, dtype=torch.bfloat16, ry=ry, rx=rx, **kw)),
        "library": device_ms_by_kernel(torch, lambda: bmm_library_crop(torch, x, ry, rx)),
    }
    timing_launches = roi_crop_pairs_premat.launches - before

    flops = 2 * T * O * (S * H * W + S * S * W) * 4
    bytes_total = (T * 3 + T * O) * H * W * 2 + T * O * (S * H + S * W + 4 * S * S) * 2
    bytes_ms = bytes_total / card_bandwidth(kinfo["name"]) * 1e3
    flops_ms = flops / BF16_FLOPS * 1e3
    bound_ms = max(bytes_ms, flops_ms)
    log_phase(
        "kernel_roi_crop_pairs_premat", tic, shape={"T": T, "O": O, "H": H, "W": W, "S": S},
        errors=errs, kernel_ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
        bound_ms=bound_ms, bytes=bytes_total, flops=flops, timing_launches=timing_launches,
        tflops=flops / kernel_ms / 1e9, library_tflops=flops / library_ms / 1e9,
        bound_share=bound_ms / kernel_ms, device_ms_by_kernel=split,
        aligned_kernel_ms={"W": W + pw, "ms": aligned_ms},
    )
    return {"max_abs_err": errs["bilinear_bfloat16"]["max_abs_err"], "ms": kernel_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "operations" if flops_ms >= bytes_ms else "bytes",
            "library_ms": library_ms}


def decision_margin(all_p):
    """[T, H, W] distance of each pixel's label from a flip: the winning
    object probability from 0.5, and from the runner-up."""
    fg = all_p[:, 1:].float().sort(dim=1).values
    margin = (fg[:, -1] - 0.5).abs()
    if fg.shape[1] > 1:
        margin = margin.minimum(fg[:, -1] - fg[:, -2])
    return margin


def phase_vos_small(torch, dev, vos):
    """One seeded backbone episode on the card and on the host, same
    scribbles (``vos``: tapnet, matchnet or ipnet, built by
    ``build_backbone``)."""
    import numpy as np

    from ivosw_tpu_torch.core.config import Config
    from ivosw_tpu_torch.data.registry import SequenceRegistry
    from ivosw_tpu_torch.data.scribbles import merge_scribbles
    from ivosw_tpu_torch.eval.backbones import build_backbone
    from ivosw_tpu_torch.interact.robot import ScribbleRobot

    tic = time.perf_counter()
    reg = SequenceRegistry.synthetic(["s"], num_frames=8, image_size=(64, 48), num_objects=2,
                                     seed=SEED)
    frames, gt = reg.load_images("s"), reg.load_annotations("s")
    with tempfile.TemporaryDirectory() as empty:  # no checkpoint: seeded weights
        cfg = Config(vos=vos, seed=SEED, ckpt_dir=empty)
        card, host = build_backbone(cfg, reg, dev), build_backbone(cfg, reg, "cpu")
    s_card, s_host = card.begin_sequence(frames, 2), host.begin_sequence(frames, 2)
    robot = ScribbleRobot(seed=SEED)
    masks, scribbles, report = np.zeros_like(gt), None, []
    for n, frame in enumerate((3, 7, 0)[:VOS_ROUNDS], start=1):
        new = robot.interact("s", masks, gt, 2, frame=frame)
        scribbles = new if scribbles is None else merge_scribbles(scribbles, new)
        labels_c, p_c, s_card = card.segment(s_card, scribbles, frame, n)
        labels_h, p_h, s_host = host.segment(s_host, scribbles, frame, n)
        torch.cuda.synchronize()
        p_c = p_c.float().cpu()
        prob_err = float((p_c - p_h.float()).abs().max())
        flipped = torch.from_numpy(labels_c != labels_h)
        margins = decision_margin(p_h)
        margin = float(margins[flipped].max()) if bool(flipped.any()) else 0.0
        share = float(flipped.float().mean())
        report.append({"round": n, "prob_max_abs_diff": prob_err, "labels_flipped": int(flipped.sum()),
                       "flipped_share": share, "flipped_max_margin": margin,
                       "near_decision_share": float((margins <= VOS_PROB_ATOL).float().mean())})
        if not (prob_err <= VOS_PROB_ATOL and margin <= VOS_PROB_ATOL
                and share <= VOS_LABEL_SHARE[vos]):
            raise AssertionError(f"{vos} card vs host, round {n}: {report[-1]} (bounds "
                                 f"{VOS_PROB_ATOL}, share {VOS_LABEL_SHARE[vos]})")
        masks = labels_h
    log_phase(f"{vos}_small", tic, rounds=report, prob_bound=VOS_PROB_ATOL,
              label_share_bound=VOS_LABEL_SHARE[vos])


def timed_calls(torch, module, store):
    """Wrap ``module.forward`` so each call's wall time, synchronised
    before and after, is appended to ``store`` (a split measurement: the
    synchronisations remove the host's run-ahead)."""
    forward = module.forward

    def timed(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = forward(*args, **kwargs)
        torch.cuda.synchronize()
        store.append(time.perf_counter() - t0)
        return out

    module.forward = timed
    return lambda: setattr(module, "forward", forward)


def run_backbone_slice(torch, dev, vos):
    """``evaluate`` with ``vos`` (seeded, from ``build_backbone``),
    ``setting=wild``, ``method=ours``, ``bf16_inputs`` on one 480×854 demo
    clip, the fused-box launches zeroed just before and read just after;
    raises unless they equal rounds·ceil(T/32) and the outputs are well
    formed. Returns what the slice phases report and reuse."""
    import numpy as np

    from ivosw_tpu_torch.core.config import Config
    from ivosw_tpu_torch.data.demo import DemoSpec, demo_training_registry
    from ivosw_tpu_torch.eval.backbones import build_backbone
    from ivosw_tpu_torch.interact.recommend import FRAME_CHUNK
    from ivosw_tpu_torch.kernels.roi_crop import roi_crop_pairs_fusedbox

    tic = time.perf_counter()
    spec = DemoSpec(h=H, w=W, num_frames=T_CLIP, num_objects=O, blob=BLOB)
    registry = demo_training_registry(n_clips=1, seed=SEED, spec=spec)
    with tempfile.TemporaryDirectory() as empty:  # no checkpoint: seeded weights
        cfg = Config(phase="eval", setting="wild", method="ours", vos=vos, dataset="demo",
                     seed=SEED, ckpt_dir=empty)
        cfg.assess_net.bf16_inputs = True
        adapter = build_backbone(cfg, registry, dev)
    assess_net, agent = make_models(torch, dev, cfg, SEED)
    last = {}
    segment = adapter.segment

    def keep_last(*args, **kwargs):
        out = segment(*args, **kwargs)
        last["all_p"] = out[1]
        return out

    adapter.segment = keep_last
    setup_s = time.perf_counter() - tic

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    roi_crop_pairs_fusedbox.launches = 0
    summary, picks, qualities = run_eval(torch, dev, registry, assess_net, agent, VOS_ROUNDS,
                                         "train", cfg, adapter=adapter)
    launches = roi_crop_pairs_fusedbox.launches
    peak_bytes = torch.cuda.max_memory_allocated(dev)
    adapter.segment = segment

    rounds = len(summary["report"])
    expected = rounds * math.ceil(T_CLIP / FRAME_CHUNK)
    curve = summary["curve"]["J_AND_F"]
    q = np.asarray(qualities)
    all_p = last["all_p"]
    if launches != expected or launches == 0:
        raise AssertionError(f"fused-box kernel launched {launches}x, expected {expected}")
    if q.shape != (rounds, T_CLIP) or not np.isfinite(q).all():
        raise AssertionError(f"predicted qualities {q.shape} not finite [rounds, T_CLIP]")
    if len(curve) != rounds or not all(0.0 <= v <= 1.0 for v in curve):
        raise AssertionError(f"J&F curve {curve} malformed for {rounds} rounds")
    if (all_p.dtype != torch.bfloat16 or all_p.device != dev
            or tuple(all_p.shape) != (T_CLIP, O + 1, H, W)
            or not bool(torch.isfinite(all_p.float()).all())):
        raise AssertionError(f"all_P {all_p.dtype} {all_p.device} {tuple(all_p.shape)}")
    return {
        "tic": tic, "registry": registry, "adapter": adapter, "assess_net": assess_net,
        "agent": agent, "all_p": all_p, "peak_memory_bytes": peak_bytes,
        "report": {"setup_seconds": setup_s, "rounds": rounds, "launches": launches,
                   "expected_launches": expected, "picks": picks, "curve": curve,
                   "auc": summary["auc"], "rec_time_avg_s": summary["timing"]["rec_time_avg"],
                   "seg_time_avg_s": summary["timing"]["seg_time_avg"]},
    }


def split_round(torch, adapter, registry, modules, functions=()):
    """One more round of ``adapter`` on the slice's clip, each call of the
    named submodules of ``adapter.net`` and of the named (module, function)
    pairs synchronised and timed apart → (encoder ms, {name: seconds per
    call}, segment ms)."""
    import numpy as np

    from ivosw_tpu_torch.interact.robot import ScribbleRobot

    name = registry.subset("train")[0]
    frames_host = registry.load_images(name)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = adapter.begin_sequence(frames_host, O)
    torch.cuda.synchronize()
    encode_ms = (time.perf_counter() - t0) * 1e3
    calls = {m: [] for m in list(modules) + [f for _, f in functions]}
    undo = [timed_calls(torch, getattr(adapter.net, m), calls[m]) for m in modules]
    for module, fn in functions:
        original = getattr(module, fn)

        def timed(*args, _original=original, _store=calls[fn], **kwargs):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out = _original(*args, **kwargs)
            torch.cuda.synchronize()
            _store.append(time.perf_counter() - t1)
            return out

        setattr(module, fn, timed)
        undo.append(lambda module=module, fn=fn, original=original:
                    setattr(module, fn, original))
    gt = registry.load_annotations(name)
    scribbles = ScribbleRobot(seed=SEED).interact(name, np.zeros_like(gt), gt, O, frame=0)
    try:
        t0 = time.perf_counter()
        adapter.segment(state, scribbles, 0, 1)
        torch.cuda.synchronize()
        segment_ms = (time.perf_counter() - t0) * 1e3
    finally:
        for u in undo:
            u()
    return encode_ms, calls, segment_ms


def phase_tapnet_slice(torch, dev, kinfo):
    """The slice's main path with TAPNet, bf16_inputs on."""
    import numpy as np

    from ivosw_tpu_torch.interact.recommend import predict_clip_quality
    from ivosw_tpu_torch.kernels.roi_crop import roi_crop_pairs_fusedbox

    run = run_backbone_slice(torch, dev, "tapnet")
    tic, registry, all_p = run["tic"], run["registry"], run["all_p"]
    assess_net, agent = run["assess_net"], run["agent"]

    # the segmentation split of one more round: encoder (begin_sequence),
    # A-Net and the T-Net steps, each call synchronised
    encode_ms, calls, segment_ms = split_round(torch, run["adapter"], registry, ("anet", "tnet"))
    anet_s, tnet_s = calls["anet"], calls["tnet"]
    split = {"encoder_ms": encode_ms, "anet_ms": sum(anet_s) * 1e3,
             "tnet_steps": len(tnet_s), "tnet_ms": sum(tnet_s) * 1e3,
             "segment_ms": segment_ms,
             "segment_rest_ms": segment_ms - (sum(anet_s) + sum(tnet_s)) * 1e3}

    frames_host = registry.load_images(registry.subset("train")[0])
    # QA time of one round on TAPNet's own probabilities (already on the card)
    frames = torch.as_tensor(frames_host).to(torch.bfloat16).to(dev)
    qa_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        predict_clip_quality(assess_net, frames, all_p, O)
        torch.cuda.synchronize()
        qa_ms.append((time.perf_counter() - t0) * 1e3)
    profile = profile_device(
        torch, lambda: predict_clip_quality(assess_net, frames, all_p, O), float(np.median(qa_ms)),
        launched=[(roi_crop_pairs_fusedbox, FUSEDBOX_KERNELS)],
    )
    h2d_ms = sum(e["device_ms"] for e in profile["copies"] if "HtoD" in e["name"])
    if h2d_ms > 0.05:
        raise AssertionError(f"host-to-device copies of {h2d_ms} ms in a TAPNet QA round")

    log_phase(
        "tapnet_slice", tic, **run["report"], qa_ms_per_round=qa_ms,
        peak_memory_bytes=run["peak_memory_bytes"], segment_split=split,
        card=kinfo["name"], power_limit=kinfo["power_limit"],
    )
    print(json.dumps({"phase": "tapnet_qa_profile", "h2d_copy_ms": h2d_ms, **profile}), flush=True)
    return run["report"]["launches"], frames, all_p, assess_net, agent


def phase_vos_slice(torch, dev, kinfo, vos):
    """The slice's main path with MatchNet or IPNet, bf16_inputs on."""
    from ivosw_tpu_torch.models.vos import matchnet

    run = run_backbone_slice(torch, dev, vos)
    # the segmentation split of one more round: encoder (begin_sequence),
    # interaction and propagation, MatchNet's similarity maps
    inter, prop = VOS_SPLIT[vos]
    functions = [(matchnet, "object_sim_maps")] if vos == "matchnet" else []
    encode_ms, calls, segment_ms = split_round(torch, run["adapter"], run["registry"],
                                               (inter, prop), functions)
    sim_s = calls.get("object_sim_maps", [])
    timed_ms = (sum(calls[inter]) + sum(calls[prop]) + sum(sim_s)) * 1e3
    split = {"encoder_ms": encode_ms, "interaction_ms": sum(calls[inter]) * 1e3,
             "propagation_steps": len(calls[prop]), "propagation_ms": sum(calls[prop]) * 1e3,
             "similarity_calls": len(sim_s), "similarity_ms": sum(sim_s) * 1e3,
             "segment_ms": segment_ms, "segment_rest_ms": segment_ms - timed_ms}
    if len(calls[prop]) != T_CLIP - 1 or (vos == "matchnet") != (len(sim_s) == 2 * (T_CLIP - 1)):
        raise AssertionError(f"{vos} split round: {split}")
    log_phase(
        f"{vos}_slice", run["tic"], **run["report"], peak_memory_bytes=run["peak_memory_bytes"],
        segment_split=split, card=kinfo["name"], power_limit=kinfo["power_limit"],
    )
    return run["report"]["launches"]


def phase_two_stage(torch, dev, frames, all_p, assess_net, agent):
    """perf_probe v2's round on TAPNet's bf16 maps: boxes, then the given-box
    pair kernel (impl="einsum"), against the fused-box round."""
    import numpy as np

    from ivosw_tpu_torch.interact.recommend import FRAME_CHUNK
    from ivosw_tpu_torch.kernels.roi_crop import roi_crop_pairs
    from ivosw_tpu_torch.models.assess import mean_object_quality, score_clip_folded

    tic = time.perf_counter()
    t = all_p.shape[0]
    obj_valid = torch.ones((O,), dtype=torch.float32, device=dev)

    def qa_round(impl):
        scores = torch.cat([
            score_clip_folded(assess_net, frames[s:s + FRAME_CHUNK], all_p[s:s + FRAME_CHUNK],
                              obj_valid, obj_offset=1, impl=impl)
            for s in range(0, t, FRAME_CHUNK)
        ])
        quality = mean_object_quality(scores, obj_valid).cpu().numpy()
        state = np.stack([quality, np.zeros(t, np.float32)], axis=1).astype(np.float32)
        return scores, agent.action(state)

    qa_round("einsum")  # warm-up: cuDNN's algorithm choice
    torch.cuda.synchronize()
    roi_crop_pairs.launches = 0
    t0 = time.perf_counter()
    scores_e, pick_e = qa_round("einsum")
    torch.cuda.synchronize()
    einsum_ms = [(time.perf_counter() - t0) * 1e3]
    launches = roi_crop_pairs.launches
    scores_p, pick_p = qa_round("pallas")
    err = float((scores_e - scores_p).abs().max())
    size = float(scores_p.abs().max())
    bound = SCORE_ATOL * max(1.0, size)
    expected = math.ceil(t / FRAME_CHUNK)
    if launches != expected:
        raise AssertionError(f"pair kernel launched {launches}x in the two-stage round, "
                             f"expected {expected}")
    if not err <= bound or not bool(torch.isfinite(scores_e).all()):
        raise AssertionError(f"two-stage vs fused-box scores: max abs diff {err} "
                             f"(bound {bound}, largest score {size})")
    pallas_ms = []
    for impl, store in (("einsum", einsum_ms), ("pallas", pallas_ms), ("einsum", einsum_ms),
                        ("pallas", pallas_ms)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        qa_round(impl)
        torch.cuda.synchronize()
        store.append((time.perf_counter() - t0) * 1e3)
    log_phase("two_stage", tic, frames=t, launches=launches, expected_launches=expected,
              score_max_abs_diff=err, largest_score=size, bound=bound,
              picks={"einsum": pick_e, "pallas": pick_p},
              einsum_round_ms=einsum_ms, fusedbox_round_ms=pallas_ms)
    return launches


def agent_transitions(n, t, seed, names=("seq",)):
    """``n`` seeded transitions of ``t`` frames (the replay schema)."""
    import numpy as np

    from ivosw_tpu_torch.data.replay import Transition

    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        counts = rng.integers(0, 3, t).astype(np.float32)
        action = int(rng.integers(t))
        nxt = counts.copy()
        nxt[action] += 1
        out.append(Transition(
            sequence=names[i % len(names)], scribble_iter=1 + i % 3, n_interaction=1 + i % 4,
            n_interaction_next=2 + i % 4, action=action, reward_step=float(rng.choice([1.0, -1.0])),
            reward_done=float(rng.normal()), done=i % 4 == 3,
            state_iou=rng.random(t, dtype=np.float32), next_state_iou=rng.random(t, dtype=np.float32),
            annotated_frames=counts, next_annotated_frames=nxt,
        ))
    return out


def brain_params_close(got, ref, lr, steps):
    """Largest |got - ref| over the Brain's parameters and whether each lies
    within 1e-3·lr·steps + 2 ulp of ``ref`` (state dicts)."""
    import numpy as np

    worst, ok = 0.0, True
    for k, r in ref.items():
        r = r.detach().cpu().numpy()
        err = np.abs(got[k].detach().cpu().numpy() - r)
        ok &= bool((err <= 1e-3 * lr * steps + 2 * np.spacing(np.abs(r))).all())
        worst = max(worst, float(err.max()))
    return worst, ok


def phase_agent_update(torch, dev, kinfo):
    """20 Q-updates at full width on the card and the same 20 on the host."""
    import numpy as np

    from ivosw_tpu_torch.core.config import Config
    from ivosw_tpu_torch.models.agent import Agent

    tic = time.perf_counter()
    cfg = Config(phase="train", seed=SEED)
    b = cfg.agent.train_batch_size
    card, host = Agent(cfg, device=dev), Agent(cfg, device="cpu")
    host.brain.load_state_dict(card.brain.state_dict())
    host.sync_target()
    for tr in agent_transitions(AGENT_POOL, AGENT_T, SEED):
        card.memory_pool.push(tr)
    sampler = np.random.default_rng(SEED)
    batches = [card.memory_pool.sample_batch(b, sampler) for _ in range(AGENT_UPDATES)]

    # warm-up on a throwaway agent: cuBLAS handles and the first launches
    Agent(cfg, device=dev).update_agent(batches[0])

    losses, ms = [], []
    for batch in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(card.update_agent(batch))
        ms.append((time.perf_counter() - t0) * 1e3)  # update_agent reads the loss: synced
    host_losses = [host.update_agent(batch) for batch in batches]
    loss_err = float(np.max(np.abs(np.array(losses) - host_losses) / np.abs(host_losses)))
    param_err, params_ok = brain_params_close(card.brain.state_dict(), host.brain.state_dict(),
                                              cfg.agent.lr, AGENT_UPDATES)
    if not (loss_err <= AGENT_LOSS_RTOL and params_ok and np.isfinite(losses).all()):
        raise AssertionError(f"card vs host Q-updates: loss rel err {loss_err} (bound "
                             f"{AGENT_LOSS_RTOL}), param max abs err {param_err}, within "
                             f"1e-3·lr·updates + 2 ulp: {params_ok}")
    if card.host_rng.random() != host.host_rng.random():
        raise AssertionError("card and host agents drew different host-RNG streams")
    profile = profile_device(torch, lambda: card.update_agent(batches[0]), float(np.median(ms)))
    log_phase("agent_update", tic, batch=b, frames=AGENT_T, updates=AGENT_UPDATES,
              lr=cfg.agent.lr, update_ms_median=float(np.median(ms)), update_ms=ms,
              losses=losses, loss_max_rel_err=loss_err, param_max_abs_err=param_err,
              kernels_per_update=profile["kernels_per_call"],
              card=kinfo["name"], power_limit=kinfo["power_limit"])
    print(json.dumps({"phase": "agent_update_profile", **profile}), flush=True)


def agent_cfg(Config, root, **kw):
    cfg = Config(**kw)
    cfg.data.len_subseq = 6
    cfg.davis_interactive.max_nb_interactions = 3
    cfg.agent.save_result_dir = os.path.join(root, "train")
    cfg.agent.train_batch_size = 4
    cfg.ckpt_dir = os.path.join(root, "weights")
    return cfg


def phase_agent_pipeline(torch, dev):
    """produce_reward → pretrain_agent → train_agent ``run`` on the card at
    the CPU tests' size (tests/test_torch_agent_pipeline.py)."""
    import numpy as np

    from ivosw_tpu_torch.core.config import Config
    from ivosw_tpu_torch.data.registry import SequenceRegistry
    from ivosw_tpu_torch.eval.eval_agent import load_weights
    from ivosw_tpu_torch.models.agent import Agent
    from ivosw_tpu_torch.models.vos.fake import FakeVOS
    from ivosw_tpu_torch.train import pretrain_agent, produce_reward, train_agent

    tic = time.perf_counter()
    registry = SequenceRegistry.synthetic(["gamma", "delta"], num_frames=8, image_size=(64, 48),
                                          num_objects=1, split="train", seed=1)
    adapter = lambda: FakeVOS(registry, base_quality=0.3, gain=0.5, tau=1.5, max_quality=0.75)
    log = logging.getLogger("chip_smoke.agent")
    log.handlers = [logging.NullHandler()]
    log.propagate = False
    seconds = {}
    with tempfile.TemporaryDirectory() as root:
        for name, stage, epochs in (("produce_reward", produce_reward, 2),
                                    ("pretrain_agent", pretrain_agent, 2),
                                    ("train_agent", train_agent, 1)):
            t0 = time.perf_counter()
            cfg = stage.configure(agent_cfg(Config, root))
            cfg.num_epochs = epochs
            cfg.agent.sample_th = 0.01
            stats, agent = stage.run(cfg, registry=registry, adapter=adapter(), log=log,
                                     device=dev)
            seconds[name] = time.perf_counter() - t0
        on_card = {p.device for p in agent.brain.parameters()} | {
            p.device for p in agent.target.parameters()}
        if on_card != {dev}:
            raise AssertionError(f"agent parameters on {on_card}, expected {dev}")
        if not (stats["update_loss_avg"] > 0 and np.isfinite(stats["update_loss_avg"])):
            raise AssertionError(f"no Q-update ran on the card: {stats}")
        fresh = Agent(Config(phase="eval", seed=SEED + 1), device=dev)
        if not load_weights(fresh.brain, cfg.ckpt_dir, "agent.pt"):
            raise AssertionError("agent.pt was not written")
        state = np.random.default_rng(SEED).random((AGENT_T, 2)).astype(np.float32)
        q_err = float(np.abs(fresh.q_values(state) - agent.q_values(state)).max())
        if not q_err <= 1e-6:
            raise AssertionError(f"agent.pt reloads to other Q-values: max abs diff {q_err}")
    log_phase("agent_pipeline", tic, stage_seconds=seconds, train_stats=stats,
              steps_done=agent.steps_done, reload_q_max_abs_diff=q_err)


def phase_agent_wild(torch, dev, kinfo):
    """The slice's path: the wild-state Q-learning rollout with TAPNet and
    the bf16 AssessNet at 480×854, the pool bootstrapped so every episode
    ends with 3·rounds − 1 Q-updates on the card."""
    import numpy as np

    from ivosw_tpu_torch.core.config import Config
    from ivosw_tpu_torch.data.demo import DemoSpec, demo_training_registry
    from ivosw_tpu_torch.interact.recommend import RewardTable
    from ivosw_tpu_torch.interact.session import InteractiveSession
    from ivosw_tpu_torch.kernels.roi_crop import roi_crop_pairs_fusedbox
    from ivosw_tpu_torch.models.vos.tapnet import TAPNetAdapter
    from ivosw_tpu_torch.train import rollout

    tic = time.perf_counter()
    spec = DemoSpec(h=H, w=W, num_frames=AGENT_FRAMES, num_objects=O, blob=BLOB)
    registry = demo_training_registry(n_clips=AGENT_CLIPS, seed=SEED, spec=spec)
    names = registry.subset("train")
    cfg = Config(phase="train", setting="wild", method="ours", vos="tapnet", dataset="demo",
                 seed=SEED)
    cfg.num_epochs = 1
    cfg.data.len_subseq = AGENT_T
    cfg.davis_interactive.max_nb_interactions = AGENT_ROUNDS
    cfg.assess_net.bf16_inputs = True
    assess_net, agent = make_models(torch, dev, cfg, SEED)
    for tr in agent_transitions(AGENT_POOL, AGENT_T, SEED + 1, names):
        agent.memory_pool.push(tr)
    table = RewardTable()
    rng = np.random.default_rng(SEED)
    for name in names:
        for n in range(2, AGENT_ROUNDS + 1):
            for scribble_iter in (1, 2, 3):
                for v in rng.uniform(0.2, 0.9, 30):
                    table.add(name, n, scribble_iter, float(v))
    adapter = TAPNetAdapter.create(seed=SEED, qa_dtype=torch.bfloat16, device=dev)
    log = logging.getLogger("chip_smoke.agent_wild")
    log.handlers = [logging.NullHandler()]
    log.propagate = False

    seg_ms, rec_ms, update_ms, losses = [], [], [], []
    encode_ms, metric_ms, submit_ms = [], [], []
    segment, recommend, update = adapter.segment, rollout.recommend_frame, agent.update_agent
    begin, metric, submit = (adapter.begin_sequence, rollout.sequence_metric,
                             InteractiveSession.submit_masks)

    def synced(store, fn):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            store.append((time.perf_counter() - t0) * 1e3)
            return out
        return run

    def recorded_update(batch):
        losses.append(synced(update_ms, update)(batch))
        return losses[-1]

    # the host's share of a round: the window's J&F, and the session's
    # submission (J&F of the whole clip, then the robot's next scribble)
    adapter.segment = synced(seg_ms, segment)
    adapter.begin_sequence = synced(encode_ms, begin)
    rollout.recommend_frame = synced(rec_ms, recommend)
    rollout.sequence_metric = synced(metric_ms, metric)
    InteractiveSession.submit_masks = synced(submit_ms, submit)
    agent.update_agent = recorded_update
    setup_s = time.perf_counter() - tic
    try:
        with tempfile.TemporaryDirectory() as out:
            cfg.agent.save_result_dir = out
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            roi_crop_pairs_fusedbox.launches = 0
            t0 = time.perf_counter()
            stats = rollout.run_interactive_phase(
                cfg, registry, adapter, agent, reward_table=table, assess_net=assess_net,
                log=log)
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
            launches = roi_crop_pairs_fusedbox.launches
            peak_bytes = torch.cuda.max_memory_allocated(dev)
    finally:
        rollout.recommend_frame, rollout.sequence_metric = recommend, metric
        InteractiveSession.submit_masks = submit
    adapter.segment, adapter.begin_sequence, agent.update_agent = segment, begin, update

    rounds = AGENT_CLIPS * AGENT_ROUNDS
    updated = [x for x in losses if x is not None]
    recorded = [agent.memory_pool.memory[-1 - i] for i in range(AGENT_CLIPS * (AGENT_ROUNDS - 1))]
    if stats["episodes"] != AGENT_CLIPS or len(seg_ms) != rounds or len(rec_ms) != rounds:
        raise AssertionError(f"{stats['episodes']} episodes, {len(seg_ms)} rounds, expected "
                             f"{AGENT_CLIPS} and {rounds}")
    if launches < rounds:
        raise AssertionError(f"fused-box kernel launched {launches}x in {rounds} wild rounds")
    if len(updated) < 3 * AGENT_ROUNDS - 1 or not np.isfinite(updated).all():
        raise AssertionError(f"{len(updated)} Q-updates ran (losses {losses})")
    if {p.device for p in agent.brain.parameters()} != {dev}:
        raise AssertionError("the agent left the card")
    for tr in recorded:
        if (len(tr.state_iou) != AGENT_T or not np.isfinite(tr.state_iou).all()
                or not np.isfinite(tr.next_state_iou).all() or not np.isfinite(tr.reward_done)):
            raise AssertionError(f"malformed transition {tr}")
    per_episode = 3 * AGENT_ROUNDS - 1
    log_phase(
        "agent_wild", tic, setup_seconds=setup_s, run_seconds=run_s, episodes=stats["episodes"],
        rounds=rounds, frames=AGENT_T, launches=launches, updates=len(updated),
        seg_ms=seg_ms, rec_ms=rec_ms, window_metric_ms=metric_ms, submit_ms=submit_ms,
        encode_ms=encode_ms,
        episode_update_ms=[sum(update_ms[i:i + per_episode])
                           for i in range(0, len(update_ms), per_episode)],
        update_ms_median=float(np.median(update_ms)), update_loss_avg=stats["update_loss_avg"],
        peak_memory_bytes=peak_bytes, card=kinfo["name"], power_limit=kinfo["power_limit"],
    )
    return launches


def vos_step_window(registry, window, seed, round2_prob=1.0):
    """One seeded training window of ``registry`` (host arrays)."""
    import numpy as np

    from ivosw_tpu_torch.interact.robot import ScribbleRobot
    from ivosw_tpu_torch.train.train_vos import sample_windows

    stream = sample_windows(registry, registry.subset("train"), np.random.default_rng(seed),
                            window, ScribbleRobot(seed=seed), round2_prob=round2_prob)
    return next(stream)


def phase_vos_train_small(torch, dev, vos):
    """One ``vos_train_step`` of ``vos`` at 48×64 (K=3, O=2, a round-2
    window) on the card and on the host from the same seeded weights."""
    from ivosw_tpu_torch.data.registry import SequenceRegistry
    from ivosw_tpu_torch.train import train_vos as tv

    tic = time.perf_counter()
    reg = SequenceRegistry.synthetic(["s", "t"], num_frames=6, image_size=(64, 48),
                                     num_objects=2, split="train", seed=SEED)
    win = vos_step_window(reg, 3, SEED)
    net_cls, init_fn, loss_fn, _ = tv._family(vos)
    init = init_fn(SEED)
    out = {}
    for side, device in (("card", dev), ("host", torch.device("cpu"))):
        net = net_cls()
        net.load_state_dict(init)
        net.to(device)
        opt = tv.make_vos_optimizer(net.parameters(), VOS_TRAIN_LR)
        loss = float(tv.vos_train_step(net, opt, tv.upload_window(win, device), loss_fn))
        out[side] = (loss, {n: (p.grad.float().cpu(), p.detach().cpu())
                            for n, p in net.named_parameters()})
    (loss_c, card), (loss_h, host) = out["card"], out["host"]
    loss_err = abs(loss_c - loss_h) / abs(loss_h)
    grad_err = {n: float((card[n][0] - g).norm() / g.norm().clamp_min(1e-30))
                for n, (g, _) in host.items()}
    worst = max(grad_err, key=grad_err.get)
    param_err, far, total = 0.0, 0, 0
    for n, (_, p) in host.items():
        diff = (card[n][1] - p).abs()
        slack = 2 * VOS_TRAIN_LR + 4 * torch.finfo(torch.float32).eps * init[n].abs()
        if not bool((diff <= slack + 1e-12).all()):
            raise AssertionError(f"{vos} card vs host step: {n} moved {float(diff.max())} "
                                 f"from the host's (bound 2·lr)")
        param_err = max(param_err, float(diff.max()))
        far += int((diff > VOS_TRAIN_LR / 100).sum())
        total += diff.numel()
    report = {"loss_card": loss_c, "loss_host": loss_h, "loss_rel_err": loss_err,
              "grad_worst_rel_l2": grad_err[worst], "grad_worst_param": worst,
              "grad_median_rel_l2": sorted(grad_err.values())[len(grad_err) // 2],
              "param_max_abs_err": param_err, "param_far_share": far / total}
    if not (loss_err <= VOS_STEP_LOSS_RTOL and grad_err[worst] <= VOS_GRAD_RTOL
            and far / total <= VOS_STEP_FLIP_SHARE):
        raise AssertionError(f"{vos} card vs host step: {report}")
    log_phase(f"vos_train_small_{vos}", tic, **report, loss_bound=VOS_STEP_LOSS_RTOL,
              grad_bound=VOS_GRAD_RTOL, far_share_bound=VOS_STEP_FLIP_SHARE)


def crop_launch_counts():
    from ivosw_tpu_torch.kernels import roi_crop

    return {name: getattr(roi_crop, name).launches for name in
            ("roi_crop", "roi_crop_pairs", "roi_crop_pairs_fusedbox", "roi_crop_pairs_premat")}


def phase_vos_train(torch, dev, kinfo, vos):
    """``train_vos.run`` of ``vos`` on the card at the HD demo tier; the
    written checkpoint segments one round through the family's adapter."""
    import numpy as np

    from ivosw_tpu_torch.core.config import Config
    from ivosw_tpu_torch.data.demo import HD_SPEC, demo_training_registry
    from ivosw_tpu_torch.data.registry import SequenceRegistry
    from ivosw_tpu_torch.eval.backbones import build_backbone
    from ivosw_tpu_torch.interact.robot import ScribbleRobot
    from ivosw_tpu_torch.train import train_vos as tv

    tic = time.perf_counter()
    registry = demo_training_registry(n_clips=VOS_TRAIN_CLIPS + 1, seed=1, spec=HD_SPEC)
    # the last clip is held out of training: the loss is read on one of its
    # round-2 windows before and after
    name = registry.subset("train")[-1]
    held = SequenceRegistry(sequences={name: registry.sequences.pop(name)},
                            _synthetic={name: registry._synthetic.pop(name)})
    net_cls, init_fn, loss_fn, _ = tv._family(vos)
    held_out = tv.upload_window(vos_step_window(held, VOS_TRAIN_WINDOW, SEED), dev)
    init = init_fn(SEED)

    def held_out_loss(state):
        net = net_cls()
        net.load_state_dict(state)
        with torch.no_grad():
            return float(loss_fn(net.to(dev), held_out))

    loss_before = held_out_loss(init)
    setup_s = time.perf_counter() - tic
    with tempfile.TemporaryDirectory() as ckpt:
        cfg = Config(seed=SEED, vos=vos, ckpt_dir=ckpt)
        timings = {}
        crops = crop_launch_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        out = tv.run(cfg, registry=registry, num_steps=VOS_TRAIN_STEPS, window=VOS_TRAIN_WINDOW,
                     lr=VOS_TRAIN_LR, params=init, save_every=VOS_TRAIN_STEPS, round2_prob=0.5,
                     device=dev, timings=timings, log=logging.getLogger("vos_train"))
        run_s = time.perf_counter() - t0
        peak_bytes = torch.cuda.max_memory_allocated(dev)
        crop_launches = {k: v - crops[k] for k, v in crop_launch_counts().items()}
        loss_after = held_out_loss(out["params"])

        # the written {family}.pt through the adapter: one 192×256 round
        adapter = build_backbone(cfg, registry, dev)
        loaded = adapter.net.state_dict()
        if any(not torch.equal(loaded[k].cpu(), v) for k, v in out["params"].items()):
            raise AssertionError(f"{vos}: the adapter did not load the written checkpoint")
        name = registry.subset("train")[0]
        frames, gt = registry.load_images(name), registry.load_annotations(name)
        n_obj = int(gt.max())
        scribbles = ScribbleRobot(seed=SEED).interact(name, np.zeros_like(gt), gt, n_obj,
                                                      frame=0)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        labels, all_p, _ = adapter.segment(adapter.begin_sequence(frames, n_obj), scribbles, 0, 1)
        torch.cuda.synchronize()
        segment_ms = (time.perf_counter() - t1) * 1e3
    if (labels.shape != gt.shape or tuple(all_p.shape) != (len(frames), n_obj + 1) + gt.shape[1:]
            or not bool(torch.isfinite(all_p.float()).all())):
        raise AssertionError(f"{vos}: trained adapter gave labels {labels.shape}, "
                             f"all_P {tuple(all_p.shape)}")
    losses = out["losses"]
    if not np.isfinite(losses).all() or not loss_after < loss_before:
        raise AssertionError(f"{vos}: held-out loss {loss_before} -> {loss_after}, "
                             f"losses {losses}")

    # three steps profiled on the held-out window, from the trained weights
    net = net_cls()
    net.load_state_dict(out["params"])
    net.to(dev)
    opt = tv.make_vos_optimizer(net.parameters(), VOS_TRAIN_LR)
    step_ms = [x * 1e3 for x in timings["step_s"]]
    profile = profile_device(torch, lambda: tv.vos_train_step(net, opt, held_out, loss_fn),
                             float(np.median(step_ms[3:])), calls=VOS_PROFILE_STEPS)
    log_phase(
        f"vos_train_{vos}", tic, setup_seconds=setup_s, run_seconds=run_s,
        steps=VOS_TRAIN_STEPS, window=VOS_TRAIN_WINDOW, clips=VOS_TRAIN_CLIPS,
        hw=[HD_SPEC.h, HD_SPEC.w], lr=VOS_TRAIN_LR,
        step_ms_median=float(np.median(step_ms[3:])), step_ms=step_ms,
        window_ms_median=float(np.median(timings["window_s"])) * 1e3,
        upload_ms_median=float(np.median(timings["upload_s"])) * 1e3,
        peak_memory_bytes=peak_bytes, held_out_loss_before=loss_before,
        held_out_loss_after=loss_after, losses=losses, crop_kernel_launches=crop_launches,
        kernels_per_step=profile["kernels_per_call"],
        compute_idle_share=profile["compute_idle_share"],
        device_idle_share=profile["device_idle_share"], adapter_segment_ms=segment_ms,
        card=kinfo["name"], power_limit=kinfo["power_limit"],
    )
    print(json.dumps({"phase": f"vos_train_{vos}_profile", **profile}), flush=True)


def phase_vos_train_dp(torch, dev):
    """A TAPNet ``run`` with two windows a step (``vos_train_step_dp``)."""
    import numpy as np

    from ivosw_tpu_torch.core.config import Config
    from ivosw_tpu_torch.data.demo import HD_SPEC, demo_training_registry
    from ivosw_tpu_torch.train import train_vos as tv

    tic = time.perf_counter()
    registry = demo_training_registry(n_clips=VOS_TRAIN_CLIPS, seed=1, spec=HD_SPEC)
    with tempfile.TemporaryDirectory() as ckpt:
        timings = {}
        out = tv.run(Config(seed=SEED, vos="tapnet", ckpt_dir=ckpt), registry=registry,
                     num_steps=VOS_DP_STEPS, window=VOS_TRAIN_WINDOW, lr=VOS_TRAIN_LR,
                     save_every=VOS_DP_STEPS, dp_windows=2, device=dev, timings=timings,
                     log=logging.getLogger("vos_train"))
    if len(out["losses"]) != VOS_DP_STEPS or not np.isfinite(out["losses"]).all():
        raise AssertionError(f"dp_windows=2 run: losses {out['losses']}")
    log_phase("vos_train_dp", tic, dp_windows=2, steps=VOS_DP_STEPS, losses=out["losses"],
              step_ms=[x * 1e3 for x in timings["step_s"]])


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "ivosw_tpu_torch", "csrc")):
        print("chip_smoke: run from a checkout holding ivosw_tpu_torch/", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from ivosw_tpu_torch.device import resolve_device

    tic = time.perf_counter()
    dev = resolve_device(None)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[dev.index or 0]
    smi_name, _, power = smi.partition(",")
    kinfo = {"name": torch.cuda.get_device_name(dev), "power_limit": power.strip()}
    log_phase("device", tic, torch=torch.__version__, cuda=torch.version.cuda,
              kind=kinfo["name"], nvidia_smi=smi, count=torch.cuda.device_count())

    tic = time.perf_counter()
    from ivosw_tpu_torch.kernels import _build

    libs = _build.build_all()
    log_phase("build", tic, libraries=sorted(p.name for p in libs.values()))

    from ivosw_tpu_torch.interact.recommend import FRAME_CHUNK

    f32_stats = phase_kernel(torch, dev, kinfo, FRAME_CHUNK)  # one main-path launch
    phase_kernel(torch, dev, kinfo, T_CLIP)
    phase_small(torch, dev)
    fake_launches = phase_slice(torch, dev, kinfo)
    crop_stats = phase_kernel_roi_crop(torch, dev, kinfo)
    phase_train_small(torch, dev)
    crop_launches = phase_train(torch, dev, kinfo)
    phase_train_assess(torch, dev)
    stats = phase_kernel(torch, dev, kinfo, FRAME_CHUNK, torch.bfloat16)
    pair_stats = phase_kernel_roi_crop_pairs(torch, dev, kinfo, FRAME_CHUNK)
    premat_stats = phase_kernel_roi_crop_pairs_premat(torch, dev, kinfo, FRAME_CHUNK)
    for vos in ("tapnet", "matchnet", "ipnet"):
        phase_vos_small(torch, dev, vos)
    launches, frames, all_p, assess_net, agent = phase_tapnet_slice(torch, dev, kinfo)
    pair_launches = phase_two_stage(torch, dev, frames, all_p, assess_net, agent)
    phase_agent_update(torch, dev, kinfo)
    phase_agent_pipeline(torch, dev)
    agent_launches = phase_agent_wild(torch, dev, kinfo)
    vos_launches = {vos: phase_vos_slice(torch, dev, kinfo, vos) for vos in VOS_SPLIT}
    for vos in ("tapnet", "matchnet", "ipnet"):
        phase_vos_train_small(torch, dev, vos)
    for vos in ("tapnet", "matchnet", "ipnet"):
        phase_vos_train(torch, dev, kinfo, vos)
    phase_vos_train_dp(torch, dev)

    def row(name, source, replaces, launches, st, bound_by, path):
        return {
            "name": name, "route": "cuda", "source": f"ivosw_tpu_torch/csrc/{source}",
            "replaces": f"ivosw_tpu/kernels/roi_pallas.py:{replaces}", "launches": launches,
            "max_abs_err": st["max_abs_err"], "ms": st["ms"], "plain_ms": st["plain_ms"],
            "bound_ms": st["bound_ms"], "bound_by": bound_by, "library_ms": st["library_ms"],
            "path": path, **{k: st[k] for k in ("device_ms", "bound_share") if k in st},
        }

    fused = row("roi_crop_pairs_fusedbox", "roi_crop_fusedbox.cu", 461, launches, stats, "bytes",
                "tapnet_slice (bf16 inputs)")
    fused["float32_inputs"] = {"launches": fake_launches, "path": "slice", **f32_stats}
    fused["agent_wild"] = {"launches": agent_launches, "path": "agent_wild (bf16 inputs)"}
    for vos, n in vos_launches.items():
        fused[f"{vos}_slice"] = {"launches": n, "path": f"{vos}_slice (bf16 inputs)"}
    kernels = [
        fused,
        row("roi_crop", "roi_crop.cu", 67, crop_launches, crop_stats, "bytes", "train"),
        row("roi_crop_pairs", "roi_crop_pairs.cu", 299, pair_launches, pair_stats,
            pair_stats["bound_by"], "two_stage"),
        row("roi_crop_pairs_premat", "roi_crop_pairs_premat.cu", 584, 0, premat_stats,
            premat_stats["bound_by"], None),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
