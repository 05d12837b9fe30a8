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
   float32 bound), kernel / plain / library / bound times. Once at the
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
   timed and profiled (``torch.profiler``: device time by op);
5. kernel_roi_crop: the crop kernel with given boxes (AssessNet training)
   against its plain torch version at the training path's shape, B=32
   images of 480×854 with C=4 channels (frame + prob) and boxes from
   empty, tiny, border-touching and out-of-range masks, 256² float32 crops:
   crop error (float32 bound), kernel / plain / library / bound times;
6. train_small: two ``assess_train_step``s of a float32 AssessNet on 48×64
   images, batch 4, lr 1e-2, on the card (crop kernel) and on the host
   (plain crop) from the same weights: losses and parameter updates agree
   to the stated relative bounds;
7. train: the training path, ``pretrain_assess.run`` on two 480×854 demo
   clips (16 frames, 3 objects), batch 32, seeded full-width ResNet-50
   AssessNet in bf16, 8 steps. The crop kernel's launch count is zeroed
   just before and read just after, and must be 8; losses finite. Step
   times, peak device memory and the host's batch-building time; one more
   step, its batch already on the card, is profiled (``train_profile``);
8. train_assess: ``generate_qa_data.run`` (FakeVOS) on one 480×854 clip
   (T=8, O=2, 2 rounds: 32 prob maps as PNGs) into a temporary directory,
   then one ``train_assess.run`` epoch at batch 32: one launch per batch,
   finite losses, ``assess_net.pt`` written.

Then it prints the kernel table (one JSON object; each kernel's launches
are those of its path's run: the slice for the fused-box kernel, the
training run for the crop kernel), the card's name and power limit as nvidia-smi gives them, and, last, the result line
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


def phase_kernel(torch, dev, kinfo, T):
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
    ).reshape(T * O, 4, H, W)

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
    timing_launches = roi_crop_pairs_fusedbox.launches - before

    _, boxes = roi_crop_pairs_fusedbox(frames, probs, S, torch.bfloat16, return_boxes=True, **kw)
    bw = card_bandwidth(kinfo["name"])
    bytes_probs = T * O * H * W * 4  # every pixel of each object plane
    bytes_frames = frame_bytes_needed(boxes, T)
    bytes_out = T * O * S * S * 4 * 2 + T * O * 4 * 4
    flops = T * O * S * S * 4 * 2 * 4  # 4 taps × 4 channels, multiply + add
    bytes_total = bytes_probs + bytes_frames + bytes_out
    bound_ms = max(bytes_total / bw, flops / FP32_FLOPS) * 1e3
    log_phase(
        "kernel", tic,
        shape={"T": T, "O": O, "H": H, "W": W, "S": S},
        box_mismatches=errs["torch.bfloat16"][0],
        max_abs_err_bf16=errs["torch.bfloat16"][1], bound_bf16=errs["torch.bfloat16"][2],
        max_abs_err_f32=errs["torch.float32"][1], bound_f32=errs["torch.float32"][2],
        library_max_abs_err_vs_f32_plain=library_err,
        kernel_ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
        bytes={"probs": bytes_probs, "frames": bytes_frames, "out": bytes_out},
        timing_launches=timing_launches,
    )
    return {
        "max_abs_err": errs["torch.bfloat16"][1], "ms": kernel_ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "library_ms": library_ms,
    }


def run_eval(torch, dev, registry, assess_net, agent, rounds, subset, cfg):
    """evaluate() with each round's frame pick and predicted qualities
    recorded (wrappers around the driver's recommend_frame and the policy
    layer's predict_clip_quality)."""
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
                cfg, registry, FakeVOS(registry), agent=agent, assess_net=assess_net,
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
        torch, lambda: predict_clip_quality(assess_net, frames, all_p, O), float(np.median(qa_ms))
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


def profile_device(torch, fn, wall_ms: float, top: int = 10):
    """torch.profiler over one call of ``fn`` (a QA round, a train step;
    after a profiled warm-up call that pays the tracer's start-up): device
    time of each kernel and copy, the copies' (memcpy / memset) sum apart
    from the compute kernels' sum, and the share of the profiled call's own
    wall time in which no compute kernel ran, and in which neither a kernel
    nor a copy ran. ``wall_ms`` (an unprofiled call's time) is reported
    beside it: the pageable upload's rate varies from call to call. One
    stream runs the call, so device activities do not overlap."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            profiled_ms = (time.perf_counter() - t0) * 1e3
    device = [
        e for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
        and not e.key.startswith("Activity Buffer")
    ]
    device.sort(key=lambda e: e.self_device_time_total, reverse=True)
    is_copy = lambda e: e.key.startswith(("Memcpy", "Memset"))
    copy_ms = sum(e.self_device_time_total for e in device if is_copy(e)) / 1e3
    compute_ms = sum(e.self_device_time_total for e in device if not is_copy(e)) / 1e3
    return {
        "wall_ms": wall_ms,
        "profiled_wall_ms": profiled_ms,
        "compute_ms": compute_ms,
        "copy_ms": copy_ms,
        "compute_idle_share": 1.0 - compute_ms / profiled_ms,
        "device_idle_share": 1.0 - (compute_ms + copy_ms) / profiled_ms,
        "top": [
            {"name": e.key[:90], "calls": e.count, "device_ms": e.self_device_time_total / 1e3}
            for e in device[:top]
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
        kernel_ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
        bytes={"in": bytes_in, "out": bytes_out}, timing_launches=timing_launches,
    )
    return {"max_abs_err": err, "ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "library_ms": library_ms}


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
        float(np.median(step_s[2:])) * 1e3,
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

    stats = phase_kernel(torch, dev, kinfo, FRAME_CHUNK)  # one main-path launch
    phase_kernel(torch, dev, kinfo, T_CLIP)
    phase_small(torch, dev)
    launches = phase_slice(torch, dev, kinfo)
    crop_stats = phase_kernel_roi_crop(torch, dev, kinfo)
    phase_train_small(torch, dev)
    crop_launches = phase_train(torch, dev, kinfo)
    phase_train_assess(torch, dev)

    kernels = [{
        "name": "roi_crop_pairs_fusedbox",
        "route": "cuda",
        "source": "ivosw_tpu_torch/csrc/roi_crop_fusedbox.cu",
        "replaces": "ivosw_tpu/kernels/roi_pallas.py:461",
        "launches": launches,
        "max_abs_err": stats["max_abs_err"],
        "ms": stats["ms"],
        "plain_ms": stats["plain_ms"],
        "bound_ms": stats["bound_ms"],
        "bound_by": "bytes",
        "library_ms": stats["library_ms"],
    }, {
        "name": "roi_crop",
        "route": "cuda",
        "source": "ivosw_tpu_torch/csrc/roi_crop.cu",
        "replaces": "ivosw_tpu/kernels/roi_pallas.py:67",
        "launches": crop_launches,
        "max_abs_err": crop_stats["max_abs_err"],
        "ms": crop_stats["ms"],
        "plain_ms": crop_stats["plain_ms"],
        "bound_ms": crop_stats["bound_ms"],
        "bound_by": "bytes",
        "library_ms": crop_stats["library_ms"],
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
