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
   timed and profiled (``torch.profiler``: device time by op).

Then it prints the kernel table (one JSON object), the card's name and power
limit as nvidia-smi gives them, and, last, the result line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
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
    import torch.nn.functional as F

    planes = probs[:, 1:]
    nchw = torch.cat(
        [frames.permute(0, 3, 1, 2)[:, None].expand(T, O, 3, H, W),
         planes[:, :, None]], dim=2,
    ).reshape(T * O, 4, H, W)

    def library():
        yxhw = mask_to_yxhw((planes > 0.5).reshape(T * O, H, W), 1.5)
        ymin, ymax, xmin, xmax = yxhw_to_minmax(yxhw)
        theta = torch.zeros((T * O, 2, 3), device=dev)
        theta[:, 0, 0] = (xmax - xmin) / (W - 1)
        theta[:, 0, 2] = (xmin + xmax - (W - 1)) / (W - 1)
        theta[:, 1, 1] = (ymax - ymin) / (H - 1)
        theta[:, 1, 2] = (ymin + ymax - (H - 1)) / (H - 1)
        grid = F.affine_grid(theta, [T * O, 4, S, S], align_corners=True)
        return F.grid_sample(nchw, grid, mode="bilinear", padding_mode="zeros",
                             align_corners=True)

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
    bound_ms = max(bytes_total / bw, flops / 67e12) * 1e3  # fp32 outside tensor cores
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
    import logging

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
    profile = profile_qa_round(
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


def profile_qa_round(torch, fn, wall_ms: float, top: int = 10):
    """torch.profiler over one QA round (after a profiled warm-up round that
    pays the tracer's start-up): device time of each kernel and copy, the
    copies' (memcpy / memset) sum apart from the compute kernels' sum, and
    the share of the profiled round's own wall time in which no compute
    kernel ran, and in which neither a kernel nor a copy ran. ``wall_ms``
    (an unprofiled round's time) is reported beside it: the pageable
    upload's rate varies from round to round. One stream runs the round,
    so device activities do not overlap."""
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
