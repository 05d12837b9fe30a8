#!/usr/bin/env python3
"""Time variants of the given-box pair crop kernel against an earlier build.

Run from the repository root on a machine with one CUDA card and ``nvcc``:

    python3 scripts/pair_crop_variants.py [--parent OLD.cu] [--yxhw-parent OLD.cu]
        [--variant kRows=4 ...] [--source LABEL=OTHER.cu ...]

``ivosw_tpu_torch/csrc/roi_crop_pairs.cu`` is copied once per variant with
its ``constexpr`` knobs replaced (``kRows``, ``kThreads``, ``kStages``;
several knobs in one variant are joined by commas, e.g.
``kRows=4,kThreads=128``) and each
copy is built into its own library under ``build/pair_variants/`` with
``kernels/_build.py``'s flags plus ``-Xptxas -v`` (registers and spills are
printed). ``--source`` adds another version of the source with the same C
interface (a design tried and dropped, kept under the git-ignored
``build/``); ``--diagnostic`` likewise, but its result is not checked (a
probe that skips part of the work, such as the copies). ``--parent`` names an earlier version whose C interface takes
(ymin, ymax, xmin, xmax) boxes [T·O, 4]; its call converts the yxhw boxes
with torch first, as that version's wrapper did. ``--yxhw-parent`` names an
earlier version whose C interface takes float32 yxhw boxes through their
strides without a box-type flag (the interface before bfloat16 boxes).

On ``chip_smoke.py``'s pair case (one launch of the two-stage round: T=32,
O=3, 480×854, S=256, bf16 inputs and output) every build is checked against
``roi_crop_pairs_reference`` (bound ``PAIR_BF16_ATOL``), then timed in turns
(parent, variants, variants reversed, parent): device time per call, all
the call's kernels over 20 calls (``chip_smoke.device_ms_by_kernel``) and wall time
per call (``chip_smoke.cuda_ms``). Prints one JSON line per build and per
measurement, then a summary line with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT_DIR = os.path.join(REPO, "build", "pair_variants")
KNOBS = {"kRows": "int", "kThreads": "int", "kStages": "int"}


def variant_source(text: str, knobs: dict) -> str:
    for name, value in knobs.items():
        pattern = rf"constexpr {KNOBS[name]} {name} = [^;]+;"
        if not re.search(pattern, text):
            raise ValueError(f"no knob {name} in the source")
        text = re.sub(pattern, f"constexpr {KNOBS[name]} {name} = {value};", text, count=1)
    return text


def build(sources: dict) -> dict:
    """{label: .cu text} → {label: loaded library}; one nvcc each, in
    parallel; prints each build's ptxas report."""
    from ivosw_tpu_torch.kernels import _build

    os.makedirs(OUT_DIR, exist_ok=True)
    procs = {}
    for label, text in sources.items():
        src = os.path.join(OUT_DIR, f"{label}.cu")
        with open(src, "w") as f:
            f.write(text)
        lib = os.path.join(OUT_DIR, f"lib{label}.so")
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", lib, src]
        procs[label] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                              stderr=subprocess.STDOUT, text=True))
    libs, failed = {}, []
    for label, (lib, proc) in procs.items():
        out, _ = proc.communicate(timeout=_build.NVCC_TIMEOUT_S)
        usage = [line.strip() for line in out.splitlines() if "registers" in line or "spill" in line]
        print(json.dumps({"build": label, "rc": proc.returncode, "ptxas": usage}), flush=True)
        if proc.returncode != 0:
            print(out, file=sys.stderr)
            failed.append(label)
        else:
            libs[label] = ctypes.CDLL(lib)
    if failed:
        raise RuntimeError(f"builds failed: {failed}")
    return libs


def yxhw_parent_call(torch, lib, frames, probs, yxhw, S, dtype, obj_offset, o):
    """The interface before bfloat16 boxes: the wrapper's call without the
    box-type flag (float32 boxes only)."""
    from ivosw_tpu_torch.kernels import roi_crop as rc

    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn = rc._bind(lib, "ivosw_roi_crop_pairs",
                  [p, p, i, i, i, i, i, i, i, i, i, p, ll, ll, i, i, i, i, p, i, p])
    t, h, w, _ = frames.shape
    fsize, psize = frames.element_size(), probs.element_size()
    frame_cap, plane_cap, _ = rc.pair_stage_bytes(w, fsize, psize)
    out = torch.empty((t * o, S, S, 4), dtype=dtype, device=frames.device)
    err = fn(frames.data_ptr(), probs.data_ptr(), rc._is_bf16(frames), rc._is_bf16(probs), t,
             probs.shape[1], obj_offset, o, h, w, S, yxhw.data_ptr(), yxhw.stride(0),
             yxhw.stride(1), rc.span_load_bytes(frames.data_ptr(), h * w * 3 * fsize, fsize),
             rc.span_load_bytes(probs.data_ptr(), h * w * psize, psize), frame_cap, plane_cap,
             out.data_ptr(), rc._is_bf16(out),
             torch.cuda.current_stream(frames.device).cuda_stream)
    rc._check_launch(lib, err, "yxhw parent roi_crop_pairs")
    return out


def parent_call(torch, lib, frames, probs, yxhw, S, dtype, obj_offset, o):
    """The earlier interface: boxes converted by torch, then one launch."""
    from ivosw_tpu_torch.kernels.roi_crop import _bind, _check_launch, _is_bf16
    from ivosw_tpu_torch.ops.roi import yxhw_to_minmax

    p, i = ctypes.c_void_p, ctypes.c_int
    fn = _bind(lib, "ivosw_roi_crop_pairs", [p, p, i, i, i, i, i, i, i, i, i, p, p, i, p])
    t, h, w, _ = frames.shape
    boxes = torch.stack(yxhw_to_minmax(yxhw.float()), dim=1).contiguous()
    out = torch.empty((t * o, S, S, 4), dtype=dtype, device=frames.device)
    err = fn(frames.data_ptr(), probs.data_ptr(), _is_bf16(frames), _is_bf16(probs), t,
             probs.shape[1], obj_offset, o, h, w, S, boxes.data_ptr(), out.data_ptr(),
             _is_bf16(out), torch.cuda.current_stream(frames.device).cuda_stream)
    _check_launch(lib, err, "parent roi_crop_pairs")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="an earlier roi_crop_pairs.cu (boxes as min/max)")
    ap.add_argument("--yxhw-parent",
                    help="an earlier roi_crop_pairs.cu (float32 yxhw boxes, no box-type flag)")
    ap.add_argument("--variant", action="append", default=[],
                    help="knob=value[,knob=value...] of csrc/roi_crop_pairs.cu")
    ap.add_argument("--source", action="append", default=[],
                    help="LABEL=PATH: another .cu with csrc/roi_crop_pairs.cu's C interface")
    ap.add_argument("--diagnostic", action="append", default=[],
                    help="LABEL=PATH: as --source, timed but not checked (a probe that "
                         "skips part of the work)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("pair_crop_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from ivosw_tpu_torch.interact.recommend import FRAME_CHUNK
    from ivosw_tpu_torch.kernels import roi_crop as rc

    with open(os.path.join(REPO, "ivosw_tpu_torch", "csrc", "roi_crop_pairs.cu")) as f:
        text = f.read()
    variants = {"new": {}}
    for spec in args.variant:
        knobs = dict(kv.split("=") for kv in spec.split(","))
        variants["new_" + "_".join(f"{k}{v}" for k, v in knobs.items())] = knobs
    sources = {label: variant_source(text, knobs) for label, knobs in variants.items()}
    for spec in args.source + args.diagnostic:
        label, path = spec.split("=", 1)
        with open(path) as f:
            sources[label] = f.read()
    for label, path in (("parent", args.parent), ("yxhw_parent", args.yxhw_parent)):
        if path:
            with open(path) as f:
                sources[label] = f.read()
    libs = build(sources)

    dev = torch.device("cuda", torch.cuda.current_device())
    frames, probs, yxhw = cs.pair_case(torch, dev, FRAME_CHUNK, torch.bfloat16)
    kw = dict(obj_offset=1, num_objects=cs.O)
    ref = rc.roi_crop_pairs_reference(frames, probs, yxhw, cs.S, torch.bfloat16, **kw)
    load = rc._load

    def call(label):
        if label in ("parent", "yxhw_parent"):
            fn = parent_call if label == "parent" else yxhw_parent_call
            return lambda: fn(torch, libs[label], frames, probs, yxhw, cs.S, torch.bfloat16, 1,
                              cs.O)

        def run():
            rc._load = lambda source: libs[label] if source == rc._PAIRS_SOURCE else load(source)
            try:
                return rc.roi_crop_pairs(frames, probs, yxhw, cs.S, torch.bfloat16, **kw)
            finally:
                rc._load = load
        return run

    labels = list(libs)
    unchecked = {spec.split("=", 1)[0] for spec in args.diagnostic}
    for label in labels:
        err = float((call(label)().float() - ref.float()).abs().max())
        print(json.dumps({"check": label, "max_abs_err": err, "bound": rc.PAIR_BF16_ATOL}),
              flush=True)
        if not err <= rc.PAIR_BF16_ATOL and label not in unchecked:
            raise AssertionError(f"{label}: max abs err {err}")

    parents = [k for k in ("parent", "yxhw_parent") if k in libs]
    order = parents + [k for k in labels if k not in parents]
    order = order + order[::-1]
    results = {label: {"device_ms": [], "wall_ms": []} for label in labels}
    for label in order:
        calls = 20
        split = cs.device_ms_by_kernel(torch, call(label), calls=calls)
        device_ms = sum(v["ms"] * v["launches"] for v in split.values()) / calls
        wall_ms = cs.cuda_ms(call(label), 50)
        results[label]["device_ms"].append(device_ms)
        results[label]["wall_ms"].append(wall_ms)
        print(json.dumps({"time": label, "device_ms": device_ms, "wall_ms": wall_ms,
                          "by_kernel": split}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"card": smi, "shape": {"T": FRAME_CHUNK, "O": cs.O, "H": cs.H,
                                             "W": cs.W, "S": cs.S}, "results": results}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
