"""Seeding, key streams, meters, timers, profiler capture, logging
(counterpart of ``ivosw_tpu/utils/misc.py``; its ``enable_compile_cache``
is JAX's own and has none)."""

from __future__ import annotations

import logging
import os
import random
import time
from typing import Iterator

import numpy as np
import torch


def set_random_seed(seed: int) -> "np.random.Generator":
    """Seed the host RNGs and torch's default generators; returns a numpy
    Generator for stream-local randomness. Code of the port that draws
    random numbers takes an explicit generator; this only pins the globals
    for third-party code."""
    np.random.seed(seed)
    random.seed(seed)
    torch.manual_seed(seed)
    return np.random.default_rng(seed)


def rng_chain(seed: int) -> Iterator[torch.Generator]:
    """Endless deterministic stream of seeded CPU ``torch.Generator``s from
    one seed (the counterpart of the JAX package's stream of split keys):
    the i-th is seeded from the i-th child of ``np.random.SeedSequence(seed)``."""
    root = np.random.SeedSequence(seed)
    while True:
        (child,) = root.spawn(1)
        yield torch.Generator().manual_seed(int(child.generate_state(1, np.uint64)[0] >> 1))


class profile_trace:
    """``torch.profiler`` capture around a code region: ``with
    profile_trace("/tmp/trace"): ...`` writes ``{trace_dir}/trace.json``
    (a Chrome trace: host activity, and the device's when CUDA is there).
    Does nothing when ``trace_dir`` is falsy. ``.profile`` is the
    profiler, for ``key_averages()``."""

    def __init__(self, trace_dir=None):
        self.trace_dir = trace_dir
        self.profile = None

    def __enter__(self):
        if self.trace_dir:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self.profile = torch.profiler.profile(activities=activities)
            self.profile.__enter__()
        return self

    def __exit__(self, exc_type, exc, tb):
        if self.profile is not None:
            self.profile.__exit__(exc_type, exc, tb)
            os.makedirs(self.trace_dir, exist_ok=True)
            self.profile.export_chrome_trace(os.path.join(self.trace_dir, "trace.json"))
        return False


class AverageMeter:
    """Running average tracker."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count


class PhaseTimer:
    """Wall-clock phase timer that waits for the device before reading the
    clock: CUDA work is asynchronous, so ``stop`` synchronises the device
    of ``result`` (a tensor) when one is given."""

    def __init__(self, sync: bool = True):
        self.sync = sync
        self.meters = {}

    def start(self) -> float:
        return time.perf_counter()

    def stop(self, name: str, tic: float, result=None) -> float:
        if self.sync and isinstance(result, torch.Tensor) and result.is_cuda:
            torch.cuda.synchronize(result.device)
        elapsed = time.perf_counter() - tic
        self.meters.setdefault(name, AverageMeter()).update(elapsed)
        return elapsed

    def summary(self) -> dict:
        return {k: {"avg": m.avg, "count": m.count} for k, m in self.meters.items()}


def create_stream_logger(
    name: str = "ivosw_tpu_torch", fmt: str = "%(name)s - %(message)s"
) -> logging.Logger:
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    logger.handlers = []
    ch = logging.StreamHandler()
    ch.setFormatter(logging.Formatter(fmt))
    logger.addHandler(ch)
    logger.propagate = False
    return logger
