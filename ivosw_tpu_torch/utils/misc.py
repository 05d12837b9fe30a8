"""Seeding, meters, timers, logging (counterpart of ``ivosw_tpu/utils/misc.py``)."""

from __future__ import annotations

import logging
import random
import time

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
