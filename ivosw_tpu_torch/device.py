"""Device policy of the port.

Entry points take a ``device`` argument. ``None`` means the first CUDA
device; when no GPU is present that raises instead of falling back to the
CPU, so a measurement can never silently run on the host. The CPU runs only
when the caller asks for it (``device="cpu"``), as the tests do.

Float32 precision is set explicitly whenever a CUDA device is resolved:
``torch.backends.cuda.matmul.allow_tf32 = False`` and
``torch.backends.cudnn.allow_tf32 = False``. Float32 matrix products and
convolutions then run in full float32, so the plain float32 reference paths
agree with the CPU and with the JAX package to float32 tolerance. The main
scoring path runs in bfloat16 and is not affected by either flag.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` → the current CUDA device (raises without a GPU); anything
    else as given. A CUDA device always carries its index, so it compares
    equal to the ``.device`` of the tensors placed on it."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run on the host"
            )
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return device


def check_on_device(device: torch.device, **named) -> None:
    """Raise unless every named module (its parameters) or tensor lies on
    ``device``; host arrays and ``None`` pass. Nothing is moved: a model
    left on another device would otherwise run (and be timed) there."""
    for name, x in named.items():
        if isinstance(x, torch.nn.Module):
            x = next(x.parameters(), None)
        if isinstance(x, torch.Tensor) and x.device != device:
            raise ValueError(f"{name} is on {x.device}, expected {device}")
