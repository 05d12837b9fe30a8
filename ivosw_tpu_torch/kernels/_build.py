"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Every ``ivosw_tpu_torch/csrc/*.cu`` file has a plain C interface and becomes
its own shared library under ``build/kernels/`` at the repository root
(listed in ``.gitignore``), named after the source and the hash of its
content and of the flags, so an edited source is rebuilt and an unchanged
one is reused. All stale sources compile at once, one ``nvcc`` each.
PyTorch's extension builder is not used: a source that includes PyTorch's
headers takes minutes to compile, a plain C one seconds.

Flags: ``-gencode arch=compute_90a,code=sm_90a`` (Hopper), ``-O3`` and
``--fmad=false``. The last keeps nvcc from contracting a multiply and an
add into one FMA, so float32 box and coordinate arithmetic rounds after
every operation exactly as the JAX and torch reference paths do.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
]
NVCC_TIMEOUT_S = 600

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


def library_path(source: Path) -> Path:
    digest = hashlib.sha256(source.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{source.stem}_{digest.hexdigest()[:16]}.so"


def build_all() -> Dict[str, Path]:
    """Compile every stale source in parallel; returns {stem: library path}.

    Raises RuntimeError with nvcc's output when a build fails or runs past
    NVCC_TIMEOUT_S."""
    sources = sorted(CSRC.glob("*.cu"))
    libs = {src.stem: library_path(src) for src in sources}
    stale = [src for src in sources if not libs[src.stem].exists()]
    if not stale:
        return libs
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = []
    for src in stale:
        tmp = libs[src.stem].with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs.append((src, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    failures = []
    try:
        for src, tmp, proc in procs:
            try:
                out, _ = proc.communicate(timeout=NVCC_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                proc.kill()
                out, _ = proc.communicate()
                failures.append(f"{src.name}: nvcc timed out after {NVCC_TIMEOUT_S}s\n{out}")
                continue
            if proc.returncode != 0:
                failures.append(f"{src.name}: nvcc exit {proc.returncode}\n{out}")
            else:
                os.replace(tmp, libs[src.stem])
    finally:
        for _, tmp, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            tmp.unlink(missing_ok=True)
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return libs


def load(stem: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<stem>.cu``, building it on first use."""
    if stem not in _loaded:
        _loaded[stem] = ctypes.CDLL(str(build_all()[stem]))
    return _loaded[stem]
