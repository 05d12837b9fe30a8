"""Test harness configuration.

Intent: run tests on an 8-device virtual CPU mesh
(XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORM_NAME=cpu).

Caveat for THIS image: jax is pre-imported at interpreter startup (jax._src
is in sys.modules before any conftest runs), so setting the env here cannot
take effect — the process must be STARTED with it. Use scripts/test_cpu.sh
for the CPU-mesh run. When launched without the env, tests run on whatever
backend is live (the single real TPU chip here); multi-device tests skip
themselves via the `eight_devices` guard below. The driver's multi-chip
validation path (__graft_entry__.dryrun_multichip) is launched with the env
pre-set and is unaffected.
"""

import os
import sys

# effective only in environments where jax is NOT pre-imported
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault("JAX_PLATFORM_NAME", "cpu")
os.environ.setdefault("JAX_COMPILATION_CACHE_DIR", "/tmp/jax_cache_ivosw_tests")
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "1")
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES", "0")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import pytest  # noqa: E402

# persistent compile cache — jax.config.update works even though jax is
# pre-imported (env vars above may not); ResNet-scale jits dominate wall time
try:
    import jax as _jax

    _jax.config.update(
        "jax_compilation_cache_dir",
        os.environ.get("JAX_COMPILATION_CACHE_DIR", "/tmp/jax_cache_ivosw_tests"),
    )
    _jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    _jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
except Exception:
    pass


@pytest.fixture
def eight_devices():
    """8 devices for mesh tests. The default backend may be the single TPU
    chip, but the in-process XLA_FLAGS above DOES reach the lazily-
    initialised CPU backend — so multi-device tests run under plain pytest
    too, on CPU virtual devices."""
    import jax

    if len(jax.devices()) >= 8:
        return jax.devices()[:8]
    try:
        cpu = jax.devices("cpu")
    except RuntimeError:
        cpu = []
    if len(cpu) >= 8:
        return cpu[:8]
    pytest.skip("needs 8 devices (run via scripts/test_cpu.sh)")


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "requires_cuda: needs a CUDA card and nvcc; skips on a host without them",
    )
    config.addinivalue_line(
        "markers", "slow: long runs, left out of the default test run (-m 'not slow')"
    )
