"""Test configuration: CPU backend with a virtual 8-device mesh.

Multi-device sharding is validated without a cluster via JAX's standard
trick (SURVEY.md §4.4): force the host platform to expose 8 devices.  x64
is enabled so float64 oracle paths are available; all production code is
explicitly f32/i32 typed.

The suite runs on the CPU unless JAX_PLATFORMS says otherwise; tests
marked `gpu` run the compiled kernel and skip (through the `gpu_device`
fixture) where JAX finds no GPU:

    JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu -q
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if ("xla_force_host_platform_device_count" not in _flags
        and os.environ["JAX_PLATFORMS"] == "cpu"):
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_enable_x64", True)


@pytest.fixture
def gpu_device():
    """The first GPU, or a skip where JAX finds none (decided per test,
    never at import)."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs a GPU: the compiled kernel has no CPU lowering")
    return dev


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_per_module():
    """Drop compiled executables between test modules.

    The full suite compiles hundreds of distinct XLA:CPU programs in one
    process; letting them all stay live has twice produced a deterministic
    SIGSEGV *inside* a later `backend_compile` call (~113 tests in, LLVM
    JIT resource accumulation — the same prefix split across processes
    passes).  Per-module cache clearing costs a few recompiles and keeps
    the process well under the threshold.
    """
    yield
    jax.clear_caches()
