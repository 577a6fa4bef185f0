"""Test configuration: run on a virtual 8-device CPU mesh.

Unit tests use the CPU backend with 8 virtual devices so that
sharding/collective code paths compile and execute as they would on a
multi-device mesh (same SPMD program, different target).  An explicit
`JAX_PLATFORMS` wins, which is how the `gpu`-marked tests reach a card:
`JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/test_gpu.py`.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_enable_x64", False)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; skips elsewhere "
        "(decided in the `gpu` fixture of tests/test_gpu.py)")


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_per_module():
    """Drop compiled-executable caches after each test module.

    A full-suite run accumulates thousands of jitted programs (the E2E
    tests alone jit per (config, subframe, softbuffer) key); with all of
    them live in one process, XLA:CPU eventually segfaults inside
    backend_compile_and_load (~462 tests in).  Per-module clearing keeps
    the working set bounded without re-compiling within a module.
    """
    yield
    jax.clear_caches()
