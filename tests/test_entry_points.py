"""Entry points: platform choice, compile cache, and the GPU-only scripts.

Every entry point takes JAX's platform from `JAX_PLATFORMS` (or JAX's own
default) instead of forcing the CPU; `bench.py` and `chip_smoke.py` refuse
to run without a GPU and print no result.
"""

import os
import shutil
import subprocess
import sys

import jax
import pytest

from srsran_4g_tpu.utils import compile_cache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, cwd=ROOT, **env):
    return subprocess.run([sys.executable, *args], cwd=cwd,
                          env=dict(os.environ, **env), capture_output=True,
                          text=True, timeout=300)


@pytest.mark.parametrize("args", [
    ["-m", "srsran_4g_tpu.apps.srsenb", "--ttis", "1"],
    ["-m", "srsran_4g_tpu.apps.srsue", "--ttis", "1"],
    ["tools/run_lte.py", "--ttis", "1"],
])
def test_entry_point_honours_jax_platforms(args):
    r = _run(args, JAX_PLATFORMS="nosuchplatform")
    assert r.returncode != 0
    assert "nosuchplatform" in r.stderr


def test_compile_cache_follows_env(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_to_checkout(monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        assert compile_cache.enable() == os.path.join(ROOT, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == os.path.join(
            ROOT, ".jax_cache")
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


@pytest.mark.parametrize("script", ["bench.py", "chip_smoke.py"])
def test_gpu_scripts_fail_without_gpu(script):
    r = _run([script], JAX_PLATFORMS="cpu")
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout and '"value"' not in r.stdout


def test_chip_smoke_fails_outside_the_checkout(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    r = _run(["chip_smoke.py"], cwd=tmp_path, JAX_PLATFORMS="cpu",
             PYTHONPATH="")
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
