#!/usr/bin/env bash
# Local CI runner — the same stages as .github/workflows/ci.yml plus the
# GPU-only gates, in the order that catches regressions cheapest-first.
# Counterpart of the reference's ccpp.yml cmake+ninja+ctest pipeline.
#
# Usage: bash tools/ci.sh [--no-gpu]
set -euo pipefail
cd "$(dirname "$0")/.."

NO_GPU=${1:-}

echo "=== stage 1: native runtime build + TSAN race gate ==="
make -C native
make -C native tsan   # builds AND runs rt_test_tsan under TSAN

echo "=== stage 2: pytest suite (virtual 8-device CPU mesh) ==="
JAX_PLATFORMS=cpu python -m pytest tests/ -q

echo "=== stage 3: 8-device multichip dry run ==="
XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
  python -c "import __graft_entry__ as g; g.dryrun_multichip(8)"

if [ "$NO_GPU" != "--no-gpu" ]; then
  echo "=== stage 4 (GPU): chip smoke — kernel parity, receivers, air path ==="
  python chip_smoke.py

  echo "=== stage 5 (GPU): headline bench ==="
  python bench.py
fi

echo "CI: all stages green"
