"""Smoke test of the receive path on one NVIDIA GPU (or four, with --four).

Runs in one process, so no second JAX process competes for the card:

  1. device: JAX's default device must be a GPU; prints its name and power
     limit.
  2. turbo: the windowed decoder on the GPU kernel against `lax.scan`, at
     the bench cells' code-block batch (1,664 blocks of K=5824), with the
     CRC early stop and with all half-iterations: parity and timing.
  3. siso: the 20 MHz 64QAM receiver (`pdsch.decode`, TBS 75376, 30 dB) at
     batch 128, every CRC passing and the payload bit-exact, timed with the
     kernel and with `lax.scan` turbo; then one fused batch of 256.
  4. tm4: the TM4 2x2 receiver (`pdsch_mimo.decode`) at batch 64, both
     codewords' CRCs passing.
  5. air: `tools/run_lte.py` at 100 PRB for 300 TTIs must PASS, and
     `__graft_entry__.entry()` compiles and runs.
  6. gpu_vs_cpu: both receivers on the GPU and on the host CPU in this
     process: equalised symbols and LLRs within tolerance, bits identical.

Each phase prints its results (compile and run seconds, `memory_analysis()`
of its programs) and the device's `peak_bytes_in_use` on a line of its
own.  Any failure raises, and the script exits non-zero without a result.
The last line is one JSON object naming the device.

  python chip_smoke.py          # one card, phases 1-6
  python chip_smoke.py --four   # only the four-card mesh vs one card
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def _phase(name: str, fn, *args, **kwargs) -> dict:
    from srsran_4g_tpu import device_checks as dc

    print(f"phase {name}: start", flush=True)
    t0 = time.perf_counter()
    res = fn(*args, **kwargs)
    print(f"phase {name}: {json.dumps(res, default=str)}")
    print(f"phase {name}: ok in {time.perf_counter() - t0:.1f} s, "
          f"peak_bytes_in_use={dc.peak_bytes()}", flush=True)
    return res


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card path and its one-card "
                         "comparison")
    args = ap.parse_args(argv)

    # the GPU-vs-CPU phase needs the host platform beside the card's
    plats = os.environ.get("JAX_PLATFORMS")
    if plats and "cpu" not in plats.split(","):
        os.environ["JAX_PLATFORMS"] = plats + ",cpu"
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from srsran_4g_tpu.utils import compile_cache

    print(f"compile cache: {compile_cache.enable()}")
    import jax

    from srsran_4g_tpu import device_checks as dc

    info = _phase("device", dc.card)
    if args.four:
        _phase("four_card", dc.four_card, 4)
    else:
        _phase("turbo", dc.turbo_parity)
        _phase("siso", dc.siso_receiver)
        _phase("tm4", dc.tm4_receiver)
        _phase("air", dc.air_path)
        _phase("graft_entry", dc.graft_entry)
        _phase("gpu_vs_cpu", dc.gpu_vs_cpu)

    print(f"card: {info['nvidia_smi']}")
    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
