"""Side-by-side turbo BER parity vs the reference's own binary.

Runs the reference's `turbodecoder_test` (compiled from /root/reference
by tools/measure_ref_baseline.py) and the framework decoder at the SAME
per-coded-bit noise variance, and commits both curves plus the
horizontal (dB) offset of the waterfall at BER 1e-3.

Noise-convention note: turbodecoder_test defines Es/N0 = 1/sigma^2 and
Eb/No = Es/N0 + 10log10(3) (turbodecoder_test.c:217); the framework
sweep uses the textbook real-channel Eb/N0 = 1/(2 R sigma^2).  At
R = 1/3 both reduce to functions of sigma alone with
ref_ebno = fw_ebno + 10log10(2) = fw_ebno + 3.01 dB, so both decoders
are driven at identical sigma and compared point-for-point.

Usage: python tools/ber_parity.py [--frames 100] [--iters 5]
Writes artifacts/ber_parity.json.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

K = 6144
# reference-convention Eb/No grid spanning the 5-iteration waterfall
REF_POINTS = [3.0, 3.25, 3.5, 3.75, 4.0, 4.5, 5.0]
CONV_OFFSET_DB = 3.01   # ref_ebno - fw_ebno at equal sigma, R=1/3


def run_reference(binary: str, ebno: float, frames: int, iters: int) -> float:
    # the reference counts HALF-iterations (turbodecoder.c:373 flips the
    # decision buffer on n_iter %% 2); the framework counts full
    # iterations, so drive the binary with 2x
    r = subprocess.run(
        [binary, "-l", str(K), "-i", str(2 * iters), "-n", str(frames),
         "-e", str(ebno)], capture_output=True, text=True, timeout=600)
    bers = re.findall(r"BER: ([0-9.e+-]+)", r.stdout)
    if not bers:
        raise RuntimeError(r.stdout[-300:] + r.stderr[-300:])
    return float(bers[-1])


def run_framework(sigma2: float, frames: int, iters: int) -> float:
    import jax.numpy as jnp

    from srsran_4g_tpu.ops import turbo

    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2, size=(frames, K)).astype(np.int8)
    d = np.asarray(turbo.turbo_encode(jnp.asarray(bits)))
    y = (1 - 2 * d.astype(np.float64)) + \
        rng.standard_normal(d.shape) * np.sqrt(sigma2)
    llr = jnp.asarray((-2 * y / sigma2).astype(np.float32))
    hard = np.asarray(turbo.turbo_decode(llr, n_iter=iters,
                                         window=128, train=32)[0])
    return float(np.mean(hard != bits))


def waterfall_db(points: list[tuple[float, float]],
                 target: float = 1e-3) -> float:
    """Interpolated Eb/No (dB) where the BER curve crosses `target`."""
    pts = sorted(points)
    for (x0, b0), (x1, b1) in zip(pts, pts[1:]):
        if b0 > target >= b1:
            l0, l1 = np.log10(max(b0, 1e-9)), np.log10(max(b1, 1e-9))
            t = (np.log10(target) - l0) / (l1 - l0)
            return x0 + t * (x1 - x0)
    return float("nan")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=100)
    ap.add_argument("--iters", type=int, default=5)
    args = ap.parse_args()

    import measure_ref_baseline

    work = measure_ref_baseline.build()
    binary = str(work / "turbodecoder_test")

    rows = []
    for ref_ebno in REF_POINTS:
        sigma2 = 10 ** (-(ref_ebno - 10 * np.log10(3.0)) / 10)
        ref_ber = run_reference(binary, ref_ebno, args.frames, args.iters)
        fw_ber = run_framework(sigma2, args.frames, args.iters)
        rows.append(dict(ref_ebno_db=ref_ebno,
                         fw_ebno_db=round(ref_ebno - CONV_OFFSET_DB, 3),
                         sigma2=round(float(sigma2), 5),
                         ref_ber=ref_ber, fw_ber=fw_ber))
        print(f"sigma2={sigma2:.4f}  ref(Eb/No {ref_ebno:.2f}) BER "
              f"{ref_ber:.2e}   framework BER {fw_ber:.2e}", flush=True)

    ref_wf = waterfall_db([(r["ref_ebno_db"], r["ref_ber"]) for r in rows])
    fw_wf = waterfall_db([(r["ref_ebno_db"], r["fw_ber"]) for r in rows])
    offset = fw_wf - ref_wf
    out = dict(k=K, frames=args.frames, iters=args.iters,
               conv_offset_db=CONV_OFFSET_DB, points=rows,
               ref_waterfall_1e3_db=round(float(ref_wf), 3),
               fw_waterfall_1e3_db=round(float(fw_wf), 3),
               divergence_db=round(float(offset), 3))
    path = os.path.join(os.path.dirname(__file__), "..", "artifacts",
                        "ber_parity.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(f"waterfall@1e-3: ref {ref_wf:.3f} dB, framework {fw_wf:.3f} dB, "
          f"divergence {offset:+.3f} dB")
    print(f"wrote {os.path.abspath(path)}")


if __name__ == "__main__":
    main()
