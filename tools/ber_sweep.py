"""BER parity sweep: turbo codec over the reference's Eb/N0 grid.

Reproduces the shape of `lib/src/phy/fec/turbo/test/turbodecoder_test.c`
(Eb/N0 1.0..8.0 dB, BER per point, Mb/s throughput print) so the decoder's
waterfall can be compared against the reference's published behaviour.
Writes a JSON table to artifacts/ber_turbo.json.

Usage: python tools/ber_sweep.py [--k 6144] [--frames 64] [--iters 5]
"""

import sys, os; sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse
import json
import time

import numpy as np


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--k", type=int, default=6144)
    p.add_argument("--frames", type=int, default=64)
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--snr-min", type=float, default=0.0)
    p.add_argument("--snr-max", type=float, default=3.0)
    p.add_argument("--snr-step", type=float, default=0.25)
    p.add_argument("--cpu", action="store_true")
    args = p.parse_args()

    if args.cpu:
        os.environ["JAX_PLATFORMS"] = "cpu"
    import jax.numpy as jnp

    from srsran_4g_tpu.ops import turbo

    k, b = args.k, args.frames
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2, size=(b, k)).astype(np.int8)
    d = np.asarray(turbo.turbo_encode(jnp.asarray(bits)))
    rate = k / (3.0 * (k + 4))

    dec = jax.jit(lambda llr: turbo.turbo_decode(
        llr, n_iter=args.iters, window=128, train=32)[0])

    rows = []
    points = np.arange(args.snr_min, args.snr_max + 1e-9, args.snr_step)
    for ebn0_db in points:
        ebn0 = 10 ** (ebn0_db / 10)
        sigma2 = 1.0 / (2 * rate * ebn0)
        y = (1 - 2 * d.astype(np.float64)) + \
            rng.standard_normal(d.shape) * np.sqrt(sigma2)
        llr = jnp.asarray((-2 * y / sigma2).astype(np.float32))
        t0 = time.perf_counter()
        hard = np.asarray(jax.block_until_ready(dec(llr)))
        dt = time.perf_counter() - t0
        ber = float(np.mean(hard != bits))
        fer = float(np.mean((hard != bits).any(axis=1)))
        rows.append(dict(ebn0_db=round(float(ebn0_db), 3), ber=ber, fer=fer,
                         mbps=round(b * k / dt / 1e6, 2)))
        print(f"Eb/N0 {ebn0_db:5.2f} dB   BER {ber:.2e}   FER {fer:.3f}   "
              f"{rows[-1]['mbps']:8.1f} Mb/s", flush=True)

    os.makedirs(os.path.join(os.path.dirname(__file__), "..", "artifacts"),
                exist_ok=True)
    out = os.path.join(os.path.dirname(__file__), "..", "artifacts",
                       "ber_turbo.json")
    with open(out, "w") as f:
        json.dump(dict(k=k, frames=b, iters=args.iters, points=rows), f,
                  indent=1)
    print(f"wrote {os.path.abspath(out)}")


if __name__ == "__main__":
    main()
