"""Benchmark: 20 MHz PDSCH receive pipeline throughput on one GPU.

Headline metric (BASELINE.md): subframes/s of the full 20 MHz (100 PRB)
PDSCH receiver — channel estimation, MMSE equalisation, 64QAM soft demod,
descrambling, rate dematching and windowed max-log-MAP turbo decode with CRC
early stop (per half-iteration, per code block) — batched over subframes.
vs_baseline is measured against the reference's MEASURED host-aggregate
throughput at the same configuration: 8,790 subframes/s (pdsch_test
-n 100 -m 28, noiseless + CRC early stop, 2 processes saturating the
reference host's 2 AVX-512 cores — BASELINE.md "Measured reference
baseline").  The second cell is the TM4 2x2 dual-codeword receiver.

Both cells run in this one process, the TM4 line first and the SISO
headline last.  Each prints ONE JSON line on stdout; the device and the
details go to stderr.  Without a GPU it exits non-zero before any work.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np


def _device() -> None:
    """Name the device on stderr; exit non-zero unless it is a GPU."""
    import jax

    from srsran_4g_tpu import device_checks as dc

    d = jax.devices()[0]
    print(f"bench: platform={d.platform} device_kind={d.device_kind} "
          f"count={len(jax.devices())} nvidia-smi: {dc.nvidia_smi()}",
          file=sys.stderr)
    if d.platform != "gpu":
        sys.exit("bench: no GPU; refusing to time another platform")


def main() -> None:
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from srsran_4g_tpu.utils import compile_cache

    compile_cache.enable()
    _device()
    mode = os.environ.get("BENCH_MODE", "both")
    if mode in ("both", "mimo"):
        main_mimo()
    if mode in ("both", "siso"):
        main_siso()


def main_siso() -> None:
    import jax
    import jax.numpy as jnp

    from srsran_4g_tpu.channel.awgn import awgn, snr_to_noise_var
    from srsran_4g_tpu.models import grid as G, pdsch

    cell = G.CellConfig(nof_prb=100, cell_id=123, cfi=1)
    # 20 MHz, 64QAM, TBS 75376 (max single-stream 64QAM TBS @ 100 PRB)
    cfg = pdsch.PdschConfig(
        cell=cell, rnti=0x1234, subframe=4, mod="64qam", tbs=75376
    )
    # One program lax.maps the fused receiver over `chunks` chunks of
    # `batch` subframes, so one dispatch covers chunks*batch subframes.
    batch = int(os.environ.get("BENCH_BATCH", "128"))
    chunks = int(os.environ.get("BENCH_CHUNKS", "24"))
    n_iter = int(os.environ.get("BENCH_TURBO_ITERS", "4"))
    iters = int(os.environ.get("BENCH_REPS", "16"))

    print(
        f"bench: 100 PRB 64QAM tbs={cfg.tbs} G={cfg.g_bits} "
        f"nof_re={cfg.nof_re} batch={batch} chunks={chunks} "
        f"CBs={cfg.plan.segm.C}",
        file=sys.stderr,
    )

    rng = np.random.default_rng(0)

    @jax.jit
    def make_rx(bits, key):
        tx = pdsch.add_crs(cfg, pdsch.encode(cfg, bits))
        nv = snr_to_noise_var(30.0)
        return awgn(key, tx, nv)

    # independent payloads + noise per chunk (chunk axis leading)
    rx = jnp.stack([
        make_rx(
            jnp.asarray(rng.integers(0, 2, size=(batch, cfg.tbs))
                        .astype(np.int8)),
            jax.random.PRNGKey(1 + c),
        )
        for c in range(chunks)
    ])
    rx = jax.block_until_ready(rx)

    @jax.jit
    def rx_step(rx_chunks):
        def one(rx_grid):
            out = pdsch.decode(cfg, rx_grid, n_iter=n_iter)
            return (jnp.sum(out["crc_ok"].astype(jnp.float32)),
                    out["bits"][0, 0])
        oks, b0 = jax.lax.map(one, rx_chunks)
        return jnp.sum(oks), b0

    # warmup / compile
    t0 = time.perf_counter()
    n_ok, _ = rx_step(rx)
    ok_frac = float(n_ok) / (batch * chunks)
    print(f"bench: compile+warmup {time.perf_counter() - t0:.1f} s, "
          f"crc_ok fraction = {ok_frac}", file=sys.stderr)

    # Pipelined dispatch: enqueue all steps, wait once on the last one
    t0 = time.perf_counter()
    outs = [rx_step(rx)[0] for _ in range(iters)]
    v = float(jax.block_until_ready(outs[-1]))
    dt = time.perf_counter() - t0
    assert v == float(n_ok), "late-step decode diverged"

    sf_per_s = batch * chunks * iters / dt
    result = {
        "metric": "pdsch_rx_subframes_per_sec_20mhz_64qam",
        "value": round(sf_per_s, 2),
        "unit": "subframes/s",
        "vs_baseline": round(sf_per_s / 8790.0, 3),
    }
    print(
        f"bench: {sf_per_s:.1f} sf/s ({sf_per_s * cfg.tbs / 1e6:.1f} Mb/s info"
        f", crc_ok={ok_frac})",
        file=sys.stderr,
    )
    print(json.dumps(result), flush=True)


def main_mimo() -> None:
    """TM4 2×2 dual-codeword 20 MHz receiver — the reference's 150 Mbps
    headline configuration (debian/man/srsue.txt:17)."""
    import jax
    import jax.numpy as jnp

    from srsran_4g_tpu.channel.awgn import awgn
    from srsran_4g_tpu.models import grid as G, pdsch, pdsch_mimo

    cell = G.CellConfig(nof_prb=100, cell_id=123, cfi=1, nof_ports=2)
    tbs = 75376
    # TM4 closed loop: the eNB transmits with the PMI the UE reports —
    # select it from the bench channel exactly as models/mimo.pmi_select_2tx
    # does
    pmi = int(os.environ.get("BENCH_PMI", "2"))
    cfg = pdsch_mimo.PdschMimoConfig(
        cell=cell, rnti=0x1234, subframe=4, mod0="64qam", tbs0=tbs,
        mod1="64qam", tbs1=tbs, tm="tm4", pmi=pmi)
    batch = int(os.environ.get("BENCH_BATCH", "64"))
    chunks = int(os.environ.get("BENCH_CHUNKS", "16"))
    n_iter = int(os.environ.get("BENCH_TURBO_ITERS", "4"))
    iters = int(os.environ.get("BENCH_REPS", "16"))
    rng = np.random.default_rng(0)
    hmat = np.array([[1.0 + 0.1j, 0.3 - 0.4j],
                     [0.2 + 0.4j, -0.9 + 0.2j]], np.complex64)
    nv = float(10 ** (-30.0 / 10))

    @jax.jit
    def make_rx(tb0, tb1, key):
        tx = pdsch.add_crs(cfg.cw[0], pdsch_mimo.encode(cfg, tb0, tb1))
        y = jnp.einsum("rt,btsk->brsk", hmat, tx,
                       precision=jax.lax.Precision.HIGHEST)
        return awgn(key, y, nv)

    # independent payloads + noise per chunk
    rx = jnp.stack([
        make_rx(
            jnp.asarray(rng.integers(0, 2, (batch, tbs)).astype(np.int8)),
            jnp.asarray(rng.integers(0, 2, (batch, tbs)).astype(np.int8)),
            jax.random.PRNGKey(1 + c),
        )
        for c in range(chunks)
    ])
    rx = jax.block_until_ready(rx)

    @jax.jit
    def rx_step(rx_all):
        def one(rx_grids):
            out = pdsch_mimo.decode(cfg, rx_grids, n_iter=n_iter)
            ok = (out["crc_ok0"].astype(jnp.float32)
                  + out["crc_ok1"].astype(jnp.float32))
            return jnp.sum(ok)
        return jnp.sum(jax.lax.map(one, rx_all))

    t0 = time.perf_counter()
    n_ok = float(rx_step(rx))
    print(f"bench-mimo: compile+warmup {time.perf_counter() - t0:.1f} s, "
          f"crc_ok fraction = {n_ok / (2 * batch * chunks)}", file=sys.stderr)
    t0 = time.perf_counter()
    outs = [rx_step(rx) for _ in range(iters)]
    v = float(jax.block_until_ready(outs[-1]))
    dt = time.perf_counter() - t0
    assert v == n_ok
    sf_per_s = batch * chunks * iters / dt
    mbps = sf_per_s * 2 * tbs / 1e6
    print(f"bench-mimo: {sf_per_s:.1f} sf/s ({mbps:.1f} Mb/s info)",
          file=sys.stderr)
    # MIMO baseline: the MEASURED host-saturated aggregate of the
    # reference's own `pdsch_test -x 4 -a 2 -m 28 -M 28 -p 2` on the
    # reference host — 3,700 sf/s, the maximum of the observed spread
    # (BASELINE.md "Round-5 correction + measured MIMO baseline")
    print(json.dumps({
        "metric": "pdsch_mimo2x2_rx_subframes_per_sec_20mhz_64qam",
        "value": round(sf_per_s, 2), "unit": "subframes/s",
        "vs_baseline": round(sf_per_s / 3700.0, 3)}), flush=True)


if __name__ == "__main__":
    main()
