"""Pipelined per-stage timing of the bench step.

Unlike profile_components.py (one fence per call), every stage here
enqueues `ITERS` dependent steps and fences ONCE on the last scalar — the
dispatch pattern bench.py uses — so the per-step figures are comparable
to the headline.
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax
import jax.numpy as jnp

from srsran_4g_tpu.channel.awgn import awgn, snr_to_noise_var
from srsran_4g_tpu.models import grid as G, pdsch, chest as chest_mod
from srsran_4g_tpu.models import equalizer, sch
from srsran_4g_tpu.ops import modem, scrambling

cell = G.CellConfig(nof_prb=100, cell_id=123, cfi=1)
cfg = pdsch.PdschConfig(cell=cell, rnti=0x1234, subframe=4, mod="64qam",
                        tbs=75376)
B = int(os.environ.get("BENCH_BATCH", "128"))
ITERS = int(os.environ.get("PROF_ITERS", "16"))

rng = np.random.default_rng(0)
bits = jnp.asarray(rng.integers(0, 2, (B, cfg.tbs)).astype(np.int8))
rx = jax.jit(lambda b, k: awgn(
    k, pdsch.add_crs(cfg, pdsch.encode(cfg, b)),
    snr_to_noise_var(30.0)))(bits, jax.random.PRNGKey(1))


def timeit(name, fn, arg):
    f = jax.jit(fn)
    float(f(arg))                      # compile + warm
    t0 = time.perf_counter()
    outs = [f(arg) for _ in range(ITERS)]
    v = float(outs[-1])
    dt = (time.perf_counter() - t0) / ITERS
    print(f"{name:28s} {dt*1e3:8.2f} ms/step  ({dt/B*1e6:6.1f} us/sf)"
          f"  [check={v:.1f}]", flush=True)
    return dt


def full(rx_grid):
    out = pdsch.decode(cfg, rx_grid, n_iter=4)
    return jnp.sum(out["crc_ok"].astype(jnp.float32))


def chest_only(rx_grid):
    est = chest_mod.estimate(chest_mod.ChestConfig(cell=cell), rx_grid,
                             cfg.subframe)
    return jnp.sum(jnp.abs(est["h"]) ** 2) + jnp.sum(est["noise_var"])


def front_end(rx_grid):
    est = chest_mod.estimate(chest_mod.ChestConfig(cell=cell), rx_grid,
                             cfg.subframe)
    idx = jnp.asarray(cfg.re_indices)
    b = rx_grid.shape[0]
    y = rx_grid.reshape(b, -1)[:, idx]
    h_re = est["h"].reshape(b, -1)[:, idx]
    x, eff_nv = equalizer.equalize_single(y, h_re, est["noise_var"])
    llr = modem.demodulate_soft(cfg.mod, x, eff_nv)
    return jnp.sum(scrambling.descramble_llrs(
        llr.reshape(b, cfg.g_bits), jnp.asarray(cfg.scramble_seq)))


def eq_demod_only(rx_grid):
    """equalize+demod with a FAKE flat channel: isolates chest."""
    idx = jnp.asarray(cfg.re_indices)
    b = rx_grid.shape[0]
    y = rx_grid.reshape(b, -1)[:, idx]
    h_re = jnp.ones_like(y)
    x, eff_nv = equalizer.equalize_single(y, h_re, 0.001)
    llr = modem.demodulate_soft(cfg.mod, x, eff_nv)
    return jnp.sum(scrambling.descramble_llrs(
        llr.reshape(b, cfg.g_bits), jnp.asarray(cfg.scramble_seq)))


# LLRs for the back half (computed once, on device)
llrs = jax.jit(lambda r: (lambda est: scrambling.descramble_llrs(
    modem.demodulate_soft(
        cfg.mod,
        *equalizer.equalize_single(
            r.reshape(B, -1)[:, jnp.asarray(cfg.re_indices)],
            est["h"].reshape(B, -1)[:, jnp.asarray(cfg.re_indices)],
            est["noise_var"])).reshape(B, cfg.g_bits),
    jnp.asarray(cfg.scramble_seq)))(
        chest_mod.estimate(chest_mod.ChestConfig(cell=cell), r,
                           cfg.subframe)))(rx)


def back_end(llr):
    _, ok, _ = sch.dlsch_decode(cfg.plan, llr, n_iter=4)
    return jnp.sum(ok.astype(jnp.float32))


def main():
    print(f"batch={B} iters={ITERS} "
          f"platform={jax.devices()[0].platform}", flush=True)
    timeit("full fused decode", full, rx)
    timeit("front-end (chest..descr)", front_end, rx)
    timeit("chest only", chest_only, rx)
    timeit("eq+demod only (no chest)", eq_demod_only, rx)
    timeit("dlsch_decode it=4", back_end, llrs)


if __name__ == "__main__":
    main()
