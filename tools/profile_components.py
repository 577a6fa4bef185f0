"""Per-component timing of the 20 MHz PDSCH receive chain.

Each stage is wrapped in a jit that reduces its output to ONE f32
scalar, so the float() per iteration fences real device compute.
"""
import time, sys
import os; sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np
import jax, jax.numpy as jnp

from srsran_4g_tpu.channel.awgn import awgn, snr_to_noise_var
from srsran_4g_tpu.models import grid as G, pdsch, chest, equalizer, sch
from srsran_4g_tpu.ops import modem, scrambling, rate_match as rm, turbo

cell = G.CellConfig(nof_prb=100, cell_id=123, cfi=1)
cfg = pdsch.PdschConfig(cell=cell, rnti=0x1234, subframe=4, mod="64qam", tbs=75376)
B = int(os.environ.get("BENCH_BATCH", "32"))

rng = np.random.default_rng(0)
bits = jnp.asarray(rng.integers(0, 2, size=(B, cfg.tbs)).astype(np.int8))
rx = jax.jit(lambda b, k: awgn(
    k, pdsch.add_crs(cfg, pdsch.encode(cfg, b)),
    snr_to_noise_var(30.0)))(bits, jax.random.PRNGKey(1))


def _scalarize(x):
    leaves = jax.tree_util.tree_leaves(x)
    tot = jnp.float32(0)
    for leaf in leaves:
        l = leaf
        if jnp.iscomplexobj(l):
            l = jnp.real(l)
        tot = tot + jnp.sum(l.astype(jnp.float32))
    return tot


def timeit(name, fn, *args, iters=5):
    """fn must be UNJITTED; we jit fn -> scalar here."""
    f = jax.jit(lambda *a: _scalarize(fn(*a)))
    float(f(*args))  # compile + warm
    t0 = time.perf_counter()
    for _ in range(iters):
        float(f(*args))
    dt = (time.perf_counter() - t0) / iters
    print(f"{name:30s} {dt*1e3:8.2f} ms  ({dt*1e3/B*1000:6.1f} us/sf)",
          file=sys.stderr)


ccfg = chest.ChestConfig(cell=cell)
idx_np = np.asarray(cfg.re_indices)
seq_np = np.asarray(cfg.scramble_seq)

timeit("full_decode", lambda g: pdsch.decode(cfg, g, n_iter=4)["crc_ok"], rx,
       iters=3)
timeit("chest", lambda g: chest.estimate(ccfg, g, cfg.subframe), rx)


def front_through_demod(g):
    est = chest.estimate(ccfg, g, cfg.subframe)
    idx = jnp.asarray(idx_np)
    y = g.reshape(B, -1)[:, idx]
    h_re = est["h"].reshape(B, -1)[:, idx]
    x, eff = equalizer.equalize_single(y, h_re, est["noise_var"])
    return modem.demodulate_soft(cfg.mod, x, eff)


timeit("chest+eq+demod", front_through_demod, rx)


def frontend(g):
    llr = front_through_demod(g)
    return scrambling.descramble_llrs(llr.reshape(B, -1), jnp.asarray(seq_np))


timeit("frontend_total", frontend, rx)
llrs = jax.jit(frontend)(rx)

timeit("dlsch_decode(it=4)", lambda l: sch.dlsch_decode(cfg.plan, l, n_iter=4)[:2],
       llrs, iters=3)
timeit("dlsch_decode(it=2)", lambda l: sch.dlsch_decode(cfg.plan, l, n_iter=2)[:2],
       llrs, iters=3)

# turbo alone at the bench shape: 13 CBs x B, K=6144
K = cfg.plan.groups[-1].K
d = jnp.asarray(rng.standard_normal((B * 13, 3, K + 4)).astype(np.float32))
timeit("turbo_4it_w128", lambda x: turbo.turbo_decode(x, n_iter=4, window=128,
                                                      train=32), d, iters=3)
