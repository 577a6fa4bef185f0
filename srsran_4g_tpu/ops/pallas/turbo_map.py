"""Windowed max-log-MAP half-iteration as one GPU kernel (Pallas, Triton route).

`ops/turbo.py:_map_windowed` runs the same arithmetic as a `lax.scan` of
T+L steps in each direction over tiny (B, W, 8) tiles, so on a GPU each
trellis step becomes a few small kernel launches.  Here one program
instance handles `_BLOCK` independent lanes, one lane per (code block,
window), and loops over the trellis steps inside the kernel:

- lane n = w·B + b, so neighbouring lanes read neighbouring code blocks of
  the trellis-major (K, B) gamma arrays and every load and store is
  coalesced;
- the 8 state metrics of a lane are 8 scalars in registers; the
  add-compare-select step is static per-state code (no gathers);
- the forward sweep writes each body-step alpha to a device-memory store
  (L·8 floats per lane: held in shared memory it would leave too few lanes
  per SM), and the backward sweep reads it back to emit the LLRs as it
  passes the same trellis index;
- window 0 starts alpha in state 0 and the last window starts beta from
  the exact tail metrics; the other windows train for T steps from uniform
  metrics, masking the steps that fall outside the trellis.

Every operation is the one `_map_windowed` performs, in the same order, so
the two agree to float32 rounding.  `interpret=True` runs the kernel on the
CPU (tests); compiled, it needs the Triton route of a CUDA device.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

_BLOCK = 128  # lanes per program instance: one per thread at 4 warps
_NUM_WARPS = 4


@functools.lru_cache(maxsize=1)
def _tables():
    from srsran_4g_tpu.ops.turbo import _trellis

    t = _trellis()
    return {name: tuple(int(v) for v in arr.reshape(-1))
            for name, arr in t.items()}


def _norm(c):
    mx = c[0]
    for v in c[1:]:
        mx = jnp.maximum(mx, v)
    return tuple(v - mx for v in c)


def _alpha_step(a, gs, gp):
    """Mirror of `turbo._alpha_step` on 8 per-state lane vectors."""
    t = _tables()
    out = []
    for s in range(8):
        cands = []
        for j in range(2):
            c = a[t["pred"][2 * s + j]]
            if t["pred_u"][2 * s + j]:
                c = c + gs
            if t["pred_p"][2 * s + j]:
                c = c + gp
            cands.append(c)
        out.append(jnp.maximum(cands[0], cands[1]))
    return _norm(out)


def _beta_step(bn, gs, gp):
    """Mirror of `turbo._beta_step`: beta_{k+1} → beta_k."""
    t = _tables()
    out = []
    for s in range(8):
        c0 = bn[t["ns"][2 * s]]
        if t["par"][2 * s]:
            c0 = c0 + gp
        c1 = bn[t["ns"][2 * s + 1]] + gs
        if t["par"][2 * s + 1]:
            c1 = c1 + gp
        out.append(jnp.maximum(c0, c1))
    return _norm(out)


def _llr(a, bn, gs, gp):
    """Mirror of `turbo._llr_from_metrics`."""
    t = _tables()
    m = []
    for u in range(2):
        best = None
        for s in range(8):
            c = a[s]
            if t["par"][2 * s + u]:
                c = c + gp
            c = c + bn[t["ns"][2 * s + u]]
            best = c if best is None else jnp.maximum(best, c)
        m.append(best)
    return m[1] + gs - m[0]


def _kernel(gs_ref, gp_ref, bex_ref, llr_ref, astore_ref, *,
            nb: int, nw: int, k: int, win: int, train: int, neg: float):
    n = nb * nw
    lane = pl.program_id(0) * _BLOCK + jnp.arange(_BLOCK, dtype=jnp.int32)
    live = lane < n
    lane = jnp.minimum(lane, n - 1)  # keep masked lanes' addresses in range
    wi = lane // nb
    bi = lane - wi * nb
    k0 = wi * win

    def gamma(kk, m):
        idx = jnp.clip(kk, 0, k - 1) * nb + bi
        return (plgpu.load(gs_ref.at[idx], mask=m, other=0.0),
                plgpu.load(gp_ref.at[idx], mask=m, other=0.0))

    def store(ref, idx, val):
        # dead lanes point past the end: the interpreter drops such
        # updates, and the compiled store is masked anyway
        plgpu.store(ref.at[jnp.where(live, idx, ref.shape[0])], val,
                    mask=live)

    def where(m, new, old):
        return tuple(jnp.where(m, x, y) for x, y in zip(new, old))

    # ---- forward: T masked training steps, then L steps storing alpha_k
    zero = jnp.zeros((_BLOCK,), jnp.float32)
    first = wi == 0
    a = tuple(jnp.where(first, 0.0 if s == 0 else neg, zero)
              for s in range(8))

    def a_train(r, a):
        kk = k0 - train + r
        ok = kk >= 0
        gs, gp = gamma(kk, live & ok)
        return where(ok, _alpha_step(a, gs, gp), a)

    def a_body(j, a):
        gs, gp = gamma(k0 + j, live)
        for s in range(8):
            store(astore_ref, (j * 8 + s) * n + lane, a[s])
        return _alpha_step(a, gs, gp)

    a = jax.lax.fori_loop(0, train, a_train, a)
    jax.lax.fori_loop(0, win, a_body, a)

    # ---- backward: T masked training steps down to beta at the window's
    # end, then L steps that emit LLR_k from alpha_k, beta_{k+1}, gamma_k
    last = wi == nw - 1
    bt = tuple(jnp.where(last,
                         plgpu.load(bex_ref.at[s * nb + bi], mask=live,
                                    other=0.0),
                         zero)
               for s in range(8))

    def b_train(r, bt):
        kk = k0 + win + train - 1 - r
        ok = kk <= k - 1
        gs, gp = gamma(kk, live & ok)
        return where(ok, _beta_step(bt, gs, gp), bt)

    def b_body(j, bt):
        kk = k0 + win - 1 - j
        gs, gp = gamma(kk, live)
        a = tuple(plgpu.load(astore_ref.at[((win - 1 - j) * 8 + s) * n + lane],
                             mask=live, other=0.0)
                  for s in range(8))
        store(llr_ref, kk * nb + bi, _llr(a, bt, gs, gp))
        return _beta_step(bt, gs, gp)

    bt = jax.lax.fori_loop(0, train, b_train, bt)
    jax.lax.fori_loop(0, win, b_body, bt)


def map_windowed(lsa, lp, beta_exact, win_len: int, train_len: int,
                 neg: float, interpret: bool = False):
    """One windowed max-log-MAP half-iteration on the GPU kernel.

    Args:
      lsa, lp: (B, K) float32 systematic+a-priori and parity LLRs.
      beta_exact: (B, 8) beta_K from the trellis termination.
      win_len, train_len: window L (divides K) and training length T.
      neg: the "minus infinity" metric of unreachable states.
      interpret: run in the Pallas interpreter (CPU tests).

    Returns:
      (B, K) float32 a-posteriori LLRs, as `turbo._map_windowed`.
    """
    b, k = lsa.shape
    assert k % win_len == 0, (k, win_len)
    nw = k // win_len
    n = b * nw
    # flat int32 addressing inside the kernel
    assert win_len * 8 * n < 2**31 and k * b < 2**31, (b, k, win_len)
    kern = functools.partial(_kernel, nb=b, nw=nw, k=k, win=win_len,
                             train=train_len, neg=neg)
    llr, _ = pl.pallas_call(
        kern,
        out_shape=(jax.ShapeDtypeStruct((k * b,), jnp.float32),
                   jax.ShapeDtypeStruct((win_len * 8 * n,), jnp.float32)),
        grid=(pl.cdiv(n, _BLOCK),),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=_NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name="turbo_map_windowed",
    )(lsa.T.reshape(-1), lp.T.reshape(-1), beta_exact.T.reshape(-1))
    return llr.reshape(k, b).T
