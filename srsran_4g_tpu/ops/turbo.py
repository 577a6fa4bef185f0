"""LTE turbo codec: rate-1/3 PCCC encoder + windowed max-log-MAP decoder.

TS 36.212 §5.1.3.2.  Counterpart of the reference's
`lib/src/phy/fec/turbo/{turbocoder.c,turbodecoder*.c,tc_interl_lte.c}`.

Constituent RSC code: g0 = 1 + D² + D³ (feedback, 13 octal),
g1 = 1 + D + D³ (15 octal), 8 states, trellis-terminated with 3 tail bits
per encoder (12 tail bits total, arranged per §5.1.3.2.2 into the three
d-streams of length K+4 each).

Decoder design (the reference's windowed SIMD max-log-MAP
`turbodecoder_sse.c` re-thought for a batched accelerator):

- Batched over code blocks: every tensor carries a leading batch dim `B`;
  a whole transport block's CBs (and many subframes' TBs) decode together.
- **Windowed BCJR**: the K-step forward/backward recursions are split into
  W = K/L windows processed *in parallel* (extra tensor dim), each with a
  T-step training prologue starting from a uniform metric — so the
  sequential `lax.scan` length is T+L (e.g. 160) instead of K (6144).
  Window 0 (alpha) / the last window (beta) start from exact boundary
  metrics instead of training.  `window=None` runs the exact full-length
  recursion (used as the parity oracle in tests).
- The 8-state max-plus step is 2 static-index gathers + adds + max,
  vectorised over (B, W) — no data-dependent control flow anywhere.  On a
  CUDA device the whole half-iteration runs as one kernel instead
  (`ops/pallas/turbo_map.py`), with the same arithmetic.
- LLR convention: positive ⇒ bit 1; extrinsic scaling (default 0.75)
  compensates max-log optimism, standard for max-log turbo decoding.

HARQ soft-combining happens *outside* this module at the d-stream level
(see ops/rate_match.py): repeated transmissions accumulate into the same
(3, K+4) LLR buffers that feed this decoder.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from srsran_4g_tpu.utils.constants import TURBO_F1, TURBO_F2, cb_size_index

_NEG = -1e30


# --- trellis tables (host precompute) ---------------------------------------


@functools.lru_cache(maxsize=1)
def _trellis() -> dict[str, np.ndarray]:
    """RSC trellis tables. State s = (r1<<2)|(r2<<1)|r3, r1 = newest reg."""
    ns = np.zeros((8, 2), dtype=np.int64)  # next state
    par = np.zeros((8, 2), dtype=np.int64)  # parity output
    tail_u = np.zeros(8, dtype=np.int64)  # termination input bit
    for s in range(8):
        r1, r2, r3 = (s >> 2) & 1, (s >> 1) & 1, s & 1
        for u in (0, 1):
            a = u ^ r2 ^ r3  # feedback g0 = 1 + D^2 + D^3
            p = a ^ r1 ^ r3  # output g1 = 1 + D + D^3
            ns[s, u] = (a << 2) | (r1 << 1) | r2
            par[s, u] = p
        tail_u[s] = r2 ^ r3  # input that zeroes the feedback
    # predecessor tables: for each next-state s', its two (state, u, parity)
    pred = np.zeros((8, 2), dtype=np.int64)
    pred_u = np.zeros((8, 2), dtype=np.int64)
    pred_p = np.zeros((8, 2), dtype=np.int64)
    fill = np.zeros(8, dtype=np.int64)
    for s in range(8):
        for u in (0, 1):
            sp = ns[s, u]
            j = fill[sp]
            pred[sp, j] = s
            pred_u[sp, j] = u
            pred_p[sp, j] = par[s, u]
            fill[sp] += 1
    assert (fill == 2).all()
    return dict(ns=ns, par=par, tail_u=tail_u, pred=pred, pred_u=pred_u, pred_p=pred_p)


@functools.lru_cache(maxsize=256)
def qpp_permutation(k: int) -> np.ndarray:
    """QPP interleaver π for code-block size K: out[i] = in[π(i)]."""
    idx = cb_size_index(k)
    f1, f2 = int(TURBO_F1[idx]), int(TURBO_F2[idx])
    i = np.arange(k, dtype=np.int64)
    return (f1 * i + f2 * i * i) % k


@functools.lru_cache(maxsize=256)
def qpp_inverse(k: int) -> np.ndarray:
    p = qpp_permutation(k)
    ip = np.empty_like(p)
    ip[p] = np.arange(k, dtype=np.int64)
    return ip


# --- encoder ----------------------------------------------------------------


def _rsc_encode(bits: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """One constituent RSC encoder.

    Args:  bits (B, K) int.
    Returns: (parity (B, K) int8, final_state (B,) int32).
    """
    t = _trellis()
    ns_flat = jnp.asarray(t["ns"].reshape(-1), dtype=jnp.int32)  # (16,)
    par_flat = jnp.asarray(t["par"].reshape(-1), dtype=jnp.int32)

    def step(state, u):
        idx = state * 2 + u
        return ns_flat[idx], par_flat[idx]

    b = jnp.swapaxes(bits.astype(jnp.int32), 0, -1)  # (K, B)
    state0 = jnp.zeros(bits.shape[:-1], dtype=jnp.int32)
    final_state, parity = jax.lax.scan(step, state0, b)
    return jnp.swapaxes(parity, 0, -1).astype(jnp.int8), final_state


def _rsc_tail(state: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Trellis termination: 3 (sys, parity) tail bit pairs, (B, 3) each."""
    t = _trellis()
    tail_u = jnp.asarray(t["tail_u"], dtype=jnp.int32)
    ns_flat = jnp.asarray(t["ns"].reshape(-1), dtype=jnp.int32)
    par_flat = jnp.asarray(t["par"].reshape(-1), dtype=jnp.int32)
    sys_bits, par_bits = [], []
    for _ in range(3):
        u = tail_u[state]
        idx = state * 2 + u
        sys_bits.append(u)
        par_bits.append(par_flat[idx])
        state = ns_flat[idx]
    sys = jnp.stack(sys_bits, axis=-1).astype(jnp.int8)
    par = jnp.stack(par_bits, axis=-1).astype(jnp.int8)
    return sys, par


def turbo_encode(bits: jnp.ndarray) -> jnp.ndarray:
    """Turbo-encode code blocks.

    Args:
      bits: (B, K) systematic bits (incl. any attached CRC), K a valid
        code-block size.

    Returns:
      d: (B, 3, K+4) int8 — the three output streams incl. tail bits
      (d[:,0]=systematic, d[:,1]=parity1, d[:,2]=parity2), matching the
      §5.1.3.2.2 tail arrangement.
    """
    k = bits.shape[-1]
    perm = jnp.asarray(qpp_permutation(k))
    p1, s1 = _rsc_encode(bits)
    p2, s2 = _rsc_encode(bits[..., perm])
    x1, z1 = _rsc_tail(s1)  # enc1 tail: sys x_K..x_K+2, parity z_K..z_K+2
    x2, z2 = _rsc_tail(s2)

    b8 = bits.astype(jnp.int8)
    d0 = jnp.concatenate(
        [b8, x1[..., 0:1], z1[..., 1:2], x2[..., 0:1], z2[..., 1:2]], axis=-1
    )
    d1 = jnp.concatenate(
        [p1, z1[..., 0:1], x1[..., 2:3], z2[..., 0:1], x2[..., 2:3]], axis=-1
    )
    d2 = jnp.concatenate(
        [p2, x1[..., 1:2], z1[..., 2:3], x2[..., 1:2], z2[..., 2:3]], axis=-1
    )
    return jnp.stack([d0, d1, d2], axis=-2)


# --- max-log-MAP half-iteration ---------------------------------------------


def _alpha_step(alpha, g_sys, g_par):
    """alpha (..., 8) → next alpha.  g_sys/g_par: (...,) branch LLR terms."""
    t = _trellis()
    pred0 = tuple(t["pred"][:, 0])
    pred1 = tuple(t["pred"][:, 1])
    u0 = jnp.asarray(t["pred_u"][:, 0], dtype=jnp.float32)
    u1 = jnp.asarray(t["pred_u"][:, 1], dtype=jnp.float32)
    p0 = jnp.asarray(t["pred_p"][:, 0], dtype=jnp.float32)
    p1 = jnp.asarray(t["pred_p"][:, 1], dtype=jnp.float32)
    gs = g_sys[..., None]
    gp = g_par[..., None]
    c0 = alpha[..., jnp.asarray(pred0)] + u0 * gs + p0 * gp
    c1 = alpha[..., jnp.asarray(pred1)] + u1 * gs + p1 * gp
    out = jnp.maximum(c0, c1)
    # normalise by the max so unreachable states stay ~_NEG without the
    # reachable ones losing f32 precision
    return out - jnp.max(out, axis=-1, keepdims=True)


def _beta_step(beta, g_sys, g_par):
    """beta_{k+1} (..., 8) → beta_k."""
    t = _trellis()
    ns0 = jnp.asarray(t["ns"][:, 0])
    ns1 = jnp.asarray(t["ns"][:, 1])
    p0 = jnp.asarray(t["par"][:, 0], dtype=jnp.float32)
    p1 = jnp.asarray(t["par"][:, 1], dtype=jnp.float32)
    gs = g_sys[..., None]
    gp = g_par[..., None]
    c0 = beta[..., ns0] + p0 * gp
    c1 = beta[..., ns1] + gs + p1 * gp
    out = jnp.maximum(c0, c1)
    return out - jnp.max(out, axis=-1, keepdims=True)


def _llr_from_metrics(alpha, beta_next, g_sys, g_par):
    """A-posteriori LLR given alpha_k, beta_{k+1} (..., 8) and gamma terms."""
    t = _trellis()
    ns0 = jnp.asarray(t["ns"][:, 0])
    ns1 = jnp.asarray(t["ns"][:, 1])
    p0 = jnp.asarray(t["par"][:, 0], dtype=jnp.float32)
    p1 = jnp.asarray(t["par"][:, 1], dtype=jnp.float32)
    gp = g_par[..., None]
    m0 = jnp.max(alpha + p0 * gp + beta_next[..., ns0], axis=-1)
    m1 = jnp.max(alpha + p1 * gp + beta_next[..., ns1], axis=-1)
    return m1 + g_sys - m0


def _exact_boundary_beta(tail_sys, tail_par):
    """beta_K from the 3 termination steps. tail_*: (B, 3) LLRs."""
    b = jnp.full(tail_sys.shape[:-1] + (8,), _NEG, dtype=jnp.float32)
    b = b.at[..., 0].set(0.0)
    for i in (2, 1, 0):
        b = _beta_step(b, tail_sys[..., i], tail_par[..., i])
    return b


def _map_full(lsa, lp, tail_sys, tail_par):
    """Exact max-log BCJR over the full trellis (scan length K+3).

    lsa/lp: (B, K) combined systematic+apriori and parity LLRs.
    tail_*: (B, 3).  Returns a-posteriori LLR (B, K).
    """
    batch = lsa.shape[:-1]
    k = lsa.shape[-1]
    gs = jnp.concatenate([lsa, tail_sys], axis=-1)  # (B, K+3)
    gp = jnp.concatenate([lp, tail_par], axis=-1)
    gs_t = jnp.moveaxis(gs, -1, 0)
    gp_t = jnp.moveaxis(gp, -1, 0)

    a0 = jnp.full(batch + (8,), _NEG, dtype=jnp.float32).at[..., 0].set(0.0)

    def fstep(alpha, g):
        return _alpha_step(alpha, g[0], g[1]), alpha

    _, alphas = jax.lax.scan(fstep, a0, (gs_t, gp_t))  # alphas[k] = alpha_k

    bK3 = jnp.full(batch + (8,), _NEG, dtype=jnp.float32).at[..., 0].set(0.0)

    def bstep(beta, g):
        nb = _beta_step(beta, g[0], g[1])
        return nb, beta  # emit beta_{k+1}

    _, betas_rev = jax.lax.scan(bstep, bK3, (gs_t[::-1], gp_t[::-1]))
    beta_next = betas_rev[::-1]  # beta_next[k] = beta_{k+1}

    llr = _llr_from_metrics(alphas[:k], beta_next[:k], gs_t[:k], gp_t[:k])
    return jnp.moveaxis(llr, 0, -1)


def _map_windowed(lsa, lp, tail_sys, tail_par, win_len, train_len):
    """Windowed max-log BCJR: scan length T+L, windows in parallel."""
    assert lsa.ndim == 2, "windowed decode expects (B, K) inputs"
    batch = lsa.shape[:-1]
    k = lsa.shape[-1]
    l, t = win_len, train_len
    assert k % l == 0, (k, l)
    w = k // l

    gs = jnp.moveaxis(lsa, -1, 0)  # (K, B)
    gp = jnp.moveaxis(lp, -1, 0)

    # ---- alpha: window w covers trellis steps [w*l, (w+1)*l) --------------
    # step t' of the scan handles trellis index k_idx = w*l - t + t'
    k_idx = (np.arange(w)[None, :] * l) - t + np.arange(t + l)[:, None]  # (T+L, W)
    valid = k_idx >= 0
    k_clamped = np.clip(k_idx, 0, k - 1)
    gidx = jnp.asarray(k_clamped)  # (T+L, W)
    vmask = jnp.asarray(valid[..., None], dtype=jnp.float32)  # (T+L, W, 1)

    gs_win = jnp.moveaxis(gs[gidx], -1, 1)  # (T+L, B, W)
    gp_win = jnp.moveaxis(gp[gidx], -1, 1)

    a_init = jnp.zeros(batch + (w, 8), dtype=jnp.float32)
    a_init = a_init.at[..., 0, :].set(_NEG)  # window 0: exact start
    a_init = a_init.at[..., 0, 0].set(0.0)

    def fstep(alpha, xs):
        g_s, g_p, m = xs  # (B, W), (B, W), (W, 1)
        nxt = _alpha_step(alpha, g_s, g_p)
        nxt = m * nxt + (1.0 - m) * alpha
        return nxt, None

    def fstep_collect(alpha, xs):
        g_s, g_p, m = xs
        nxt = _alpha_step(alpha, g_s, g_p)
        nxt = m * nxt + (1.0 - m) * alpha
        return nxt, alpha

    # run T training steps without collecting, then L steps collecting
    a_carry, _ = jax.lax.scan(fstep, a_init, (gs_win[:t], gp_win[:t], vmask[:t]))
    _, alphas = jax.lax.scan(
        fstep_collect, a_carry, (gs_win[t:], gp_win[t:], vmask[t:])
    )
    # alphas: (L, B, W, 8) — alpha_k for k = w*l + (step index)
    alphas = jnp.moveaxis(alphas, 0, -2)  # (B, W, L, 8)

    # ---- beta: backward, init at k = (w+1)*l + T ---------------------------
    k_idx_b = (np.arange(w)[None, :] * l + l + t - 1) - np.arange(t + l)[:, None]
    valid_b = k_idx_b <= k - 1
    k_clamped_b = np.clip(k_idx_b, 0, k - 1)
    gidx_b = jnp.asarray(k_clamped_b)
    vmask_b = jnp.asarray(valid_b[..., None], dtype=jnp.float32)
    gs_winb = jnp.moveaxis(gs[gidx_b], -1, 1)
    gp_winb = jnp.moveaxis(gp[gidx_b], -1, 1)

    beta_k_exact = _exact_boundary_beta(tail_sys, tail_par)  # (B, 8)
    b_init = jnp.zeros(batch + (w, 8), dtype=jnp.float32)
    b_init = b_init.at[..., w - 1, :].set(beta_k_exact)

    def bstep_collect(beta, xs):
        g_s, g_p, m = xs
        nxt = _beta_step(beta, g_s, g_p)
        nxt = m * nxt + (1.0 - m) * beta
        return nxt, nxt  # emit beta_k (post-step)

    if t > 1:
        b_carry, _ = jax.lax.scan(
            lambda b, xs: (bstep_collect(b, xs)[0], None),
            b_init,
            (gs_winb[: t - 1], gp_winb[: t - 1], vmask_b[: t - 1]),
        )
    else:
        b_carry = b_init
    # After T-1 steps the carry is beta at k = w*l + l + 1; the next L steps
    # produce beta at k = w*l + l .. w*l + 1, which are exactly the
    # beta_{k+1} values needed for k = w*l + l - 1 .. w*l.
    _, betas = jax.lax.scan(
        bstep_collect, b_carry, (gs_winb[t - 1:], gp_winb[t - 1:], vmask_b[t - 1:])
    )
    betas = betas[:l]  # (L, B, W, 8), beta at k = w*l + l - j
    beta_next = jnp.moveaxis(betas, 0, -2)[..., ::-1, :]  # (B, W, L, 8) at k+1

    # ---- LLR ---------------------------------------------------------------
    lsa_w = lsa.reshape(batch + (w, l))  # (B, W, L)
    lp_w = lp.reshape(batch + (w, l))
    llr = _llr_from_metrics(alphas, beta_next, lsa_w, lp_w)
    return llr.reshape(batch + (k,))


def _map_windowed_kernel(lsa, lp, tail_sys, tail_par, win_len, train_len,
                        interpret=False):
    """`_map_windowed` on the GPU kernel (Pallas, Triton route)."""
    from srsran_4g_tpu.ops.pallas import turbo_map

    return turbo_map.map_windowed(
        lsa, lp, _exact_boundary_beta(tail_sys, tail_par), win_len,
        train_len, _NEG, interpret=interpret)


# --- full decoder -----------------------------------------------------------


def choose_window(k: int, window: int, train: int) -> int | None:
    """Largest divisor of K that is <= the requested window and > train, so
    awkward sizes still get a parallel-window decode (None: full length)."""
    return next((l for l in range(min(window, k), train, -1) if k % l == 0),
                None)


def turbo_decode(
    d_llr: jnp.ndarray,
    n_iter: int = 5,
    window: int | None = 208,
    train: int = 32,
    ext_scale: float = 0.75,
    backend: str = "auto",
    early_crc: str | None = None,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Decode turbo code blocks from d-stream LLRs.

    Args:
      d_llr: (B, 3, K+4) float32 LLRs (positive ⇒ bit 1) for the three
        streams incl. tails — the direct output of rate dematching /
        HARQ combining.
      n_iter: full decoder iterations (2 half-iterations each).
      window: window length L (must divide K) or None for the exact
        full-length recursion.
      train: training prologue length T (< window).
      ext_scale: extrinsic scaling factor for max-log.
      backend: "auto" lets the lowering platform choose the windowed
        half-iteration: the GPU kernel (`ops/pallas/turbo_map.py`, Pallas
        through Triton) on CUDA, `_map_windowed` (`lax.scan`) elsewhere.
        "xla" always takes `_map_windowed`; "triton_interpret" runs the
        kernel in the Pallas interpreter (CPU tests).
      early_crc: CRC key ("24A"/"24B") appended to each code block; when
        given, iterations run in a `lax.while_loop` that exits as soon as
        EVERY block in the batch passes its CRC — the reference's per-CB
        early stop (sch.c decode_tb_cb), batched.  Leading zero filler
        bits do not disturb the check (zero-init CRCs ignore them).

    Returns:
      (hard_bits (B, K) int8, app_llr (B, K) float32).
    """
    if backend not in ("auto", "xla", "triton_interpret"):
        raise ValueError(f"unknown turbo backend {backend!r}")
    k = d_llr.shape[-1] - 4
    d0, d1, d2 = d_llr[..., 0, :], d_llr[..., 1, :], d_llr[..., 2, :]
    ls = d0[..., :k]
    lp1 = d1[..., :k]
    lp2 = d2[..., :k]
    # §5.1.3.2.2 tail arrangement (see turbo_encode)
    t1_sys = jnp.stack([d0[..., k], d2[..., k], d1[..., k + 1]], axis=-1)
    t1_par = jnp.stack([d1[..., k], d0[..., k + 1], d2[..., k + 1]], axis=-1)
    t2_sys = jnp.stack([d0[..., k + 2], d2[..., k + 2], d1[..., k + 3]], axis=-1)
    t2_par = jnp.stack([d1[..., k + 2], d0[..., k + 3], d2[..., k + 3]], axis=-1)

    perm = jnp.asarray(qpp_permutation(k))
    iperm = jnp.asarray(qpp_inverse(k))
    ls_int = ls[..., perm]

    if window is not None:
        window = choose_window(k, window, train)

    def half(lsa, lp, tsys, tpar):
        if window is None:
            return _map_full(lsa, lp, tsys, tpar)
        args = (lsa, lp, tsys, tpar)
        kernel = functools.partial(_map_windowed_kernel, win_len=window,
                                   train_len=train)
        plain = functools.partial(_map_windowed, win_len=window,
                                  train_len=train)
        if backend == "triton_interpret":
            return kernel(*args, interpret=True)
        if backend == "xla":
            return plain(*args)
        return jax.lax.platform_dependent(*args, cuda=kernel, default=plain)

    def iteration(la1):
        lsa1 = ls + la1
        lapp1 = half(lsa1, lp1, t1_sys, t1_par)
        e1 = ext_scale * (lapp1 - lsa1)
        la2 = e1[..., perm]
        lsa2 = ls_int + la2
        lapp2 = half(lsa2, lp2, t2_sys, t2_par)
        e2 = ext_scale * (lapp2 - lsa2)
        return e2[..., iperm], lapp2[..., iperm]

    la1 = jnp.zeros_like(ls)
    if early_crc is None:

        def body(_, carry):
            la1, _ = carry
            return iteration(la1)

        la1, app = jax.lax.fori_loop(
            0, n_iter, body, (la1, jnp.zeros_like(ls))
        )
    else:
        from srsran_4g_tpu.ops.crc import crc_matrix

        g = jnp.asarray(crc_matrix(k, early_crc), dtype=jnp.float32)

        def crc_ok_per_block(app):
            bits = (app > 0).astype(jnp.float32)
            # 0/1 operands and integer sums: exact at any matmul precision
            rem = jnp.dot(bits, g, preferred_element_type=jnp.float32)
            return jnp.all((rem.astype(jnp.int32) & 1) == 0, axis=-1)  # (B,)

        # The loop advances one HALF-iteration at a time and checks the
        # CRC after each half — at high SNR decoder 1's first pass already
        # converges, so the common case pays ~half the reference's
        # iteration granularity (sch.c:371 checks per full iteration).
        # Per-block early stop: a block whose CRC checks is FROZEN — its
        # APP/extrinsics no longer change, so late halves cannot flip a
        # converged block while stragglers keep iterating.
        def h1(la):
            lsa = ls + la
            lapp = half(lsa, lp1, t1_sys, t1_par)
            e = ext_scale * (lapp - lsa)
            return e[..., perm], lapp

        def h2(la):
            lsa = ls_int + la
            lapp = half(lsa, lp2, t2_sys, t2_par)
            e = ext_scale * (lapp - lsa)
            return e[..., iperm], lapp[..., iperm]

        def cond(carry):
            _, _, hi, done = carry
            return (~jnp.all(done)) & (hi < 2 * n_iter)

        def body(carry):
            la, app, hi, done = carry
            la_n, app_n = jax.lax.cond(hi % 2 == 0, h1, h2, la)
            keep = done[:, None]
            la_n = jnp.where(keep, la, la_n)
            app_n = jnp.where(keep, app, app_n)
            return la_n, app_n, hi + 1, done | crc_ok_per_block(app_n)

        init = (la1, jnp.zeros_like(ls), jnp.int32(0),
                jnp.zeros(ls.shape[0], bool))
        la1, app, _, _ = jax.lax.while_loop(cond, body, init)

    return (app > 0).astype(jnp.int8), app
