"""Tail-biting convolutional code (K=7, rate 1/3) + batched Viterbi decoder.

TS 36.212 §5.1.3.1 (generators 133, 171, 165 octal) — used by PBCH, PDCCH
(DCI) and PCFICH-adjacent control channels.  Counterpart of the reference's
`lib/src/phy/fec/convolutional/{convcoder.c,viterbi*.c}` (SSE/AVX/NEON ACS
kernels).

Design: the add-compare-select recursion runs as a `lax.scan` over
trellis steps on a (batch, 64) path-metric tensor — the 64-state dimension
and the batch dimension are both vector lanes, so one scan step is a pair
of static gathers + adds + max, and hundreds of codewords (e.g. all PDCCH
blind-decode candidates of a subframe) decode in one call.  Tail-biting is
handled by decoding 3 concatenated copies of the LLR sequence and keeping
the middle one (circular Viterbi approximation, standard practice).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

# generator polynomials, current bit in the MSB (G0=133, G1=171, G2=165 oct)
_POLYS = (0o133, 0o171, 0o165)
_K = 7
_NSTATES = 64


@functools.lru_cache(maxsize=1)
def _tables() -> dict[str, np.ndarray]:
    def parity(x: int) -> int:
        return bin(x).count("1") & 1

    masks = []
    for g in _POLYS:
        # bit 6 = current input, bits 5..0 = previous inputs (newest first)
        masks.append(int(bin(g)[2:].zfill(7), 2))
    out = np.zeros((_NSTATES, 2, 3), dtype=np.int64)
    ns = np.zeros((_NSTATES, 2), dtype=np.int64)
    for s in range(_NSTATES):
        for u in (0, 1):
            full = (u << 6) | s
            out[s, u] = [parity(full & m) for m in masks]
            ns[s, u] = full >> 1
    # predecessors of each next-state: pred b ∈ {0,1} is ((ns<<1)|b) & 63,
    # the transition input bit is ns >> 5
    pred = np.zeros((_NSTATES, 2), dtype=np.int64)
    pred_out = np.zeros((_NSTATES, 2, 3), dtype=np.int64)
    for nxt in range(_NSTATES):
        u = nxt >> 5
        for b in (0, 1):
            sp = ((nxt << 1) | b) & (_NSTATES - 1)
            pred[nxt, b] = sp
            pred_out[nxt, b] = out[sp, u]
    return dict(out=out, ns=ns, pred=pred, pred_out=pred_out)


def conv_encode(bits: jnp.ndarray) -> jnp.ndarray:
    """Tail-biting encode: (B, N) bits → (B, 3, N) streams d0,d1,d2."""
    t = _tables()
    out_t = jnp.asarray(t["out"], jnp.int8)  # (64, 2, 3)
    n = bits.shape[-1]
    b = bits.astype(jnp.int32)
    # initial state = last 6 bits, newest (u_{N-1}) in the MSB:
    # b[..., n-6+i] = u_{N-6+i} carries weight 2^i
    weights = jnp.asarray([1 << i for i in range(6)], jnp.int32)
    s0 = jnp.sum(b[..., n - 6:] * weights, axis=-1)

    ns_flat = jnp.asarray(t["ns"].reshape(-1), jnp.int32)

    def step(state, u):
        o = out_t[state, u]
        return ns_flat[state * 2 + u], o

    bt = jnp.moveaxis(b, -1, 0)  # (N, B)
    _, outs = jax.lax.scan(step, s0, bt)  # (N, B, 3)
    return jnp.moveaxis(outs, 0, -1).astype(jnp.int8)  # (B, 3, N)


def viterbi_decode(
    llrs: jnp.ndarray, tail_biting: bool = True
) -> jnp.ndarray:
    """Max-log Viterbi decode.

    Args:
      llrs: (B, 3, N) float32, positive ⇒ bit 1 (stream-major like the
        encoder output).
      tail_biting: circular decode via 3x sequence replication.

    Returns:
      (B, N) int8 decoded bits.
    """
    t = _tables()
    n = llrs.shape[-1]
    lt = jnp.moveaxis(llrs, -1, 0)  # (N, B, 3)
    if tail_biting:
        lt = jnp.concatenate([lt, lt, lt], axis=0)

    pred0 = jnp.asarray(t["pred"][:, 0])
    pred1 = jnp.asarray(t["pred"][:, 1])
    po0 = jnp.asarray(t["pred_out"][:, 0], jnp.float32)  # (64, 3)
    po1 = jnp.asarray(t["pred_out"][:, 1], jnp.float32)

    nsteps = lt.shape[0]
    batch = llrs.shape[:-2]
    pm0 = jnp.zeros(batch + (_NSTATES,), jnp.float32)

    def step(pm, l):
        # l: (B, 3); branch metric = sum_i out_i * llr_i
        bm0 = jnp.einsum("...i,si->...s", l, po0)
        bm1 = jnp.einsum("...i,si->...s", l, po1)
        c0 = pm[..., pred0] + bm0
        c1 = pm[..., pred1] + bm1
        dec = (c1 > c0).astype(jnp.int8)
        new = jnp.maximum(c0, c1)
        new = new - jnp.max(new, axis=-1, keepdims=True)
        return new, dec

    pm, decs = jax.lax.scan(step, pm0, lt)  # decs: (nsteps, B, 64)

    # traceback from the best final state
    state0 = jnp.argmax(pm, axis=-1).astype(jnp.int32)

    def back(state, dec):
        d = jnp.take_along_axis(dec, state[..., None], axis=-1)[..., 0]
        bit = (state >> 5).astype(jnp.int8)
        prev = ((state << 1) | d.astype(jnp.int32)) & (_NSTATES - 1)
        return prev, bit

    _, bits_rev = jax.lax.scan(back, state0, decs[::-1])
    bits = jnp.moveaxis(bits_rev[::-1], 0, -1)  # (B, nsteps)
    if tail_biting:
        bits = bits[..., n:2 * n]
    return bits
