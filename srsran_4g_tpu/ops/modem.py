"""Modulation mapping and max-log soft demodulation, TS 36.211 §7.1.

Counterpart of the reference's `lib/src/phy/modem/{mod.c,demod_soft.c,
lte_tables.c}`.  Design:

- **modulate**: bits are packed into per-symbol indices and the constellation
  point is a single gather from a 2^Qm-entry table (device-resident).
- **soft demod**: Gray-mapped square QAM factorises per real axis; we compute
  the *exact* max-log LLR per axis by evaluating the squared distance to all
  2^(Qm/2) PAM levels and taking masked minima over the bit-0 / bit-1 level
  subsets.  This is a handful of fully-vectorised elementwise ops per RE — unlike the
  reference's hand-written piecewise "zone" kernels (demod_soft.c:846-896) we
  let the compiler fuse the whole thing, and it is exact max-log for every
  constellation including 256QAM.

LLR sign convention: **positive LLR ⇒ bit = 1** (matching
log P(b=1)/P(b=0)); LLRs are normalised by the supplied noise variance
(complex, per-RE or scalar), i.e. llr = (min_{b=0} d² − min_{b=1} d²)/σ².
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np

from srsran_4g_tpu.utils.constants import BITS_PER_SYMBOL, MOD_BPSK


def _pam_levels(m_axis_bits: int) -> np.ndarray:
    """PAM level for each axis bit pattern (TS 36.211 recursive mapping).

    Pattern bits (b0, b1, ..) are the even (I) or odd (Q) modulation bits.
    level(b) = (1-2·b0)·[2^(m-1) - (1-2·b1)·[2^(m-2) - ... ]] / norm
    """
    m = m_axis_bits
    n_levels = 1 << m
    levels = np.zeros(n_levels)
    for idx in range(n_levels):
        bits = [(idx >> (m - 1 - j)) & 1 for j in range(m)]
        val = 1.0  # innermost term
        for j in range(m - 1, 0, -1):
            val = (1 << (m - j)) - (1 - 2 * bits[j]) * val
        levels[idx] = (1 - 2 * bits[0]) * val
    return levels


@functools.lru_cache(maxsize=8)
def _axis_tables(mod: str) -> tuple[np.ndarray, np.ndarray, float]:
    """(levels (2^m,), bit patterns (2^m, m), norm) for one axis."""
    qm = BITS_PER_SYMBOL[mod]
    m = max(qm // 2, 1)
    levels = _pam_levels(m)
    # average symbol energy of the full complex constellation
    if mod == MOD_BPSK:
        norm = np.sqrt(2.0)
    else:
        norm = np.sqrt(2.0 * np.mean(levels**2))
    patterns = np.array(
        [[(idx >> (m - 1 - j)) & 1 for j in range(m)] for idx in range(1 << m)],
        dtype=np.int8,
    )
    return levels / norm, patterns, float(norm)


@functools.lru_cache(maxsize=8)
def _symbol_table(mod: str) -> np.ndarray:
    """Complex constellation table indexed by the packed Qm-bit word."""
    qm = BITS_PER_SYMBOL[mod]
    levels, _, _ = _axis_tables(mod)
    table = np.zeros(1 << qm, dtype=np.complex64)
    if mod == MOD_BPSK:
        # TS 36.211 Table 7.1.1-1: b=0 → (1+j)/√2, b=1 → −(1+j)/√2
        table[0] = (1 + 1j) / np.sqrt(2)
        table[1] = -(1 + 1j) / np.sqrt(2)
        return table
    m = qm // 2
    for word in range(1 << qm):
        bits = [(word >> (qm - 1 - j)) & 1 for j in range(qm)]
        i_idx = 0
        q_idx = 0
        for j in range(m):
            i_idx = (i_idx << 1) | bits[2 * j]
            q_idx = (q_idx << 1) | bits[2 * j + 1]
        table[word] = levels[i_idx] + 1j * levels[q_idx]
    return table


def modulate(mod: str, bits: jnp.ndarray) -> jnp.ndarray:
    """Map bits (..., S*Qm) → complex64 symbols (..., S)."""
    qm = BITS_PER_SYMBOL[mod]
    n = bits.shape[-1]
    assert n % qm == 0, (n, qm)
    b = bits.reshape(bits.shape[:-1] + (n // qm, qm)).astype(jnp.int32)
    weights = jnp.asarray([1 << (qm - 1 - j) for j in range(qm)], dtype=jnp.int32)
    word = jnp.sum(b * weights, axis=-1)
    return jnp.asarray(_symbol_table(mod))[word]


def demodulate_soft(
    mod: str, symbols: jnp.ndarray, noise_var: jnp.ndarray | float = 1.0
) -> jnp.ndarray:
    """Max-log LLRs for received symbols.

    Args:
      symbols: (..., S) complex equalised symbols (unit-energy constellation).
      noise_var: effective complex noise variance per symbol — scalar or
        broadcastable to (..., S).  For an MMSE-equalised RE, pass
        σ²/|h|² (or use the CSI-weighted demod in models/equalizer.py).

    Returns:
      (..., S*Qm) float32 LLRs, positive ⇒ bit 1, ordering
      [b0 b1 ... b_{Qm-1}] per symbol (even bits from I, odd from Q).
    """
    inv_nv = 1.0 / jnp.maximum(jnp.asarray(noise_var, jnp.float32), 1e-12)
    if mod == MOD_BPSK:
        table = jnp.asarray(_symbol_table(mod))
        d = jnp.abs(symbols[..., None] - table) ** 2  # (..., S, 2)
        llr = (d[..., 0] - d[..., 1]) * inv_nv
        return llr.astype(jnp.float32)

    qm = BITS_PER_SYMBOL[mod]
    m = qm // 2
    levels_np, patterns_np, _ = _axis_tables(mod)
    # Per-axis metric for level l: (y-l)^2 = y^2 - 2ly + l^2; the y^2 term
    # is common to every level and cancels in d0-d1, so use l^2 - 2ly.
    # The 2^m levels are unrolled in Python — everything stays a chain of
    # (..., S)-shaped elementwise fma/min ops that XLA fuses into ONE
    # pass over the symbols, instead of materialising a (..., S, 2, 2^m, m)
    # masked-min tensor (at the 20 MHz bench shape that intermediate is
    # ~0.5 GB and made soft demod the front-end's cost center).
    inv = jnp.asarray(inv_nv, jnp.float32)

    def tree_min(xs):
        while len(xs) > 1:
            xs = [jnp.minimum(xs[i], xs[i + 1])
                  for i in range(0, len(xs) - 1, 2)] + (
                      [xs[-1]] if len(xs) % 2 else [])
        return xs[0]

    planes = []  # per symbol: [I0, Q0, I1, Q1, ...]
    axes = (jnp.real(symbols).astype(jnp.float32),
            jnp.imag(symbols).astype(jnp.float32))
    metrics = [[np.float32(l * l) - np.float32(2.0 * l) * y
                for l in levels_np] for y in axes]
    for j in range(m):
        for ax in range(2):
            ms = metrics[ax]
            d0 = tree_min([ms[i] for i in range(1 << m)
                           if not patterns_np[i][j]])
            d1 = tree_min([ms[i] for i in range(1 << m)
                           if patterns_np[i][j]])
            planes.append((d0 - d1) * inv)
    # interleave to [I0 Q0 I1 Q1 ...] per symbol
    llr = jnp.stack(planes, axis=-1)  # (..., S, Qm)
    return llr.reshape(symbols.shape[:-1] + (symbols.shape[-1] * qm,)).astype(
        jnp.float32
    )


def demodulate_hard(mod: str, symbols: jnp.ndarray) -> jnp.ndarray:
    """Hard decisions via max-log LLR sign."""
    return (demodulate_soft(mod, symbols) > 0).astype(jnp.int8)
