"""Gold (pseudo-random) sequence generation, TS 36.211 §7.2.

The LTE scrambling/pilot sequence c(n) is the XOR of two 31-bit LFSRs:

    x1(n+31) = x1(n+3) + x1(n)                      (mod 2)
    x2(n+31) = x2(n+3) + x2(n+2) + x2(n+1) + x2(n)  (mod 2)
    c(n)     = x1(n + Nc) + x2(n + Nc),  Nc = 1600

x1 is seeded with 1, x2 with ``c_init``.  The reference implements this with
28-bit-parallel register stepping and a precomputed per-seed-bit superposition
of the Nc fast-forward (lib/src/phy/common/sequence.c:48-170).  We use the
same two ideas, batch-style:

- the Nc fast-forward is a *linear* map of the seed over GF(2), so the
  advanced x2 state is the XOR of 31 precomputed basis states selected by the
  seed bits (``x2_init_after_nc``) — on device this is a masked XOR-reduce;
- sequence bits are produced 28 at a time from the 31-bit register state,
  either in NumPy (host precompute, cached) or inside a ``lax.scan`` for
  fully-jitted on-device generation with traced ``c_init``.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from srsran_4g_tpu.utils.constants import GOLD_SEQ_NC

_MASK31 = (1 << 31) - 1
_PAR_BITS = 28  # max parallel step: 31 - (max shift 3)


def _step_x1_par(state: int) -> int:
    """Advance x1 register by 28 positions (bit i of state = x1(n+i))."""
    new = ((state >> 3) ^ state) & ((1 << _PAR_BITS) - 1)
    return ((state >> _PAR_BITS) | (new << 3)) & _MASK31


def _step_x2_par(state: int) -> int:
    new = ((state >> 3) ^ (state >> 2) ^ (state >> 1) ^ state) & ((1 << _PAR_BITS) - 1)
    return ((state >> _PAR_BITS) | (new << 3)) & _MASK31


def _step_x1_single(state: int) -> int:
    b = ((state >> 3) ^ state) & 1
    return ((state >> 1) | (b << 30)) & _MASK31


def _step_x2_single(state: int) -> int:
    b = ((state >> 3) ^ (state >> 2) ^ (state >> 1) ^ state) & 1
    return ((state >> 1) | (b << 30)) & _MASK31


@functools.lru_cache(maxsize=1)
def _x1_state_after_nc() -> int:
    s = 1
    for _ in range(GOLD_SEQ_NC):
        s = _step_x1_single(s)
    return s


@functools.lru_cache(maxsize=1)
def _x2_basis_after_nc() -> np.ndarray:
    """x2 state after Nc steps for each single-bit seed (GF(2) basis)."""
    basis = np.zeros(31, dtype=np.uint32)
    for i in range(31):
        s = 1 << i
        for _ in range(GOLD_SEQ_NC):
            s = _step_x2_single(s)
        basis[i] = s
    return basis


def x2_init_after_nc(c_init: int) -> int:
    """x2 register state at n = Nc for a given seed (host path)."""
    basis = _x2_basis_after_nc()
    s = 0
    for i in range(31):
        if (c_init >> i) & 1:
            s ^= int(basis[i])
    return s


@functools.lru_cache(maxsize=4096)
def gold_sequence_np(c_init: int, length: int) -> np.ndarray:
    """Gold sequence bits c(0..length-1) as uint8 ndarray (host, cached)."""
    s1 = _x1_state_after_nc()
    s2 = x2_init_after_nc(c_init)
    nchunks = (length + _PAR_BITS - 1) // _PAR_BITS
    out = np.empty(nchunks * _PAR_BITS, dtype=np.uint8)
    mask = (1 << _PAR_BITS) - 1
    for i in range(nchunks):
        c = (s1 ^ s2) & mask
        # little-endian bit unpack of the 28 low bits
        out[i * _PAR_BITS:(i + 1) * _PAR_BITS] = (
            (c >> np.arange(_PAR_BITS, dtype=np.uint32)) & 1
        ).astype(np.uint8)
        s1 = _step_x1_par(s1)
        s2 = _step_x2_par(s2)
    return out[:length]


# --- device path ------------------------------------------------------------


def _step_par_jnp(state: jnp.ndarray, taps_shift: tuple[int, ...]) -> tuple:
    """One 28-bit-parallel step; returns (new_state, 28 emitted bits)."""
    new = state
    acc = state
    for sh in taps_shift:
        acc = acc ^ (state >> sh)
    newbits = acc & ((1 << _PAR_BITS) - 1)
    new = ((state >> _PAR_BITS) | (newbits << 3)) & _MASK31
    return new


def gold_sequence(c_init: jnp.ndarray, length: int) -> jnp.ndarray:
    """Gold sequence generated on device under jit.

    Args:
      c_init: int32/uint32 scalar or (...,) batch of seeds (traced OK).
      length: static sequence length.

    Returns:
      uint8 bits of shape ``c_init.shape + (length,)``.
    """
    c_init = jnp.asarray(c_init, dtype=jnp.uint32)
    batch_shape = c_init.shape

    basis = jnp.asarray(_x2_basis_after_nc(), dtype=jnp.uint32)  # (31,)
    bits_of_seed = (c_init[..., None] >> jnp.arange(31, dtype=jnp.uint32)) & 1
    s2 = jnp.bitwise_xor.reduce(
        jnp.where(bits_of_seed.astype(bool), basis, jnp.uint32(0)), axis=-1
    )
    s1 = jnp.full(batch_shape, _x1_state_after_nc(), dtype=jnp.uint32)

    nchunks = (length + _PAR_BITS - 1) // _PAR_BITS
    par_mask = jnp.uint32((1 << _PAR_BITS) - 1)
    m31 = jnp.uint32(_MASK31)

    def step(carry, _):
        s1, s2 = carry
        c = (s1 ^ s2) & par_mask
        n1 = ((s1 >> 3) ^ s1) & par_mask
        s1n = ((s1 >> _PAR_BITS) | (n1 << 3)) & m31
        n2 = ((s2 >> 3) ^ (s2 >> 2) ^ (s2 >> 1) ^ s2) & par_mask
        s2n = ((s2 >> _PAR_BITS) | (n2 << 3)) & m31
        return (s1n, s2n), c

    _, chunks = jax.lax.scan(step, (s1, s2), None, length=nchunks)
    # chunks: (nchunks, ...batch) uint32 → bits (..., nchunks*28)
    chunks = jnp.moveaxis(chunks, 0, -1)
    shifts = jnp.arange(_PAR_BITS, dtype=jnp.uint32)
    bits = (chunks[..., None] >> shifts) & 1
    bits = bits.reshape(batch_shape + (nchunks * _PAR_BITS,))
    return bits[..., :length].astype(jnp.uint8)
