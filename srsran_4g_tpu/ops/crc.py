"""CRC attachment/checking as GF(2) linear algebra, TS 36.212 §5.1.1.

The reference computes CRCs with byte-wise LUT stepping
(lib/src/phy/fec/crc.c).  Here we instead exploit that a zero-initialised
CRC is a *linear* function of the message bits over GF(2):

    crc(m) = m @ G  (mod 2)

where row i of G is the CRC of a unit impulse at bit position i.  G is
precomputed once per (message length, polynomial) on the host and cached; the
device-side computation is then a single f32 matmul followed by a
parity reduction — ideal for checking whole batches of code blocks at once.
f32 accumulation is exact up to 2^24 contributions, far above the largest LTE
transport block (~392k bits).

Supported polynomials: CRC24A/24B (transport/code block), CRC16, CRC8
(see utils/constants.CRC_POLYS).
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np

from srsran_4g_tpu.utils.constants import CRC_POLYS


@functools.lru_cache(maxsize=64)
def _unit_crcs(n_bits: int, poly_key: str) -> np.ndarray:
    """CRC remainder of x^(order + j) mod g for j = 0..n_bits-1.

    Row j corresponds to a unit impulse j bits from the *end* of the message.
    Returned as (n_bits, order) uint8, LSB of the remainder in column 0.
    """
    poly, order = CRC_POLYS[poly_key]
    g = poly  # includes x^order term
    r = 1 << order  # x^order, to be reduced
    out = np.empty((n_bits, order), dtype=np.uint8)
    rem = r
    # reduce x^order once
    if rem >> order:
        rem ^= g
    for j in range(n_bits):
        out[j] = (rem >> np.arange(order)) & 1
        rem <<= 1
        if rem >> order:
            rem ^= g
    return out


@functools.lru_cache(maxsize=64)
def crc_matrix(n_bits: int, poly_key: str) -> np.ndarray:
    """G matrix (n_bits, order) uint8: crc(m) = m @ G mod 2, MSB-first bits.

    m[0] is the first (highest-order) message bit, matching the reference's
    MSB-first byte convention.  Column c is CRC bit of weight 2^(order-1-c),
    i.e. the CRC is appended MSB-first as well (TS 36.212 p_0..p_L-1).
    """
    units = _unit_crcs(n_bits, poly_key)  # row j = impulse j from end
    order = CRC_POLYS[poly_key][1]
    # message bit i is (n_bits-1-i) bits from the end
    g = units[::-1].copy()  # (n_bits, order), LSB-first columns
    # reorder columns to MSB-first parity bits
    return g[:, ::-1].copy()


def crc_np(bits: np.ndarray, poly_key: str) -> np.ndarray:
    """Host CRC of MSB-first bit array (..., N) → (..., order) parity bits."""
    n = bits.shape[-1]
    g = crc_matrix(n, poly_key).astype(np.int64)
    return (bits.astype(np.int64) @ g) % 2


def crc_attach_np(bits: np.ndarray, poly_key: str) -> np.ndarray:
    return np.concatenate([bits, crc_np(bits, poly_key).astype(bits.dtype)], axis=-1)


def crc_compute(bits: jnp.ndarray, poly_key: str) -> jnp.ndarray:
    """Device CRC: bits (..., N) int/float 0-1 → (..., order) int8 parity."""
    n = bits.shape[-1]
    g = jnp.asarray(crc_matrix(n, poly_key), dtype=jnp.float32)
    # exact at any matmul precision: 0/1 operands are exact in TF32 and
    # bf16, and the f32 accumulator holds the integer sums (<= n < 2^24)
    acc = jnp.dot(bits.astype(jnp.float32), g, preferred_element_type=jnp.float32)
    return (acc.astype(jnp.int32) & 1).astype(jnp.int8)


def crc_check(bits_with_crc: jnp.ndarray, poly_key: str) -> jnp.ndarray:
    """Check trailing CRC; returns boolean (...,) — True = CRC OK.

    Implemented as: CRC of the *entire* message incl. parity is zero.
    """
    n = bits_with_crc.shape[-1]
    g = jnp.asarray(crc_matrix(n, poly_key), dtype=jnp.float32)
    acc = jnp.dot(  # exact at any precision, as in crc_compute
        bits_with_crc.astype(jnp.float32), g, preferred_element_type=jnp.float32
    )
    rem = acc.astype(jnp.int32) & 1
    return jnp.all(rem == 0, axis=-1)
