"""Short linear block codes for UCI: (20, A) and (32, O) Reed-Muller.

TS 36.212 §5.2.3.3 (PUCCH format 2 CQI) and §5.2.2.6.4 ((32, O) for UCI on
PUSCH).  Counterpart of the reference's `lib/src/phy/fec/block/block.c` and
the RM(20,A) encoder in `lib/src/phy/phch/uci.c`.  Basis matrices are spec
tables (utils/uci_tables.npz).

Decoding is brute-force max-likelihood: correlate the LLRs against all 2^A
codewords — one (B, N) × (N, 2^A) matmul, exact ML for A ≤ 13.
"""

from __future__ import annotations

import functools
import os

import jax.numpy as jnp
import numpy as np

_NPZ = os.path.join(os.path.dirname(__file__), "..", "utils", "uci_tables.npz")


@functools.lru_cache(maxsize=1)
def _tables():
    with np.load(os.path.abspath(_NPZ)) as z:
        return {k: z[k] for k in z.files}


def _basis(n: int) -> np.ndarray:
    return _tables()["rm20_basis" if n == 20 else "rm32_basis"]


@functools.lru_cache(maxsize=64)
def codebook(n: int, a: int) -> np.ndarray:
    """(2^A, N) all codewords as ±1 floats (+1 ⇔ bit 0)."""
    basis = _basis(n)[:, :a]  # (N, A)
    words = np.arange(1 << a)
    msgs = ((words[:, None] >> np.arange(a)) & 1).astype(np.int64)  # (2^A, A)
    cw = (msgs @ basis.T) % 2
    return (1.0 - 2.0 * cw).astype(np.float32)


def encode(bits: jnp.ndarray, n: int) -> jnp.ndarray:
    """(B, A) info bits → (B, N) coded bits (A ≤ 13 for N=20, ≤ 11 for 32)."""
    a = bits.shape[-1]
    basis = jnp.asarray(_basis(n)[:, :a], jnp.float32)
    acc = jnp.dot(bits.astype(jnp.float32), basis.T,
                  preferred_element_type=jnp.float32)
    return (acc.astype(jnp.int32) & 1).astype(jnp.int8)


def decode(llrs: jnp.ndarray, n: int, a: int) -> tuple[jnp.ndarray, jnp.ndarray]:
    """ML decode (B, N) LLRs (positive ⇒ bit 1) → ((B, A) bits, (B,) metric)."""
    cb = jnp.asarray(codebook(n, a))  # (2^A, N), +1 ⇔ bit 0
    corr = jnp.einsum("bn,cn->bc", -llrs.astype(jnp.float32), cb)
    best = jnp.argmax(corr, axis=-1)
    bits = ((best[:, None] >> jnp.arange(a)) & 1).astype(jnp.int8)
    metric = jnp.max(corr, axis=-1)
    return bits, metric
