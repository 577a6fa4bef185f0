"""Turbo rate matching / dematching with HARQ soft-combining, TS 36.212 §5.1.4.1.

Counterpart of the reference's `lib/src/phy/fec/turbo/rm_turbo.c`, which
precomputes giant deinterleaver LUTs (rm_turbo.c:79-100) and soft-combines
with SIMD adds.  Same idea, batch-shaped:

- All the sub-block interleaving, bit collection and bit selection logic is
  folded into **one host-precomputed index vector per (K, rv, E, Ncb)**
  mapping each transmitted position e → a flat index into the (3, K+4)
  d-streams.  Cached per config, device-resident after first use.
- Encoding is then a single gather; dematching is a single `scatter-add`
  into the (3, K+4) LLR soft-buffer, which *is* the HARQ combining
  (repetitions accumulate; retransmissions with different rv add into the
  same buffer passed back in).
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np

from srsran_4g_tpu.utils.constants import RM_PERM_TC

_NCOLS = 32


@functools.lru_cache(maxsize=1024)
def _w_to_d_index(k: int, n_filler: int = 0) -> np.ndarray:
    """Map circular-buffer position → flat index into d (3, K+4), -1 = NULL.

    Implements the §5.1.4.1.1 sub-block interleavers and §5.1.4.1.2 bit
    collection for stream length D = K+4.  Filler bits (first ``n_filler``
    positions of the systematic and parity-1 streams, TS 36.212 §5.1.3.2.1)
    are additional NULLs, never transmitted.
    """
    d = k + 4
    rows = (d + _NCOLS - 1) // _NCOLS
    kp = rows * _NCOLS
    nd = kp - d  # dummy NULLs prepended

    # position y_idx[i] = index into the d-stream (or -1 for NULL padding)
    y = np.full(kp, -1, dtype=np.int64)
    y[nd:] = np.arange(d)
    y01 = y.copy()
    if n_filler:
        y01[nd:nd + n_filler] = -1  # fillers NULL in streams 0 and 1 only

    # streams 0/1: write row-major into R x 32, permute columns, read col-major
    mat = y01.reshape(rows, _NCOLS)
    v01 = mat[:, RM_PERM_TC].T.reshape(-1)  # column-major read-out

    # stream 2: v2[idx] = y[pi(idx)], pi(idx) = (P[idx // R] + 32*(idx % R) + 1) % Kp
    idx = np.arange(kp)
    pi = (RM_PERM_TC[idx // rows] + _NCOLS * (idx % rows) + 1) % kp
    v2 = y[pi]

    # bit collection: w = [v0 | interlace(v1, v2)]
    w = np.empty(3 * kp, dtype=np.int64)
    w[:kp] = np.where(v01 >= 0, v01, -1)  # stream 0 flat index = pos
    inter = np.empty(2 * kp, dtype=np.int64)
    inter[0::2] = np.where(v01 >= 0, d + v01, -1)  # stream 1
    inter[1::2] = np.where(v2 >= 0, 2 * d + v2, -1)  # stream 2
    w[kp:] = inter
    return w


def _rv_start(k: int, rv: int, ncb: int) -> int:
    d = k + 4
    rows = (d + _NCOLS - 1) // _NCOLS
    return rows * (2 * ((ncb + 8 * rows - 1) // (8 * rows)) * rv + 2)


@functools.lru_cache(maxsize=4096)
def rm_indices(
    k: int, rv: int, e: int, ncb: int | None = None, n_filler: int = 0
) -> np.ndarray:
    """Gather indices g (E,) into flat d (3*(K+4),) for one transmission.

    out[j] = d_flat[g[j]] reproduces the reference's
    `srsran_rm_turbo_tx_lut`; the same indices drive the dematching
    scatter-add.
    """
    w = _w_to_d_index(k, n_filler)
    kw = w.shape[0]
    if ncb is None:
        ncb = kw
    k0 = _rv_start(k, rv, ncb)
    # valid (non-NULL) positions of the circular buffer, in ring order from k0
    ring = (k0 + np.arange(ncb)) % ncb
    valid = ring[w[ring] >= 0]
    n_valid = valid.shape[0]
    reps = (e + n_valid - 1) // n_valid
    sel = np.tile(valid, reps)[:e]
    return w[sel]


def rate_match(
    d: jnp.ndarray, k: int, rv: int, e: int, n_filler: int = 0
) -> jnp.ndarray:
    """d (B, 3, K+4) bits → (B, E) rate-matched bits."""
    g = jnp.asarray(rm_indices(k, rv, e, n_filler=n_filler))
    flat = d.reshape(d.shape[:-2] + (3 * (k + 4),))
    return flat[..., g]


@functools.lru_cache(maxsize=1024)
def conv_rm_indices(n: int, e: int) -> np.ndarray:
    """Rate-matching gather for convolutionally-coded channels
    (TS 36.212 §5.1.4.2, reference rm_conv.c): indices (E,) into the flat
    (3*N,) d-streams."""
    from srsran_4g_tpu.utils.constants import RM_PERM_CC

    rows = (n + _NCOLS - 1) // _NCOLS
    kp = rows * _NCOLS
    nd = kp - n
    y = np.full(kp, -1, dtype=np.int64)
    y[nd:] = np.arange(n)
    v = y.reshape(rows, _NCOLS)[:, RM_PERM_CC].T.reshape(-1)
    w = np.concatenate([np.where(v >= 0, s * n + v, -1) for s in range(3)])
    valid = w[w >= 0]
    reps = (e + valid.shape[0] - 1) // valid.shape[0]
    return np.tile(valid, reps)[:e]


def conv_rate_match(d: jnp.ndarray, e: int) -> jnp.ndarray:
    """d (B, 3, N) bits → (B, E)."""
    n = d.shape[-1]
    g = jnp.asarray(conv_rm_indices(n, e))
    return d.reshape(d.shape[:-2] + (3 * n,))[..., g]


def conv_rate_dematch(e_llr: jnp.ndarray, n: int) -> jnp.ndarray:
    """(B, E) LLRs → (B, 3, N) combined d-stream LLRs."""
    e = e_llr.shape[-1]
    g = jnp.asarray(conv_rm_indices(n, e))
    batch = e_llr.shape[:-1]
    flat = jnp.zeros(batch + (3 * n,), dtype=jnp.float32)
    flat = flat.at[..., g].add(e_llr.astype(jnp.float32))
    return flat.reshape(batch + (3, n))


def rate_dematch(
    e_llr: jnp.ndarray,
    k: int,
    rv: int,
    softbuffer: jnp.ndarray | None = None,
    n_filler: int = 0,
) -> jnp.ndarray:
    """Soft-combine received LLRs into the d-stream soft-buffer.

    Args:
      e_llr: (B, E) float32 LLRs of one transmission.
      softbuffer: (B, 3, K+4) accumulated LLRs from previous transmissions
        (HARQ), or None for a fresh buffer.

    Returns:
      (B, 3, K+4) combined LLRs — feed straight into ops.turbo.turbo_decode.
    """
    e = e_llr.shape[-1]
    g = jnp.asarray(rm_indices(k, rv, e, n_filler=n_filler))
    batch = e_llr.shape[:-1]
    if softbuffer is None:
        flat = jnp.zeros(batch + (3 * (k + 4),), dtype=jnp.float32)
    else:
        flat = softbuffer.reshape(batch + (3 * (k + 4),)).astype(jnp.float32)
    flat = flat.at[..., g].add(e_llr.astype(jnp.float32))
    return flat.reshape(batch + (3, k + 4))
