"""NR polar code: construction, encoder, SC decoder, TS 38.212 §5.3.1.

Counterpart of the reference's `lib/src/phy/fec/polar/` (code construction
`polar_code.c`, scalar/AVX2 encoders, SSC decoders).  Design:

- encoder: the generator F^{⊗n} butterfly — log2(N) fully vectorised XOR
  stages over (B, N) tensors;
- decoder: batched successive cancellation; per decoded bit, the path
  LLR block is recomputed top-down with the f (min-sum) / g updates and
  the left-sibling partial sums re-encoded from the already-decided bits —
  every tensor is static-shape and the whole batch (e.g. all PDCCH blind
  candidates) advances in lock-step through one `lax.fori_loop`;
- construction: NR universal reliability sequence (mother-code tables,
  spec data in utils/polar_tables.npz) → frozen set for (K, N).

The reference's SSC tree pruning is a CPU latency optimisation; on the accelerator the
batch dimension supplies the parallelism, so plain SC with a static
schedule is simpler and fully vectorised.
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np


@functools.lru_cache(maxsize=1)
def _tables():
    path = os.path.join(os.path.dirname(__file__), "..", "utils",
                        "polar_tables.npz")
    with np.load(os.path.abspath(path)) as f:
        return {k: f[k] for k in f.files}


@functools.lru_cache(maxsize=64)
def frozen_mask(k: int, n_log: int) -> np.ndarray:
    """(N,) bool — True where the bit is frozen (not information)."""
    n = 1 << n_log
    mother = _tables()[f"mother_{n_log}"]
    mask = np.ones(n, dtype=bool)
    mask[mother[n - k:]] = False  # most reliable K positions carry info
    return mask


def encode(u: jnp.ndarray) -> jnp.ndarray:
    """Polar transform x = u · F^{⊗n} (natural bit order): (..., N)."""
    n = u.shape[-1]
    x = u.astype(jnp.int32)
    stage = 1
    while stage < n:
        xr = x.reshape(x.shape[:-1] + (n // (2 * stage), 2, stage))
        upper = xr[..., 0, :] ^ xr[..., 1, :]
        x = jnp.stack([upper, xr[..., 1, :]], axis=-2).reshape(x.shape)
        stage *= 2
    return x.astype(jnp.int8)


def encode_info(bits: jnp.ndarray, n_log: int) -> jnp.ndarray:
    """Place K info bits into the reliable positions and encode."""
    k = bits.shape[-1]
    n = 1 << n_log
    mask = frozen_mask(k, n_log)
    info_pos = np.nonzero(~mask)[0]
    u = jnp.zeros(bits.shape[:-1] + (n,), jnp.int32)
    u = u.at[..., jnp.asarray(info_pos)].set(bits.astype(jnp.int32))
    return encode(u)


def _f(a, b):
    """Check-node combine (min-sum)."""
    return jnp.sign(a) * jnp.sign(b) * jnp.minimum(jnp.abs(a), jnp.abs(b))


def _g(a, b, u):
    return b + (1.0 - 2.0 * u) * a


def decode_masked(llrs: jnp.ndarray, mask_np) -> jnp.ndarray:
    """Batched SC decode with an explicit frozen mask; returns the full
    decided u vector (B, N) — used by the 38.212-exact layer
    (ops/polar_3gpp.py) whose frozen sets depend on (K, E)."""
    n = int(np.asarray(mask_np).shape[0])
    n_log = int(np.log2(n))
    return _sc_decode(llrs, jnp.asarray(np.asarray(mask_np)), n, n_log)


def decode(llrs: jnp.ndarray, k: int, n_log: int) -> jnp.ndarray:
    """Batched successive-cancellation decode.

    Args:
      llrs: (B, N) float32, positive ⇒ bit 1 (framework convention).
    Returns:
      (B, K) info bits.
    """
    n = 1 << n_log
    b = llrs.shape[0]
    mask = jnp.asarray(frozen_mask(k, n_log))
    out_u = _sc_decode(llrs, mask, n, n_log)
    info_pos = np.nonzero(~np.asarray(frozen_mask(k, n_log)))[0]
    return out_u[:, jnp.asarray(info_pos)].astype(jnp.int8)


def _sc_decode(llrs: jnp.ndarray, mask: jnp.ndarray, n: int,
               n_log: int) -> jnp.ndarray:
    b = llrs.shape[0]
    chan = -llrs.astype(jnp.float32)  # internal: positive ⇒ bit 0

    def body(i, out_u):
        block = chan  # path block at stage 0, size n
        for s in range(1, n_log + 1):
            m = n >> (s - 1)
            half = m >> 1
            a = block[:, :half]
            bb = block[:, half:m]
            branch = (i >> (n_log - s)) & 1
            parent_start = (i >> (n_log - s + 1)) << (n_log - s + 1)
            # left-sibling partial sums: re-encode the decided bits of the
            # parent block's left half
            u_left = jax.lax.dynamic_slice(out_u, (0, parent_start), (b, half))
            u_enc = encode(u_left).astype(jnp.float32) if half > 1 else \
                u_left.astype(jnp.float32)
            block = jnp.where(branch == 0, _f(a, bb), _g(a, bb, u_enc))
        llr_i = block[:, 0]
        u_i = jnp.where(mask[i], 0, (llr_i < 0).astype(jnp.int32))
        return out_u.at[:, i].set(u_i)

    return jax.lax.fori_loop(0, n, body, jnp.zeros((b, n), jnp.int32))
