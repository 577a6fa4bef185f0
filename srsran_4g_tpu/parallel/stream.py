"""Sharded sample-stream operators with halo exchange between devices.

The reference's streaming mechanisms — ring buffers, FFT overlap-save
convolution (`lib/src/phy/utils/convolution.c`, `channel/fading.c`), and
CP-strided FFT plans (`dft/ofdm.c:172-207`) — become, on a device mesh,
*time-block sharding*: each device owns a contiguous chunk of the IQ sample
stream and exchanges only the block-boundary samples (filter tails, CP- and
symbol-spanning regions) with its ring neighbor via `jax.lax.ppermute`
(neighbour exchange over the device interconnect).  These functions are meant to run inside
`shard_map` with the sample axis sharded over the named mesh axis.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from srsran_4g_tpu.ops.ofdm import OfdmConfig, _gather_index, _sc_to_bin, _window_phase


def left_halo(x: jnp.ndarray, n: int, axis_name: str) -> jnp.ndarray:
    """Fetch the last ``n`` samples of the left ring neighbor's chunk.

    x: (..., chunk) local shard.  Returns (..., n): for shard 0 the halo is
    zeros (stream start).
    """
    size = jax.lax.axis_size(axis_name)
    idx = jax.lax.axis_index(axis_name)
    tail = x[..., -n:]
    perm = [(i, (i + 1) % size) for i in range(size)]
    halo = jax.lax.ppermute(tail, axis_name, perm)
    return jnp.where(idx == 0, jnp.zeros_like(halo), halo)


def fir_filter_sharded(
    x: jnp.ndarray, taps: jnp.ndarray, axis_name: str
) -> jnp.ndarray:
    """Causal FIR convolution of a time-block-sharded stream (overlap-save).

    Each shard holds (..., chunk) contiguous samples; the first len(taps)-1
    output samples of a chunk need the previous chunk's tail, which arrives
    from the ring neighbor over the device interconnect instead of living in a host ring buffer.
    """
    ntaps = taps.shape[-1]
    halo = left_halo(x, ntaps - 1, axis_name)
    ext = jnp.concatenate([halo, x], axis=-1)  # (..., chunk + ntaps - 1)
    # dense small-tap convolution: sum_k taps[k] * ext[n + ntaps-1 - k]
    out = jnp.zeros_like(x)
    for k in range(ntaps):
        out = out + taps[k] * ext[..., ntaps - 1 - k: ntaps - 1 - k + x.shape[-1]]
    return out


def ofdm_demodulate_sharded(
    cfg: OfdmConfig, samples_local: jnp.ndarray, axis_name: str
) -> jnp.ndarray:
    """OFDM-demodulate a subframe whose sample axis is sharded over
    ``axis_name`` into equal contiguous chunks.

    Symbols whose body starts inside the local chunk are demodulated
    locally; bodies spanning the boundary use a right-neighbor halo of
    symbol_sz+CP samples fetched via ppermute.  The per-shard symbol grids
    are summed over the axis (each symbol produced by exactly one shard)
    via psum — on hardware this rides the device interconnect.

    Returns the full (..., nsymb, nre) grid, replicated over the axis.
    """
    size = jax.lax.axis_size(axis_name)
    idx = jax.lax.axis_index(axis_name)
    chunk = samples_local.shape[-1]
    sf = cfg.sf_len
    assert chunk * size == sf or size == 1, (chunk, size, sf)

    if size > 1:
        assert chunk >= cfg.symbol_sz, (
            "stream shards must hold at least one FFT body", chunk, cfg.symbol_sz)

    # right halo: first H samples of the right neighbor
    h = min(cfg.symbol_sz + cfg.cp_len(0), chunk)
    head = samples_local[..., :h]
    perm = [(i, (i - 1) % size) for i in range(size)]
    halo = jax.lax.ppermute(head, axis_name, perm)
    ext = jnp.concatenate([samples_local, halo], axis=-1)

    gidx = _gather_index(cfg)  # (nsymb, symbol_sz) global offsets
    starts = gidx[:, 0]
    owner = np.minimum(starts // chunk, size - 1) if size > 1 else np.zeros_like(starts)
    # clip to the local+halo extent: out-of-range rows belong to other
    # shards and are masked out below
    local_idx = np.clip(gidx - (owner[:, None] * chunk), 0, chunk + h - 1)

    syms = ext[..., jnp.asarray(local_idx)]  # (..., nsymb, symbol_sz)
    n = cfg.symbol_sz
    freq = jnp.fft.fft(syms, axis=-1).astype(jnp.complex64) / jnp.sqrt(
        jnp.asarray(n, jnp.float32)
    ).astype(jnp.complex64)
    grid = freq[..., jnp.asarray(_sc_to_bin(cfg))]
    ramp = _window_phase(cfg)
    if ramp is not None:
        grid = grid * jnp.asarray(ramp)
    mine = (jnp.asarray(owner) == idx)[:, None]
    grid = jnp.where(mine, grid, jnp.zeros_like(grid))
    return jax.lax.psum(grid, axis_name)
