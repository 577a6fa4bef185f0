"""Sharded end-to-end PHY pipeline over a (dp, sp) mesh.

This is the framework's "training step" analog: a full
encode → channel → receive → decode round per subframe batch, compiled as a
single SPMD program with `shard_map`:

- transport blocks are sharded over ``dp`` (subframe/UE data parallelism —
  the batched answer to the reference's pipelined sf_workers, SURVEY.md §2.7);
- the IQ sample stream of every subframe is sharded over ``sp`` in
  contiguous time blocks; the fading FIR's tail and symbol-spanning samples
  cross chips via `ppermute` halos (parallel/stream.py), the per-symbol
  grids are reassembled with a `psum` — all device-to-device collectives;
- BLER/bit counters are `psum`-reduced over the whole mesh.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from srsran_4g_tpu.channel.awgn import awgn
from srsran_4g_tpu.models import pdsch as pdsch_mod
from srsran_4g_tpu.ops import ofdm as ofdm_mod
from srsran_4g_tpu.parallel import stream


def make_pipeline_step(
    cfg: pdsch_mod.PdschConfig,
    mesh: Mesh,
    snr_db: float = 20.0,
    fir_taps: int = 9,
    n_iter: int = 4,
):
    """Build a jitted sharded pipeline step.

    Returns step(tb_bits (B, tbs), key) → dict of psum'd metrics.  B must be
    divisible by the ``dp`` axis size; the subframe sample stream must be
    divisible by ``sp``.
    """
    ofdm_cfg = ofdm_mod.OfdmConfig(nof_prb=cfg.cell.nof_prb)
    sp = mesh.shape["sp"]
    assert ofdm_cfg.sf_len % sp == 0

    noise_var = float(10.0 ** (-snr_db / 10.0))
    # short static low-pass-ish channel (unit-energy random taps per build)
    import numpy as np

    rng = np.random.default_rng(1234)
    taps = rng.standard_normal(fir_taps) + 1j * rng.standard_normal(fir_taps)
    taps[0] += 3.0 * np.sqrt(fir_taps)  # strong LOS tap keeps it equalisable
    taps = (taps / np.linalg.norm(taps)).astype(np.complex64)
    taps_j = jnp.asarray(taps)

    def local_step(tb_bits, key):
        # ---- TX (dp-sharded batch, replicated over sp) --------------------
        tx_grid = pdsch_mod.add_crs(cfg, pdsch_mod.encode(cfg, tb_bits))
        samples = ofdm_mod.modulate(ofdm_cfg, tx_grid)  # (b_loc, sf_len)

        # ---- channel: sp-sharded time blocks with halo exchange -------
        chunk = ofdm_cfg.sf_len // sp
        sp_idx = jax.lax.axis_index("sp")
        local = jax.lax.dynamic_slice_in_dim(samples, sp_idx * chunk, chunk, -1)
        faded = stream.fir_filter_sharded(local, taps_j, "sp")
        key = jax.random.fold_in(key, sp_idx)
        noisy = awgn(key, faded, noise_var)

        # ---- RX: sharded OFDM demod reassembles the grid over sp ----------
        rx_grid = stream.ofdm_demodulate_sharded(ofdm_cfg, noisy, "sp")

        # the dominant turbo decode splits its code-block lanes over sp
        # (all_gather'd back), so no chip decodes redundantly
        out = pdsch_mod.decode(cfg, rx_grid, n_iter=n_iter,
                               cb_shard=("sp", sp) if sp > 1 else None)

        bit_err = jnp.sum(out["bits"] != tb_bits) / sp  # sp-replicated
        blocks_ok = jnp.sum(out["crc_ok"]) / sp
        blocks = jnp.asarray(tb_bits.shape[0] / sp, jnp.float32)
        stats = jnp.stack(
            [bit_err.astype(jnp.float32), blocks_ok.astype(jnp.float32), blocks]
        )
        stats = jax.lax.psum(stats, ("dp", "sp"))
        return {
            "bit_errors": stats[0],
            "blocks_ok": stats[1],
            "blocks": stats[2],
            "bler": 1.0 - stats[1] / stats[2],
        }

    step = shard_map(
        local_step,
        mesh=mesh,
        in_specs=(P("dp", None), P()),
        out_specs=P(),
        check_vma=False,
    )
    return jax.jit(step)


def shard_batch(mesh: Mesh, x):
    """Place a host batch with dp sharding on the mesh."""
    return jax.device_put(x, NamedSharding(mesh, P("dp")))
