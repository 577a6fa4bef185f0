"""NR carrier/slot grid and DMRS generation (TS 38.211).

Counterpart of the reference's NR common PHY (`lib/src/phy/common/
phy_common_nr.c`) and NR DMRS (`lib/src/phy/ch_estimation/dmrs_sch.c`,
`dmrs_pdcch.c`, `dmrs_pbch.c`): numerology/slot math, the type-1 DMRS
comb mapping for PDSCH/PUSCH mapping type A, and the per-symbol Gold
sequence seeds.

One slot = 14 OFDM symbols (normal CP); the compute grid is
(batch, 14, 12*N_RB) complex64, batched over slots — the framework replaces
the reference's per-slot worker threads with a batch dimension.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np

import jax.numpy as jnp

from srsran_4g_tpu.ops import sequence

NRE = 12
NSYMB = 14


@dataclass(frozen=True)
class NrCarrierConfig:
    nof_prb: int = 52           # e.g. 10 MHz at 15 kHz SCS
    pci: int = 1                # physical cell id (0..1007)
    scs_khz: int = 15           # 15/30/60/120 (mu = log2(scs/15))
    cp: str = "normal"

    @property
    def mu(self) -> int:
        return {15: 0, 30: 1, 60: 2, 120: 3}[self.scs_khz]

    @property
    def nre(self) -> int:
        return self.nof_prb * NRE

    @property
    def slots_per_frame(self) -> int:
        return 10 << self.mu

    @property
    def symbol_sz(self) -> int:
        n = 128
        while n < self.nre:
            n *= 2
        return n


def dmrs_cinit(slot: int, symbol: int, n_id: int, n_scid: int = 0) -> int:
    """38.211 7.4.1.1.1 c_init for PDSCH/PUSCH DMRS."""
    return ((1 << 17) * (NSYMB * slot + symbol + 1) * (2 * n_id + 1)
            + 2 * n_id + n_scid) % (1 << 31)


@functools.lru_cache(maxsize=512)
def dmrs_symbols_type1(nof_prb: int, slot: int, symbol: int,
                       n_id: int) -> np.ndarray:
    """Type-1 DMRS QPSK sequence for one symbol over nof_prb PRBs
    (comb-2: 6 RE per PRB)."""
    m = 6 * nof_prb
    c = sequence.gold_sequence_np(dmrs_cinit(slot, symbol, n_id), 2 * m)
    c = c.astype(np.float32)  # uint8 would wrap under 1 - 2*c
    r = ((1 - 2 * c[0::2]) + 1j * (1 - 2 * c[1::2])) / np.sqrt(2)
    return r.astype(np.complex64)


def dmrs_re_indices_type1(nof_prb: int, delta: int = 0) -> np.ndarray:
    """Subcarrier indices of type-1 DMRS (comb 2, CDM group delta)."""
    return (2 * np.arange(6 * nof_prb) + delta).astype(np.int32)


def put_dmrs_type1(grid: jnp.ndarray, cfg: NrCarrierConfig, slot: int,
                   dmrs_syms: tuple[int, ...] = (2, 11)) -> jnp.ndarray:
    """Insert type-1 DMRS into (B, 14, nre) slot grid."""
    ks = jnp.asarray(dmrs_re_indices_type1(cfg.nof_prb))
    for l in dmrs_syms:
        r = jnp.asarray(dmrs_symbols_type1(cfg.nof_prb, slot, l, cfg.pci))
        grid = grid.at[:, l, ks].set(r)
    return grid


def data_re_indices_type1(cfg: NrCarrierConfig,
                          dmrs_syms: tuple[int, ...] = (2, 11),
                          start_sym: int = 1,
                          nof_syms: int = 13,
                          rb_start: int = 0,
                          nof_rb: int | None = None) -> np.ndarray:
    """Flat (symbol*nre + k) indices of PDSCH data REs in a slot with
    type-1 DMRS symbols fully reserved (no data on DMRS symbols).

    rb_start/nof_rb restrict the frequency-domain allocation (type-1 RA
    from DCI 1_0/0_0 RIV); default is the full carrier."""
    nof_rb = cfg.nof_prb - rb_start if nof_rb is None else nof_rb
    k0, k1 = rb_start * 12, (rb_start + nof_rb) * 12
    idx = []
    for l in range(start_sym, start_sym + nof_syms):
        if l in dmrs_syms:
            continue
        idx.extend(l * cfg.nre + k for k in range(k0, k1))
    return np.asarray(idx, dtype=np.int32)
