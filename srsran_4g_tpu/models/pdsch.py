"""PDSCH physical channel: encode (eNB side) and decode (UE side).

Counterpart of the reference's `lib/src/phy/phch/pdsch.c`
(srsran_pdsch_encode :1017, srsran_pdsch_decode :788) composed with the
composite receivers `lib/src/phy/ue/ue_dl.c` / `lib/src/phy/enb/enb_dl.c`.

Chain (single codeword; TM2 SFBC for 2 ports, SFBC-FSTD for 4 ports):

  encode:  TB bits → DL-SCH (CRC/segment/turbo/rate-match) → scramble →
           modulate → RE-map into the resource grid (+ CRS insertion)
  decode:  grid → chest → RE-gather → equalise → soft demod → descramble →
           DL-SCH decode (dematch/HARQ/turbo/CRC)

Everything is batched over a leading subframe/UE dimension and jit-stable:
RE maps, scrambling sequences and interpolation matrices are host-cached
per static config.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import jax.numpy as jnp
import numpy as np

from srsran_4g_tpu.models import chest as chest_mod
from srsran_4g_tpu.models import equalizer
from srsran_4g_tpu.models import grid as G
from srsran_4g_tpu.models import sch
from srsran_4g_tpu.ops import modem, scrambling
from srsran_4g_tpu.utils.constants import BITS_PER_SYMBOL


@dataclass(frozen=True)
class PdschConfig:
    cell: G.CellConfig
    rnti: int
    subframe: int
    mod: str  # "qpsk" | "16qam" | "64qam" | "256qam"
    tbs: int
    rv: int = 0
    prb_alloc: tuple[int, ...] | None = None  # None = full band
    codeword: int = 0

    @functools.cached_property
    def re_indices(self) -> np.ndarray:
        return G.pdsch_re_indices(self.cell, self.subframe, self.prb_alloc)

    @property
    def nof_re(self) -> int:
        return int(self.re_indices.shape[0])

    @property
    def qm(self) -> int:
        return BITS_PER_SYMBOL[self.mod]

    @property
    def g_bits(self) -> int:
        return self.nof_re * self.qm

    @functools.cached_property
    def plan(self) -> sch.DlschPlan:
        return sch.dlsch_plan(self.tbs, self.g_bits, self.qm, self.rv)

    @functools.cached_property
    def scramble_seq(self) -> np.ndarray:
        from srsran_4g_tpu.ops.sequence import gold_sequence_np

        cinit = scrambling.pdsch_cinit(
            self.rnti, self.codeword, self.subframe, self.cell.cell_id
        )
        return gold_sequence_np(cinit, self.g_bits)


def encode(cfg: PdschConfig, tb_bits: jnp.ndarray) -> jnp.ndarray:
    """TB bits (B, tbs) → resource grid with PDSCH REs set.

    Returns (B, nsymb, nre) for 1 port, (B, P, nsymb, nre) for 2/4 ports
    (TM2 SFBC / SFBC-FSTD transmit diversity, TS 36.211 §6.3.4.3).
    """
    cw = sch.dlsch_encode(cfg.plan, tb_bits)
    seq = jnp.asarray(cfg.scramble_seq)
    scr = scrambling.scramble_bits(cw, seq)
    syms = modem.modulate(cfg.mod, scr)  # (B, nof_re)
    b = tb_bits.shape[0]
    idx = jnp.asarray(cfg.re_indices)
    if cfg.cell.nof_ports == 1:
        flat = jnp.zeros((b, cfg.cell.nsymb * cfg.cell.nre), dtype=jnp.complex64)
        flat = flat.at[:, idx].set(syms)
        return flat.reshape(b, cfg.cell.nsymb, cfg.cell.nre)
    s = jnp.sqrt(2.0).astype(jnp.complex64)
    if cfg.cell.nof_ports == 2:
        x0 = syms[:, 0::2]
        x1 = syms[:, 1::2]
        p0 = jnp.stack([x0, x1], axis=-1).reshape(b, -1) / s
        p1 = jnp.stack([-jnp.conj(x1), jnp.conj(x0)], axis=-1).reshape(b, -1) / s
        flat = jnp.zeros((b, 2, cfg.cell.nsymb * cfg.cell.nre),
                         dtype=jnp.complex64)
        flat = flat.at[:, 0, idx].set(p0)
        flat = flat.at[:, 1, idx].set(p1)
        return flat.reshape(b, 2, cfg.cell.nsymb, cfg.cell.nre)
    assert cfg.cell.nof_ports == 4, "1, 2 or 4 ports supported"
    # SFBC-FSTD (precoding.c:1961): Alamouti pairs on ports (0,2) for REs
    # (4i, 4i+1) and ports (1,3) for REs (4i+2, 4i+3)
    pad = (-syms.shape[1]) % 4
    sp = jnp.pad(syms, ((0, 0), (0, pad)))
    x0, x1, x2, x3 = (sp[:, i::4] for i in range(4))
    zero = jnp.zeros_like(x0)
    p0 = jnp.stack([x0, x1, zero, zero], axis=-1).reshape(b, -1) / s
    p1 = jnp.stack([zero, zero, x2, x3], axis=-1).reshape(b, -1) / s
    p2 = jnp.stack([-jnp.conj(x1), jnp.conj(x0), zero, zero],
                   axis=-1).reshape(b, -1) / s
    p3 = jnp.stack([zero, zero, -jnp.conj(x3), jnp.conj(x2)],
                   axis=-1).reshape(b, -1) / s
    n = syms.shape[1]
    flat = jnp.zeros((b, 4, cfg.cell.nsymb * cfg.cell.nre), dtype=jnp.complex64)
    for p, vals in enumerate((p0, p1, p2, p3)):
        flat = flat.at[:, p, idx].set(vals[:, :n])
    return flat.reshape(b, 4, cfg.cell.nsymb, cfg.cell.nre)


def add_crs(cfg: PdschConfig, grid_tx: jnp.ndarray, port: int = 0) -> jnp.ndarray:
    """Insert cell reference signals into a TX grid (enb_dl.c put_refs).

    For multi-port grids (B, P, nsymb, nre), each port gets its own CRS and
    zeros on the other ports' CRS REs (already guaranteed by the reserved
    mask in the RE mapping).
    """
    cell = cfg.cell
    g = jnp.asarray(grid_tx)
    if g.ndim >= 3 and cell.nof_ports >= 2 and g.shape[-3] == cell.nof_ports:
        for p in range(cell.nof_ports):
            syms, scs = G.crs_pattern(cell, p)
            vals = jnp.asarray(G.crs_values(cell, p, cfg.subframe))
            g = g.at[..., p, jnp.asarray(syms)[:, None], jnp.asarray(scs)].set(vals)
        return g
    syms, scs = G.crs_pattern(cell, port)
    vals = jnp.asarray(G.crs_values(cell, port, cfg.subframe))
    return g.at[..., jnp.asarray(syms)[:, None], jnp.asarray(scs)].set(vals)


def demap(
    cfg: PdschConfig,
    rx_grid: jnp.ndarray,
    h: jnp.ndarray | None = None,
    noise_var: jnp.ndarray | float | None = None,
    chest_cfg: chest_mod.ChestConfig | None = None,
) -> dict:
    """Receiver front end: grid → equalised symbols → codeword LLRs.

    If ``h``/``noise_var`` are not given, they are estimated from the CRS
    (srsran_ue_dl_decode_fft_estimate path, ue_dl.c:349).

    Returns dict(x (B, nof_re) equalised symbols, llr (B, G) descrambled
    LLRs, h, noise_var, snr_db?).
    """
    out: dict = {}
    n_ports = cfg.cell.nof_ports
    if h is None or noise_var is None:
        ccfg = chest_cfg or chest_mod.ChestConfig(cell=cfg.cell)
        ests = [chest_mod.estimate(ccfg, rx_grid, cfg.subframe, port=p)
                for p in range(n_ports)]
        if n_ports > 1:
            if h is None:
                h = jnp.stack([e["h"] for e in ests], axis=1)
            if noise_var is None:
                noise_var = sum(e["noise_var"] for e in ests) / n_ports
        else:
            h = ests[0]["h"] if h is None else h
            noise_var = (ests[0]["noise_var"] if noise_var is None
                         else noise_var)
        out["snr_db"] = ests[0]["snr_db"]

    idx = jnp.asarray(cfg.re_indices)
    b = rx_grid.shape[0]
    y = rx_grid.reshape(b, -1)[:, idx]
    if n_ports == 2:
        h0 = h[:, 0].reshape(b, -1)[:, idx]
        h1 = h[:, 1].reshape(b, -1)[:, idx]
        x, eff_nv = equalizer.alamouti_decode_2x1(y, h0, h1, noise_var)
    elif n_ports == 4:
        h_re = h.reshape(b, 4, -1)[..., idx]
        pad = (-y.shape[-1]) % 4
        yp = jnp.pad(y, ((0, 0), (0, pad)))
        hp = jnp.pad(h_re, ((0, 0), (0, 0), (0, pad)),
                     constant_values=1.0)
        x, eff_nv = equalizer.sfbc_fstd_decode_4x1(yp, hp, noise_var)
        x, eff_nv = x[..., :y.shape[-1]], eff_nv[..., :y.shape[-1]]
    else:
        h_re = h.reshape(b, -1)[:, idx]
        x, eff_nv = equalizer.equalize_single(y, h_re, noise_var)

    # per-RE CSI-scaled LLRs: demod divides by the effective noise variance
    llr_scr = modem.demodulate_soft(cfg.mod, x, eff_nv)
    llr = scrambling.descramble_llrs(
        llr_scr.reshape(b, cfg.g_bits), jnp.asarray(cfg.scramble_seq)
    )
    out.update(x=x, llr=llr, h=h, noise_var=noise_var)
    return out


def decode(
    cfg: PdschConfig,
    rx_grid: jnp.ndarray,
    h: jnp.ndarray | None = None,
    noise_var: jnp.ndarray | float | None = None,
    softbuffers: dict | None = None,
    n_iter: int = 5,
    chest_cfg: chest_mod.ChestConfig | None = None,
    cb_shard: tuple[str, int] | None = None,
) -> dict:
    """Decode PDSCH from a received resource grid (`demap` + DL-SCH).

    Returns dict(bits, crc_ok, softbuffers, h, noise_var, snr_db?).
    """
    out = demap(cfg, rx_grid, h, noise_var, chest_cfg)
    del out["x"]
    bits, ok, soft = sch.dlsch_decode(
        cfg.plan, out.pop("llr"), softbuffers=softbuffers, n_iter=n_iter,
        cb_shard=cb_shard,
    )
    out.update(bits=bits, crc_ok=ok, softbuffers=soft)
    return out
