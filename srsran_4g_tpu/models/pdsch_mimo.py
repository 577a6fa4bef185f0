"""PDSCH spatial multiplexing: TM3 (open-loop CDD) / TM4 (closed-loop)
2×2 with two codewords — the reference's headline throughput mode
("150 Mbps 20 MHz MIMO TM3/TM4", debian/man/srsue.txt:17).

Counterpart of `lib/src/phy/phch/pdsch.c` encode/decode at rank 2 with
`lib/src/phy/mimo/precoding.c` (srsran_precoding_multiplex /
srsran_predecoding_type) and dual-codeword `srsran_dlsch_decode2`
(sch.c:580).  Composition:

  encode: per-codeword DL-SCH → scramble(q) → modulate → layer map →
          codebook/CDD precode → per-port RE map (+ per-port CRS)
  decode: per (rx, port) CRS chest → effective channel H·W (TM4) or
          H·W·D(i)·U (TM3, per-RE cycling) → batched 2×2 MMSE →
          layer demap → per-codeword soft demod/descramble/DL-SCH

Everything batched over subframes; the 2×2 solves are the closed-form
elementwise kernels in `models/mimo.py`.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import jax.numpy as jnp
import numpy as np

from srsran_4g_tpu.models import chest as chest_mod
from srsran_4g_tpu.models import grid as G
from srsran_4g_tpu.models import mimo, pdsch, sch
from srsran_4g_tpu.ops import modem, scrambling


@dataclass(frozen=True)
class PdschMimoConfig:
    cell: G.CellConfig  # nof_ports must be 2
    rnti: int
    subframe: int
    mod0: str
    tbs0: int
    mod1: str
    tbs1: int
    tm: str = "tm4"  # "tm3" (CDD) | "tm4" (codebook)
    pmi: int = 0     # TM4 rank-2 codebook index (0..2)
    rv0: int = 0
    rv1: int = 0
    prb_alloc: tuple[int, ...] | None = None

    @functools.cached_property
    def cw(self) -> tuple[pdsch.PdschConfig, pdsch.PdschConfig]:
        return (
            pdsch.PdschConfig(cell=self.cell, rnti=self.rnti,
                              subframe=self.subframe, mod=self.mod0,
                              tbs=self.tbs0, rv=self.rv0,
                              prb_alloc=self.prb_alloc, codeword=0),
            pdsch.PdschConfig(cell=self.cell, rnti=self.rnti,
                              subframe=self.subframe, mod=self.mod1,
                              tbs=self.tbs1, rv=self.rv1,
                              prb_alloc=self.prb_alloc, codeword=1),
        )


def _modulated_cw(cfg: pdsch.PdschConfig, tb_bits: jnp.ndarray) -> jnp.ndarray:
    cwb = sch.dlsch_encode(cfg.plan, tb_bits)
    scr = scrambling.scramble_bits(cwb, jnp.asarray(cfg.scramble_seq))
    return modem.modulate(cfg.mod, scr)  # (B, nof_re)


def encode(cfg: PdschMimoConfig, tb0: jnp.ndarray,
           tb1: jnp.ndarray) -> jnp.ndarray:
    """Two TBs → (B, 2, nsymb, nre) port grids (no CRS; use pdsch.add_crs)."""
    assert cfg.cell.nof_ports == 2
    c0, c1 = cfg.cw
    d0 = _modulated_cw(c0, tb0)
    d1 = _modulated_cw(c1, tb1)
    layers = mimo.layer_map([d0, d1], 2)  # (B, 2, S)
    if cfg.tm == "tm3":
        ports = mimo.cdd_precode_2x2(layers)
    else:
        ports = mimo.precode_2x2(layers, cfg.pmi)
    b = ports.shape[0]
    idx = jnp.asarray(c0.re_indices)
    flat = jnp.zeros((b, 2, cfg.cell.nsymb * cfg.cell.nre), jnp.complex64)
    for p in range(2):
        flat = flat.at[:, p, idx].set(ports[:, p])
    return flat.reshape(b, 2, cfg.cell.nsymb, cfg.cell.nre)


def _effective_channel(cfg: PdschMimoConfig, h: jnp.ndarray) -> jnp.ndarray:
    """(B, rx2, tx2, S) physical channel → (B, rx2, layer2, S) effective
    channel including the TX precoding."""
    if cfg.tm == "tm4":
        w = jnp.asarray(mimo._CODEBOOK_2TX_R2[cfg.pmi])  # (2, 2)
        return jnp.einsum("brts,tl->brls", h, w, precision=mimo._F32)
    # TM3: W0 · D(i) · U with D(i) = diag(1, e^{-jπ i}) per RE counter i
    s = h.shape[-1]
    u = jnp.asarray(np.array([[1, 1], [1, -1]], np.complex64) / np.sqrt(2))
    d1 = jnp.exp(-1j * jnp.pi * jnp.arange(s)).astype(jnp.complex64)
    w0 = jnp.asarray(mimo._CODEBOOK_2TX_R2[0])
    # build W(i) = W0 · D(i) · U explicitly: (tx, layer, S)
    wdi = jnp.stack([
        jnp.stack([w0[0, 0] * u[0, 0] + w0[0, 1] * d1 * u[1, 0],
                   w0[0, 0] * u[0, 1] + w0[0, 1] * d1 * u[1, 1]], axis=0),
        jnp.stack([w0[1, 0] * u[0, 0] + w0[1, 1] * d1 * u[1, 0],
                   w0[1, 0] * u[0, 1] + w0[1, 1] * d1 * u[1, 1]], axis=0),
    ], axis=0)  # (tx, layer, S)
    return jnp.einsum("brts,tls->brls", h, wdi, precision=mimo._F32)


def demap(cfg: PdschMimoConfig, rx_grids: jnp.ndarray,
          h: jnp.ndarray | None = None,
          noise_var: jnp.ndarray | float | None = None) -> dict:
    """Receiver front end for both codewords from 2 RX antennas.

    Args:
      rx_grids: (B, 2, nsymb, nre) received grids (2 RX antennas).
      h: optional (B, 2rx, 2tx, nsymb, nre); estimated from per-port CRS
        on each antenna when absent.

    Returns dict(x (B, 2, S) MMSE layer estimates, llr0/llr1 (B, G)
    descrambled codeword LLRs, h, noise_var).
    """
    c0, c1 = cfg.cw
    b = rx_grids.shape[0]
    if h is None or noise_var is None:
        ccfg = chest_mod.ChestConfig(cell=cfg.cell)
        hs, nvs = [], []
        for r in range(2):
            row = []
            for p in range(2):
                est = chest_mod.estimate(ccfg, rx_grids[:, r], cfg.subframe,
                                         port=p)
                row.append(est["h"])
                nvs.append(est["noise_var"])
            hs.append(jnp.stack(row, axis=1))
        if h is None:
            h = jnp.stack(hs, axis=1)  # (B, rx, tx, nsymb, nre)
        if noise_var is None:
            noise_var = sum(nvs) / len(nvs)

    idx = jnp.asarray(c0.re_indices)
    y = rx_grids.reshape(b, 2, -1)[..., idx]            # (B, 2, S)
    h_re = h.reshape(b, 2, 2, -1)[..., idx]             # (B, 2, 2, S)
    h_eff = _effective_channel(cfg, h_re)
    nv = jnp.asarray(noise_var, jnp.float32)
    if nv.ndim == 1:  # per-batch estimate -> broadcast over REs
        nv = nv[:, None]
    xh, env = mimo.mmse_detect_2x2(y, h_eff, nv)
    out: dict = dict(x=xh, h=h, noise_var=noise_var)
    for q, (cfg_q, mod_q) in enumerate(((c0, cfg.mod0), (c1, cfg.mod1))):
        llr = modem.demodulate_soft(mod_q, xh[:, q], env[:, q])
        out[f"llr{q}"] = scrambling.descramble_llrs(
            llr.reshape(b, cfg_q.g_bits), jnp.asarray(cfg_q.scramble_seq))
    return out


def decode(cfg: PdschMimoConfig, rx_grids: jnp.ndarray,
           h: jnp.ndarray | None = None,
           noise_var: jnp.ndarray | float | None = None,
           n_iter: int = 5) -> dict:
    """Decode both codewords from 2 RX antennas (`demap` + DL-SCH).

    Returns dict(bits0, bits1, crc_ok0, crc_ok1, h, noise_var).
    """
    c0, c1 = cfg.cw
    b = rx_grids.shape[0]
    fe = demap(cfg, rx_grids, h, noise_var)
    out: dict = dict(h=fe["h"], noise_var=fe["noise_var"])
    if c0.plan == c1.plan:
        # same transport format on both codewords: fold them into ONE
        # DL-SCH decode at 2x batch, so one wider turbo batch fills the
        # decoder's lanes instead of a second decoder thread
        # (pdsch.c:81,402, SURVEY P4)
        both = jnp.concatenate([fe["llr0"], fe["llr1"]], axis=0)  # (2B, G)
        bits, ok, _ = sch.dlsch_decode(c0.plan, both, n_iter=n_iter)
        out["bits0"], out["bits1"] = bits[:b], bits[b:]
        out["crc_ok0"], out["crc_ok1"] = ok[:b], ok[b:]
        return out
    for q, cfg_q in enumerate((c0, c1)):
        bits, ok, _ = sch.dlsch_decode(cfg_q.plan, fe[f"llr{q}"],
                                       n_iter=n_iter)
        out[f"bits{q}"] = bits
        out[f"crc_ok{q}"] = ok
    return out
