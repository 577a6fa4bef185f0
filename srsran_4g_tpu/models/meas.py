"""Neighbour-cell search and measurement + UL power control.

Counterparts of the reference's
`srsue/src/phy/scell/scell_recv.cc` (find_cells: per-N_ID_2 PSS search
with peak-to-RMS thresholding, SSS confirmation),
`srsue/src/phy/scell/intra_measure_lte.cc` +
`lib/src/phy/sync/refsignal_dl_sync.c` (CRS-based RSRP/RSRQ/CFO
measurement of a known PCI on the serving frequency), and
`lib/src/phy/ue/ue_ul.c:354-433` (srsran_ue_ul_pusch_power /
pucch_power / srs_power — TS 36.213 §5.1 open-loop + accumulated
closed-loop TPC).

Batch-first: the neighbour search correlates all three PSS roots in one
batched FFT matched filter (sync.find_pss already computes the (B,3,N)
correlation surface — here we keep the per-root peaks instead of the
argmax), and CRS measurement is a gather + mean over the pilot lattice.
Power control is host-side scalar math (it feeds the radio, not the
graph).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import jax.numpy as jnp
import numpy as np

from srsran_4g_tpu.models import grid as G, sync, ue_dl
from srsran_4g_tpu.ops.ofdm import OfdmConfig, demodulate
from srsran_4g_tpu.ops.zadoff_chu import pss_sequence

PSS_THRESHOLD = 2.0  # peak/RMS, scell_recv.cc:53


# --- neighbour-cell search (scell_recv.find_cells) ----------------------------

def find_neighbour_cells(samples: jnp.ndarray, nof_prb: int,
                         serving_cell_id: int | None = None,
                         threshold: float = PSS_THRESHOLD) -> list[dict]:
    """Search a capture (B=1, N) for neighbour cells: per-N_ID_2 PSS
    peaks above `threshold` (peak/RMS of the correlation surface), each
    confirmed and completed by SSS.

    Returns a list of dicts (cell_id, n_id_2, offset, peak_ratio, phase),
    excluding `serving_cell_id`."""
    cfg = OfdmConfig(nof_prb=nof_prb)
    n = cfg.symbol_sz
    found = sync.find_pss(samples, n)
    corr = found["corr"]  # (B, 3, N)
    cells: list[dict] = []
    corr_np = np.asarray(corr)
    for n_id_2 in range(3):
        c = corr_np[0, n_id_2]
        peak_idx = int(np.argmax(c))
        rms = float(np.sqrt(np.mean(c ** 2)) + 1e-12)
        ratio = float(c[peak_idx]) / rms
        if ratio < threshold:
            continue
        off = jnp.asarray([peak_idx])
        cfo = sync.pss_cfo_estimate(
            jnp.take_along_axis(samples, off[..., None] + jnp.arange(n),
                                axis=-1),
            jnp.asarray([n_id_2]), n)
        corrected = sync.cfo_correct(samples, cfo, n)
        sf = ue_dl.align_subframe(corrected, off, cfg)
        g = demodulate(cfg, sf)
        nsy = cfg.nsymb_slot
        mid = cfg.nre // 2
        pss_re = g[..., nsy - 1, mid - 31:mid + 31]
        h_pss = pss_re * jnp.conj(jnp.asarray(pss_sequence(n_id_2)))
        sss_re = g[..., nsy - 2, mid - 31:mid + 31]
        sss_eq = sss_re * jnp.conj(h_pss) / jnp.maximum(
            jnp.abs(h_pss) ** 2, 1e-9)
        out = sync.sss_detect(sss_eq, n_id_2)
        # SSS confirmation (scell_recv's sss threshold): the winning
        # hypothesis must stand out from the 336-candidate noise floor
        sss_corr = np.abs(np.asarray(out["corr"])[0])
        sss_ratio = float(sss_corr.max()) / float(sss_corr.mean() + 1e-12)
        if sss_ratio < 3.0:
            continue
        cell_id = 3 * int(np.asarray(out["n_id_1"])[0]) + n_id_2
        if cell_id == serving_cell_id:
            continue
        cells.append(dict(cell_id=cell_id, n_id_2=n_id_2, offset=peak_idx,
                          peak_ratio=ratio,
                          phase=int(np.asarray(out["phase"])[0]),
                          cfo=float(np.asarray(cfo)[0])))
    return sorted(cells, key=lambda c: -c["peak_ratio"])


# --- CRS-based cell measurement (intra_measure / refsignal_dl_sync) ----------

def measure_cell(rx_grid: jnp.ndarray, cell: G.CellConfig,
                 subframe: int) -> dict:
    """RSRP / RSSI / RSRQ / SNR / CFO of a known PCI from one aligned
    subframe grid (B, 14, nre) — TS 36.214 §5.1.1/5.1.3 definitions.

    CFO is estimated from the CRS phase rotation between the two slots
    (refsignal_dl_sync.c's CFO path, 0.5 ms apart ⇒ ±1 kHz unambiguous).
    """
    ls, ks = G.crs_pattern(cell, 0)
    vals = jnp.asarray(G.crs_values(cell, 0, subframe))
    y = rx_grid[..., jnp.asarray(ls)[:, None], jnp.asarray(ks)]
    h_ls = y * jnp.conj(vals)  # (B, S, P)

    rsrp = jnp.mean(jnp.abs(jnp.mean(h_ls, axis=-1)) ** 2, axis=-1)
    # RSSI per TS 36.214: total power over CRS-bearing symbols, whole band
    rssi_sym = jnp.mean(
        jnp.abs(rx_grid[..., jnp.asarray(ls), :]) ** 2, axis=(-1, -2))
    rssi = rssi_sym * cell.nre
    rsrq = cell.nof_prb * rsrp / jnp.maximum(rssi, 1e-12)

    # noise: residual after removing the per-symbol mean channel
    resid = h_ls - jnp.mean(h_ls, axis=-1, keepdims=True)
    noise = jnp.mean(jnp.abs(resid) ** 2, axis=(-1, -2))
    snr_db = 10.0 * jnp.log10(jnp.maximum(rsrp, 1e-12)
                              / jnp.maximum(noise, 1e-12))

    # CFO from slot-0 ↔ slot-1 CRS phase drift (symbols 0 and 7)
    half = len(ls) // 2
    z = jnp.sum(h_ls[..., half:, :] * jnp.conj(h_ls[..., :half, :]),
                axis=(-1, -2))
    cfo_hz = jnp.angle(z) / (2.0 * np.pi * 0.5e-3)

    return dict(
        rsrp=rsrp.astype(jnp.float32),
        rsrp_dbfs=10.0 * jnp.log10(jnp.maximum(rsrp, 1e-12)),
        rssi=rssi.astype(jnp.float32),
        rsrq_db=10.0 * jnp.log10(jnp.maximum(rsrq, 1e-12)),
        snr_db=snr_db.astype(jnp.float32),
        cfo_hz=cfo_hz.astype(jnp.float32),
    )


# --- UL power control (TS 36.213 §5.1, ue_ul.c:354-433) -----------------------

PC_MAX_DBM = 23.0  # class-3 UE


@dataclass
class PowerCtrlConfig:
    p0_nominal_pusch: float = -85.0
    p0_ue_pusch: float = 0.0
    alpha: float = 0.8
    p0_nominal_pucch: float = -107.0
    p0_ue_pucch: float = 0.0
    delta_f_pucch: tuple = (0.0, 0.0, 1.0, 0.0, 0.0)  # F1,F1a/b,F2,F2a,F2b
    delta_preamble_msg3: float = 6.0
    p_srs_offset: float = 0.0
    accumulation_enabled: bool = True


@dataclass
class PowerCtrlState:
    """Closed-loop accumulators f(i)/g(i) driven by TPC commands."""
    cfg: PowerCtrlConfig = field(default_factory=PowerCtrlConfig)
    f_pusch: float = 0.0
    g_pucch: float = 0.0

    TPC_DB = {0: -1.0, 1: 0.0, 2: 1.0, 3: 3.0}

    def apply_tpc_pusch(self, tpc: int) -> None:
        d = self.TPC_DB[tpc]
        self.f_pusch = self.f_pusch + d if self.cfg.accumulation_enabled else d

    def apply_tpc_pucch(self, tpc: int) -> None:
        self.g_pucch += self.TPC_DB[tpc]

    def pusch_power(self, n_prb: int, pathloss_db: float,
                    p0_preamble: float | None = None) -> float:
        """P_PUSCH = min(Pcmax, 10log10(M) + P0 + α·PL + f) — 36.213
        5.1.1.1; msg3 uses preamble P0 + delta_preamble_msg3 and α=1."""
        if p0_preamble is not None:
            p0 = p0_preamble + self.cfg.delta_preamble_msg3
            alpha = 1.0
        else:
            p0 = self.cfg.p0_nominal_pusch + self.cfg.p0_ue_pusch
            alpha = self.cfg.alpha
        p = 10.0 * np.log10(n_prb) + p0 + alpha * pathloss_db + self.f_pusch
        return float(min(PC_MAX_DBM, p))

    def pucch_power(self, pathloss_db: float, fmt: str = "1",
                    n_cqi: int = 0, n_harq: int = 0) -> float:
        """P_PUCCH = min(Pcmax, P0 + PL + h(n) + ΔF + g) — 36.213 5.1.2.1."""
        fmt_idx = {"1": 0, "1a": 1, "1b": 1, "2": 2, "2a": 3, "2b": 4}[fmt]
        delta_f = self.cfg.delta_f_pucch[fmt_idx]
        if fmt in ("1", "1a", "1b"):
            h = 0.0
        else:
            h = 10.0 * np.log10(n_cqi / 4.0) if n_cqi >= 4 else 0.0
        p0 = self.cfg.p0_nominal_pucch + self.cfg.p0_ue_pucch
        p = p0 + pathloss_db + h + delta_f + self.g_pucch
        return float(min(PC_MAX_DBM, p))

    def srs_power(self, n_prb: int, pathloss_db: float) -> float:
        """P_SRS = min(Pcmax, P_SRS_OFFSET + 10log10(M) + P0 + α·PL + f)."""
        p0 = self.cfg.p0_nominal_pusch + self.cfg.p0_ue_pusch
        p = (self.cfg.p_srs_offset + 10.0 * np.log10(n_prb) + p0
             + self.cfg.alpha * pathloss_db + self.f_pusch)
        return float(min(PC_MAX_DBM, p))
