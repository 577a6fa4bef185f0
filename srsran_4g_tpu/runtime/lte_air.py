"""LTE air interface: scheduler-driven subframes over the jitted accelerator PHY.

This is the glue the reference implements in `srsenb/src/phy/lte/cc_worker.cc`
(encode_pdsch:596 + PDCCH put) and `srsue/src/phy/lte/cc_worker.cc`
(work_dl_regular:214 → decode_pdcch:259 → decode_pdsch:442, work_ul:600):
every grant travels over the air as a DCI on PDCCH, the UE blind-decodes
its search space every TTI, HARQ-ACK/SR/CQI ride PUCCH, and UL data rides
PUSCH — nothing is handed between the nodes out-of-band.

Each distinct (config, subframe)-shaped step is jitted once and cached;
subframe composition sums disjoint-RE grids (PDSCH allocations, PUCCH
resources, PUSCH allocations never overlap by scheduler construction).
Every method takes the real subframe index (tti % 10), so scrambling,
CRS phase and the PDCCH search-space Yk recursion are exercised at all
ten indices with a bounded (10-entry per config) jit cache; DL_SF/UL_SF
remain only as defaults for single-subframe harnesses.

PUCCH resource derivation follows 36.213 §10.1: the HARQ-ACK format-1a
index is the first CCE of the scheduling PDCCH; SR and CQI resources are
RRC-configured per UE (here: allocated at attach).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np

from srsran_4g_tpu.models import dci as dci_mod, pdcch as pdcch_mod
from srsran_4g_tpu.models import grid as G, pdsch as pdsch_mod
from srsran_4g_tpu.models import pucch as pucch_mod, pusch as pusch_mod
from srsran_4g_tpu.models import chest as chest_mod, prach as prach_mod
from srsran_4g_tpu.models import phich as phich_mod
from srsran_4g_tpu.models import ra
from srsran_4g_tpu.ops.ofdm import OfdmConfig, demodulate, modulate
from srsran_4g_tpu.stack import enb_mac as enb_mac_mod
from srsran_4g_tpu.utils import constants as C

DL_SF = 4   # default DL subframe index for single-subframe harnesses
UL_SF = 3   # default UL subframe index for single-subframe harnesses


@dataclass(frozen=True)
class UePucchRes:
    """RRC-configured PUCCH resources of one UE."""

    n_pucch_sr: int
    n_pucch_2: int     # CQI (format 2) resource index


class CchAllocator:
    """Per-TTI CCE allocation over the search spaces
    (sf_cch_allocator.cc): first non-colliding candidate wins."""

    def __init__(self, cell: G.CellConfig, cfi: int) -> None:
        self.cell = cell
        self.cfi = cfi
        self.n_cce = pdcch_mod.cce_re_indices(cell, cfi).shape[0]

    def alloc(self, rnti: int, used: set[int],
              min_l: int = 1, sf: int = DL_SF) -> tuple[int, int] | None:
        for l_agg, start in pdcch_mod.search_space_candidates(
                self.cell, self.cfi, rnti, sf):
            if l_agg < min_l:
                continue
            cces = set(range(start, start + l_agg))
            if not (cces & used):
                used |= cces
                return l_agg, start
        return None


def dci_to_pdsch_cfg(cell: G.CellConfig, rnti: int, d: dci_mod.Dci1A,
                     sf: int = DL_SF) -> pdsch_mod.PdschConfig:
    """Both sides derive the PDSCH parameters from the DCI alone
    (ra_dl.c: MCS→modulation/I_TBS→TBS)."""
    return pdsch_mod.PdschConfig(
        cell=cell, rnti=rnti, subframe=sf, mod=ra.dl_mcs_to_mod(d.mcs),
        tbs=ra.dl_tbs(d.mcs, d.l_crbs), rv=d.rv,
        prb_alloc=tuple(range(d.rb_start, d.rb_start + d.l_crbs)))


def dci_to_pdsch_mimo_cfg(cell: G.CellConfig, rnti: int, d, sf: int,
                          tm: int):
    """Format 2/2A → dual-codeword PDSCH parameters (both sides derive
    everything from the DCI: RBG bitmap → PRBs, per-codeword MCS → TBS;
    TM4 pinfo 1..2 = rank-2 codebook index, ra_dl.c srsran_ra_dl_dci_to_grant
    + precoding info table 36.212 5.3.3.1.5-4)."""
    from srsran_4g_tpu.models import pdsch_mimo

    prbs = ra.type0_alloc_to_prbs(d.rbg_bitmap, cell.nof_prb)
    return pdsch_mimo.PdschMimoConfig(
        cell=cell, rnti=rnti, subframe=sf,
        mod0=ra.dl_mcs_to_mod(d.mcs0), tbs0=ra.dl_tbs(d.mcs0, len(prbs)),
        mod1=ra.dl_mcs_to_mod(d.mcs1), tbs1=ra.dl_tbs(d.mcs1, len(prbs)),
        tm="tm4" if tm == 4 else "tm3",
        pmi=d.pinfo if tm == 4 else 0,
        rv0=d.rv0, rv1=d.rv1, prb_alloc=prbs)


def _ul_cfg(cell: G.CellConfig, rnti: int, prb_start: int, prb_len: int,
            mcs: int, rv: int = 0, sf: int = UL_SF) -> pusch_mod.PuschConfig:
    return pusch_mod.PuschConfig(
        cell=cell, rnti=rnti, subframe=sf, mod=ra.ul_mcs_to_mod(mcs),
        tbs=ra.tbs_from_itbs(ra.ul_mcs_to_itbs(mcs), prb_len),
        prb_start=prb_start, nof_prb_alloc=prb_len, rv=rv)


class LteAirPhy:
    """The jitted sample-domain channel both nodes share."""

    def __init__(self, nof_prb: int, cell_id: int = 1, cfi: int | None = None,
                 snr_db: float = 20.0, seed: int = 7,
                 fading=None, nof_ports: int = 1, nof_rx: int = 1,
                 frame_type: str = "fdd", ul_dl_config: int = 1,
                 ssf_config: int = 4) -> None:
        """`fading`: optional channel.fading.FadingConfig — applied (with
        independent DL/UL realisations) between the nodes, as the
        reference's channel emulator hooks into its rx/tx paths
        (srsue/src/phy/sync.cc:88-90).

        `nof_ports`/`nof_rx` = 2 selects the 2×2 MIMO air: the eNB
        assembles 2-port grids (SFBC control + CRS per port, TM3/TM4
        spatial-mux PDSCH), the DL channel is a fixed well-conditioned
        2×2 mix + AWGN, and the UE receives 2 antenna streams
        (enb.conf.example:17-31 `tm=3/4 nof_ports=2`).

        `frame_type="tdd"` selects frame structure type 2 with
        `ul_dl_config`/`ssf_config` (36.211 Table 4.2-2/-1): PSS moves
        to symbol 2 of the special subframes, SSS to the last symbol of
        sf 0/5, special subframes transmit only their DwPTS symbols, and
        the UL/PHICH/ACK timing helpers of models/tdd.py replace the FDD
        n+4 rule (phy_common.c:111 srsran_sfidx_tdd_type,
        harq_ack.c association sets)."""
        import jax

        self.jax = jax
        self.fading = fading
        self.seed = seed
        self.nof_ports = nof_ports
        self.nof_rx = nof_rx
        assert frame_type in ("fdd", "tdd")
        self.frame_type = frame_type
        self.ul_dl_config = ul_dl_config
        self.ssf_config = ssf_config
        assert (nof_ports, nof_rx) in ((1, 1), (2, 2))
        assert fading is None or nof_ports == 1, \
            "fading emulation is single-port only"
        assert frame_type == "fdd" or nof_ports == 1, \
            "the TDD air is single-port"
        if cfi is None:
            cfi = 3 if nof_prb <= 10 else 2
        self.cell = G.CellConfig(nof_prb=nof_prb, cell_id=cell_id, cfi=cfi,
                                 nof_ports=nof_ports, frame_type=frame_type)
        # fixed 2x2 DL mix (flat in frequency, constant over the run):
        # well-conditioned and with non-cancelling port sums so the
        # all-ports PSS/SSS transmission stays detectable on either antenna
        self.h_mix = np.array([[1.0 + 0.0j, 0.35 + 0.25j],
                               [-0.30 + 0.20j, 0.95 + 0.1j]], np.complex64)
        self.ofdm = OfdmConfig(nof_prb=nof_prb)
        self.cch = CchAllocator(self.cell, cfi)
        self.dci_len = dci_mod.format1a_len(nof_prb)
        from srsran_4g_tpu.channel.awgn import snr_to_noise_var

        self.nv = float(snr_to_noise_var(snr_db))
        self._key = jax.random.PRNGKey(seed)
        self._fns: dict = {}
        self.prach_cfg = prach_mod.PrachConfig(
            symbol_sz=C.symbol_sz(nof_prb), root_seq_index=0,
            zero_corr_zone=5)

    # -- utilities -----------------------------------------------------------

    def sf_kind(self, tti: int) -> str:
        """'D'/'S'/'U' for TDD; always 'D' on the FDD air."""
        if self.frame_type == "fdd":
            return "D"
        from srsran_4g_tpu.models import tdd

        return tdd.sf_type(self.ul_dl_config, tti % 10)

    def ack_k(self, tti: int) -> int:
        """HARQ-ACK delay for a PDSCH at `tti` (FDD: 4; TDD: the
        association-set k)."""
        if self.frame_type == "fdd":
            return 4
        from srsran_4g_tpu.models import tdd

        return tdd.ack_delay(self.ul_dl_config, tti % 10)

    def ul_k(self, tti: int) -> int | None:
        """PUSCH delay for an UL grant/RAR at `tti` (FDD: 4; TDD:
        Table 8-2 — None when this subframe carries no UL grants)."""
        if self.frame_type == "fdd":
            return 4
        from srsran_4g_tpu.models import tdd

        return tdd.ul_grant_delay(self.ul_dl_config, tti % 10)

    def phich_k(self, tti: int) -> int:
        """PHICH delay for a PUSCH at `tti` (FDD: 4)."""
        if self.frame_type == "fdd":
            return 4
        from srsran_4g_tpu.models import tdd

        return tdd.phich_delay(self.ul_dl_config, tti % 10)

    def cqi_due(self, tti: int) -> bool:
        """Periodic CQI occasion: the report must land on an UL subframe
        (FDD keeps the historical tti%%20==5; TDD config1 uses sf 2)."""
        if self.frame_type == "fdd":
            return tti % 20 == 5
        return tti % 20 == 2

    def key(self):
        self._key, k = self.jax.random.split(self._key)
        return k

    def _fn(self, k, builder):
        f = self._fns.get(k)
        if f is None:
            f = self._fns[k] = self.jax.jit(builder())
        return f

    def _bits(self, pdu: bytes, nbits: int) -> np.ndarray:
        b = np.unpackbits(np.frombuffer(pdu, np.uint8))[:nbits]
        return np.pad(b, (0, nbits - len(b))).astype(np.int8)[None]

    # -- eNB TX --------------------------------------------------------------

    def enb_dl_tx(self, items: list[tuple[pdsch_mod.PdschConfig | None, bytes,
                                          np.ndarray, int, int, int]],
                  sf: int = DL_SF,
                  phich: list[tuple[int, int, int]] | None = None,
                  mib: tuple[np.ndarray, int] | None = None,
                  tti: int = 0):
        """items: (cfg, pdu, dci_bits, rnti, l_agg, cce_start) → samples.

        cfg None = DCI-only item (UL grant: PDCCH but no PDSCH).
        `sf` is the subframe index (tti % 10); at sf 0/5 the sync
        signals (PSS/SSS, and PBCH at sf 0) are added so a UE can
        acquire the cell over the air.  `phich`: (group, nseq, ack)
        UL-HARQ indications to carry (phich.c counterpart).
        Returns noisy time-domain samples (1, sf_len) — or
        (1, nof_rx, sf_len) on the 2×2 MIMO air.

        On a 2-port cell an item's cfg may be a `PdschMimoConfig` with
        pdu = (pdu0, pdu1): the dual-codeword TM3/TM4 spatial multiplex
        (srsenb cc_worker encode_pdsch at rank 2).
        """
        from srsran_4g_tpu.models import pdsch_mimo

        jnp = self.jax.numpy
        grid = None
        for cfg, pdu, _, _, _, _ in items:
            if cfg is None:
                continue
            if isinstance(cfg, pdsch_mimo.PdschMimoConfig):
                enc = self._fn(("pdsch_mimo_enc", cfg), lambda cfg=cfg:
                               functools.partial(pdsch_mimo.encode, cfg))
                g = enc(jnp.asarray(self._bits(pdu[0], cfg.tbs0)),
                        jnp.asarray(self._bits(pdu[1], cfg.tbs1)))
            else:
                enc = self._fn(("pdsch_enc", cfg),
                               lambda cfg=cfg: functools.partial(
                                   pdsch_mod.encode, cfg))
                g = enc(jnp.asarray(self._bits(pdu, cfg.tbs)))
            grid = g if grid is None else grid + g

        def build_overhead():
            from srsran_4g_tpu.models import pcfich as pcfich_mod

            cell, cfi = self.cell, self.cell.cfi

            def f(g):
                ref_cfg = pdsch_mod.PdschConfig(
                    cell=cell, rnti=0, subframe=sf, mod="qpsk", tbs=16)
                g = pdsch_mod.add_crs(ref_cfg, g)
                cfi_arr = jnp.full((g.shape[0],), cfi, jnp.int32)
                return pcfich_mod.put_into_grid(
                    cell, g, pcfich_mod.encode(cell, cfi_arr, sf))
            return f

        if grid is None:
            shape = ((1, self.cell.nsymb, self.cell.nre)
                     if self.nof_ports == 1 else
                     (1, self.nof_ports, self.cell.nsymb, self.cell.nre))
            grid = jnp.zeros(shape, jnp.complex64)
        grid = self._fn(("overhead", sf), build_overhead)(grid)
        sync_sfs = (0, 5) if self.frame_type == "fdd" else (0, 1, 5, 6)
        if sf in sync_sfs:
            grid = self._fn(("sync", sf), self._build_sync(sf))(grid)
        if mib is not None and sf == 0:
            mib_bits, block = mib
            putb = self._fn(("pbch", block % 4), self._build_pbch(block % 4))
            grid = putb(grid, jnp.asarray(mib_bits[None]))
        for group, nseq, ack in (phich or []):
            put_ph = self._fn(
                ("phich", group, nseq, sf),
                lambda group=group, nseq=nseq: functools.partial(
                    self._phich_put, group=group, nseq=nseq, sf=sf))
            grid = put_ph(grid, jnp.asarray([ack], jnp.int8))

        for cfg, _, dci_bits, rnti, l_agg, cce_start in items:
            put = self._fn(
                ("dci_put", rnti, l_agg, cce_start, len(dci_bits), sf),
                lambda rnti=rnti, l_agg=l_agg, cce_start=cce_start:
                    functools.partial(pdcch_mod.put_dci, self.cell,
                                      self.cell.cfi, sf, rnti=rnti,
                                      l_agg=l_agg, cce_start=cce_start))
            grid = put(grid, dci_bits=jnp.asarray(dci_bits[None]))

        if self.frame_type == "tdd" and self.sf_kind(tti) == "S":
            # special subframe: only the DwPTS symbols transmit
            # (36.211 Table 4.2-1 via tdd.dl_symbol_mask)
            from srsran_4g_tpu.models import tdd as tdd_mod

            mask = tdd_mod.dl_symbol_mask(self.ul_dl_config,
                                          self.ssf_config, sf)
            dw = self._fn(("dwpts", sf), lambda: (
                lambda g: g * jnp.asarray(
                    mask.astype(np.float32))[:, None]))
            grid = dw(grid)
        chan = self._fn(("chan_dl",), lambda: self._build_channel(0))
        return chan(grid, jnp.asarray(float(tti) * 1e-3), self.key())

    def _build_channel(self, link: int):
        """grid → (fading) → OFDM → AWGN → samples; `link` decorrelates
        the DL (0) and UL (1) fading realisations.  On the 2×2 MIMO DL
        (link 0, nof_ports=2) the per-port sample streams pass through the
        fixed `h_mix` before per-antenna AWGN."""
        from srsran_4g_tpu.channel.awgn import awgn

        nv, cfg, fcfg = self.nv, self.ofdm, self.fading
        if link == 0 and self.nof_ports == 2:
            jnp = self.jax.numpy
            h = jnp.asarray(self.h_mix)

            def f(grid, t0, key):
                x = modulate(cfg, grid)            # (B, 2tx, sf_len)
                y = jnp.einsum("rt,bts->brs", h, x)
                return awgn(key, y, nv)
            return f
        if fcfg is None:
            def f(grid, t0, key):
                return awgn(key, modulate(cfg, grid), nv)
            return f
        from srsran_4g_tpu.channel import fading as fad
        from srsran_4g_tpu.ops import ofdm as ofdm_ops

        jnp = self.jax.numpy
        n = cfg.symbol_sz
        # per-symbol start times (s) within the subframe
        offs = ofdm_ops._symbol_offsets(cfg) / (cfg.sf_len / 1e-3) * 1e-3
        bins = ofdm_ops._sc_to_bin(cfg).astype(np.int64)
        signed = np.where(bins >= n // 2, bins - n, bins)
        sc_f = (signed / n).astype(np.float32)
        seed = self.seed * 2 + link

        def f(grid, t0, key):
            h = fad.freq_response(fcfg, seed, t0 + jnp.asarray(offs,
                                                               jnp.float32),
                                  jnp.asarray(sc_f))
            return awgn(key, modulate(cfg, grid * h[None]), nv)
        return f

    def _build_sync(self, sf: int):
        """PSS/SSS placement: FDD sf 0/5 (put_sync_signals); TDD SSS in
        the last symbol of sf 0/5 + PSS in symbol 2 of the special
        subframes 1/6 (put_sync_signals_tdd, 36.211 §6.11)."""
        from srsran_4g_tpu.models import enb_dl

        cell, tdd_air = self.cell, self.frame_type == "tdd"

        def build():
            def f(g):
                if tdd_air:
                    return enb_dl.put_sync_signals_tdd(cell, g, sf)
                return enb_dl.put_sync_signals(cell, g, sf)
            return f
        return build

    def _build_pbch(self, block: int):
        """PBCH segment `block` (sfn %% 4) into subframe 0 (pbch.c);
        the CRC antenna mask follows the cell's port count."""
        from srsran_4g_tpu.models import pbch as pbch_mod

        cell = self.cell

        def build():
            def f(g, mib_bits):
                syms = pbch_mod.encode(cell, mib_bits,
                                       n_ports=cell.nof_ports)
                return pbch_mod.put_into_grid(cell, g, syms[:, block])
            return f
        return build

    def _phich_put(self, g, ack, group: int, nseq: int, sf: int):
        syms = phich_mod.encode(self.cell, ack, group, nseq, sf)
        return phich_mod.put_into_grid(self.cell, g, syms, group)

    # -- UE cell acquisition ---------------------------------------------------

    def ue_cell_search(self, samples) -> dict:
        """PSS/SSS blind search on one subframe of samples
        (srsue sync.cc FIND via ue_dl.cell_search).

        Returns dict(found, cell_id, phase (0: sf 0, 1: sf 5), peak)."""
        from srsran_4g_tpu.models import ue_dl as ue_dl_mod

        if self.nof_rx == 2:
            samples = samples[:, 0]    # search on antenna 0 (sync.cc)
        search = self._fn(("cell_search",), lambda: functools.partial(
            ue_dl_mod.cell_search, nof_prb=self.cell.nof_prb))
        out = search(samples)
        peak = float(np.asarray(out["pss_peak"])[0])
        return dict(found=peak > 0.5,
                    cell_id=int(np.asarray(out["cell_id"])[0]),
                    phase=int(np.asarray(out["phase"])[0]), peak=peak)

    def ue_cell_search_tdd(self, samples2) -> dict:
        """TDD cell search over a TWO-subframe buffer [sf_n-1 | sf_n]:
        the PSS sits in symbol 2 of the special subframe and the SSS in
        the last symbol of the PRECEDING subframe (sync.c frame-type
        detection; models/tdd.detect_frame_type).

        Returns dict(found, cell_id, phase, peak) where phase 0 means
        the buffer's first subframe is sf 0 (1 → sf 5)."""
        from srsran_4g_tpu.models import sync as sync_mod
        from srsran_4g_tpu.models import tdd as tdd_mod

        cfg = self.ofdm

        def build():
            def f(s):
                found = sync_mod.find_pss(s, cfg.symbol_sz)
                res = tdd_mod.detect_frame_type(s, found["offset"],
                                                found["n_id_2"], cfg)
                return (found["offset"], found["n_id_2"], found["peak"],
                        res.frame_type, res.n_id_1, res.phase, res.metric)
            return f

        off, n2, peak, ft, n1, phase, metric = self._fn(
            ("cell_search_tdd",), build)(samples2)
        exp_off = tdd_mod.pss_to_sf_start(cfg, "tdd")
        off_v = int(np.asarray(off)[0])
        ok = (float(np.asarray(peak)[0]) > 0.5
              and int(np.asarray(ft)[0]) == 1
              and abs(off_v - exp_off) < 4)
        cell_id = 3 * int(np.asarray(n1)[0]) + int(np.asarray(n2)[0])
        return dict(found=ok, cell_id=cell_id,
                    phase=int(np.asarray(phase)[0]),
                    peak=float(np.asarray(peak)[0]))

    def ue_mib_rx(self, samples, cell_id: int) -> dict | None:
        """PBCH decode from a subframe-0 sample buffer (ue_mib.c): the
        central 6 PRB of the full-band grid carry the PBCH; the 40 ms
        segment index (sfn %% 4) is blind-tried.  Returns
        dict(mib (24,), n_ports, block) or None."""
        demod = self._fn(("ofdm_demod",),
                         lambda: functools.partial(demodulate, self.ofdm))
        if self.nof_rx == 2:
            samples = samples[:, 0]    # MIB from antenna 0 (ue_mib.c)
        grid = demod(samples)
        mid = self.cell.nre // 2
        grid6 = grid[..., mid - 36:mid + 36]
        cell6 = G.CellConfig(nof_prb=6, cell_id=cell_id, cfi=self.cell.cfi,
                             nof_ports=self.nof_ports)
        two_port = self.nof_ports == 2

        def build():
            from srsran_4g_tpu.models import pbch as pbch_mod

            def f(g6):
                est = chest_mod.estimate(
                    chest_mod.ChestConfig(cell=cell6), g6, 0, port=0)
                h1 = None
                if two_port:
                    h1 = chest_mod.estimate(
                        chest_mod.ChestConfig(cell=cell6), g6, 0,
                        port=1)["h"]
                outs = []
                for blk in range(4):
                    r = pbch_mod.decode(cell6, g6, est["h"],
                                        est["noise_var"], frame_idx=blk,
                                        h1=h1)
                    outs.append((r["crc_ok"], r["mib"], r["n_ports"]))
                return outs
            return f

        outs = self._fn(("mib_rx", cell_id), build)(grid6)
        for blk, (ok, mib, ports) in enumerate(outs):
            if bool(np.asarray(ok)[0]):
                return dict(mib=np.asarray(mib)[0],
                            n_ports=int(np.asarray(ports)[0]), block=blk)
        return None

    # -- PHICH -----------------------------------------------------------------

    def _ue_front(self, samples, sf: int):
        """OFDM demod + CRS estimation front-end
        (srsran_ue_dl_decode_fft_estimate, ue_dl.c:349).

        SISO: returns (grid (B,S,K), h, None, h_full=None, nv, snr_db).
        2×2:  returns (grids (B,2,S,K), h (rx0,port0), h1 (rx0,port1),
        h_full (B,2rx,2tx,S,K), nv, snr_db)."""
        demod = self._fn(("ofdm_demod",),
                         lambda: functools.partial(demodulate, self.ofdm))
        if self.nof_rx == 1:
            grid = demod(samples)
            est = self._fn(("chest", sf), lambda: functools.partial(
                chest_mod.estimate, chest_mod.ChestConfig(cell=self.cell),
                subframe=sf))(grid)
            return grid, est["h"], None, None, est["noise_var"], est["snr_db"]

        def build():
            jnp = self.jax.numpy
            ccfg = chest_mod.ChestConfig(cell=self.cell)

            def f(grids):
                ests = [[chest_mod.estimate(ccfg, grids[:, r], sf, port=p)
                         for p in range(2)] for r in range(2)]
                h_full = jnp.stack(
                    [jnp.stack([ests[r][p]["h"] for p in range(2)], axis=1)
                     for r in range(2)], axis=1)  # (B, rx, tx, S, K)
                nv = sum(ests[r][p]["noise_var"] for r in range(2)
                         for p in range(2)) / 4
                return h_full, nv, ests[0][0]["snr_db"]
            return f

        grids = demod(samples)
        h_full, nv, snr = self._fn(("chest2x2", sf), build)(grids)
        return grids, h_full[:, 0, 0], h_full[:, 0, 1], h_full, nv, snr

    def ue_phich_rx(self, samples, group: int, nseq: int,
                    sf: int = DL_SF) -> bool:
        """Decode one PHICH: True = ACK, False = NACK
        (srsue cc_worker decode_phich)."""
        grid, h, h1, _, nv, _ = self._ue_front(samples, sf)
        if self.nof_rx == 2:
            grid = grid[:, 0]
        dec = self._fn(("phich_dec", group, nseq, sf), lambda:
                       functools.partial(phich_mod.decode, self.cell,
                                         group=group, nseq=nseq,
                                         subframe=sf))
        r = (dec(grid, h=h, noise_var=nv) if h1 is None
             else dec(grid, h=h, noise_var=nv, h1=h1))
        return bool(np.asarray(r["ack"])[0])

    # -- UE RX ----------------------------------------------------------------

    def ue_dl_rx_multi(self, samples, rnti: int, sf: int = DL_SF,
                       harq_bufs: dict | None = None,
                       mimo_fmt: str | None = None,
                       common_1c: bool = False) -> dict:
        """Blind-decode the UE's full search space for `rnti`.

        Returns dict(snr_db, hits=[{dci|ul_dci|dci2, cce_start, pdu?,
        pdu2?}, ...]) plus (2×2 air) ri/pmi/cqi from the CRS channel
        estimate (srsran_pmi_select feedback, precoding.c:307).
        Every CRC-passing candidate is taken, smallest aggregation level
        first, skipping candidates whose CCEs overlap an accepted one
        (overlapping "echo" detections of the same DCI at a larger L).
        pdu None on a DL hit = PDSCH KO (CRC fail).

        `harq_bufs` is the UE's per-process soft-buffer store
        ({pid: {"ndi", "tbs", "bufs"}}): retransmissions of the same
        process (same NDI/TBS) chase-combine their LLRs before turbo
        decoding, as the reference's srsran_softbuffer_rx
        (ue_dl.c decode_tb softbuffer path).  Dual-codeword (format
        2/2A) transmissions re-decode each retransmission standalone.

        `mimo_fmt`: "2" (TM4) or "2A" (TM3) adds a second blind search
        at that format's payload length (ue_dl.c:543-548 searches the
        TM-specific format alongside 0/1A).

        `common_1c`: also search the format-1C payload length — the
        compact SI/RAR/paging format a real UE always monitors in the
        common search space (ra_dl.c:383 P/SI/RA-RNTI accept 1A/1C).
        """
        grids, h, h1, h_full, nv, snr_db = self._ue_front(samples, sf)
        grid0 = grids[:, 0] if self.nof_rx == 2 else grids

        def run_blind(dci_len):
            blind = self._fn(("blind", rnti, sf, dci_len, h1 is not None),
                             lambda: functools.partial(
                pdcch_mod.blind_decode, self.cell, self.cell.cfi, sf,
                rnti=rnti, dci_len=dci_len))
            return (blind(grid0, h=h, noise_var=nv) if h1 is None
                    else blind(grid0, h=h, noise_var=nv, h1=h1))

        res = dict(snr_db=float(snr_db[0]), hits=[])
        if self.nof_rx == 2:
            res.update(self._csi_report(h_full, nv))
        out = run_blind(self.dci_len)
        out2 = None
        if mimo_fmt is not None:
            len2 = (dci_mod.format2_len(self.cell.nof_prb, 2)
                    if mimo_fmt == "2"
                    else dci_mod.format2a_len(self.cell.nof_prb, 2))
            out2 = run_blind(len2)
        out1c = (run_blind(dci_mod.format1c_len(self.cell.nof_prb))
                 if common_1c else None)
        cands = pdcch_mod.search_space_candidates(
            self.cell, self.cell.cfi, rnti, sf)
        ok = np.asarray(out["ok_per_candidate"][0])
        payloads = np.asarray(out["payload_per_candidate"][0])
        ok2 = (np.asarray(out2["ok_per_candidate"][0])
               if out2 is not None else np.zeros_like(ok))
        payloads2 = (np.asarray(out2["payload_per_candidate"][0])
                     if out2 is not None else None)
        ok1c = (np.asarray(out1c["ok_per_candidate"][0])
                if out1c is not None else np.zeros_like(ok))
        payloads1c = (np.asarray(out1c["payload_per_candidate"][0])
                      if out1c is not None else None)
        if not ok.any() and not ok2.any() and not ok1c.any():
            return res
        used: set[int] = set()
        for i in sorted(range(len(cands)), key=lambda i: cands[i][0]):
            if not (ok[i] or ok2[i] or ok1c[i]):
                continue
            l_agg, start = cands[i]
            cces = set(range(start, start + l_agg))
            if cces & used:
                continue
            used |= cces
            if ok1c[i] and not ok[i] and not ok2[i]:
                d1c = dci_mod.unpack_1c(payloads1c[i], self.cell.nof_prb)
                cfg = pdsch_mod.PdschConfig(
                    cell=self.cell, rnti=rnti, subframe=sf, mod="qpsk",
                    tbs=ra.dl_tbs_1c(d1c.mcs),
                    prb_alloc=dci_mod.dci1c_prbs(d1c, self.cell.nof_prb))
                h_1c = h if h1 is None else self.jax.numpy.stack(
                    [h, h1], axis=1)
                dec = self._fn(("pdsch_dec", cfg, False), lambda cfg=cfg:
                               functools.partial(pdsch_mod.decode, cfg,
                                                 n_iter=6))
                r = dec(grid0, h=h_1c, noise_var=nv)
                pdu = (np.packbits(np.asarray(r["bits"][0],
                                              np.uint8)).tobytes()
                       if bool(r["crc_ok"][0]) else None)
                res["hits"].append(dict(dci_1c=d1c, cce_start=start,
                                        pdu=pdu))
                continue
            if ok2[i] and not ok[i]:
                d2 = (dci_mod.unpack_2(payloads2[i], self.cell.nof_prb)
                      if mimo_fmt == "2"
                      else dci_mod.unpack_2a(payloads2[i],
                                             self.cell.nof_prb))
                res["hits"].append(self._rx_dual_cw(
                    grids, h_full, nv, rnti, sf, d2, start,
                    4 if mimo_fmt == "2" else 3))
                continue
            bits = payloads[i]
            if bits[0] == 0:       # format 0/1A flag: UL grant
                res["hits"].append(dict(
                    ul_dci=dci_mod.unpack_0(bits, self.cell.nof_prb),
                    cce_start=start))
                continue
            d = dci_mod.unpack_1a(bits, self.cell.nof_prb)
            cfg = dci_to_pdsch_cfg(self.cell, rnti, d, sf)
            sb = None
            if harq_bufs is not None:
                ent = harq_bufs.get(d.harq_pid)
                if (ent is not None and ent["ndi"] == d.ndi
                        and ent["tbs"] == cfg.tbs):
                    sb = ent["bufs"]
            h_sfbc = h if h1 is None else self.jax.numpy.stack(
                [h, h1], axis=1)
            dec = self._fn(("pdsch_dec", cfg, sb is not None),
                           lambda cfg=cfg:
                           functools.partial(pdsch_mod.decode, cfg, n_iter=6))
            r = (dec(grid0, h=h_sfbc, noise_var=nv) if sb is None
                 else dec(grid0, h=h_sfbc, noise_var=nv, softbuffers=sb))
            crc_ok = bool(r["crc_ok"][0])
            if harq_bufs is not None:
                harq_bufs[d.harq_pid] = dict(
                    ndi=d.ndi, tbs=cfg.tbs,
                    bufs=None if crc_ok else r.get("softbuffers"))
            pdu = (np.packbits(np.asarray(r["bits"][0], np.uint8)).tobytes()
                   if crc_ok else None)
            res["hits"].append(dict(dci=d, cce_start=start, pdu=pdu))
        return res

    def _rx_dual_cw(self, grids, h_full, nv, rnti: int, sf: int, d,
                    start: int, tm: int) -> dict:
        """Decode a format 2/2A dual-codeword PDSCH from both RX antennas
        (pdsch_mimo.decode: effective channel H·W → batched 2×2 MMSE →
        per-codeword DL-SCH)."""
        from srsran_4g_tpu.models import pdsch_mimo

        cfg = dci_to_pdsch_mimo_cfg(self.cell, rnti, d, sf, tm)
        dec = self._fn(("pdsch_mimo_dec", cfg), lambda cfg=cfg:
                       functools.partial(pdsch_mimo.decode, cfg, n_iter=6))
        r = dec(grids, h=h_full, noise_var=nv)
        ok0 = bool(np.asarray(r["crc_ok0"])[0])
        ok1 = bool(np.asarray(r["crc_ok1"])[0])
        pdu = (np.packbits(np.asarray(r["bits0"][0], np.uint8)).tobytes()
               if ok0 else None)
        pdu2 = (np.packbits(np.asarray(r["bits1"][0], np.uint8)).tobytes()
                if ok1 else None)
        return dict(dci2=d, cce_start=start, pdu=pdu, pdu2=pdu2)

    def _csi_report(self, h_full, nv) -> dict:
        """RI/PMI selection from the full 2×2 CRS estimate: capacity
        argmax over the rank-1/rank-2 codebooks (mimo.pmi_select_2tx,
        reference srsran_pmi_select precoding.c:307)."""
        from srsran_4g_tpu.models import mimo

        def build():
            jnp = self.jax.numpy

            def f(hf, nvv):
                h = hf.reshape(hf.shape[:3] + (-1,))  # (B, rx, tx, S*K)
                _, m1 = mimo.pmi_select_2tx(h, nvv, rank=1)
                pmi2, m2 = mimo.pmi_select_2tx(h, nvv, rank=2)
                best1 = jnp.max(m1, axis=-1)
                best2 = jnp.max(m2, axis=-1)
                return best1, best2, pmi2
            return f

        b1, b2, pmi2 = self._fn(("csi",), build)(h_full, nv)
        ri = 2 if float(b2[0]) > float(b1[0]) else 1
        return dict(ri=ri, pmi=int(np.asarray(pmi2)[0]))

    # -- UE UL TX --------------------------------------------------------------

    def pucch_cfg(self, n_pucch: int, rnti: int = 0,
                  n_rb_2: int = 1, sf: int = UL_SF) -> pucch_mod.PucchConfig:
        return pucch_mod.PucchConfig(cell=self.cell, subframe=sf,
                                     n_pucch=n_pucch, n_rb_2=n_rb_2,
                                     rnti=rnti)

    def ue_ul_tx(self, pusch: tuple[pusch_mod.PuschConfig, bytes] | None,
                 ack: tuple[int, int] | None = None,
                 sr: int | None = None,
                 cqi: tuple[int, int, int] | None = None,
                 csi: tuple[int, int, int, int, int] | None = None,
                 sf: int = UL_SF):
        """One UE's UL grid: PUSCH + PUCCH contributions (or None).

        ack: (n_pucch, ack_bit); sr: n_pucch_sr; cqi: (n_pucch_2, rnti, cqi);
        csi: (n_pucch_2, rnti, cqi, ri, pmi) — the 7-bit CQI(4)+RI(1)+PMI(2)
        periodic report of the 2×2 air (36.213 §7.2.2 mode 1-1 condensed
        onto one format-2 occasion; format 2 carries up to 13 bits).
        """
        jnp = self.jax.numpy
        grid = None
        if pusch is not None:
            cfg, pdu = pusch
            enc = self._fn(("pusch_enc", cfg), lambda cfg=cfg:
                           functools.partial(pusch_mod.encode, cfg))
            grid = enc(jnp.asarray(self._bits(pdu, cfg.tbs)))
        if ack is not None:
            n_pucch, bit = ack
            pcfg = self.pucch_cfg(n_pucch, sf=sf)
            enc = self._fn(("pucch1a_enc", n_pucch, sf), lambda pcfg=pcfg:
                           lambda bits: pucch_mod.encode_format1(pcfg, bits))
            g = enc(jnp.asarray([[bit]], jnp.int8))
            grid = g if grid is None else grid + g
        if sr is not None:
            pcfg = self.pucch_cfg(sr, sf=sf)
            g = pucch_mod.encode_format1(pcfg, None)
            grid = g if grid is None else grid + g
        if cqi is not None:
            n2, rnti, val = cqi
            pcfg = self.pucch_cfg(n2, rnti=rnti, sf=sf)
            enc = self._fn(("pucch2_enc", n2, rnti, sf), lambda pcfg=pcfg:
                           lambda bits: pucch_mod.encode_format2(pcfg, bits))
            bits = ((val >> np.arange(3, -1, -1)) & 1).astype(np.int8)
            g = enc(jnp.asarray(bits[None]))
            grid = g if grid is None else grid + g
        if csi is not None:
            n2, rnti, val, ri, pmi = csi
            pcfg = self.pucch_cfg(n2, rnti=rnti, sf=sf)
            enc = self._fn(("pucch2_csi_enc", n2, rnti, sf), lambda pcfg=pcfg:
                           lambda bits: pucch_mod.encode_format2(pcfg, bits))
            word = (val << 3) | ((ri - 1) << 2) | (pmi & 3)
            bits = ((word >> np.arange(6, -1, -1)) & 1).astype(np.int8)
            g = enc(jnp.asarray(bits[None]))
            grid = g if grid is None else grid + g
        return grid

    def combine_ul(self, grids: list, tti: int = 0):
        """Sum per-UE UL grids and push through the channel → eNB samples."""
        jnp = self.jax.numpy
        total = None
        for g in grids:
            if g is not None:
                total = g if total is None else total + g
        if total is None:
            total = jnp.zeros((1, self.cell.nsymb, self.cell.nre),
                              jnp.complex64)
        chan = self._fn(("chan_ul",), lambda: self._build_channel(1))
        return chan(total, jnp.asarray(float(tti) * 1e-3), self.key())

    # -- eNB UL RX ---------------------------------------------------------------

    def enb_ul_grid(self, samples):
        demod = self._fn(("ofdm_demod",),
                         lambda: functools.partial(demodulate, self.ofdm))
        return demod(samples)

    def enb_pusch_rx(self, ul_grid, cfg: pusch_mod.PuschConfig) -> bytes | None:
        dec = self._fn(("pusch_dec", cfg), lambda cfg=cfg:
                       functools.partial(pusch_mod.decode, cfg, n_iter=6))
        r = dec(ul_grid)
        if not bool(r["crc_ok"][0]):
            return None
        return np.packbits(np.asarray(r["bits"][0], np.uint8)).tobytes()

    def enb_pucch_ack_rx(self, ul_grid, n_pucch: int,
                         sf: int = UL_SF) -> bool | None:
        """→ True (ACK) / False (NACK) / None (DTX)."""
        pcfg = self.pucch_cfg(n_pucch, sf=sf)
        dec = self._fn(("pucch1a_dec", n_pucch, sf), lambda pcfg=pcfg:
                       lambda g: pucch_mod.decode_format1(pcfg, g, 1,
                                                          noise_var=self.nv))
        r = dec(ul_grid)
        if not bool(r["detected"][0]):
            return None
        return int(np.asarray(r["bits"])[0, 0]) == 0  # bit 0 ⇔ ACK

    def enb_sr_rx(self, ul_grid, n_pucch_sr: int, sf: int = UL_SF) -> bool:
        pcfg = self.pucch_cfg(n_pucch_sr, sf=sf)
        dec = self._fn(("sr_dec", n_pucch_sr, sf), lambda pcfg=pcfg:
                       lambda g: pucch_mod.decode_format1(pcfg, g, 1,
                                                          noise_var=self.nv))
        return bool(dec(ul_grid)["detected"][0])

    def enb_cqi_rx(self, ul_grid, n_pucch_2: int, rnti: int,
                   sf: int = UL_SF) -> int:
        pcfg = self.pucch_cfg(n_pucch_2, rnti=rnti, sf=sf)
        dec = self._fn(("pucch2_dec", n_pucch_2, rnti, sf), lambda pcfg=pcfg:
                       lambda g: pucch_mod.decode_format2(pcfg, g, 4))
        bits = np.asarray(dec(ul_grid)["bits"])[0]
        return int(bits.dot(1 << np.arange(3, -1, -1)))

    def enb_csi_rx(self, ul_grid, n_pucch_2: int, rnti: int,
                   sf: int = UL_SF) -> tuple[int, int, int]:
        """→ (cqi, ri, pmi): the 7-bit CQI+RI+PMI periodic report of the
        2×2 air (counterpart of ue_ul_tx csi=...)."""
        pcfg = self.pucch_cfg(n_pucch_2, rnti=rnti, sf=sf)
        dec = self._fn(("pucch2_csi_dec", n_pucch_2, rnti, sf),
                       lambda pcfg=pcfg:
                       lambda g: pucch_mod.decode_format2(pcfg, g, 7))
        bits = np.asarray(dec(ul_grid)["bits"])[0]
        word = int(bits.dot(1 << np.arange(6, -1, -1)))
        return word >> 3, ((word >> 2) & 1) + 1, word & 3

    # -- PRACH ---------------------------------------------------------------------

    def prach_tx_samples(self, preamble_idx: int) -> np.ndarray:
        """UE-side PRACH for the sample-stream (multi-process) deployment:
        normalised noisy preamble padded to one subframe of samples
        (the three-process analog of `prach`; prach.c preamble gen)."""
        jnp = self.jax.numpy

        def build():
            def f(pre_t, key):
                from srsran_4g_tpu.channel.awgn import awgn

                pre_t = pre_t / jnp.sqrt(jnp.mean(jnp.abs(pre_t) ** 2))
                return awgn(key, pre_t[None, :], self.nv)
            return f

        pre = prach_mod.generate(self.prach_cfg, preamble_idx)
        noisy = np.asarray(self._fn(("prach_tx", pre.shape[0]), build)(
            pre, self.key()))
        out = np.zeros((1, self.ofdm.sf_len), np.complex64)
        n = min(noisy.shape[1], self.ofdm.sf_len)
        out[:, :n] = noisy[:, :n]
        return out

    def prach_rx(self, samples) -> int | None:
        """eNB-side PRACH correlation on one UL subframe of samples
        (prach_worker.cc FFT correlation off the fast path)."""
        cfg = self.prach_cfg
        n_pre = cfg.cp_len + cfg.seq_len_samples

        def build():
            def f(rx):
                det = prach_mod.detect(cfg, rx)
                return det["detected"][0], det["power"][0]
            return f

        sl = np.asarray(samples)[:, :n_pre]
        # energy gate: an idle (zero/PUCCH-only) subframe must not reach
        # the correlator with pathological normalisation
        if float(np.mean(np.abs(sl) ** 2)) < 1e-6:
            return None
        det, power = self._fn(("prach_det",), build)(self.jax.numpy.asarray(sl))
        if not np.asarray(det).any():
            return None
        return int(np.asarray(power).argmax())

    def prach(self, preamble_idx: int) -> int | None:
        """UE preamble TX → eNB detect; returns detected index or None."""
        jnp = self.jax.numpy

        def build():
            cfg = self.prach_cfg

            def f(pre_t, key):
                from srsran_4g_tpu.channel.awgn import awgn

                pre_t = pre_t / jnp.sqrt(jnp.mean(jnp.abs(pre_t) ** 2))
                rx = awgn(key, pre_t[None, :], self.nv)
                det = prach_mod.detect(cfg, rx)
                return det["detected"][0], det["power"][0]
            return f

        pre = prach_mod.generate(self.prach_cfg, preamble_idx)
        det, power = self._fn(("prach",), build)(pre, self.key())
        if not np.asarray(det).any():
            return None
        return int(np.asarray(power).argmax())
