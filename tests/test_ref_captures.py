"""Reference-capture interop tier: decode the reference repo's committed
real-world IQ captures through this framework's receivers.

Counterpart of the reference's `*_file_test` binaries — same files, same
pass criteria:

- ``signal.1.92M.dat``      -> pbch_file_test (phch/test/CMakeLists.txt:453):
  MIB decoded, 2 TX ports, payload == the hard-coded bch_payload_file
  (pbch_file_test.c:63-64,232).
- ``signal.1.92M.amar.dat`` -> pdcch_file_test / pdsch_pdcch_file_test
  (CMakeLists.txt:461-462): SI-RNTI DCI 1A with RIV=11 (full 6 PRB),
  mcs_idx=2, rv=0, pid=0 (pdcch_file_test.c:264-268), and the SIB
  transport block CRC-OK (pdsch_pdcch_file_test.c:205).

These captures were produced by real eNB hardware/software (Amarisoft),
so a decode here proves spec interop, not just TX/RX self-consistency.
"""

import os

import numpy as np
import pytest

import jax.numpy as jnp

from srsran_4g_tpu.models import chest, dci as dci_mod, grid as G, pcfich, pdcch, pdsch, ra
from srsran_4g_tpu.ops import ofdm

REF = "/root/reference/lib/src/phy/phch/test"

pytestmark = pytest.mark.skipif(not os.path.isdir(REF),
                                reason="reference captures not available")

SF_LEN_6PRB = 1920


def _subframe_grids(path: str, nof_prb: int = 6):
    x = np.fromfile(path, dtype=np.complex64)
    cfg = ofdm.OfdmConfig(nof_prb=nof_prb)
    sf_len = cfg.sf_len
    n_sf = len(x) // sf_len
    grids = []
    for sf in range(n_sf):
        s = jnp.asarray(x[sf * sf_len:(sf + 1) * sf_len])[None]
        grids.append(ofdm.demodulate(cfg, s))
    return grids


# ---------------------------------------------------------------- PBCH

class TestPbchFile:
    """pbch_file_test -i signal.1.92M.dat (cell 150, 6 PRB, 2 ports)."""

    @pytest.fixture(scope="class")
    def grid0(self):
        return _subframe_grids(f"{REF}/signal.1.92M.dat")[0]

    def test_mib_decodes_with_reference_payload(self, grid0):
        cell = G.CellConfig(nof_prb=6, cell_id=150, cfi=1, nof_ports=2)
        ch = chest.estimate(chest.ChestConfig(cell=cell), grid0, subframe=0,
                            port=0)
        from srsran_4g_tpu.models import pbch
        res = pbch.decode(cell, grid0, ch["h"], ch["noise_var"], frame_idx=0)
        assert bool(res["crc_ok"][0])
        # reference pbch_file_test.c:232: 2 ports, sfn_offset 0, payload:
        expect = np.array([0, 1, 1, 0, 1, 0, 0, 0, 0, 0, 0, 1,
                           1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0])
        assert int(res["n_ports"][0]) == 2
        np.testing.assert_array_equal(np.asarray(res["mib"][0]), expect)


# ----------------------------------------------------- PDCCH (amar eNB)

AMAR_CELL = G.CellConfig(nof_prb=6, cell_id=1, cfi=3, nof_ports=1)


@pytest.fixture(scope="module")
def amar_grids():
    return _subframe_grids(f"{REF}/signal.1.92M.amar.dat")


@pytest.fixture(scope="module")
def amar_chests(amar_grids):
    return [
        chest.estimate(chest.ChestConfig(cell=AMAR_CELL), g, subframe=sf,
                       port=0)
        for sf, g in enumerate(amar_grids)
    ]


class TestAmarFile:
    def test_cfi_on_every_subframe(self, amar_grids, amar_chests):
        """PCFICH reads CFI=3 in all 10 subframes of the capture."""
        for sf, (g, ch) in enumerate(zip(amar_grids, amar_chests)):
            out = pcfich.decode(AMAR_CELL, g, ch["h"], ch["noise_var"],
                                subframe=sf)
            assert int(out["cfi"][0]) == 3, f"sf{sf}"

    def test_chest_snr_high_all_subframes(self, amar_chests):
        for sf, ch in enumerate(amar_chests):
            assert float(ch["snr_db"][0]) > 20.0, f"sf{sf}"

    def test_si_dci_sf5_matches_reference_criterion(self, amar_grids,
                                                    amar_chests):
        """pdcch_file_test.c:264-268: type2 localized, RIV=11, rv=0,
        pid=0, mcs_idx=2."""
        g, ch = amar_grids[5], amar_chests[5]
        out = pdcch.blind_decode(AMAR_CELL, 3, 5, g, ch["h"], ch["noise_var"],
                                 rnti=0xFFFF,
                                 dci_len=dci_mod.format1a_len(6))
        assert bool(out["found"][0])
        d = dci_mod.unpack_1a(np.asarray(out["dci"][0]), 6)
        assert ra.riv_encode(6, d.l_crbs, d.rb_start) == 11
        assert d.mcs == 2 and d.rv == 0 and d.harq_pid == 0
        assert not d.distributed

    @pytest.mark.parametrize("sf,mcs,rv", [(5, 2, 0), (2, 6, 3)])
    def test_sib_pdsch_crc_ok(self, amar_grids, sf, mcs, rv):
        """pdsch_pdcch_file_test: DCI-driven PDSCH decode, CRC OK.

        sf5 carries SIB1 (mcs 2, rv 0), sf2 another SI message
        (mcs 6, rv 3); both DCIs have TPC=1 -> N_prb^1A = 3
        (36.212 §5.3.3.1.3, ra_dl.c).
        """
        tbs = ra.tbs_from_itbs(mcs, 3)
        pc = pdsch.PdschConfig(cell=AMAR_CELL, rnti=0xFFFF, subframe=sf,
                               mod="qpsk", tbs=tbs, rv=rv)
        out = pdsch.decode(pc, amar_grids[sf])
        assert bool(out["crc_ok"][0])

    def test_si_dci_found_only_in_si_subframes(self, amar_grids, amar_chests):
        """Blind SI-RNTI search across the whole capture finds DCIs in
        exactly the two SI subframes (2 and 5) — no false alarms."""
        found = []
        for sf, (g, ch) in enumerate(zip(amar_grids, amar_chests)):
            out = pdcch.blind_decode(AMAR_CELL, 3, sf, g, ch["h"],
                                     ch["noise_var"], rnti=0xFFFF,
                                     dci_len=dci_mod.format1a_len(6))
            if bool(out["found"][0]):
                found.append(sf)
        assert found == [2, 5]


# --------------------------------------------------- NB-IoT NPBCH captures

class TestNpbchFiles:
    """npbch_file_test on the four committed NB-IoT captures
    (phch/test/CMakeLists.txt:168-171): real Amarisoft R13 capture plus
    R13/R14 single-frame captures with different cell ids, repetition
    blocks and port counts. Pass criterion: MIB-NB CRC OK
    (npbch_file_test.c:229 nof_decoded_mibs > 0)."""

    CASES = [
        # (file, n_id_ncell, block/nf, is_r14, expect_ports, expect_sfn_msb)
        ("signal_nbiot_amari_nid0_sfn514_sib2.bin", 0, 0, False, 1, 512),
        ("signal_nbiot_nid256_r14_sf0.bin", 256, 0, True, 2, 832),
        ("signal_nbiot_nid257_r13_sf0.bin", 257, 4, False, 1, 64),
        ("signal_nbiot_nid257_r14_sf0.bin", 257, 7, True, 2, 384),
    ]

    @pytest.mark.parametrize("fn,cid,nf,r14,ports,sfn", CASES)
    def test_mib_nb_decodes(self, fn, cid, nf, r14, ports, sfn):
        from srsran_4g_tpu.models import nbiot

        x = np.fromfile(f"{REF}/{fn}", dtype=np.complex64)
        cfg = ofdm.OfdmConfig(nof_prb=1, half_sc_shift=True)
        g = ofdm.demodulate(cfg, jnp.asarray(x[:cfg.sf_len])[None])
        out = nbiot.npbch_decode(cid, g, block_idx=nf, nf=nf, is_r14=r14)
        assert bool(out["crc_ok"][0])
        assert int(out["n_ports"][0]) == ports
        mib = nbiot.mib_nb_unpack(out["mib"][0])
        assert mib["sfn_msb"] == sfn


# ------------------------------------------- PCFICH/PHICH 2-port capture

class TestPcfichPhichFile:
    """pcfich_file_test / phich_file_test -c 150 -n 50 -p 2 on
    ``signal.10M.dat`` (phch/test/CMakeLists.txt:459-460) — the only
    committed 50-PRB 2-TX-port capture.

    Rate note (documented divergence from the reference *test*, not the
    spec): the file is 7681 samples ≈ one slot at the STANDARD 15.36
    Msps (PSS for N_ID_2 = 0 correlates at 0.98 with symbol size 1024
    and at only 0.40 with the reduced 768 size the reference binary
    defaults to without ``-d``) — so it is decoded here at 1024.  At
    that rate the PCFICH despreads to the ideal 2-port-diversity
    correlation signature (≈ (+0.60, −0.20, −0.20) over the three
    36.212 Table 5.3.4-1 codewords) with CFI = 1.
    """

    @pytest.fixture(scope="class")
    def grid_and_chest(self):
        raw = np.fromfile(f"{REF}/signal.10M.dat", dtype=np.complex64)
        cfg = ofdm.OfdmConfig(nof_prb=50)
        x = np.concatenate(
            [raw, np.zeros(cfg.sf_len - len(raw), np.complex64)])
        grid = ofdm.demodulate(cfg, jnp.asarray(x)[None])
        cell = G.CellConfig(nof_prb=50, cell_id=150, cfi=2, nof_ports=2)
        ch0 = chest.estimate(chest.ChestConfig(cell=cell), grid,
                             subframe=0, port=0)
        ch1 = chest.estimate(chest.ChestConfig(cell=cell), grid,
                             subframe=0, port=1)
        return cell, grid, ch0, ch1

    def test_sample_rate_is_standard(self):
        from srsran_4g_tpu.models import sync

        raw = np.fromfile(f"{REF}/signal.10M.dat", dtype=np.complex64)
        out = sync.find_pss(jnp.asarray(raw)[None], 1024)
        assert int(out["n_id_2"][0]) == 0          # cell 150 → N_ID_2 = 0
        assert float(out["peak"][0]) > 0.9
        out_red = sync.find_pss(jnp.asarray(raw)[None], 768)
        assert float(out_red["peak"][0]) < 0.5

    def test_pcfich_decodes_cleanly(self, grid_and_chest):
        cell, grid, ch0, ch1 = grid_and_chest
        out = pcfich.decode(cell, grid, ch0["h"], ch0["noise_var"], 0,
                            h1=ch1["h"])
        corr = np.asarray(out["corr"][0])
        n = corr / np.abs(corr).sum()
        # dominant codeword with the ideal (+0.60, −0.20, −0.20) shape
        assert n.max() > 0.5, n
        assert (n < 0).sum() == 2, n
        assert int(out["cfi"][0]) == 1

    def test_phich_groups_despread(self, grid_and_chest):
        from srsran_4g_tpu.models import phich

        cell, grid, ch0, ch1 = grid_and_chest
        # ng=1 at 50 PRB → ceil(50/8) = 7 groups × 8 sequences, as the
        # reference's full group/sequence sweep (phich_file_test.c:258)
        metrics = []
        for grp in range(7):
            for nseq in range(8):
                r = phich.decode(cell, grid, ch0["h"], ch0["noise_var"],
                                 grp, nseq, 0, ng=1.0, h1=ch1["h"])
                m = float(r["metric"][0])
                assert np.isfinite(m)
                metrics.append(m)
        # the reference's pass criterion is that the full sweep decodes
        # without error (phich_file_test.c:277-285 only checks n > 0);
        # this subframe carries no PHICH energy (all 56 metrics sit at
        # the despread noise floor), so additionally assert no false
        # strong ACK is detected
        metrics = np.abs(np.asarray(metrics))
        assert metrics.max() < 8.0, metrics.max()


# ------------------------------------------------- NPDCCH captures

class TestNpdcchFiles:
    """npdcch_file_test + npdsch_npdcch_file_test on the two committed
    NB-IoT DCI captures (phch/test/CMakeLists.txt:475-479).

    The reference's pass criterion for all four ctests is: the DCI of
    the requested format decodes with CRC == RNTI and unpacks to a
    valid grant (the single-subframe files end before the scheduled
    NPDSCH/NPUSCH, so npdsch_npdcch_file_test.c:320-328 passes on
    `last_dci_format == requested`).  The N1 capture is noisy and
    frequency-selective — it exercises the per-subcarrier NRS
    interpolation and the format-1 natural RE order (both verified
    bit-exact against a standalone build of the reference's own
    npdcch.c + chest_dl_nbiot.c via tools/ref_npdcch.py)."""

    def _decode(self, fn, tti, rnti):
        from srsran_4g_tpu.models import nbiot_data as ND

        x = np.fromfile(f"{REF}/{fn}", dtype=np.complex64)
        cfg = ofdm.OfdmConfig(nof_prb=1, half_sc_shift=True)
        assert x.size == cfg.sf_len          # exactly one subframe
        g = ofdm.demodulate(cfg, jnp.asarray(x)[None])
        out = ND.npdcch_blind_decode(g, rnti, 0, tti % 10)
        ok = np.asarray(out["crc_ok"][0])
        return out, ok

    def test_format_n0_ul_grant(self):
        """-c 0 -t 8624 -r 258 -L 1 -l 0 -o FormatN0: UL DCI on NCCE 0."""
        from srsran_4g_tpu.models import nbiot_data as ND

        out, ok = self._decode(
            "signal_nbiot_dci_formatN0_L_1_nid0_tti_8624_rnti_0x102.bin",
            8624, 0x102)
        assert ok[0]                          # format-0 candidate, ncce 0
        dci = ND.unpack_dci_n0(np.asarray(out["bits"][0, 0]))
        # srsran_nbiot_dci_msg_to_ul_grant must yield a valid NPUSCH
        # allocation: single-tone/multi-tone sc_indication in range
        assert dci.sc_indication <= 18 and dci.mcs <= 12
        assert (dci.i_ru, dci.mcs, dci.ndi) == (7, 4, 1)

    def test_format_n1_dl_grant(self):
        """-c 0 -t 5461 -r 137 -L 2 -l 0 -o FormatN1: aggregated DCI."""
        from srsran_4g_tpu.models import nbiot_data as ND

        out, ok = self._decode(
            "signal_nbiot_dci_formatN1_nid0_tti_5461_rnti_0x89.bin",
            5461, 0x89)
        assert ok[2]                          # format-1 (both NCCEs)
        dci = ND.unpack_dci_n1(np.asarray(out["bits"][0, 2]))
        # ... and to a valid DL grant (npdsch_npdcch_dci_formatN1_test)
        assert (dci.i_sf, dci.mcs, dci.i_rep) == (1, 3, 0)
        assert dci.nof_sf == 2 and dci.tbs > 0


# --------------------------------------------------- PMCH capture

class TestPmchFile:
    """pmch_file_test -i pmch_100prbs_MCS2_SR0.bin
    (phch/test/CMakeLists.txt:463): one MBSFN subframe, 100-PRB ext-CP
    cell at the reduced 23.04 Msps rate, MBSFN area 1, subframe 1,
    MCS 2 full-band grant (TBS 4584).  Pass criterion: PMCH CRC OK
    (pmch_file_test.c:225 "PMCH Decoded OK!")."""

    def test_pmch_decodes(self):
        from srsran_4g_tpu.models import pmch, ra

        raw = np.fromfile(f"{REF}/pmch_100prbs_MCS2_SR0.bin",
                          np.complex64)
        cfg = ofdm.OfdmConfig(nof_prb=100, normal_cp=False,
                              custom_symbol_sz=1536)
        assert raw.size == cfg.sf_len    # one subframe at 23.04 Msps
        grid = ofdm.demodulate_mbsfn(cfg, jnp.asarray(raw)[None])
        tbs = ra.tbs_from_itbs(2, 100)   # dci.tb[0].mcs_idx = 2
        assert tbs == 4584
        pc = pmch.PmchConfig(nof_prb=100, area_id=1, subframe=1,
                             mod="qpsk", tbs=tbs)
        out = pmch.decode(pc, grid, n_iter=8)
        assert bool(out["crc_ok"][0])
        payload = np.packbits(
            np.asarray(out["bits"][0]).astype(np.uint8)).tobytes()
        assert any(payload)
        # srsran's random test payload (srsran_random with seed 0)
        assert payload[:4] == bytes.fromhex("67c66973")
