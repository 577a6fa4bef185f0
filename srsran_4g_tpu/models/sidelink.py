"""LTE sidelink: PSSS/SSSS sync, PSBCH, SCI format 0 (TS 36.211 §9).

Counterpart of the reference's sidelink set (`lib/src/phy/sync/psss.c`,
`ssss.c`, `lib/src/phy/phch/psbch.c`, `sci.c`, `mib_sl.c`): sidelink
PSS uses ZC roots {26, 37} (N_SL_ID in 0..167 -> root 26, else 37),
SSSS reuses the SSS m-sequence structure keyed by N_SL_ID, PSBCH
carries the 40-bit MIB-SL (+CRC16, TBCC, QPSK) on the centre 6 PRB,
and SCI format 0 is the PSCCH scheduling grant codec.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np

import jax.numpy as jnp

from srsran_4g_tpu.ops import convcode, crc as crc_ops, modem, rate_match, sequence
from ..stack.asn1 import BitReader, BitWriter

MIB_SL_LEN = 40
MIB_SL_V2X_LEN = 48   # TM3/4 SL-BCH TB (MasterInformationBlock-SL-V2X-r14)
_PSBCH_RE = 288  # 6 PRB x 4 symbols


@functools.lru_cache(maxsize=4)
def psss_sequence(root: int) -> np.ndarray:
    """Length-62 ZC (same structure as PSS but roots 26/37)."""
    n = np.arange(31)
    a = np.exp(-1j * np.pi * root * n * (n + 1) / 63)
    b = np.exp(-1j * np.pi * root * (n + 31) * (n + 32) / 63)
    return np.concatenate([a, b]).astype(np.complex64)


def psss_for_id(n_sl_id: int) -> np.ndarray:
    return psss_sequence(26 if n_sl_id < 168 else 37)


def psss_detect(rx_62: jnp.ndarray) -> dict:
    """(B, 62) centre REs -> which root (in-coverage vs out-of-coverage)."""
    mats = jnp.asarray(np.stack([psss_sequence(26), psss_sequence(37)]))
    corr = jnp.abs(rx_62 @ jnp.conj(mats).T) ** 2
    energy = jnp.sum(jnp.abs(rx_62) ** 2, axis=-1, keepdims=True) * 62
    m = corr / (energy + 1e-9)
    return dict(root_idx=jnp.argmax(m, axis=-1), metric=jnp.max(m, axis=-1))


@functools.lru_cache(maxsize=512)
def ssss_sequence(n_sl_id: int) -> np.ndarray:
    """62-length SSSS built from the SSS m-sequences keyed by N_SL_ID
    (36.211 9.7.2 reuses the 36.211 6.11.2 structure)."""
    id1, id2 = n_sl_id % 168, n_sl_id // 168

    def mseq(taps):
        x = np.zeros(36, np.int64)
        x[4] = 1
        for i in range(26):
            x[i + 5] = sum(x[i + t] for t in taps) % 2
        return 1 - 2 * x[:31]

    s = mseq((0, 2))
    c = mseq((0, 3))
    z = mseq((0, 1, 2, 4))
    m0 = id1 % 31
    m1 = (m0 + id1 // 31 + 1) % 31
    n = np.arange(31)
    d_even = s[(n + m0) % 31] * c[(n + id2) % 31]
    d_odd = s[(n + m1) % 31] * c[(n + id2 + 3) % 31] * z[(n + m0 % 8) % 31]
    out = np.empty(62, np.float32)
    out[0::2] = d_even
    out[1::2] = d_odd
    return out.astype(np.complex64)


def ssss_detect(rx_62: jnp.ndarray, n_ids: int = 336) -> dict:
    mat = jnp.asarray(np.stack([ssss_sequence(i) for i in range(n_ids)]))
    corr = jnp.abs(rx_62 @ jnp.conj(mat).T) ** 2
    energy = jnp.sum(jnp.abs(rx_62) ** 2, axis=-1, keepdims=True) * 62
    m = corr / (energy + 1e-9)
    return dict(n_sl_id=jnp.argmax(m, axis=-1), metric=jnp.max(m, axis=-1))


# --------------------------------------------------------------------------
# PSBCH: MIB-SL (40 bits) + CRC16 + TBCC + QPSK over centre 6 PRB


@dataclass
class MibSl:
    """mib_sl.c fields (36.331 SL-BCH payload)."""
    sl_bandwidth: int = 100      # PRBs
    tdd_config: int = 0
    direct_frame_number: int = 0  # 10 bits
    direct_subframe_number: int = 0  # 4 bits
    in_coverage: bool = True

    _BW = [6, 15, 25, 50, 75, 100]

    def pack(self, v2x: bool = False) -> np.ndarray:
        """40-bit MIB-SL (TM1/2) or, with v2x=True, the 48-bit
        MasterInformationBlock-SL-V2X-r14 (TM3/4) — same leading fields,
        longer reserved tail (mib_sl.c SRSRAN_MIB_SL_V2X_LEN)."""
        w = BitWriter()
        w.put(self._BW.index(self.sl_bandwidth), 3)
        w.put(self.tdd_config, 3)
        w.put(self.direct_frame_number, 10)
        w.put(self.direct_subframe_number, 4)
        w.put_bool(self.in_coverage)
        w.put(0, 27 if v2x else 19)  # reserved
        bits = np.asarray(w.bits, np.int8)
        assert len(bits) == (MIB_SL_V2X_LEN if v2x else MIB_SL_LEN)
        return bits

    @classmethod
    def unpack(cls, bits: np.ndarray) -> "MibSl":
        r = BitReader(np.packbits(np.asarray(bits, np.uint8)).tobytes())
        return cls(sl_bandwidth=cls._BW[r.get(3)], tdd_config=r.get(3),
                   direct_frame_number=r.get(10),
                   direct_subframe_number=r.get(4),
                   in_coverage=r.get_bool())


def psbch_encode(n_sl_id: int, mib_bits: jnp.ndarray) -> jnp.ndarray:
    """(B, 40) -> (B, 576) QPSK symbol block for the PSBCH REs."""
    with_crc = jnp.concatenate(
        [mib_bits.astype(jnp.int8), crc_ops.crc_compute(mib_bits, "16")],
        axis=-1)
    cw = convcode.conv_encode(with_crc)
    e = rate_match.conv_rate_match(cw, 2 * _PSBCH_RE)
    scr = sequence.gold_sequence_np(n_sl_id, 2 * _PSBCH_RE).astype(np.int8)
    e = jnp.bitwise_xor(e.astype(jnp.int8), jnp.asarray(scr))
    return modem.modulate("qpsk", e)


def psbch_decode(n_sl_id: int, syms: jnp.ndarray, noise_var=0.01) -> dict:
    b = syms.shape[0]
    llr = modem.demodulate_soft("qpsk", syms, jnp.asarray(noise_var))
    llr = llr.reshape(b, 2 * _PSBCH_RE)
    scr = sequence.gold_sequence_np(n_sl_id, 2 * _PSBCH_RE).astype(np.float32)
    llr = llr * jnp.asarray(1.0 - 2.0 * scr)
    d = rate_match.conv_rate_dematch(llr, MIB_SL_LEN + 16)
    bits = convcode.viterbi_decode(d)
    ok = crc_ops.crc_check(bits, "16")
    return dict(mib=bits[..., :MIB_SL_LEN], crc_ok=ok)


# --------------------------------------------------------------------------
# SCI format 0 (sci.c): PSCCH scheduling grant


@dataclass
class SciFormat0:
    freq_hopping: bool = False
    riv: int = 0            # resource block assignment
    trp: int = 0            # time resource pattern (7 bits)
    mcs: int = 0            # 5 bits
    timing_advance: int = 0  # 11 bits
    group_dst_id: int = 0   # 8 bits

    def pack(self, nof_prb: int = 100) -> np.ndarray:
        import math
        riv_bits = math.ceil(math.log2(nof_prb * (nof_prb + 1) / 2))
        w = BitWriter()
        w.put_bool(self.freq_hopping)
        w.put(self.riv, riv_bits)
        w.put(self.trp, 7)
        w.put(self.mcs, 5)
        w.put(self.timing_advance, 11)
        w.put(self.group_dst_id, 8)
        return np.asarray(w.bits, np.int8)

    @classmethod
    def unpack(cls, bits: np.ndarray, nof_prb: int = 100) -> "SciFormat0":
        import math
        riv_bits = math.ceil(math.log2(nof_prb * (nof_prb + 1) / 2))
        r = BitReader(np.packbits(np.asarray(bits, np.uint8)).tobytes())
        return cls(freq_hopping=r.get_bool(), riv=r.get(riv_bits),
                   trp=r.get(7), mcs=r.get(5), timing_advance=r.get(11),
                   group_dst_id=r.get(8))


# --------------------------------------------------------------------------
# PSCCH / PSSCH data channels, sidelink TM1/2 normal CP (36.211 §9.3-9.4)
#
# Counterpart of `lib/src/phy/phch/pscch.c` / `pssch.c`: 14-symbol subframe
# with DMRS on l = {3, 10}; the 12 remaining symbols carry data, the last
# one (l = 13) is a guard — mapped in the coded stream but blanked at TX
# and fed zero LLRs at RX (pssch.c:252 "last OFDM symbol is used in channel
# processing but not transmitted").  Both channels are SC-FDMA
# (DFT-precoded) with the PUSCH time-first channel interleaver.

SL_DMRS_SYMS = (3, 10)
SL_DATA_SYMS = tuple(l for l in range(14) if l not in SL_DMRS_SYMS)
PSCCH_SCRAMBLING_SEED = 510  # 36.211 §9.4.1
SCI_CRC_LEN = 16


def _sl_interleave_perm(e: int, qm: int) -> np.ndarray:
    """PUSCH-style time-first interleaver over the 12 data symbols
    (`srsran_sl_ulsch_interleave`)."""
    c_mux = len(SL_DATA_SYMS)
    r = e // (c_mux * qm)
    return np.arange(e).reshape(r, c_mux, qm).transpose(1, 0, 2).reshape(-1)


def _sl_dmrs(u: int, m_sc: int) -> np.ndarray:
    """(2, m_sc) PSCCH TM1/2 DMRS: u fixed, no cyclic shift, w = [1, 1]
    (chest_sl_pscch_gen, chest_sl.c:306-336)."""
    from srsran_4g_tpu.models.refsignal_ul import base_sequence
    r = base_sequence(u, 0, m_sc).astype(np.complex64)
    return np.stack([r, r])


def _pssch12_dmrs(n_x_id: int, nof_prb: int) -> np.ndarray:
    """(2, 12·nof_prb) PSSCH TM1/2 DMRS (chest_sl_pssch_gen,
    chest_sl.c:462-544): n_cs = (N_x/2)%8, group hopping
    u[ns] = (f_gh[ns] + N_x%30) % 30 over the first two pattern slots,
    w = [1, ±1] by N_x parity."""
    from srsran_4g_tpu.models.refsignal_ul import base_sequence
    m_sc = nof_prb * 12
    alpha = 2.0 * np.pi * ((n_x_id // 2) % 8) / 12.0
    rot = np.exp(1j * alpha * np.arange(m_sc))
    f_ss = n_x_id % 30
    f_gh = _sl34_group_hop(n_x_id)
    w1 = -1.0 if n_x_id % 2 else 1.0
    rows = [base_sequence(int((f_gh[ns] + f_ss) % 30), 0, m_sc) * rot
            * (w1 ** ns) for ns in range(2)]
    return np.stack(rows).astype(np.complex64)


def _sl_map(tx_syms: jnp.ndarray, dmrs: np.ndarray, nre_total: int,
            prb_start: int, nof_prb: int) -> jnp.ndarray:
    """(B, 12, m_sc) data + DMRS → (B, 14, nre_total) grid slice."""
    b = tx_syms.shape[0]
    m_sc = nof_prb * 12
    grid = jnp.zeros((b, 14, nre_total), jnp.complex64)
    ks = jnp.arange(prb_start * 12, prb_start * 12 + m_sc)
    for i, l in enumerate(SL_DATA_SYMS[:-1]):  # last data symbol blanked
        grid = grid.at[:, l, ks].set(tx_syms[:, i])
    for i, l in enumerate(SL_DMRS_SYMS):
        grid = grid.at[:, l, ks].set(jnp.asarray(dmrs[i])[None])
    return grid


def _sl_equalize(rx_grid: jnp.ndarray, dmrs: np.ndarray, prb_start: int,
                 nof_prb: int, noise_var: float) -> jnp.ndarray:
    """LS estimate from the two DMRS symbols + MMSE → (B, 12, m_sc)
    equalized data symbols (last one zeroed)."""
    m_sc = nof_prb * 12
    ks = jnp.arange(prb_start * 12, prb_start * 12 + m_sc)
    d = jnp.asarray(dmrs)
    h = (rx_grid[:, SL_DMRS_SYMS[0]][..., ks] * jnp.conj(d[0])
         + rx_grid[:, SL_DMRS_SYMS[1]][..., ks] * jnp.conj(d[1])) / 2
    eq = []
    for l in SL_DATA_SYMS[:-1]:
        y = rx_grid[:, l][..., ks]
        eq.append(y * jnp.conj(h) / (jnp.abs(h) ** 2 + noise_var))
    eq.append(jnp.zeros_like(eq[0]))
    return jnp.stack(eq, axis=1)


@dataclass(frozen=True)
class PscchConfig:
    nof_prb_cell: int = 50   # SL carrier bandwidth (grid width)
    nof_prb_sl: int = 100    # bandwidth signalled inside SCI (RIV size)
    prb_start: int = 0
    nof_prb: int = 1         # TM1/2: PSCCH is one PRB

    @property
    def sci_len(self) -> int:
        import math
        return (1 + math.ceil(math.log2(self.nof_prb_sl *
                                        (self.nof_prb_sl + 1) / 2))
                + 7 + 5 + 11 + 8)

    @property
    def e_bits(self) -> int:
        return len(SL_DATA_SYMS) * 12 * self.nof_prb * 2  # QPSK


def pscch_encode(cfg: PscchConfig, sci_bits: jnp.ndarray) -> jnp.ndarray:
    """(B, sci_len) SCI bits → (B, 14, nre) grid slice (`pscch.c:199`)."""
    crc = crc_ops.crc_compute(sci_bits, "16")
    d = convcode.conv_encode(jnp.concatenate([sci_bits, crc], axis=-1))
    e = rate_match.conv_rate_match(d, cfg.e_bits)
    e = e[..., jnp.asarray(_sl_interleave_perm(cfg.e_bits, 2))]
    scr = sequence.gold_sequence_np(PSCCH_SCRAMBLING_SEED, cfg.e_bits)
    from srsran_4g_tpu.ops.scrambling import scramble_bits
    from srsran_4g_tpu.models.pusch import transform_precode
    syms = modem.modulate("qpsk", scramble_bits(e, jnp.asarray(scr)))
    b = sci_bits.shape[0]
    syms = transform_precode(
        syms.reshape(b, len(SL_DATA_SYMS), 12 * cfg.nof_prb))
    syms = syms.at[:, -1].set(0)
    return _sl_map(syms, _sl_dmrs(0, 12 * cfg.nof_prb),
                   cfg.nof_prb_cell * 12, cfg.prb_start, cfg.nof_prb)


def pscch_decode(cfg: PscchConfig, rx_grid: jnp.ndarray,
                 noise_var: float = 1e-2) -> dict:
    """→ dict(bits (B, sci_len), crc_ok (B,), n_x_id (B,))."""
    from srsran_4g_tpu.models.pusch import transform_deprecode
    eq = _sl_equalize(rx_grid, _sl_dmrs(0, 12 * cfg.nof_prb),
                      cfg.prb_start, cfg.nof_prb, noise_var)
    syms = transform_deprecode(eq).reshape(eq.shape[0], -1)
    llr = modem.demodulate_soft("qpsk", syms, noise_var)
    llr = llr.at[:, -24 * cfg.nof_prb:].set(0.0)  # blanked guard symbol
    scr = sequence.gold_sequence_np(PSCCH_SCRAMBLING_SEED, cfg.e_bits)
    llr = llr * jnp.asarray(1.0 - 2.0 * scr, jnp.float32)
    deperm = np.empty(cfg.e_bits, np.int64)
    perm = _sl_interleave_perm(cfg.e_bits, 2)
    deperm[perm] = np.arange(cfg.e_bits)
    llr = llr[..., jnp.asarray(deperm)]
    d = rate_match.conv_rate_dematch(llr, cfg.sci_len + SCI_CRC_LEN)
    bits = convcode.viterbi_decode(d)
    ok = crc_ops.crc_check(bits, "16")
    # n_X_ID for PSSCH scrambling = decimal of the PSCCH CRC (36.211 §9.3.1)
    crc_bits = bits[..., -SCI_CRC_LEN:].astype(jnp.int32)
    n_x_id = jnp.sum(crc_bits * (1 << jnp.arange(SCI_CRC_LEN - 1, -1, -1)),
                     axis=-1)
    return dict(bits=bits[..., :cfg.sci_len], crc_ok=ok, n_x_id=n_x_id)


def sci0_n_x_id(sci_bits: np.ndarray) -> int:
    """TX-side n_X_ID: decimal value of the SCI CRC bits."""
    crc = np.asarray(crc_ops.crc_compute(
        jnp.asarray(sci_bits, jnp.int8)[None], "16"))[0]
    return int(sum(int(b) << (SCI_CRC_LEN - 1 - i) for i, b in enumerate(crc)))


@dataclass(frozen=True)
class PsschConfig:
    tbs: int
    nof_prb_cell: int = 50
    prb_start: int = 1
    nof_prb: int = 4
    mod: str = "qpsk"
    n_x_id: int = 0
    sf_idx: int = 0
    rv: int = 0

    @property
    def qm(self) -> int:
        return {"qpsk": 2, "16qam": 4}[self.mod]

    @property
    def g_bits(self) -> int:
        return len(SL_DATA_SYMS) * 12 * self.nof_prb * self.qm

    @property
    def plan(self):
        from srsran_4g_tpu.models import sch
        return sch.dlsch_plan(self.tbs, self.g_bits, self.qm, self.rv)

    @property
    def scramble_seq(self) -> np.ndarray:
        # pssch.c:352: c_init = n_X_ID * 2^14 + (sf_idx % 10) * 2^9 + 510
        cinit = self.n_x_id * 16384 + (self.sf_idx % 10) * 512 + 510
        return sequence.gold_sequence_np(cinit, self.g_bits)


def pssch_encode(cfg: PsschConfig, tb_bits: jnp.ndarray) -> jnp.ndarray:
    """(B, tbs) SL-SCH transport block → (B, 14, nre) grid slice."""
    from srsran_4g_tpu.models import sch
    from srsran_4g_tpu.models.pusch import transform_precode
    from srsran_4g_tpu.ops.scrambling import scramble_bits
    cw = sch.dlsch_encode(cfg.plan, tb_bits)
    cw = cw[..., jnp.asarray(_sl_interleave_perm(cfg.g_bits, cfg.qm))]
    syms = modem.modulate(cfg.mod, scramble_bits(cw, jnp.asarray(cfg.scramble_seq)))
    b = tb_bits.shape[0]
    syms = transform_precode(
        syms.reshape(b, len(SL_DATA_SYMS), 12 * cfg.nof_prb))
    syms = syms.at[:, -1].set(0)
    return _sl_map(syms, _pssch12_dmrs(cfg.n_x_id, cfg.nof_prb),
                   cfg.nof_prb_cell * 12, cfg.prb_start, cfg.nof_prb)


def pssch_decode(cfg: PsschConfig, rx_grid: jnp.ndarray,
                 noise_var: float = 1e-2, n_iter: int = 5) -> dict:
    """→ dict(bits (B, tbs), crc_ok (B,))."""
    from srsran_4g_tpu.models import sch
    from srsran_4g_tpu.models.pusch import transform_deprecode
    eq = _sl_equalize(rx_grid, _pssch12_dmrs(cfg.n_x_id, cfg.nof_prb),
                      cfg.prb_start, cfg.nof_prb, noise_var)
    syms = transform_deprecode(eq).reshape(eq.shape[0], -1)
    llr = modem.demodulate_soft(cfg.mod, syms, noise_var)
    llr = llr.at[:, -12 * cfg.nof_prb * cfg.qm:].set(0.0)
    llr = llr * jnp.asarray(1.0 - 2.0 * cfg.scramble_seq, jnp.float32)
    deperm = np.empty(cfg.g_bits, np.int64)
    perm = _sl_interleave_perm(cfg.g_bits, cfg.qm)
    deperm[perm] = np.arange(cfg.g_bits)
    llr = llr[..., jnp.asarray(deperm)]
    bits, ok, _ = sch.dlsch_decode(cfg.plan, llr, n_iter=n_iter)
    return dict(bits=bits, crc_ok=ok)


# --------------------------------------------------------------------------
# PSBCH spec-exact subframe chain (psbch.c + chest_sl.c psbch path) — the
# reference-capture interop path: decodes the committed
# `signal_sidelink_ideal_tm2_*` files through the full 36.211 §9.6/9.8
# processing (the psbch_encode/psbch_decode pair above is the simplified
# RE-level codec used by the framework-internal loop tests).

PSBCH_DATA_SYMS_TM12 = (0, 4, 5, 6, 7, 8, 9)   # transmitted data symbols
PSBCH_DMRS_SYMS_TM12 = (3, 10)
PSBCH_NOF_PRB = 6
_PSBCH_NSYM = 8           # 8 coded symbols; the 8th is never transmitted

# (data_syms, dmrs_syms, nof_coded_syms) per (tm group, ext_cp) — the
# srsran_psbch_symbol_map_* tables of phy_common_sl.c:125-162.  The coded
# stream always spans one more symbol than is transmitted (psbch.c:57).
_PSBCH_LAYOUT = {
    (12, False): (PSBCH_DATA_SYMS_TM12, PSBCH_DMRS_SYMS_TM12, 8),
    (12, True): ((3, 4, 5, 6, 7), (2, 8), 6),
    (34, False): ((0, 3, 5, 7, 8, 10), (4, 6, 9), 7),
}


def _psbch_dmrs(n_sl_id: int, n_dmrs: int = 2) -> np.ndarray:
    """(n_dmrs, 72) PSBCH DMRS (chest_sl.c:95-152: u=(N/16)%30, alpha
    from (N/2)%8, w[j] = ±1^j by N parity — [1,w] for TM1/2, [1,w,1]
    for TM3/4's three DMRS symbols)."""
    from srsran_4g_tpu.models.refsignal_ul import base_sequence

    m_sc = PSBCH_NOF_PRB * 12
    u = (n_sl_id // 16) % 30
    alpha = 2.0 * np.pi * ((n_sl_id // 2) % 8) / 12.0
    r = base_sequence(u, 0, m_sc) * np.exp(1j * alpha * np.arange(m_sc))
    w1 = -1.0 if n_sl_id % 2 else 1.0
    return np.stack([(w1 ** (j % 2)) * r
                     for j in range(n_dmrs)]).astype(np.complex64)


def _psbch_perm(e: int, nsym: int = _PSBCH_NSYM) -> np.ndarray:
    """sl_ulsch_interleave over the PSBCH coded symbols (Qm=2)."""
    r = e // (nsym * 2)
    return np.arange(e).reshape(r, nsym, 2).transpose(1, 0, 2).reshape(-1)


def psbch_tx_subframe(n_sl_id: int, nof_prb: int, mib_bits: jnp.ndarray,
                      tm: int = 2, ext_cp: bool = False) -> jnp.ndarray:
    """MIB-SL bits → (B, nsym, nof_prb·12) PSBCH subframe grid
    (nsym = 12 for TM1/2 extended CP, else 14).  TM1/2 carry the 40-bit
    MIB-SL; TM3/4 the 48-bit MIB-SL-V2X (pack with v2x=True)."""
    data_syms, dmrs_syms, ncoded = _PSBCH_LAYOUT[
        (12 if tm <= 2 else 34, ext_cp)]
    m_sc = PSBCH_NOF_PRB * 12
    e = ncoded * m_sc * 2
    with_crc = jnp.concatenate(
        [mib_bits.astype(jnp.int8), crc_ops.crc_compute(mib_bits, "16")],
        axis=-1)
    cw = convcode.conv_encode(with_crc)
    bits = rate_match.conv_rate_match(cw, e)
    bits = bits[..., jnp.asarray(_psbch_perm(e, ncoded))]
    scr = sequence.gold_sequence_np(n_sl_id, e).astype(np.int8)
    bits = jnp.bitwise_xor(bits.astype(jnp.int8), jnp.asarray(scr))
    syms = modem.modulate("qpsk", bits).reshape(-1, ncoded, m_sc)
    # transform precoding per symbol
    syms = jnp.fft.fft(syms, axis=-1) / np.sqrt(m_sc)
    b = syms.shape[0]
    nre = nof_prb * 12
    k0 = nre // 2 - 36
    grid = jnp.zeros((b, 12 if ext_cp else 14, nre), jnp.complex64)
    ks = jnp.arange(k0, k0 + m_sc)
    for i, l in enumerate(data_syms):
        grid = grid.at[:, l, ks].set(syms[:, i])
    dm = _psbch_dmrs(n_sl_id, len(dmrs_syms))
    for j, l in enumerate(dmrs_syms):
        grid = grid.at[:, l, ks].set(jnp.asarray(dm[j])[None])
    return grid


def psbch_rx_subframe(n_sl_id: int, nof_prb: int, rx_grid: jnp.ndarray,
                      noise_var: float = 1e-2, tm: int = 2,
                      ext_cp: bool = False) -> dict:
    """PSBCH receive from a subframe grid (B, nsym, nof_prb·12):
    DMRS LS chest/equalize → IDFT precoding → QPSK LLR → descramble →
    deinterleave → conv rate dematch → Viterbi → CRC16.

    Returns dict(mib (B, 40), crc_ok (B,))."""
    data_syms, dmrs_syms, ncoded = _PSBCH_LAYOUT[
        (12 if tm <= 2 else 34, ext_cp)]
    m_sc = PSBCH_NOF_PRB * 12
    e = ncoded * m_sc * 2
    nre = nof_prb * 12
    k0 = nre // 2 - 36
    ks = jnp.arange(k0, k0 + m_sc)
    dm = _psbch_dmrs(n_sl_id, len(dmrs_syms))
    h = sum(rx_grid[:, l][..., ks] * jnp.conj(jnp.asarray(dm[j]))
            for j, l in enumerate(dmrs_syms)) / len(dmrs_syms)
    eq = []
    for l in data_syms:
        y = rx_grid[:, l][..., ks]
        eq.append(y * jnp.conj(h) / (jnp.abs(h) ** 2 + noise_var))
    x = jnp.stack(eq, axis=1)                       # (B, ncoded-1, 72)
    d = jnp.fft.ifft(x, axis=-1) * np.sqrt(m_sc)    # IDFT precoding
    llr = modem.demodulate_soft("qpsk", d.reshape(d.shape[0], -1),
                                jnp.asarray(noise_var))
    llr = llr.reshape(d.shape[0], -1)
    # pad the never-transmitted last coded symbol with zero LLRs
    llr = jnp.concatenate(
        [llr, jnp.zeros((llr.shape[0], 2 * m_sc), llr.dtype)], axis=-1)
    scr = sequence.gold_sequence_np(n_sl_id, e).astype(np.float32)
    llr = llr * jnp.asarray(1.0 - 2.0 * scr)
    llr = llr[..., jnp.asarray(np.argsort(_psbch_perm(e, ncoded)))]
    tb_len = MIB_SL_V2X_LEN if tm >= 3 else MIB_SL_LEN
    dstreams = rate_match.conv_rate_dematch(llr, tb_len + 16)
    bits = convcode.viterbi_decode(dstreams)
    ok = crc_ops.crc_check(bits, "16")
    return dict(mib=bits[..., :tb_len], crc_ok=ok)


def sl_demodulate(samples: jnp.ndarray, nof_prb: int) -> jnp.ndarray:
    """Sidelink OFDM demodulation of one subframe (B, sf_len) → grid
    (B, 14, nre).

    36.211 SC-FDMA defines the baseband with a +7.5 kHz half-subcarrier
    offset whose phase restarts at each symbol's body
    (e^{j2π(k+1/2)Δf(t−N_cp T_s)}), so the receive shift is applied per
    symbol with a LOCAL phase origin — a continuous time-domain ramp
    decodes self-generated loops but not third-party captures."""
    from srsran_4g_tpu.ops.ofdm import OfdmConfig, _symbol_offsets
    from srsran_4g_tpu.utils import constants as C

    cfg = OfdmConfig(nof_prb=nof_prb)
    n = cfg.symbol_sz
    offs = _symbol_offsets(cfg)
    local = jnp.asarray(
        np.exp(-1j * np.pi * np.arange(n) / n).astype(np.complex64))
    nre = cfg.nre
    rows = []
    for l in range(14):
        b = int(offs[l])
        x = samples[..., b:b + n] * local
        X = jnp.fft.fft(x, axis=-1) / np.sqrt(n)
        rows.append(jnp.concatenate(
            [X[..., -(nre // 2):], X[..., :nre // 2]], axis=-1))
    return jnp.stack(rows, axis=-2)


# --------------------------------------------------------------------------
# Sidelink TM3/TM4 (V2X): SCI format 1 on a 2-PRB PSCCH + PSSCH in
# subchannels (36.211 §9.3-9.8, 36.212 §5.4.3.1.2, 36.213 §14.1).
#
# Counterpart of the reference's TM3/4 paths in `pscch.c`/`pssch.c`/
# `chest_sl.c`/`sci.c`: 4 DMRS symbols at l = {2,5,8,11} (data on the
# other 10 with l = 13 a processed-but-blanked guard), PSCCH DMRS with
# a TX-chosen cyclic shift from {0,3,6,9} on base group u = 8, PSSCH
# DMRS/scrambling keyed by N_x_ID = the decimal PSCCH CRC.  Decodes the
# reference's committed TM4 hardware captures (qc9150 / huawei —
# tests/test_ref_captures_sl.py).

SL34_DMRS_SYMS = (2, 5, 8, 11)
SL34_DATA_SYMS = (0, 1, 3, 4, 6, 7, 9, 10, 12, 13)  # 13: guard, not tx'd
PSCCH34_NOF_PRB = 2
SCI1_LEN = 32  # SRSRAN_SCI_TM34_LEN


@dataclass
class SciFormat1:
    """SCI format 1 (36.212 §5.4.3.1.2), fixed 32-bit payload."""
    priority: int = 0          # 3 bits
    resource_reserv: int = 0   # 4 bits
    riv: int = 0               # over num_sub_channel
    time_gap: int = 0          # 4 bits
    mcs: int = 0               # 5 bits
    retransmission: int = 0    # 1 bit
    transmission_format: int = 0  # 1 bit

    @staticmethod
    def riv_bits(num_sub_channel: int) -> int:
        import math
        return math.ceil(math.log2(num_sub_channel
                                   * (num_sub_channel + 1) / 2))

    def pack(self, num_sub_channel: int) -> np.ndarray:
        w = BitWriter()
        w.put(self.priority, 3)
        w.put(self.resource_reserv, 4)
        w.put(self.riv, self.riv_bits(num_sub_channel))
        w.put(self.time_gap, 4)
        w.put(self.mcs, 5)
        w.put(self.retransmission, 1)
        w.put(self.transmission_format, 1)
        bits = np.zeros(SCI1_LEN, np.int8)
        bits[:len(w.bits)] = w.bits
        return bits

    @classmethod
    def unpack(cls, bits: np.ndarray, num_sub_channel: int) -> "SciFormat1":
        r = BitReader(np.packbits(np.asarray(bits, np.uint8)).tobytes())
        return cls(priority=r.get(3), resource_reserv=r.get(4),
                   riv=r.get(cls.riv_bits(num_sub_channel)),
                   time_gap=r.get(4), mcs=r.get(5),
                   retransmission=r.get(1), transmission_format=r.get(1))


def _sl34_interleave_perm(e: int, qm: int) -> np.ndarray:
    """PUSCH-style time-first interleaver over the 10 TM3/4 data
    symbols."""
    c_mux = len(SL34_DATA_SYMS)
    r = e // (c_mux * qm)
    return np.arange(e).reshape(r, c_mux, qm).transpose(1, 0, 2).reshape(-1)


def _pscch34_dmrs(cyclic_shift: int) -> np.ndarray:
    """(24,) PSCCH TM3/4 DMRS: u = 8, α = 2π·n_cs/12, w = +1
    (chest_sl_pscch_gen, chest_sl.c:273)."""
    from srsran_4g_tpu.models.refsignal_ul import base_sequence
    m_sc = PSCCH34_NOF_PRB * 12
    alpha = 2.0 * np.pi * cyclic_shift / 12.0
    r = base_sequence(8, 0, m_sc) * np.exp(1j * alpha * np.arange(m_sc))
    return r.astype(np.complex64)


def _sl34_group_hop(n_x_id: int) -> np.ndarray:
    """f_gh(i) for i in 0..39 (36.211 §10.1.4.1.3, c_init = N_x/30)."""
    c = sequence.gold_sequence_np(n_x_id // 30, 8 * 40).astype(np.int64)
    return (c.reshape(40, 8) << np.arange(8)).sum(-1)


def _pssch34_dmrs(n_x_id: int, sf_idx: int, nof_prb: int) -> np.ndarray:
    """(4, 12·nof_prb) PSSCH TM3/4 DMRS: n_cs = (N_x/2)%8,
    f_ss = (N_x/16)%30, f_gh indexed 4·(sf%10)+ns, w by N_x parity
    (chest_sl_pssch_gen, chest_sl.c:460)."""
    from srsran_4g_tpu.models.refsignal_ul import base_sequence
    m_sc = nof_prb * 12
    alpha = 2.0 * np.pi * ((n_x_id // 2) % 8) / 12.0
    f_ss = (n_x_id // 16) % 30
    f_gh = _sl34_group_hop(n_x_id)
    rot = np.exp(1j * alpha * np.arange(m_sc))
    w1 = -1.0 if n_x_id % 2 else 1.0
    rows = []
    for ns in range(4):
        u = int((f_gh[4 * (sf_idx % 10) + ns] + f_ss) % 30)
        r = base_sequence(u, 0, m_sc) * rot
        rows.append((w1 ** ns) * r)
    return np.stack(rows).astype(np.complex64)


def _sl34_equalize(rx_grid: jnp.ndarray, dmrs: np.ndarray, prb_start: int,
                   nof_prb: int, noise_var: float) -> jnp.ndarray:
    """LS per DMRS symbol + linear time interpolation over the slot →
    (B, 10, m_sc) equalized data symbols (the guard symbol zeroed).
    `dmrs` is (4, m_sc) — one row per DMRS symbol {2,5,8,11}."""
    m_sc = nof_prb * 12
    ks = np.arange(prb_start * 12, prb_start * 12 + m_sc)
    g = np.asarray(rx_grid)
    h_p = np.stack([g[:, l][..., ks] * np.conj(dmrs[i])
                    for i, l in enumerate(SL34_DMRS_SYMS)], axis=1)
    t = np.asarray(SL34_DMRS_SYMS, np.float32)
    eq = []
    for l in SL34_DATA_SYMS[:-1]:
        if l <= t[0]:
            h = h_p[:, 0]
        elif l >= t[-1]:
            h = h_p[:, -1]
        else:
            j = int(np.searchsorted(t, l) - 1)
            w = (l - t[j]) / (t[j + 1] - t[j])
            h = (1 - w) * h_p[:, j] + w * h_p[:, j + 1]
        y = g[:, l][..., ks]
        eq.append(y * np.conj(h) / (np.abs(h) ** 2 + noise_var))
    eq.append(np.zeros_like(eq[0]))
    return jnp.asarray(np.stack(eq, axis=1))


def pscch34_decode(rx_grid: jnp.ndarray, prb_start: int, cyclic_shift: int,
                   noise_var: float = 1e-2) -> dict:
    """TM3/4 PSCCH decode at one (subchannel, cyclic-shift) hypothesis →
    dict(bits (B, 32), crc_ok (B,), n_x_id (B,))."""
    from srsran_4g_tpu.models.pusch import transform_deprecode
    m_sc = PSCCH34_NOF_PRB * 12
    e = len(SL34_DATA_SYMS) * m_sc * 2
    dm = np.tile(_pscch34_dmrs(cyclic_shift)[None], (4, 1))
    eq = _sl34_equalize(rx_grid, dm, prb_start, PSCCH34_NOF_PRB, noise_var)
    syms = transform_deprecode(eq).reshape(eq.shape[0], -1)
    llr = modem.demodulate_soft("qpsk", syms, noise_var)
    llr = llr.at[:, -2 * m_sc:].set(0.0)     # blanked guard symbol
    scr = sequence.gold_sequence_np(PSCCH_SCRAMBLING_SEED, e)
    llr = llr * jnp.asarray(1.0 - 2.0 * scr, jnp.float32)
    deperm = np.empty(e, np.int64)
    deperm[_sl34_interleave_perm(e, 2)] = np.arange(e)
    llr = llr[..., jnp.asarray(deperm)]
    d = rate_match.conv_rate_dematch(llr, SCI1_LEN + SCI_CRC_LEN)
    bits = convcode.viterbi_decode(d)
    ok = crc_ops.crc_check(bits, "16")
    crc_bits = bits[..., -SCI_CRC_LEN:].astype(jnp.int32)
    n_x_id = jnp.sum(crc_bits * (1 << jnp.arange(SCI_CRC_LEN - 1, -1, -1)),
                     axis=-1)
    return dict(bits=bits[..., :SCI1_LEN], crc_ok=ok, n_x_id=n_x_id)


def pssch34_decode(rx_grid: jnp.ndarray, prb_start: int, nof_prb: int,
                   n_x_id: int, mcs: int, rv: int, sf_idx: int,
                   noise_var: float = 1e-2, n_iter: int = 8) -> dict:
    """TM3/4 PSSCH decode → dict(bits (B, tbs), crc_ok (B,), tbs).

    TB size from the UL MCS/TBS tables (pssch.c:237), scrambling
    c_init = N_x_ID·2^14 + (sf%10)·2^9 + 510 (pssch.c:352), turbo
    SL-SCH with the 10-symbol time-first interleaver."""
    from srsran_4g_tpu.models import ra, sch
    from srsran_4g_tpu.models.pusch import transform_deprecode
    mod = ra.ul_mcs_to_mod(mcs)
    qm = {"qpsk": 2, "16qam": 4, "64qam": 6}[mod]
    tbs = ra.tbs_from_itbs(ra.ul_mcs_to_itbs(mcs), nof_prb)
    m_sc = nof_prb * 12
    g = len(SL34_DATA_SYMS) * m_sc * qm
    dm = _pssch34_dmrs(n_x_id, sf_idx, nof_prb)
    eq = _sl34_equalize(rx_grid, dm, prb_start, nof_prb, noise_var)
    syms = transform_deprecode(eq).reshape(eq.shape[0], -1)
    llr = modem.demodulate_soft(mod, syms, noise_var)
    llr = llr.at[:, -qm * m_sc:].set(0.0)
    cinit = (n_x_id << 14) + ((sf_idx % 10) << 9) + 510
    scr = sequence.gold_sequence_np(cinit % (1 << 31), g)
    llr = llr * jnp.asarray(1.0 - 2.0 * scr, jnp.float32)
    deperm = np.empty(g, np.int64)
    deperm[_sl34_interleave_perm(g, qm)] = np.arange(g)
    llr = llr[..., jnp.asarray(deperm)]
    plan = sch.dlsch_plan(tbs, g, qm, rv)
    bits, ok, _ = sch.dlsch_decode(plan, llr, n_iter=n_iter)
    return dict(bits=bits, crc_ok=ok, tbs=tbs, mod=mod)


def pssch34_prbs(sub_channel_idx: int, riv: int, size_sub_channel: int,
                 num_sub_channel: int, start_prb: int = 0) -> tuple[int, int]:
    """PSSCH PRB range from the SCI-1 RIV (36.213 §14.1.1.4C; adjacent
    PSCCH+PSSCH pools): returns (prb_start, nof_prb) with nof_prb
    clipped to the largest DFT-precodable size."""
    from srsran_4g_tpu.models import ra as _ra
    l_subch, _ = _ra.riv_decode(num_sub_channel, riv)
    prb_start = (sub_channel_idx * size_sub_channel + PSCCH34_NOF_PRB
                 + start_prb)
    nof = ((l_subch + sub_channel_idx) * size_sub_channel
           - prb_start + start_prb)
    while nof > 1 and not _valid_dft_prb(nof):
        nof -= 1
    return prb_start, nof


def _valid_dft_prb(n: int) -> bool:
    for p in (2, 3, 5):
        while n % p == 0:
            n //= p
    return n == 1


def sl_subframe_grid(samples: np.ndarray, nof_prb: int,
                     symbol_sz: int) -> jnp.ndarray:
    """One sidelink subframe → (1, 14, nof_prb·12) with the per-symbol
    half-subcarrier de-rotation (as sl_demodulate, but with an explicit
    FFT size for the reference's non-standard sample rates, e.g. 768 at
    50 PRB / 11.52 Msps)."""
    cp0 = symbol_sz * 160 // 2048
    cp = symbol_sz * 144 // 2048
    nre = nof_prb * 12
    local = np.exp(-1j * np.pi * np.arange(symbol_sz) / symbol_sz)
    rows = []
    pos = 0
    for l in range(14):
        pos += cp0 if l in (0, 7) else cp
        x = np.fft.fft(samples[pos:pos + symbol_sz] * local)
        x = x / np.sqrt(symbol_sz)
        rows.append(np.concatenate([x[-(nre // 2):], x[:nre // 2]]))
        pos += symbol_sz
    return jnp.asarray(np.stack(rows)[None].astype(np.complex64))


def slss_find(samples: np.ndarray, nof_prb: int, symbol_sz: int,
              root: int = 26) -> dict:
    """SLSS time synchronisation: matched-filter the time-domain PSSS
    (symbols 1–2 of an SLSS subframe, 36.211 §9.7.1) against the raw
    capture and return the implied subframe start.

    The batched counterpart of the reference's `sync_sl.c` PSSS correlation
    stage that `ue_sl` runs before any PSBCH decode — captures from
    real testers (e.g. the CMW500 SLSS file) are not aligned to sample
    0, so timing must come from the sync signal itself.  The two PSSS
    symbols are correlated as one batched matmul over all candidate
    lags."""
    cp0 = symbol_sz * 160 // 2048
    cp = symbol_sz * 144 // 2048
    # time-domain PSSS symbol: 62 centre REs around DC, half-subcarrier
    # shifted like the rest of the sidelink baseband
    z = psss_sequence(root)
    X = np.zeros(symbol_sz, np.complex64)
    X[-31:] = z[:31] * np.sqrt(symbol_sz)
    X[1:32] = z[31:] * np.sqrt(symbol_sz)
    ref = np.fft.ifft(X) * np.exp(1j * np.pi * np.arange(symbol_sz)
                                  / symbol_sz)
    ref = (ref / np.linalg.norm(ref)).astype(np.complex64)
    n = len(samples) - symbol_sz
    if n <= 0:
        return dict(offset=0, metric=0.0)
    # batched correlation at every lag via an FFT overlap of the
    # conjugate-reversed filter (linear correlation)
    m = int(2 ** np.ceil(np.log2(len(samples) + symbol_sz)))
    S = np.fft.fft(samples, m)
    R = np.fft.fft(np.conj(ref[::-1]), m)
    corr = np.abs(np.fft.ifft(S * R))[symbol_sz - 1:symbol_sz - 1 + n]
    # PSSS is transmitted twice (symbols 1 and 2): sum the pair spaced
    # one symbol+CP apart for a sharper peak
    stride = symbol_sz + cp
    pair = corr[:-stride] + corr[stride:]
    l1 = int(np.argmax(pair))           # body start of symbol 1
    off = l1 - (cp0 + symbol_sz + cp)   # subframe start
    return dict(offset=off, metric=float(pair[l1]),
                corr=float(corr[l1]))


def psbch_sync_decode(samples: np.ndarray, nof_prb: int, symbol_sz: int,
                      n_sl_id: int, tm: int = 2,
                      noise_var: float = 1e-2) -> dict:
    """SLSS-synchronised PSBCH decode of a raw capture: PSSS matched
    filter for coarse timing, then a CRC-gated fine-timing hypothesis
    batch over the CP ambiguity range.

    Real-tester captures carry sampling-frequency offset (the reference
    notes "SFO offset of ~64 samples" on its CMW500 files and hands the
    binary a manual `-o`, CMakeLists.txt:136); instead of a magic
    constant, all fine-timing hypotheses are demodulated and PSBCH-
    decoded as ONE batch and the CRC selects the winner — the batch
    axis is the batched form of `sync_sl.c`'s serial search."""
    cp0 = symbol_sz * 160 // 2048
    coarse = slss_find(samples, nof_prb, symbol_sz,
                       26 if n_sl_id < 168 else 37)["offset"]
    offs = [coarse + d for d in range(-8, cp0 + 24, 4)]
    offs = [o for o in offs if o >= 0] or [0]
    pad = np.concatenate([samples, np.zeros(2 * symbol_sz + cp0 + 32,
                                            samples.dtype)])
    grids = jnp.concatenate(
        [sl_subframe_grid(pad[o:], nof_prb, symbol_sz) for o in offs])
    out = psbch_rx_subframe(n_sl_id, nof_prb, grids, noise_var, tm=tm)
    # reject the all-zero decode: a mistimed hypothesis yields zero LLRs
    # whose trivial all-zero codeword passes CRC (same guard as the SCI
    # unpack sanity check, sci.c:107-116)
    ok = np.asarray(out["crc_ok"]) & np.asarray(out["mib"]).any(axis=-1)
    if not ok.any():
        return dict(crc_ok=False, mib=None, offset=coarse)
    i = int(np.argmax(ok))
    return dict(crc_ok=True, mib=np.asarray(out["mib"][i]),
                offset=offs[i])


def sl_subframe_grid_ext(samples: np.ndarray, nof_prb: int,
                         symbol_sz: int) -> jnp.ndarray:
    """Extended-CP sidelink subframe → (1, 12, nof_prb·12): 12 symbols
    with CP = symbol_sz/4 (36.211 Table 9.1-1), same per-symbol
    half-subcarrier de-rotation as `sl_subframe_grid`."""
    cp = symbol_sz // 4
    nre = nof_prb * 12
    local = np.exp(-1j * np.pi * np.arange(symbol_sz) / symbol_sz)
    rows = []
    pos = 0
    for l in range(12):
        pos += cp
        x = np.fft.fft(samples[pos:pos + symbol_sz] * local)
        x = x / np.sqrt(symbol_sz)
        rows.append(np.concatenate([x[-(nre // 2):], x[:nre // 2]]))
        pos += symbol_sz
    return jnp.asarray(np.stack(rows)[None].astype(np.complex64))
