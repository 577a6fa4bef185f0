"""NB-IoT data channels: NRS, NPDCCH (DCI N0/N1/N2) and NPDSCH.

Counterpart of the reference's `lib/src/phy/phch/npdcch.c`, `npdsch.c`,
`dci_nbiot.c`, `ra_nbiot.c` (+ `tbs_tables_nbiot.h`) and
`lib/src/phy/ch_estimation/refsignal_dl_nbiot.c`:

- NRS pilots in the last two symbols of each slot (2 REs/symbol/port),
  CRS-formula sequences seeded by N_id_Ncell.
- NPDCCH: DCI + CRC16 XOR-masked by RNTI, tail-biting convolutional
  code, rate matching, scrambling c_init = (ns/2)·512 + N_id_Ncell,
  QPSK onto one or both NCCEs (lower/upper 6 subcarriers of the PRB).
- NPDSCH: TB + CRC24A → TBCC → rate matching over nof_sf subframes,
  per-subframe scrambling c_init = rnti·2^14 + (nf%2)·2^13 +
  (ns/2)·2^9 + N_id_Ncell (BCCH: (0xffff<<15) + (ncell+1)·((nf%61)+1)),
  QPSK onto the PRB minus NRS REs.
- TBS tables 16.4.1.5.1-1 / 16.4.1.5.2-1 / 16.5.1.2-2 and the DCI
  N0/N1/N2 field layouts of TS 36.212 §6.4.3.

Batch-first: the subframe axis of a multi-subframe NPDSCH is just another
batch dim; all REs/permutations are host-precomputed index tensors and
the decoder is one batched Viterbi over (B·nof_candidates) for the
NPDCCH blind search.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import jax.numpy as jnp
import numpy as np

from srsran_4g_tpu.ops import convcode, crc as crc_ops, modem, rate_match
from srsran_4g_tpu.ops.crc import crc_matrix
from srsran_4g_tpu.ops.sequence import gold_sequence_np
from srsran_4g_tpu.utils import constants as C

# --- TBS tables (TS 36.213 §16.4.1.5 / §16.5.1.2) ----------------------------

TBS_NPDSCH = np.array([
    [16, 32, 56, 88, 120, 152, 208, 256],
    [24, 56, 88, 144, 176, 208, 256, 344],
    [32, 72, 144, 176, 208, 256, 328, 424],
    [40, 104, 176, 208, 256, 328, 440, 568],
    [56, 120, 208, 256, 328, 408, 552, 680],
    [72, 144, 224, 328, 424, 504, 680, 0],
    [88, 176, 256, 392, 504, 600, 0, 0],
    [104, 224, 328, 472, 584, 680, 0, 0],
    [120, 256, 392, 536, 680, 0, 0, 0],
    [136, 296, 456, 616, 0, 0, 0, 0],
    [144, 328, 504, 680, 0, 0, 0, 0],
    [176, 376, 584, 0, 0, 0, 0, 0],
    [208, 440, 680, 0, 0, 0, 0, 0]])

TBS_SIB1 = np.array(
    [208, 208, 208, 328, 328, 328, 440, 440, 440, 680, 680, 680, 0, 0, 0, 0])

TBS_NPUSCH = np.array([
    [16, 32, 56, 88, 120, 152, 208, 256],
    [24, 56, 88, 144, 176, 208, 256, 344],
    [32, 72, 144, 176, 208, 256, 328, 424],
    [40, 104, 176, 208, 256, 328, 440, 568],
    [56, 120, 208, 256, 328, 408, 552, 680],
    [72, 144, 224, 328, 424, 504, 680, 872],
    [88, 176, 256, 392, 504, 600, 808, 1000],
    [104, 224, 328, 472, 584, 712, 1000, 0],
    [120, 256, 392, 536, 680, 808, 0, 0],
    [136, 296, 456, 616, 776, 936, 0, 0],
    [144, 328, 504, 680, 872, 1000, 0, 0],
    [176, 376, 584, 776, 1000, 0, 0, 0],
    [208, 440, 680, 1000, 0, 0, 0, 0]])

I_SF_TO_NOF_SF = (1, 2, 3, 4, 5, 6, 8, 10)        # Table 16.4.1.3-1
I_REP_TO_NOF_REP = (1, 2, 4, 8, 16, 32, 64, 128,
                    192, 256, 384, 512, 768, 1024, 1536, 2048)


def npdsch_tbs(i_tbs: int, i_sf: int) -> int:
    """srsran_ra_nbiot_get_npdsch_tbs (ra_nbiot.c:178)."""
    t = int(TBS_NPDSCH[i_tbs, i_sf])
    if t == 0:
        raise ValueError(f"invalid (i_tbs={i_tbs}, i_sf={i_sf})")
    return t


# --- NRS ----------------------------------------------------------------------

NRS_SYMS = (5, 6, 12, 13)  # last two symbols of each slot


@functools.lru_cache(maxsize=128)
def nrs_pattern(n_id_ncell: int) -> tuple[np.ndarray, np.ndarray]:
    """(symbols (4,), subcarriers (4, 2)) of the NRS REs, port 0."""
    vshift = n_id_ncell % 6
    syms, scs = [], []
    for l_sf in NRS_SYMS:
        v = 0 if (l_sf % 7) == 5 else 3
        k = (v + vshift) % 6 + 6 * np.arange(2)
        syms.append(l_sf)
        scs.append(k)
    return np.asarray(syms), np.stack(scs)


@functools.lru_cache(maxsize=512)
def nrs_values(n_id_ncell: int, subframe: int) -> np.ndarray:
    """NRS QPSK pilots (4, 2) — CRS formula (grid.crs_values) seeded with
    N_id_Ncell, single PRB at the centre of the virtual 110-PRB grid."""
    out = []
    for l_sf in NRS_SYMS:
        ns = 2 * subframe + l_sf // 7
        l = l_sf % 7
        c_init = (1024 * (7 * (ns + 1) + l + 1) * (2 * n_id_ncell + 1)
                  + 2 * n_id_ncell + 1)
        seq = gold_sequence_np(c_init, 4 * C.MAX_PRB).astype(np.float32)
        m = np.arange(2) + C.MAX_PRB - 1
        re = (1.0 - 2.0 * seq[2 * m]) / np.sqrt(2)
        im = (1.0 - 2.0 * seq[2 * m + 1]) / np.sqrt(2)
        out.append((re + 1j * im).astype(np.complex64))
    return np.stack(out)


def put_nrs(grid: jnp.ndarray, n_id_ncell: int, subframe: int) -> jnp.ndarray:
    ls, ks = nrs_pattern(n_id_ncell)
    vals = nrs_values(n_id_ncell, subframe)
    return grid.at[..., jnp.asarray(ls)[:, None], jnp.asarray(ks)].set(
        jnp.asarray(vals))


@functools.lru_cache(maxsize=128)
def npdsch_re_indices(n_id_ncell: int, ctrl_syms: int = 0) -> np.ndarray:
    """Flat (symbol*12+sc) indices of the PRB REs available to
    NPDSCH/NPDCCH: all symbols from `ctrl_syms` on, minus NRS
    (standalone/guardband: ctrl_syms = 0 → 160 REs)."""
    used = np.zeros((14, 12), dtype=bool)
    used[:ctrl_syms, :] = True
    ls, ks = nrs_pattern(n_id_ncell)
    for i, l in enumerate(ls):
        used[l, ks[i]] = True
    free = ~used
    return np.flatnonzero(free.reshape(-1))


@functools.lru_cache(maxsize=16)
def _nrs_interp_w(n_id_ncell: int) -> tuple[np.ndarray, np.ndarray]:
    """(pilot subcarriers (4,), interpolation weights (12, 4)) mapping
    the 4 distinct NRS subcarriers to all 12 by linear
    interpolation/extrapolation (chest_dl_nbiot.c interpolate)."""
    _, ks = nrs_pattern(n_id_ncell)
    uk = np.unique(ks.reshape(-1))
    w = np.zeros((12, len(uk)), np.float32)
    for k in range(12):
        j = int(np.searchsorted(uk, k))
        a, b = (0, 1) if j == 0 else (
            (len(uk) - 2, len(uk) - 1) if j >= len(uk) else (j - 1, j))
        t = (k - uk[a]) / (uk[b] - uk[a])
        w[k, a], w[k, b] = 1 - t, t
    return uk, w


def nrs_estimate(rx_grid: jnp.ndarray, n_id_ncell: int,
                 subframe: int) -> tuple[jnp.ndarray, jnp.ndarray]:
    """LS estimate at the 8 NRS REs → per-subcarrier channel
    ((..., 12) h, (...,) noise_var).

    The two estimates per pilot subcarrier (one per slot) are averaged,
    then linearly interpolated/extrapolated over the PRB — this tracks
    the frequency-selective/timing-offset channels of the real-device
    NPDCCH captures where a single flat coefficient cannot (reference:
    chest_dl_nbiot.c estimate + interpolate).  noise_var is the
    within-subcarrier residual."""
    ls, ks = nrs_pattern(n_id_ncell)
    vals = jnp.asarray(nrs_values(n_id_ncell, subframe))
    y = rx_grid[..., jnp.asarray(ls)[:, None], jnp.asarray(ks)]
    h_ls = (y * jnp.conj(vals)).reshape(*y.shape[:-2], 8)
    uk, w = _nrs_interp_w(n_id_ncell)
    flat_k = ks.reshape(-1)
    sel = np.stack([flat_k == k for k in uk]).astype(np.float32)  # (4, 8)
    cnt = sel.sum(-1)
    hk = h_ls @ jnp.asarray(sel.T / cnt)                          # (..., 4)
    # residual of the per-RE LS vs its subcarrier mean
    h_back = hk @ jnp.asarray(sel)
    nv = jnp.mean(jnp.abs(h_ls - h_back) ** 2, axis=-1)
    h12 = hk @ jnp.asarray(w.T)                                   # (..., 12)
    return h12.astype(jnp.complex64), nv.astype(jnp.float32)


# --- DCI N0 / N1 / N2 codecs (TS 36.212 §6.4.3, dci_nbiot.c) ------------------

DCI_N0_N1_LEN = 23
DCI_N2_LEN = 15


def _pack(fields: list[tuple[int, int]], total: int) -> np.ndarray:
    bits: list[int] = []
    for val, width in fields:
        bits.extend((val >> (width - 1 - i)) & 1 for i in range(width))
    bits.extend([0] * (total - len(bits)))
    return np.asarray(bits[:total], np.int8)


def _unpack(bits: np.ndarray, widths: list[int]) -> list[int]:
    out, p = [], 0
    for w in widths:
        v = 0
        for i in range(w):
            v = (v << 1) | int(bits[p + i])
        out.append(v)
        p += w
    return out


@dataclass(frozen=True)
class DciN0:
    """UL grant (format flag 0): 36.212 §6.4.3.1."""
    sc_indication: int = 0   # 6 bits
    i_ru: int = 0            # 3 bits (resource assignment)
    i_delay: int = 0         # 2 bits (scheduling delay)
    mcs: int = 0             # 4 bits
    rv: int = 0              # 1 bit
    i_rep: int = 0           # 3 bits
    ndi: int = 0             # 1 bit
    dci_sf_rep: int = 0      # 2 bits

    def pack(self) -> np.ndarray:
        return _pack([(0, 1), (self.sc_indication, 6), (self.i_ru, 3),
                      (self.i_delay, 2), (self.mcs, 4), (self.rv, 1),
                      (self.i_rep, 3), (self.ndi, 1), (self.dci_sf_rep, 2)],
                     DCI_N0_N1_LEN)


@dataclass(frozen=True)
class DciN1:
    """DL grant (format flag 1): 36.212 §6.4.3.2, NPDSCH scheduling."""
    i_delay: int = 0    # 3 bits
    i_sf: int = 0       # 3 bits
    mcs: int = 0        # 4 bits (i_tbs)
    i_rep: int = 0      # 4 bits
    ndi: int = 0        # 1 bit
    harq_ack: int = 0   # 4 bits

    def pack(self) -> np.ndarray:
        return _pack([(1, 1), (0, 1),  # format flag, NPDCCH-order flag
                      (self.i_delay, 3), (self.i_sf, 3), (self.mcs, 4),
                      (self.i_rep, 4), (self.ndi, 1), (self.harq_ack, 4)],
                     DCI_N0_N1_LEN)

    @property
    def nof_sf(self) -> int:
        return I_SF_TO_NOF_SF[self.i_sf]

    @property
    def tbs(self) -> int:
        return npdsch_tbs(self.mcs, self.i_sf)


@dataclass(frozen=True)
class DciN2:
    """Paging/direct indication (15 bits): 36.212 §6.4.3.3."""
    is_paging: int = 1
    i_sf: int = 0
    mcs: int = 0
    i_rep: int = 0

    def pack(self) -> np.ndarray:
        return _pack([(self.is_paging, 1), (self.i_sf, 3), (self.mcs, 4),
                      (self.i_rep, 4)], DCI_N2_LEN)


def unpack_dci_n1(bits: np.ndarray) -> DciN1:
    f = _unpack(np.asarray(bits), [1, 1, 3, 3, 4, 4, 1, 4])
    assert f[0] == 1, "not a format N1 DCI"
    return DciN1(i_delay=f[2], i_sf=f[3], mcs=f[4], i_rep=f[5], ndi=f[6],
                 harq_ack=f[7])


def unpack_dci_n0(bits: np.ndarray) -> DciN0:
    f = _unpack(np.asarray(bits), [1, 6, 3, 2, 4, 1, 3, 1, 2])
    assert f[0] == 0, "not a format N0 DCI"
    return DciN0(sc_indication=f[1], i_ru=f[2], i_delay=f[3], mcs=f[4],
                 rv=f[5], i_rep=f[6], ndi=f[7], dci_sf_rep=f[8])


# --- NPDCCH -------------------------------------------------------------------

def _rnti_mask16(rnti: int) -> np.ndarray:
    return ((rnti >> np.arange(15, -1, -1)) & 1).astype(np.int8)


def _npdcch_scramble(n_id_ncell: int, ns: int, n: int) -> np.ndarray:
    return gold_sequence_np((ns // 2) * 512 + n_id_ncell, n)


@functools.lru_cache(maxsize=128)
def ncce_re_indices(n_id_ncell: int, ncce: int,
                    ctrl_syms: int = 0) -> np.ndarray:
    """REs of one NCCE: the lower (ncce=0) / upper (1) 6 subcarriers of
    the PRB, NRS excluded (npdcch.c FORMAT0_LOWER/UPPER_HALF)."""
    idx = npdsch_re_indices(n_id_ncell, ctrl_syms)
    sc = idx % 12
    return idx[(sc < 6) if ncce == 0 else (sc >= 6)]


def npdcch_encode(dci_bits: jnp.ndarray, rnti: int, n_id_ncell: int,
                  subframe: int, ncce: int = 0, l_agg: int = 2,
                  ctrl_syms: int = 0) -> jnp.ndarray:
    """(B, A) DCI payload → (B, 14, 12) PRB grid with NPDCCH (+NRS).

    l_agg=2 is NPDCCH format 1 (both NCCEs), l_agg=1 format 0 on `ncce`.
    """
    g = jnp.asarray(crc_matrix(dci_bits.shape[-1], "16"), jnp.float32)
    crc = (jnp.dot(dci_bits.astype(jnp.float32), g).astype(jnp.int32)
           & 1).astype(jnp.int8)
    mask = jnp.asarray(_rnti_mask16(rnti))
    cw = jnp.concatenate(
        [dci_bits.astype(jnp.int8), jnp.bitwise_xor(crc, mask)], axis=-1)
    d = convcode.conv_encode(cw)
    if l_agg == 2:
        # format 1 maps over both NCCEs in natural RE order (the two
        # halves interleave per symbol, npdcch.c srsran_npdcch_put) —
        # NOT lower-NCCE-then-upper concatenation
        res = np.sort(np.concatenate(
            [ncce_re_indices(n_id_ncell, 0, ctrl_syms),
             ncce_re_indices(n_id_ncell, 1, ctrl_syms)]))
    else:
        res = ncce_re_indices(n_id_ncell, ncce, ctrl_syms)
    e_bits = 2 * res.shape[0]
    e = rate_match.conv_rate_match(d, e_bits)
    scr = _npdcch_scramble(n_id_ncell, 2 * subframe, e_bits)
    e = jnp.bitwise_xor(e.astype(jnp.int8), jnp.asarray(scr))
    syms = modem.modulate("qpsk", e)
    b = dci_bits.shape[0]
    grid = jnp.zeros((b, 14 * 12), jnp.complex64)
    grid = grid.at[:, jnp.asarray(res)].set(syms)
    grid = put_nrs(grid.reshape(b, 14, 12), n_id_ncell, subframe)
    return grid


def npdcch_blind_decode(rx_grid: jnp.ndarray, rnti: int, n_id_ncell: int,
                        subframe: int, dci_len: int = DCI_N0_N1_LEN,
                        ctrl_syms: int = 0) -> dict:
    """Search the UE-specific space (format 0 lower/upper NCCE, format 1)
    for a DCI whose CRC16 matches `rnti` (npdcch.c srsran_npdcch_decode_msg).

    Returns dict(bits (B, C, A), crc_ok (B, C)) for the C=3 candidates."""
    h, nv = nrs_estimate(rx_grid, n_id_ncell, subframe)
    flat = rx_grid.reshape(rx_grid.shape[0], -1)
    cands = []
    for ncce, l_agg in ((0, 1), (1, 1), (0, 2)):
        if l_agg == 2:
            # natural RE order over both NCCEs (see npdcch_encode)
            res = np.sort(np.concatenate(
                [ncce_re_indices(n_id_ncell, 0, ctrl_syms),
                 ncce_re_indices(n_id_ncell, 1, ctrl_syms)]))
        else:
            res = ncce_re_indices(n_id_ncell, ncce, ctrl_syms)
        y = flat[:, jnp.asarray(res)]
        h_re = h[..., jnp.asarray(res % 12)]
        x = y * jnp.conj(h_re) / (jnp.abs(h_re) ** 2 + nv[..., None])
        llr = modem.demodulate_soft(
            "qpsk", x, nv[..., None] / jnp.maximum(
                jnp.abs(h_re) ** 2, 1e-9)).reshape(flat.shape[0], -1)
        scr = _npdcch_scramble(n_id_ncell, 2 * subframe, llr.shape[-1])
        llr = llr * (1.0 - 2.0 * jnp.asarray(scr, jnp.float32))
        dd = rate_match.conv_rate_dematch(llr, dci_len + 16)
        dec = convcode.viterbi_decode(dd, tail_biting=True)
        mask = jnp.asarray(_rnti_mask16(rnti))
        payload, rx_crc = dec[:, :dci_len], dec[:, dci_len:]
        calc = (jnp.dot(payload.astype(jnp.float32),
                        jnp.asarray(crc_matrix(dci_len, "16"), jnp.float32)
                        ).astype(jnp.int32) & 1).astype(jnp.int8)
        ok = jnp.all(jnp.bitwise_xor(calc, mask) == rx_crc, axis=-1)
        cands.append((payload, ok))
    bits = jnp.stack([c[0] for c in cands], axis=1)
    ok = jnp.stack([c[1] for c in cands], axis=1)
    return dict(bits=bits, crc_ok=ok)


# --- NPDSCH -------------------------------------------------------------------

@dataclass(frozen=True)
class NpdschConfig:
    n_id_ncell: int
    rnti: int
    i_tbs: int
    i_sf: int
    sfn: int = 0
    start_sf: int = 4     # first subframe index carrying the NPDSCH
    is_bcch: bool = False
    ctrl_syms: int = 0    # 0 standalone/guardband, 3 in-band

    @property
    def nof_sf(self) -> int:
        return I_SF_TO_NOF_SF[self.i_sf]

    @property
    def tbs(self) -> int:
        return int(TBS_SIB1[self.i_tbs]) if self.is_bcch else \
            npdsch_tbs(self.i_tbs, self.i_sf)

    def sf_list(self) -> list[tuple[int, int]]:
        """(nf, subframe) for each of the nof_sf subframes (skipping the
        NPSS/NSSS subframes 5 and 9 and the NPBCH subframe 0)."""
        out = []
        nf, sf = self.sfn, self.start_sf
        while len(out) < self.nof_sf:
            if sf not in (0, 5, 9):
                out.append((nf, sf))
            sf += 1
            if sf == 10:
                sf, nf = 0, nf + 1
        return out


def _npdsch_scramble(cfg: NpdschConfig, nf: int, subframe: int,
                     n: int) -> np.ndarray:
    if cfg.is_bcch:
        cinit = (0xFFFF << 15) + (cfg.n_id_ncell + 1) * ((nf % 61) + 1)
    else:
        cinit = ((cfg.rnti << 14) + ((nf % 2) << 13)
                 + ((2 * subframe) // 2 << 9) + cfg.n_id_ncell)
    return gold_sequence_np(cinit, n)


def npdsch_encode(cfg: NpdschConfig, tb_bits: jnp.ndarray) -> jnp.ndarray:
    """(B, tbs) → (B, nof_sf, 14, 12) PRB grids with NPDSCH + NRS."""
    b = tb_bits.shape[0]
    res = npdsch_re_indices(cfg.n_id_ncell, cfg.ctrl_syms)
    e_sf = 2 * res.shape[0]
    with_crc = jnp.concatenate(
        [tb_bits.astype(jnp.int8), crc_ops.crc_compute(tb_bits, "24A")],
        axis=-1)
    d = convcode.conv_encode(with_crc)
    e = rate_match.conv_rate_match(d, e_sf * cfg.nof_sf)
    grids = []
    for i, (nf, sf) in enumerate(cfg.sf_list()):
        seg = e[:, i * e_sf:(i + 1) * e_sf]
        scr = _npdsch_scramble(cfg, nf, sf, e_sf)
        seg = jnp.bitwise_xor(seg.astype(jnp.int8), jnp.asarray(scr))
        syms = modem.modulate("qpsk", seg)
        g = jnp.zeros((b, 14 * 12), jnp.complex64)
        g = g.at[:, jnp.asarray(res)].set(syms)
        grids.append(put_nrs(g.reshape(b, 14, 12), cfg.n_id_ncell, sf))
    return jnp.stack(grids, axis=1)


def npdsch_decode(cfg: NpdschConfig, rx_grids: jnp.ndarray) -> dict:
    """(B, nof_sf, 14, 12) → dict(bits (B, tbs), crc_ok (B,))."""
    res = npdsch_re_indices(cfg.n_id_ncell, cfg.ctrl_syms)
    e_sf = 2 * res.shape[0]
    llr_parts = []
    for i, (nf, sf) in enumerate(cfg.sf_list()):
        g = rx_grids[:, i]
        h, nv = nrs_estimate(g, cfg.n_id_ncell, sf)
        y = g.reshape(g.shape[0], -1)[:, jnp.asarray(res)]
        h_re = h[..., jnp.asarray(res % 12)]
        x = y * jnp.conj(h_re) / (jnp.abs(h_re) ** 2 + nv[..., None])
        llr = modem.demodulate_soft(
            "qpsk", x, nv[..., None] / jnp.maximum(
                jnp.abs(h_re) ** 2, 1e-9)).reshape(g.shape[0], -1)
        scr = _npdsch_scramble(cfg, nf, sf, e_sf)
        llr_parts.append(llr * (1.0 - 2.0 * jnp.asarray(scr, jnp.float32)))
    llr = jnp.concatenate(llr_parts, axis=-1)
    d = rate_match.conv_rate_dematch(llr, cfg.tbs + 24)
    dec = convcode.viterbi_decode(d, tail_biting=True)
    ok = crc_ops.crc_check(dec, "24A")
    return dict(bits=dec[:, :cfg.tbs], crc_ok=ok)
