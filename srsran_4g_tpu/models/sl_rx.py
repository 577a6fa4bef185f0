"""Sidelink blind-search receiver: the batched counterpart of the reference's
`pssch_pscch_file_test.c` flow — per-subframe OFDM demod, PSCCH blind
search over the resource pool, SCI unpack, then PSSCH decode at the
SCI-indicated allocation.

TM1/2 (36.213 §14.2.1.2): PSCCH PRB sweep over [prb_start, prb_end] on
the pool's PSCCH subframes, SCI format 0, PSSCH subframes gated by the
time-resource pattern with rv cycling 0,1,2,3
(`pssch_pscch_file_test.c:284-345`).

TM3/4 (36.213 §14.1.1.4C): per-subchannel 2-PRB PSCCH with a blind
cyclic-shift search over {0,3,6,9}, SCI format 1, adjacent PSSCH whose
PRBs derive from the SCI RIV over subchannels
(`pssch_pscch_file_test.c:346-431`).

All PSCCH hypotheses of a subframe (subchannels × cyclic shifts for
TM3/4, PRB starts for TM1/2) are decoded as ONE batch through the
conv-dematch → Viterbi → CRC chain — the blind search is a batch axis,
not a loop, which is the batched shape of the reference's
`for prb / for shift { pscch_decode }` scan.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import jax.numpy as jnp

from srsran_4g_tpu.models import sidelink as SL
from srsran_4g_tpu.ops import convcode, crc as crc_ops, modem, rate_match, \
    sequence

# SL-SCH redundancy-version table (pssch.h:40 srsran_pssch_rv): the SCI
# retransmission index 0..3 maps to rate-matcher rv 0,2,3,1
PSSCH_RV = (0, 2, 3, 1)


@dataclass
class SlPool:
    """Sidelink communication resource pool
    (`phy_common_sl.c:321` srsran_sl_comm_resource_pool_get_default_config).
    """
    nof_prb: int
    tm: int = 4
    period_length: int = 40
    prb_num: int = 0
    prb_start: int = 0
    prb_end: int = 0
    size_sub_channel: int = 10
    num_sub_channel: int = 5
    start_prb_sub_channel: int = 0
    pscch_sf_bitmap: np.ndarray = field(default_factory=lambda: np.zeros(0))
    pssch_sf_bitmap: np.ndarray = field(default_factory=lambda: np.zeros(0))

    @classmethod
    def default(cls, nof_prb: int, tm: int = 4) -> "SlPool":
        p = cls(nof_prb=nof_prb, tm=tm)
        p.period_length = 160 if tm >= 3 else 40
        p.prb_num = math.ceil(nof_prb / 2)
        p.prb_start, p.prb_end = 0, nof_prb - 1
        p.pscch_sf_bitmap = np.zeros(p.period_length, np.int8)
        p.pscch_sf_bitmap[1:3] = 1
        p.pssch_sf_bitmap = np.zeros(p.period_length, np.int8)
        p.pssch_sf_bitmap[3:40] = 1
        if tm >= 3:
            if nof_prb == 6:
                p.size_sub_channel, p.num_sub_channel = 6, 1
            elif nof_prb in (15, 25, 75):
                p.size_sub_channel = 5
                p.num_sub_channel = nof_prb // 5
            elif nof_prb in (50, 100):
                p.size_sub_channel = 10
                p.num_sub_channel = nof_prb // 10
            else:
                raise ValueError(f"no default TM4 pool for {nof_prb} PRB")
        return p


def _batched_equalize(grid: np.ndarray, dmrs: np.ndarray, ks: np.ndarray,
                      dmrs_syms, data_syms, noise_var: float) -> np.ndarray:
    """LS at the DMRS symbols + linear time interpolation, batched over
    hypotheses.  grid (14, nre); dmrs (H, D, m_sc); ks (H, m_sc) RE
    index per hypothesis → (H, len(data_syms), m_sc) equalized symbols
    (final guard symbol zeroed)."""
    g = grid[:, ks]                                # (14, H, m_sc)
    h_p = np.stack([g[l] * np.conj(dmrs[:, i])
                    for i, l in enumerate(dmrs_syms)], axis=1)
    t = np.asarray(dmrs_syms, np.float32)
    eq = []
    for l in data_syms[:-1]:
        if len(dmrs_syms) == 1 or l <= t[0]:
            h = h_p[:, 0]
        elif l >= t[-1]:
            h = h_p[:, -1]
        else:
            j = int(np.searchsorted(t, l) - 1)
            w = (l - t[j]) / (t[j + 1] - t[j])
            h = (1 - w) * h_p[:, j] + w * h_p[:, j + 1]
        eq.append(g[l] * np.conj(h) / (np.abs(h) ** 2 + noise_var))
    eq.append(np.zeros_like(eq[0]))
    return np.stack(eq, axis=1).astype(np.complex64)


def pscch34_blind(grid: np.ndarray, pool: SlPool,
                  noise_var: float = 1e-2) -> list[dict]:
    """TM3/4 PSCCH blind search over (subchannel × cyclic shift) as one
    batch → list of dicts for each CRC-passing hypothesis."""
    from srsran_4g_tpu.models.pusch import transform_deprecode

    m_sc = SL.PSCCH34_NOF_PRB * 12
    e = len(SL.SL34_DATA_SYMS) * m_sc * 2
    shifts = (0, 3, 6, 9)
    hyp = [(s, cs) for s in range(pool.num_sub_channel) for cs in shifts]
    ks = np.stack([np.arange(m_sc) + pool.size_sub_channel * s * 12
                   for s, _ in hyp])
    dmrs = np.stack([np.tile(SL._pscch34_dmrs(cs)[None], (4, 1))
                     for _, cs in hyp])
    eq = _batched_equalize(grid, dmrs, ks, SL.SL34_DMRS_SYMS,
                           SL.SL34_DATA_SYMS, noise_var)
    syms = transform_deprecode(jnp.asarray(eq)).reshape(len(hyp), -1)
    llr = modem.demodulate_soft("qpsk", syms, noise_var)
    llr = llr.at[:, -2 * m_sc:].set(0.0)
    scr = sequence.gold_sequence_np(SL.PSCCH_SCRAMBLING_SEED, e)
    llr = llr * jnp.asarray(1.0 - 2.0 * scr, jnp.float32)
    deperm = np.empty(e, np.int64)
    deperm[SL._sl34_interleave_perm(e, 2)] = np.arange(e)
    llr = llr[..., jnp.asarray(deperm)]
    d = rate_match.conv_rate_dematch(llr, SL.SCI1_LEN + SL.SCI_CRC_LEN)
    bits = np.asarray(convcode.viterbi_decode(d))
    ok = np.asarray(crc_ops.crc_check(jnp.asarray(bits), "16"))
    out = []
    for i, (s, cs) in enumerate(hyp):
        # sanity checks mirroring sci_format1_unpack (sci.c:145-167):
        # reject all-zero payloads (an empty subchannel yields zero LLRs
        # whose all-zero decode trivially passes CRC) and mcs >= 29
        if not ok[i] or not bits[i, :SL.SCI1_LEN].any():
            continue
        crc_bits = bits[i, -SL.SCI_CRC_LEN:].astype(np.int64)
        n_x_id = int((crc_bits << np.arange(SL.SCI_CRC_LEN - 1, -1,
                                            -1)).sum())
        out.append(dict(sub_channel=s, cyclic_shift=cs,
                        bits=bits[i, :SL.SCI1_LEN], n_x_id=n_x_id))
    return out


def pscch12_blind(grid: np.ndarray, pool: SlPool,
                  noise_var: float = 1e-2) -> list[dict]:
    """TM1/2 PSCCH blind PRB sweep (36.213 §14.2.1.2 pool geometry, incl.
    the upper-half jump of `pssch_pscch_file_test.c:306-311`)."""
    from srsran_4g_tpu.models.pusch import transform_deprecode

    prbs, p = [], pool.prb_start
    while p <= pool.prb_end:
        prbs.append(p)
        if (pool.prb_num * 2) <= (pool.prb_end - pool.prb_start + 1) and \
                p + 1 == pool.prb_start + pool.prb_num:
            p = pool.prb_end - pool.prb_num
        p += 1
    m_sc = 12
    e = len(SL.SL_DATA_SYMS) * m_sc * 2
    ks = np.stack([np.arange(m_sc) + prb * 12 for prb in prbs])
    dmrs = np.tile(SL._sl_dmrs(0, m_sc)[None], (len(prbs), 1, 1))
    eq = _batched_equalize(grid, dmrs, ks, SL.SL_DMRS_SYMS,
                           SL.SL_DATA_SYMS, noise_var)
    syms = transform_deprecode(jnp.asarray(eq)).reshape(len(prbs), -1)
    llr = modem.demodulate_soft("qpsk", syms, noise_var)
    llr = llr.at[:, -2 * m_sc:].set(0.0)
    scr = sequence.gold_sequence_np(SL.PSCCH_SCRAMBLING_SEED, e)
    llr = llr * jnp.asarray(1.0 - 2.0 * scr, jnp.float32)
    deperm = np.empty(e, np.int64)
    deperm[SL._sl_interleave_perm(e, 2)] = np.arange(e)
    llr = llr[..., jnp.asarray(deperm)]
    sci_len = SL.SciFormat0(riv=0).pack(pool.nof_prb).shape[-1]
    d = rate_match.conv_rate_dematch(llr, sci_len + SL.SCI_CRC_LEN)
    bits = np.asarray(convcode.viterbi_decode(d))
    ok = np.asarray(crc_ops.crc_check(jnp.asarray(bits), "16"))
    # all-zero payload rejection as sci_format0_unpack (sci.c:107-116)
    return [dict(prb=prbs[i], bits=bits[i, :sci_len])
            for i in range(len(prbs)) if ok[i] and bits[i, :sci_len].any()]


def decode_capture(samples: np.ndarray, nof_prb: int, tm: int,
                   symbol_sz: int, pool: SlPool | None = None,
                   first_sf_idx: int = 0, file_offset: int = 0,
                   max_subframes: int = 128,
                   noise_var: float = 1e-2) -> dict:
    """Run the full blind-decode loop over a raw IQ capture.

    Returns dict(num_decoded_sci, num_decoded_tb, events) where events
    carries one entry per decoded SCI with its unpacked fields and the
    PSSCH outcome — the counters match `pssch_pscch_file_test.c:440`'s
    printed pass criteria."""
    from srsran_4g_tpu.models import ra, ra_sl

    pool = pool or SlPool.default(nof_prb, tm)
    sf_len = symbol_sz * 15
    samples = samples[file_offset:]
    # a trailing partial subframe is zero-padded and still processed,
    # exactly like the reference's short-read path ("Couldn't read
    # entire subframe. Still processing ..",
    # pssch_pscch_file_test.c:276-279)
    if len(samples) % sf_len:
        samples = np.concatenate([
            samples, np.zeros(sf_len - len(samples) % sf_len,
                              samples.dtype)])
    nsf = min(len(samples) // sf_len, max_subframes)
    num_sci = num_tb = 0
    events = []
    current_sf_idx = first_sf_idx
    period_sf_idx = 0
    allowed_pssch_sf_idx = 0
    sci0_state = None  # TM1/2: last decoded SCI persists across the period
    for sf in range(nsf):
        grid = np.asarray(SL.sl_subframe_grid(
            samples[sf * sf_len:(sf + 1) * sf_len], nof_prb, symbol_sz))[0]
        if tm in (1, 2):
            if pool.pscch_sf_bitmap[period_sf_idx % pool.period_length]:
                for h in pscch12_blind(grid, pool, noise_var):
                    sci = SL.SciFormat0.unpack(h["bits"], pool.nof_prb)
                    if sci.mcs >= 29:  # sci.c:132 sanity check
                        continue
                    num_sci += 1
                    sci0_state = sci
                    events.append(dict(sf=sf, sci=sci, prb=h["prb"]))
            if pool.pssch_sf_bitmap[period_sf_idx % pool.period_length] \
                    and sci0_state is not None:
                sci = sci0_state
                if ra_sl.pssch_allowed_sf(current_sf_idx, sci.trp):
                    rv = allowed_pssch_sf_idx % 4
                    l_crb, prb0 = ra.riv_decode(nof_prb, sci.riv)
                    # TM1/2 n_X_ID is the SCI's 8-bit N_sa_id field
                    # (pssch_pscch_file_test.c:325 N_x_id = sci.N_sa_id)
                    n_x = sci.group_dst_id
                    mod = ra.ul_mcs_to_mod(sci.mcs)
                    tbs = ra.tbs_from_itbs(ra.ul_mcs_to_itbs(sci.mcs),
                                           l_crb)
                    cfg = SL.PsschConfig(
                        tbs=tbs, nof_prb_cell=nof_prb, prb_start=prb0,
                        nof_prb=l_crb, mod=mod, n_x_id=n_x,
                        sf_idx=current_sf_idx, rv=PSSCH_RV[rv])
                    out = SL.pssch_decode(
                        cfg, jnp.asarray(grid)[None], noise_var)
                    ok = bool(out["crc_ok"][0])
                    num_tb += int(ok)
                    events.append(dict(sf=sf, pssch=True, crc_ok=ok,
                                       tbs=tbs, rv=rv))
                    allowed_pssch_sf_idx += 1
                current_sf_idx += 1
        else:
            for h in pscch34_blind(grid, pool, noise_var):
                sci = SL.SciFormat1.unpack(h["bits"], pool.num_sub_channel)
                if sci.mcs >= 29:  # sci.c:165 sanity check
                    continue
                num_sci += 1
                ps, nprb = SL.pssch34_prbs(
                    h["sub_channel"], sci.riv, pool.size_sub_channel,
                    pool.num_sub_channel, pool.start_prb_sub_channel)
                rv_idx = 1 if sci.retransmission else 0
                out = SL.pssch34_decode(
                    jnp.asarray(grid)[None], ps, nprb, h["n_x_id"],
                    sci.mcs, PSSCH_RV[rv_idx], current_sf_idx, noise_var)
                ok = bool(out["crc_ok"][0])
                num_tb += int(ok)
                events.append(dict(sf=sf, sci=sci, crc_ok=ok,
                                   tbs=int(out["tbs"]), mcs=sci.mcs,
                                   sub_channel=h["sub_channel"]))
            current_sf_idx = (current_sf_idx + 1) % 10
        period_sf_idx += 1
    return dict(num_decoded_sci=num_sci, num_decoded_tb=num_tb,
                events=events)
