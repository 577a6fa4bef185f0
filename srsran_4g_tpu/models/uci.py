"""LTE UCI on PUSCH: CQI/RI/HARQ-ACK multiplexed with UL-SCH data.

Counterpart of the reference's `lib/src/phy/phch/uci.c` (Q' sizing,
(32,O) short-CQI block code, CRC8+convolutional long-CQI coding,
ACK/RI coded-symbol generation) and the UL-SCH channel-interleaver
multiplexing in `lib/src/phy/phch/sch.c:661-1018` (`ulsch_interleave`:
RI symbols reserved at columns {1,4,7,10} bottom-up, ACK symbols
puncturing columns {2,3,8,9} bottom-up, CQI prepended to data), per
TS 36.212 §5.2.2.6-5.2.2.8 and §5.2.4.

Batch-first design: the whole multiplexing structure is a single
host-precomputed bijective gather `out[p] = src[perm[p]]` over the
flattened (symbols × Qm) bit grid plus an ACK puncture index vector, so
encode is one gather + one scatter and demux on the receive side is the
inverse scatter — no per-position control flow in the jitted graph.
ACK/RI use repetition (1 bit) / cyclic simplex (2 bits) codes whose
decode is an LLR-sum / 4-codeword correlation, matching the reference's
max-log decision metric.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import jax.numpy as jnp
import numpy as np

from srsran_4g_tpu.ops import block_code, convcode, crc as crc_ops
from srsran_4g_tpu.ops import rate_match as rm
from srsran_4g_tpu.ops.cbsegm import cbsegm

RI_COLS = (1, 4, 7, 10)   # columns (data SC-FDMA symbols) for RI, normal CP
ACK_COLS = (2, 3, 8, 9)   # columns punctured by HARQ-ACK (next to DMRS)
N_DATA_SYMS = 12
_CQI_LONG_MIN = 12        # O >= 12 ⇒ CRC8 + tail-biting convolutional code


@dataclass(frozen=True)
class UciCfg:
    """UCI payload sizes and beta offsets (TS 36.213 Table 8.6.3-1..3)."""

    o_cqi: int = 0
    o_ack: int = 0   # 0, 1 or 2 HARQ-ACK bits
    o_ri: int = 0    # 0, 1 or 2 RI bits
    beta_cqi: float = 2.0
    beta_ack: float = 2.0
    beta_ri: float = 2.0


@dataclass(frozen=True)
class UciPlan:
    """Static multiplexing plan for one (tbs, allocation, UciCfg)."""

    cfg: UciCfg
    qm: int
    m_sc: int
    q_prime_cqi: int   # CQI coded symbols
    q_prime_ack: int
    q_prime_ri: int
    g_data: int        # UL-SCH coded bits (excludes CQI and RI, incl. ACK
                       # positions — ACK punctures data after the fact)
    perm: np.ndarray       # (H*Qm,) out[p] = src[perm[p]]
    ack_pos: np.ndarray    # (Q'_ack*Qm,) bit positions in out punctured by ACK

    @property
    def q_cqi(self) -> int:
        return self.q_prime_cqi * self.qm

    @property
    def q_ri(self) -> int:
        return self.q_prime_ri * self.qm

    @property
    def q_ack(self) -> int:
        return self.q_prime_ack * self.qm


def _k_total(tbs: int) -> int:
    s = cbsegm(tbs)
    return s.C1 * s.K1 + s.C2 * s.K2


@functools.lru_cache(maxsize=256)
def uci_plan(tbs: int, m_sc: int, qm: int, cfg: UciCfg) -> UciPlan:
    """Compute Q' sizes (uci.c Q_prime_cqi / Q_prime_ri_ack) and the
    interleaver permutation (sch.c ulsch_interleave)."""
    n_symb = N_DATA_SYMS
    h_syms = m_sc * n_symb
    k_tot = _k_total(tbs)

    def q_prime_ack_ri(o: int, beta: float) -> int:
        if o == 0:
            return 0
        x = math.ceil(o * m_sc * n_symb * beta / k_tot)
        return min(x, 4 * m_sc)

    q_ri = q_prime_ack_ri(cfg.o_ri, cfg.beta_ri)
    q_ack = q_prime_ack_ri(cfg.o_ack, cfg.beta_ack)

    q_cqi = 0
    if cfg.o_cqi:
        l_crc = 8 if cfg.o_cqi >= _CQI_LONG_MIN else 0
        x = math.ceil((cfg.o_cqi + l_crc) * m_sc * n_symb * cfg.beta_cqi
                      / k_tot)
        q_cqi = min(x, h_syms - q_ri)

    g_data = (h_syms - q_cqi - q_ri) * qm
    if g_data <= 0:
        raise ValueError("UCI leaves no room for UL-SCH data")

    rp = m_sc  # interleaver rows of Qm-bit symbols; C = 12 columns
    c = n_symb
    # RI reservation: symbol i at column RI_COLS[i%4], row rp-1-(i//4)
    ri_idx = np.full((rp, c), -1, dtype=np.int64)
    for i in range(q_ri):
        ri_idx[rp - 1 - (i // 4), RI_COLS[i % 4]] = i
    # CQI+data fill the remaining cells row-major
    cell = np.full((rp, c), -1, dtype=np.int64)
    k = 0
    for r in range(rp):
        for cc in range(c):
            if ri_idx[r, cc] < 0:
                cell[r, cc] = k
                k += 1
    n_cqidata = k
    assert n_cqidata == h_syms - q_ri

    # output is read column-major (per SC-FDMA symbol); src layout is
    # [cqi_enc | data | ri_enc] in coded-symbol units
    perm = np.empty(h_syms * qm, dtype=np.int64)
    for cc in range(c):
        for r in range(rp):
            p = (cc * rp + r) * qm
            if ri_idx[r, cc] >= 0:
                s = n_cqidata + ri_idx[r, cc]
            else:
                s = cell[r, cc]
            perm[p:p + qm] = s * qm + np.arange(qm)

    ack_pos = np.empty(q_ack * qm, dtype=np.int64)
    for i in range(q_ack):
        r = rp - 1 - (i // 4)
        cc = ACK_COLS[i % 4]
        ack_pos[i * qm:(i + 1) * qm] = (cc * rp + r) * qm + np.arange(qm)

    return UciPlan(cfg=cfg, qm=qm, m_sc=m_sc, q_prime_cqi=q_cqi,
                   q_prime_ack=q_ack, q_prime_ri=q_ri, g_data=g_data,
                   perm=perm, ack_pos=ack_pos)


# --- small-payload codes -----------------------------------------------------

def _simplex_codebook(o: int, nbits: int) -> np.ndarray:
    """Cyclic repetition (o=1) / simplex [o0,o1,o0^o1] (o=2) codewords:
    (2^o, nbits) in {0,1}."""
    if o == 1:
        base = np.array([[0], [1]], dtype=np.int8)
    elif o == 2:
        base = np.array(
            [[b0, b1, b0 ^ b1] for b0 in (0, 1) for b1 in (0, 1)],
            dtype=np.int8)
    else:
        raise ValueError("ACK/RI payloads are 1 or 2 bits")
    reps = -(-nbits // base.shape[1])
    return np.tile(base, (1, reps))[:, :nbits]


def encode_ack_ri(bits: jnp.ndarray, nbits: int) -> jnp.ndarray:
    """(B, O) ACK or RI bits → (B, nbits) coded bits (uci.c encode_ri_ack)."""
    o = bits.shape[-1]
    cb = jnp.asarray(_simplex_codebook(o, nbits))  # (2^o, nbits)
    word = jnp.sum(bits.astype(jnp.int32)
                   * (1 << jnp.arange(o, dtype=jnp.int32)), axis=-1)
    return cb[word]


def decode_ack_ri(llrs: jnp.ndarray, o: int) -> jnp.ndarray:
    """(B, nbits) LLRs (positive ⇒ 1) → (B, O) ML decision."""
    cb = jnp.asarray(_simplex_codebook(o, llrs.shape[-1]), jnp.float32)
    corr = jnp.einsum("...n,cn->...c", llrs.astype(jnp.float32),
                      2.0 * cb - 1.0)
    best = jnp.argmax(corr, axis=-1)
    return ((best[..., None] >> jnp.arange(o)) & 1).astype(jnp.int8)


def encode_cqi(cqi_bits: jnp.ndarray, q_bits: int) -> jnp.ndarray:
    """(B, O) CQI bits → (B, q_bits): (32,O) block code cyclically repeated
    for O ≤ 11 (uci.c encode_cqi_short), CRC8 + tail-biting convolutional +
    rate matching for O ≥ 12 (encode_cqi_long)."""
    o = cqi_bits.shape[-1]
    if o < _CQI_LONG_MIN:
        cw = block_code.encode(cqi_bits, 32)  # (B, 32)
        reps = -(-q_bits // 32)
        return jnp.tile(cw, (1, reps))[:, :q_bits]
    with_crc = jnp.concatenate(
        [cqi_bits.astype(jnp.int8), crc_ops.crc_compute(cqi_bits, "8")],
        axis=-1)
    d = convcode.conv_encode(with_crc)  # (B, 3, O+8)
    return rm.conv_rate_match(d, q_bits)


def decode_cqi(llrs: jnp.ndarray, o: int) -> tuple[jnp.ndarray, jnp.ndarray]:
    """(B, q_bits) LLRs → ((B, O) bits, (B,) ok). Short CQI folds the cyclic
    repetitions onto 32 positions then ML-decodes; long CQI Viterbi-decodes
    and checks CRC8."""
    q_bits = llrs.shape[-1]
    if o < _CQI_LONG_MIN:
        reps = -(-q_bits // 32)
        pad = jnp.pad(llrs.astype(jnp.float32),
                      ((0, 0), (0, reps * 32 - q_bits)))
        folded = jnp.sum(pad.reshape(llrs.shape[0], reps, 32), axis=1)
        bits, metric = block_code.decode(folded, 32, o)
        return bits, metric > 0
    d = rm.conv_rate_dematch(llrs.astype(jnp.float32), o + 8)
    dec = convcode.viterbi_decode(d, tail_biting=True)  # (B, O+8)
    ok = crc_ops.crc_check(dec, "8")
    return dec[:, :o], ok


# --- multiplexing ------------------------------------------------------------

def mux(plan: UciPlan, data_bits: jnp.ndarray,
        cqi_bits: jnp.ndarray | None = None,
        ack_bits: jnp.ndarray | None = None,
        ri_bits: jnp.ndarray | None = None) -> jnp.ndarray:
    """UL-SCH coded bits (B, G_data) + UCI payloads → (B, H*Qm) channel bits
    in final (column-major / time-first) order, ACK punctured in."""
    b = data_bits.shape[0]
    parts = []
    if plan.q_cqi:
        assert cqi_bits is not None
        parts.append(encode_cqi(cqi_bits, plan.q_cqi))
    parts.append(data_bits.astype(jnp.int8))
    if plan.q_ri:
        assert ri_bits is not None
        parts.append(encode_ack_ri(ri_bits, plan.q_ri))
    src = jnp.concatenate(parts, axis=-1)
    out = src[:, jnp.asarray(plan.perm)]
    if plan.q_ack:
        assert ack_bits is not None
        ack_cw = encode_ack_ri(ack_bits, plan.q_ack)
        out = out.at[:, jnp.asarray(plan.ack_pos)].set(ack_cw)
    return out.reshape(b, -1)


def demux(plan: UciPlan, llrs: jnp.ndarray) -> dict:
    """(B, H*Qm) descrambled LLRs → dict with data_llrs (B, G_data) (ACK
    positions zeroed as erasures), and decoded ack / ri / cqi payloads."""
    out: dict = {}
    if plan.q_ack:
        ack_llr = llrs[:, jnp.asarray(plan.ack_pos)]
        out["ack_bits"] = decode_ack_ri(ack_llr, plan.cfg.o_ack)
        llrs = llrs.at[:, jnp.asarray(plan.ack_pos)].set(0.0)
    src = jnp.zeros_like(llrs)
    src = src.at[:, jnp.asarray(plan.perm)].set(llrs)
    ofs = 0
    if plan.q_cqi:
        bits, ok = decode_cqi(src[:, :plan.q_cqi], plan.cfg.o_cqi)
        out["cqi_bits"], out["cqi_ok"] = bits, ok
        ofs = plan.q_cqi
    out["data_llrs"] = src[:, ofs:ofs + plan.g_data]
    if plan.q_ri:
        ri_llr = src[:, ofs + plan.g_data:ofs + plan.g_data + plan.q_ri]
        out["ri_bits"] = decode_ack_ri(ri_llr, plan.cfg.o_ri)
    return out
