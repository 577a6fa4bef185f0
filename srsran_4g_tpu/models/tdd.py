"""LTE TDD (frame structure type 2), TS 36.211 §4.2 / TS 36.213 §10.

Counterpart of the reference's TDD support spread across
`lib/src/phy/common/phy_common.c` (`srsran_sfidx_tdd_type`,
`srsran_tdd_nof_harq_ack` — UL/DL configurations and special-subframe
geometry), `lib/src/phy/phch/harq_ack.c` (downlink association sets,
ACK/NACK bundling and multiplexing for TDD), and `sync.c`'s frame-type
detection (PSS/SSS relative position differs between FDD and TDD).

Batch-first: all tables are host-side numpy constants; the per-subframe
type never enters a jitted graph (it selects which static graph runs),
and the frame-type detector is one extra 336×2 correlation matmul over a
second SSS-position hypothesis.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax.numpy as jnp
import numpy as np

from srsran_4g_tpu.models import sync
from srsran_4g_tpu.ops.ofdm import OfdmConfig, _symbol_offsets
from srsran_4g_tpu.ops.zadoff_chu import pss_sequence

# --- UL/DL configurations (TS 36.211 Table 4.2-2) ----------------------------
# 'D' downlink, 'U' uplink, 'S' special (DwPTS | GP | UpPTS)
UL_DL_CONFIGS = (
    "DSUUUDSUUU",  # 0
    "DSUUDDSUUD",  # 1
    "DSUDDDSUDD",  # 2
    "DSUUUDDDDD",  # 3
    "DSUUDDDDDD",  # 4
    "DSUDDDDDDD",  # 5
    "DSUUUDSUUD",  # 6
)

# Special-subframe configurations (Table 4.2-1, normal CP):
# DwPTS length in OFDM symbols; UpPTS is 1 symbol for configs 0-4 and
# 2 symbols for configs 5-8; the rest is guard period.
DWPTS_SYMS = (3, 9, 10, 11, 12, 3, 9, 10, 11)
UPPTS_SYMS = (1, 1, 1, 1, 1, 2, 2, 2, 2)
N_SYMS_SF = 14  # normal CP


def sf_type(ul_dl_config: int, subframe: int) -> str:
    """'D' / 'U' / 'S' for (config, subframe) — srsran_sfidx_tdd_type."""
    return UL_DL_CONFIGS[ul_dl_config][subframe % 10]


def dl_symbol_mask(ul_dl_config: int, ssf_config: int,
                   subframe: int) -> np.ndarray:
    """(14,) bool: symbols usable for DL transmission in this subframe
    (all for 'D', DwPTS only for 'S', none for 'U')."""
    t = sf_type(ul_dl_config, subframe)
    m = np.zeros(N_SYMS_SF, dtype=bool)
    if t == "D":
        m[:] = True
    elif t == "S":
        m[:DWPTS_SYMS[ssf_config]] = True
    return m


# --- HARQ-ACK downlink association sets (TS 36.213 Table 10.1.3.1-1) ---------
# For UL subframe n, the DL subframes {n-k : k in K} are acknowledged in n.
DL_ASSOC_SETS: tuple[dict[int, tuple[int, ...]], ...] = (
    {2: (6,), 4: (4,), 7: (6,), 9: (4,)},                       # config 0
    {2: (7, 6), 3: (4,), 7: (7, 6), 8: (4,)},                   # config 1
    {2: (8, 7, 4, 6), 7: (8, 7, 4, 6)},                         # config 2
    {2: (7, 6, 11), 3: (6, 5), 4: (5, 4)},                      # config 3
    {2: (12, 8, 7, 11), 3: (6, 5, 4, 7)},                       # config 4
    {2: (13, 12, 9, 8, 7, 5, 4, 11, 6)},                        # config 5
    {2: (7,), 3: (7,), 4: (5,), 7: (7,), 8: (7,)},              # config 6
)

# PUSCH scheduling timing (TS 36.213 Table 8-2): UL grant (DCI0 / PHICH)
# received in DL subframe n schedules PUSCH in n+k.  Config 0 additionally
# uses the UL-index field to address two UL subframes; this table carries
# the base k.
UL_GRANT_K: tuple[dict[int, int], ...] = (
    {0: 4, 1: 6, 5: 4, 6: 6},                                   # config 0
    {1: 6, 4: 4, 6: 6, 9: 4},                                   # config 1
    {3: 4, 8: 4},                                               # config 2
    {0: 4, 8: 4, 9: 4},                                         # config 3
    {8: 4, 9: 4},                                               # config 4
    {8: 4},                                                     # config 5
    {0: 7, 1: 7, 5: 7, 6: 7, 9: 5},                             # config 6
)


def ack_subframe_for_dl(ul_dl_config: int, dl_subframe: int) -> int:
    """UL subframe index (mod 10 offset from the DL subframe) where the
    HARQ-ACK for a PDSCH in `dl_subframe` is reported."""
    for n_ul, ks in DL_ASSOC_SETS[ul_dl_config].items():
        for k in ks:
            if (n_ul - k) % 10 == dl_subframe % 10:
                return n_ul
    raise ValueError(
        f"subframe {dl_subframe} is not DL in config {ul_dl_config}")


def bundle_acks(acks: jnp.ndarray, valid: jnp.ndarray) -> jnp.ndarray:
    """ACK/NACK bundling (TS 36.213 §10.1.3.2.1): logical AND across the
    association set.  acks/valid: (..., M) int/bool; positions with
    valid=0 (no PDSCH received there) are transparent.

    Returns (...,) bundled bit (1 = ACK)."""
    a = jnp.where(valid.astype(bool), acks.astype(bool), True)
    return jnp.all(a, axis=-1).astype(jnp.int8) & \
        jnp.any(valid.astype(bool), axis=-1).astype(jnp.int8)


def multiplex_acks(acks: jnp.ndarray, valid: jnp.ndarray,
                   m: int) -> jnp.ndarray:
    """ACK/NACK multiplexing payload (§10.1.3.2.2 simplified to the
    o_ack ≤ 4 bit vector handed to PUCCH format 1b / UCI-on-PUSCH):
    one bit per association-set position, NACK where nothing was
    received.  Returns (..., m) int8."""
    a = (acks.astype(bool) & valid.astype(bool)).astype(jnp.int8)
    return a[..., :m]


# --- frame-type detection and TDD sync geometry -------------------------------

def pss_sss_distance(cfg: OfdmConfig, frame_type: str) -> int:
    """Samples from SSS body start to PSS body start.

    FDD: SSS is the symbol immediately before PSS (sf0/5 symbols 5,6 of
    slot 0 → subframe symbols 5,6).  TDD: SSS is the last symbol of
    sf0/5, PSS is symbol 2 of sf1/6 (third DwPTS symbol)."""
    offs = _symbol_offsets(cfg)
    if frame_type == "fdd":
        return int(offs[6] - offs[5])
    return int(cfg.sf_len + offs[2] - offs[13])


def pss_to_sf_start(cfg: OfdmConfig, frame_type: str) -> int:
    """Samples from the start of the subframe containing SSS (sf0/5) to
    the PSS body start."""
    offs = _symbol_offsets(cfg)
    if frame_type == "fdd":
        return int(offs[6])
    return int(cfg.sf_len + offs[2])


def extract_center62(samples: jnp.ndarray, body_start: jnp.ndarray,
                     cfg: OfdmConfig) -> jnp.ndarray:
    """FFT one OFDM symbol body at `body_start` (B,) and return the 62
    center subcarriers (DC excluded), ordered low→high frequency."""
    n = cfg.symbol_sz
    idx = body_start[..., None] + jnp.arange(n)
    idx = jnp.clip(idx, 0, samples.shape[-1] - n)
    sym = jnp.take_along_axis(samples, idx, axis=-1)
    f = jnp.fft.fft(sym, axis=-1) / jnp.sqrt(jnp.asarray(n, jnp.float32))
    bins = np.concatenate([np.arange(n - 31, n), np.arange(1, 32)])
    return f[..., jnp.asarray(bins)].astype(jnp.complex64)


@dataclass(frozen=True)
class FrameTypeResult:
    frame_type: jnp.ndarray   # (B,) 0 = FDD, 1 = TDD
    n_id_1: jnp.ndarray
    phase: jnp.ndarray        # 0 → PSS in sf0(/1), 1 → sf5(/6)
    metric: jnp.ndarray


def detect_frame_type(samples: jnp.ndarray, pss_offset: jnp.ndarray,
                      n_id_2: jnp.ndarray, cfg: OfdmConfig
                      ) -> FrameTypeResult:
    """Try both SSS position hypotheses (sync.c frame-type detection):
    the stronger SSS correlation decides FDD vs TDD and yields
    (N_ID_1, half-frame phase) in the same pass."""
    pss_re = extract_center62(samples, pss_offset, cfg)
    pss_refs = jnp.stack([jnp.asarray(pss_sequence(i)) for i in range(3)])
    h_pss = pss_re * jnp.conj(pss_refs[n_id_2])
    inv = jnp.conj(h_pss) / jnp.maximum(jnp.abs(h_pss) ** 2, 1e-9)

    results = []
    for ft in ("fdd", "tdd"):
        d = pss_sss_distance(cfg, ft)
        sss_re = extract_center62(samples, pss_offset - d, cfg)
        sss_eq = sss_re * inv
        outs = [sync.sss_detect(sss_eq, i) for i in range(3)]
        for o in outs:
            o["metric"] = jnp.max(o["corr"], axis=-1)
        sel = n_id_2[..., None]
        pick = lambda key: jnp.take_along_axis(  # noqa: E731
            jnp.stack([o[key] for o in outs], -1), sel, axis=-1)[..., 0]
        results.append((pick("n_id_1"), pick("phase"), pick("metric")))

    m_fdd, m_tdd = results[0][2], results[1][2]
    is_tdd = (m_tdd > m_fdd).astype(jnp.int32)
    choose = lambda a, b: jnp.where(is_tdd.astype(bool), b, a)  # noqa: E731
    return FrameTypeResult(
        frame_type=is_tdd,
        n_id_1=choose(results[0][0], results[1][0]),
        phase=choose(results[0][1], results[1][1]),
        metric=jnp.maximum(m_fdd, m_tdd),
    )


def ack_delay(ul_dl_config: int, dl_subframe: int) -> int:
    """HARQ-ACK delay k in subframes: a PDSCH in DL subframe n is
    acknowledged in UL subframe n+k (the association-set inverse,
    Table 10.1.3.1-1 / harq_ack.c)."""
    for n_ul, ks in DL_ASSOC_SETS[ul_dl_config].items():
        for k in ks:
            if (n_ul - k) % 10 == dl_subframe:
                return k
    raise ValueError((ul_dl_config, dl_subframe))


def ul_grant_delay(ul_dl_config: int, dl_subframe: int) -> int | None:
    """PUSCH delay k for an UL grant sent in DL subframe n (Table 8-2);
    None when n carries no UL grants in this configuration."""
    return UL_GRANT_K[ul_dl_config].get(dl_subframe)


def phich_delay(ul_dl_config: int, ul_subframe: int) -> int:
    """PHICH delay for a PUSCH in UL subframe n: the next D/S subframe
    at least 4 TTIs later.  For config 1 this reproduces Table 9.1.2-1
    exactly (sf2→+4, sf3→+6, sf7→+4, sf8→+6)."""
    for k in range(4, 14):
        if sf_type(ul_dl_config, (ul_subframe + k) % 10) in ("D", "S"):
            return k
    raise ValueError((ul_dl_config, ul_subframe))
