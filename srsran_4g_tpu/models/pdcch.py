"""PDCCH: downlink control channel with DCI blind decoding.

TS 36.211 §6.8 / 36.212 §5.3.3.  Counterpart of the reference's
`lib/src/phy/phch/pdcch.c` (encode, blind DCI search over the common and
UE-specific search spaces with the CCE tree).

Chain: DCI payload → CRC16 XOR-masked with the RNTI → tail-biting conv 1/3
→ rate match to 72·L bits (L CCEs, 1 CCE = 9 REGs = 36 REs) → subframe
scrambling → QPSK → quadruplet interleaving over the control REGs
(models/regs.py) → grid.

Design for blind decoding: all (search-space candidate × DCI length)
hypotheses of the whole batch are gathered into one (B, n_cand, E_max) LLR
tensor and pushed through ONE batched Viterbi per DCI length; CRC/RNTI
checks are batched matmuls.  Where the reference walks a tree of candidates
sequentially per TTI (pdcch.c dci blind search), this build decodes every
candidate of every subframe in parallel.
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np

from srsran_4g_tpu.models import grid as G, regs
from srsran_4g_tpu.ops import convcode, modem, rate_match, scrambling
from srsran_4g_tpu.ops.crc import crc_matrix
from srsran_4g_tpu.ops.sequence import gold_sequence_np

CCE_BITS = 72  # 9 REGs * 4 REs * 2 bits


def _rnti_mask(rnti: int) -> np.ndarray:
    return ((rnti >> np.arange(15, -1, -1)) & 1).astype(np.int8)


def _crc16(bits: jnp.ndarray) -> jnp.ndarray:
    g = jnp.asarray(crc_matrix(bits.shape[-1], "16"), jnp.float32)
    return (
        jnp.dot(bits.astype(jnp.float32), g, preferred_element_type=jnp.float32)
        .astype(jnp.int32) & 1
    ).astype(jnp.int8)


@functools.lru_cache(maxsize=64)
def _scramble_seq(cell: G.CellConfig, cfi: int, subframe: int, ng: float) -> np.ndarray:
    n_regs = regs.pdcch_regs(cell, cfi, ng).shape[0]
    cinit = scrambling.pdcch_cinit(subframe, cell.cell_id)
    return gold_sequence_np(cinit, n_regs * 8)


@functools.lru_cache(maxsize=64)
def cce_re_indices(cell: G.CellConfig, cfi: int, ng: float = 1.0) -> np.ndarray:
    """(n_cce, 36) flat RE indices of each CCE after quadruplet
    interleaving — CCE c, quadruplet q lives on REG π(9c+q)."""
    reg_res = regs.pdcch_regs(cell, cfi, ng)  # (n_regs, 4)
    order = regs.pdcch_interleave_order(cell, cfi, ng)  # quad i → REG
    n_cce = reg_res.shape[0] // 9
    mapped = reg_res[order[: n_cce * 9]]  # (n_cce*9, 4)
    return mapped.reshape(n_cce, 36)


def search_space_candidates(
    cell: G.CellConfig, cfi: int, rnti: int, subframe: int, ng: float = 1.0
) -> list[tuple[int, int]]:
    """(L, cce_start) candidates: common (L=4,8) + UE-specific search space
    (TS 36.213 §9.1.1, Yk hash)."""
    n_cce = cce_re_indices(cell, cfi, ng).shape[0]
    cands: list[tuple[int, int]] = []
    # common search space: 4 candidates at L=4, 2 at L=8, CCEs 0..15
    for l, m_max in ((4, 4), (8, 2)):
        for m in range(m_max):
            start = m * l
            if start + l <= n_cce:
                cands.append((l, start))
    # UE-specific: Yk recursion
    y = rnti if rnti else 1
    for _ in range(subframe + 1):
        y = (39827 * y) % 65537
    for l, m_max in ((1, 6), (2, 6), (4, 2), (8, 2)):
        if n_cce // l == 0:
            continue
        for m in range(m_max):
            start = l * ((y + m) % (n_cce // l))
            if start + l <= n_cce and (l, start) not in cands:
                cands.append((l, start))
    return cands


def encode_dci(
    cell: G.CellConfig, dci_bits: jnp.ndarray, rnti: int, l_agg: int,
) -> jnp.ndarray:
    """DCI payload (B, A) → rate-matched scrambled-ready bits (B, 72·L)."""
    crc = _crc16(dci_bits)
    mask = jnp.asarray(_rnti_mask(rnti))
    a = jnp.concatenate(
        [dci_bits.astype(jnp.int8), jnp.bitwise_xor(crc, mask)], axis=-1
    )
    d = convcode.conv_encode(a)
    return rate_match.conv_rate_match(d, CCE_BITS * l_agg)


def put_dci(
    cell: G.CellConfig, cfi: int, subframe: int, grid_tx: jnp.ndarray,
    dci_bits: jnp.ndarray, rnti: int, l_agg: int, cce_start: int,
    ng: float = 1.0,
) -> jnp.ndarray:
    """Encode one DCI and scatter it onto its CCEs in the TX grid."""
    n_cce = cce_re_indices(cell, cfi, ng).shape[0]
    assert cce_start + l_agg <= n_cce, (cce_start, l_agg, n_cce)
    e = encode_dci(cell, dci_bits, rnti, l_agg)
    seq = _scramble_seq(cell, cfi, subframe, ng)
    # scrambling index: bit position within the full PDCCH bit sequence —
    # CCE c starts at bit 72·c
    bit0 = CCE_BITS * cce_start
    scr = scrambling.scramble_bits(e, jnp.asarray(seq[bit0:bit0 + e.shape[-1]]))
    syms = modem.modulate("qpsk", scr)  # (B, 36·L)
    idx = cce_re_indices(cell, cfi, ng)[cce_start:cce_start + l_agg].reshape(-1)
    from srsran_4g_tpu.models import mimo

    return mimo.scatter_ctrl_syms(grid_tx, idx, syms)


def blind_decode(
    cell: G.CellConfig, cfi: int, subframe: int,
    rx_grid: jnp.ndarray, h: jnp.ndarray, noise_var,
    rnti: int, dci_len: int, ng: float = 1.0,
    candidates: list[tuple[int, int]] | None = None,
    h1: jnp.ndarray | None = None,
) -> dict:
    """Blind-search all candidates for a DCI of the given payload length.

    With ``h1`` (port-1 estimates) each candidate's REs are SFBC-combined
    (2-port TX diversity, pdcch.c via predecoding_diversity).

    Returns dict(found (B,), dci (B, A), candidate (B,) index, corr).
    All candidates are decoded as one Viterbi batch.
    """
    from srsran_4g_tpu.models import equalizer

    if candidates is None:
        candidates = search_space_candidates(cell, cfi, rnti, subframe, ng)
    b = rx_grid.shape[0]
    seq = _scramble_seq(cell, cfi, subframe, ng)
    n = dci_len + 16

    cand_llrs = []
    for l_agg, cce_start in candidates:
        idx = cce_re_indices(cell, cfi, ng)[cce_start:cce_start + l_agg].reshape(-1)
        y = rx_grid.reshape(b, -1)[:, jnp.asarray(idx)]
        h_re = h.reshape(b, -1)[:, jnp.asarray(idx)]
        if h1 is not None:
            x, eff_nv = equalizer.alamouti_decode_2x1(
                y, h_re, h1.reshape(b, -1)[:, jnp.asarray(idx)], noise_var)
        else:
            x, eff_nv = equalizer.equalize_single(y, h_re, noise_var)
        llr = modem.demodulate_soft("qpsk", x, eff_nv)
        bit0 = CCE_BITS * cce_start
        llr = scrambling.descramble_llrs(
            llr, jnp.asarray(seq[bit0:bit0 + llr.shape[-1]])
        )
        cand_llrs.append(rate_match.conv_rate_dematch(llr, n))
    stacked = jnp.stack(cand_llrs, axis=1)  # (B, C, 3, n)
    flat = stacked.reshape(b * len(candidates), 3, n)
    bits = convcode.viterbi_decode(flat).reshape(b, len(candidates), n)

    payload = bits[..., :dci_len]
    crc_rx = bits[..., dci_len:]
    expect = jnp.bitwise_xor(_crc16(payload), jnp.asarray(_rnti_mask(rnti)))
    ok = jnp.all(expect == crc_rx, axis=-1)  # (B, C)
    found = jnp.any(ok, axis=-1)
    cand_idx = jnp.argmax(ok, axis=-1)
    dci = jnp.take_along_axis(payload, cand_idx[:, None, None], axis=1)[:, 0]
    return dict(found=found, dci=dci, candidate=cand_idx, ok_per_candidate=ok,
                payload_per_candidate=payload)
