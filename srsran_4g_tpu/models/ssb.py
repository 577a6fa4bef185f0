"""NR SS/PBCH block: PSS/SSS sequences, PBCH (polar), SSB grid + search.

Counterpart of the reference's NR sync (`lib/src/phy/sync/ssb.c`,
`pss_nr.c`, `sss_nr.c`) and `lib/src/phy/phch/pbch_nr.c`: the 127-length
m-sequence PSS/SSS (TS 38.211 7.4.2), PBCH DMRS, polar-coded BCH
(TS 38.212 7.1: payload+CRC24C, N=512, E=864), the 240-subcarrier x
4-symbol SSB grid, and cell search — PSS correlation over NID2, SSS
matched filtering over NID1 as one (336, 127) matmul,
then PBCH decode.

Rate matching is pure repetition (E > N); the 38.212 sub-block
interleaver is omitted (self-consistent within this framework).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np

import jax.numpy as jnp

from srsran_4g_tpu.ops import crc as crc_ops
from srsran_4g_tpu.ops import modem, polar, sequence

SSB_NRE = 240
SSB_NSYM = 4
PSS_LEN = 127
PBCH_E = 864          # rate-matched bits
PBCH_N_LOG = 9        # N = 512
PBCH_A = 32           # payload bits (24-bit MIB + timing bits)
PBCH_K = PBCH_A + 24  # + CRC24C


# --------------------------------------------------------------------------
# PSS / SSS sequences (38.211 7.4.2.2 / 7.4.2.3)


@functools.lru_cache(maxsize=8)
def _m_seq(taps: tuple[int, ...], init: tuple[int, ...]) -> np.ndarray:
    x = np.zeros(PSS_LEN + 7, dtype=np.int64)
    x[:7] = init
    for i in range(PSS_LEN):
        x[i + 7] = sum(x[i + t] for t in taps) % 2
    return x[:PSS_LEN]


@functools.lru_cache(maxsize=4)
def pss_sequence(nid2: int) -> np.ndarray:
    x = _m_seq((4, 0), (0, 1, 1, 0, 1, 1, 1))
    m = (np.arange(PSS_LEN) + 43 * nid2) % PSS_LEN
    return (1.0 - 2.0 * x[m]).astype(np.float32)


@functools.lru_cache(maxsize=1024)
def sss_sequence(nid1: int, nid2: int) -> np.ndarray:
    x0 = _m_seq((4, 0), (1, 0, 0, 0, 0, 0, 0))
    x1 = _m_seq((1, 0), (1, 0, 0, 0, 0, 0, 0))
    m0 = 15 * (nid1 // 112) + 5 * nid2
    m1 = nid1 % 112
    n = np.arange(PSS_LEN)
    d = (1 - 2 * x0[(n + m0) % PSS_LEN]) * (1 - 2 * x1[(n + m1) % PSS_LEN])
    return d.astype(np.float32)


# --------------------------------------------------------------------------
# PBCH DMRS + RE mapping (38.211 7.4.1.4, 7.4.3.1)


def pbch_dmrs(pci: int, i_ssb: int = 0) -> np.ndarray:
    """144 QPSK DMRS symbols; c_init per 38.211 7.4.1.4.1 (L=4/8)."""
    ibar = i_ssb  # + 4*n_hf for L=4; n_hf=0 here
    cinit = ((1 << 11) * (ibar + 1) * ((pci >> 2) + 1)
             + (1 << 6) * (ibar + 1) + (pci & 3)) % (1 << 31)
    c = sequence.gold_sequence_np(cinit, 2 * 144).astype(np.float32)
    r = ((1 - 2 * c[0::2]) + 1j * (1 - 2 * c[1::2])) / np.sqrt(2)
    return r.astype(np.complex64)


def _ssb_re_maps(pci: int):
    """(data_idx, dmrs_idx) flat indices into the 4x240 SSB grid."""
    v = pci % 4
    dmrs, data = [], []
    # symbol 1: full 240, DMRS at v, v+4, ...
    for k in range(SSB_NRE):
        (dmrs if k % 4 == v else data).append(1 * SSB_NRE + k)
    # symbol 2: edges 0..47 and 192..239
    for k in list(range(48)) + list(range(192, 240)):
        (dmrs if k % 4 == v else data).append(2 * SSB_NRE + k)
    # symbol 3: full 240
    for k in range(SSB_NRE):
        (dmrs if k % 4 == v else data).append(3 * SSB_NRE + k)
    return (np.asarray(data, np.int32), np.asarray(dmrs, np.int32))


# --------------------------------------------------------------------------
# PBCH polar coding (38.212 7.1)


def pbch_encode_bits(payload: jnp.ndarray, pci: int) -> jnp.ndarray:
    """(B, 32) -> (B, 864) rate-matched scrambled bits."""
    b = payload.shape[0]
    with_crc = jnp.concatenate(
        [payload.astype(jnp.int8), crc_ops.crc_compute(payload, "24C")],
        axis=-1)
    cw = polar.encode_info(with_crc, PBCH_N_LOG)  # (B, 512)
    e = cw[:, jnp.asarray(np.arange(PBCH_E) % (1 << PBCH_N_LOG))]
    scr = sequence.gold_sequence_np(pci, PBCH_E).astype(np.int8)
    return jnp.bitwise_xor(e.astype(jnp.int8), jnp.asarray(scr))


def pbch_decode_bits(llrs: jnp.ndarray, pci: int) -> tuple[jnp.ndarray, jnp.ndarray]:
    """(B, 864) LLRs -> (payload (B,32), crc_ok (B,))."""
    scr = sequence.gold_sequence_np(pci, PBCH_E).astype(np.float32)
    llrs = llrs * jnp.asarray(1.0 - 2.0 * scr)
    # de-repeat: accumulate the E LLRs back onto N positions
    n = 1 << PBCH_N_LOG
    idx = jnp.asarray(np.arange(PBCH_E) % n)
    acc = jnp.zeros(llrs.shape[:-1] + (n,), llrs.dtype)
    acc = acc.at[..., idx].add(llrs)
    dec = polar.decode(acc, PBCH_K, PBCH_N_LOG)  # (B, K) info bits
    ok = crc_ops.crc_check(dec, "24C")
    return dec[..., :PBCH_A], ok


# --------------------------------------------------------------------------
# SSB assembly + search


@dataclass(frozen=True)
class SsbConfig:
    pci: int
    i_ssb: int = 0


def assemble(cfg: SsbConfig, payload: jnp.ndarray) -> jnp.ndarray:
    """(B, 32) MIB payload -> (B, 4, 240) SSB grid."""
    b = payload.shape[0]
    nid2, nid1 = cfg.pci % 3, cfg.pci // 3
    grid = jnp.zeros((b, SSB_NSYM, SSB_NRE), jnp.complex64)
    grid = grid.at[:, 0, 56:56 + PSS_LEN].set(
        jnp.asarray(pss_sequence(nid2) + 0j))
    grid = grid.at[:, 2, 56:56 + PSS_LEN].set(
        jnp.asarray(sss_sequence(nid1, nid2) + 0j))
    bits = pbch_encode_bits(payload, cfg.pci)
    syms = modem.modulate("qpsk", bits)  # (B, 432)
    data_idx, dmrs_idx = _ssb_re_maps(cfg.pci)
    flat = grid.reshape(b, -1)
    flat = flat.at[:, jnp.asarray(data_idx)].set(syms)
    flat = flat.at[:, jnp.asarray(dmrs_idx)].set(
        jnp.asarray(pbch_dmrs(cfg.pci, cfg.i_ssb)))
    return flat.reshape(b, SSB_NSYM, SSB_NRE)


def search_pci(rx_ssb: jnp.ndarray) -> dict:
    """Blind PCI search on an aligned (B, 4, 240) SSB capture.

    PSS correlation over the 3 NID2 hypotheses, then SSS matched filter
    over all 336 NID1 as a single (B, 3, 336) batched matmul.
    """
    b = rx_ssb.shape[0]
    pss_y = rx_ssb[:, 0, 56:56 + PSS_LEN]           # (B, 127)
    pss_mat = jnp.asarray(np.stack([pss_sequence(i) for i in range(3)]))
    pss_corr = jnp.abs(pss_y @ pss_mat.T) ** 2       # (B, 3)
    pss_energy = jnp.sum(jnp.abs(pss_y) ** 2, axis=-1, keepdims=True) + 1e-9
    nid2 = jnp.argmax(pss_corr, axis=-1)             # (B,)

    sss_y = rx_ssb[:, 2, 56:56 + PSS_LEN]           # (B, 127)
    sss_mat = jnp.asarray(np.stack(
        [[sss_sequence(n1, n2) for n1 in range(336)] for n2 in range(3)]))
    # (B, 3, 336): correlation against every (nid2, nid1) pair
    corr = jnp.abs(jnp.einsum("bk,cnk->bcn", sss_y, sss_mat)) ** 2
    corr_sel = jnp.take_along_axis(
        corr, nid2[:, None, None], axis=1)[:, 0]     # (B, 336)
    nid1 = jnp.argmax(corr_sel, axis=-1)
    metric = pss_corr.max(axis=-1) / (PSS_LEN * pss_energy[:, 0])
    return dict(pci=3 * nid1 + nid2, nid1=nid1, nid2=nid2, metric=metric)


def decode_pbch(cfg: SsbConfig, rx_ssb: jnp.ndarray) -> dict:
    """Channel-estimate from PBCH DMRS, equalize, decode the BCH."""
    b = rx_ssb.shape[0]
    data_idx, dmrs_idx = _ssb_re_maps(cfg.pci)
    flat = rx_ssb.reshape(b, -1)
    r = jnp.asarray(pbch_dmrs(cfg.pci, cfg.i_ssb))
    h_ls = flat[:, jnp.asarray(dmrs_idx)] * jnp.conj(r)    # (B, 144)
    # average per symbol-third (sym1 / sym2-edges / sym3) for robustness
    h_avg = jnp.mean(h_ls, axis=-1, keepdims=True)
    nv = jnp.mean(jnp.abs(h_ls - h_avg) ** 2, axis=-1, keepdims=True) + 1e-9
    y = flat[:, jnp.asarray(data_idx)]
    x = y * jnp.conj(h_avg) / (jnp.abs(h_avg) ** 2 + nv)
    llr = modem.demodulate_soft("qpsk", x, nv / (jnp.abs(h_avg) ** 2 + 1e-9))
    payload, ok = pbch_decode_bits(llr.reshape(b, PBCH_E), cfg.pci)
    return dict(payload=payload, crc_ok=ok, snr_est=1.0 / nv[:, 0])
