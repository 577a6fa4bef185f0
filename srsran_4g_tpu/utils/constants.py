"""LTE dimension tables and 3GPP constants.

Batched equivalents of the reference's `lib/src/phy/common/phy_common.c`
(srsran_symbol_sz, CP length macros), `lib/src/phy/fec/cbsegm.c` (code-block
size table) and `lib/src/phy/fec/turbo/tc_interl_lte.c` (QPP interleaver
parameters).  All numeric tables are 3GPP TS 36.211/36.212 specification data.

Everything here is plain Python/NumPy: these are *static* configuration values
resolved at trace time; nothing in this module ever runs on device.
"""

from __future__ import annotations

import functools

import numpy as np

# --- Resource grid dimensions (TS 36.211 §6.2) ------------------------------

NRE = 12  # subcarriers per PRB
CP_NORM_NSYMB = 7  # OFDM symbols per slot, normal CP
CP_EXT_NSYMB = 6  # OFDM symbols per slot, extended CP
NSLOTS_X_SF = 2
NSYMB_SF_NORM = CP_NORM_NSYMB * NSLOTS_X_SF  # 14
NSYMB_SF_EXT = CP_EXT_NSYMB * NSLOTS_X_SF  # 12
SF_PER_FRAME = 10
MAX_PRB = 110
MAX_PORTS = 4

# DFT size per channel bandwidth (reference: phy_common.c srsran_symbol_sz).
SYMBOL_SZ_BY_PRB = {6: 128, 15: 256, 25: 512, 50: 1024, 75: 1536, 100: 2048}


def symbol_sz(nof_prb: int) -> int:
    """DFT size for a given number of PRB (TS 36.104 sample rates / 15 kHz)."""
    if nof_prb in SYMBOL_SZ_BY_PRB:
        return SYMBOL_SZ_BY_PRB[nof_prb]
    # Generic rule used by the reference for non-standard PRB counts:
    # smallest power of two with >= nof_prb*NRE subcarriers of occupancy.
    n = 128
    while n < nof_prb * NRE / 0.875:
        n *= 2
    return n


def cp_len_norm(symbol_idx_in_slot: int, symb_sz: int) -> int:
    """Normal CP length in samples for the given symbol of a slot."""
    return (160 if symbol_idx_in_slot == 0 else 144) * symb_sz // 2048


def cp_len_ext(symb_sz: int) -> int:
    return 512 * symb_sz // 2048


def slot_len(symb_sz: int) -> int:
    """Samples per 0.5 ms slot (normal CP)."""
    return 15360 * symb_sz // 2048


def sf_len(symb_sz: int) -> int:
    """Samples per 1 ms subframe (normal CP)."""
    return 2 * slot_len(symb_sz)


# --- Turbo code-block sizes (TS 36.212 Table 5.1.3-3) -----------------------
# The 188 admissible interleaver sizes K: 40..512 step 8, 512..1024 step 16,
# 1024..2048 step 32, 2048..6144 step 64.


@functools.lru_cache(maxsize=None)
def cb_sizes() -> np.ndarray:
    ks = (
        list(range(40, 512, 8))
        + list(range(512, 1024, 16))
        + list(range(1024, 2048, 32))
        + list(range(2048, 6144 + 64, 64))
    )
    arr = np.asarray(ks, dtype=np.int64)
    assert arr.shape[0] == 188
    return arr


MAX_CB_LEN = 6144  # SRSRAN_TCOD_MAX_LEN_CB equivalent


def cb_size_index(k: int) -> int:
    """Index of code-block size K in the 188-entry table (exact match)."""
    idx = int(np.searchsorted(cb_sizes(), k))
    if idx >= 188 or cb_sizes()[idx] != k:
        raise ValueError(f"{k} is not a valid turbo code-block size")
    return idx


def cb_size_ceil(k: int) -> int:
    """Smallest admissible code-block size >= k."""
    idx = int(np.searchsorted(cb_sizes(), k))
    if idx >= 188:
        raise ValueError(f"no turbo code-block size >= {k}")
    return int(cb_sizes()[idx])


# QPP interleaver parameters f1, f2 per code-block size (TS 36.212
# Table 5.1.3-3; same data as reference tc_interl_lte.c:39-69).
TURBO_F1 = np.asarray(
    [3, 7, 19, 7, 7, 11, 5, 11, 7, 41, 103, 15, 9, 17, 9, 21, 101, 21, 57,
     23, 13, 27, 11, 27, 85, 29, 33, 15, 17, 33, 103, 19, 19, 37, 19, 21,
     21, 115, 193, 21, 133, 81, 45, 23, 243, 151, 155, 25, 51, 47, 91, 29,
     29, 247, 29, 89, 91, 157, 55, 31, 17, 35, 227, 65, 19, 37, 41, 39, 185,
     43, 21, 155, 79, 139, 23, 217, 25, 17, 127, 25, 239, 17, 137, 215, 29,
     15, 147, 29, 59, 65, 55, 31, 17, 171, 67, 35, 19, 39, 19, 199, 21, 211,
     21, 43, 149, 45, 49, 71, 13, 17, 25, 183, 55, 127, 27, 29, 29, 57, 45,
     31, 59, 185, 113, 31, 17, 171, 209, 253, 367, 265, 181, 39, 27, 127,
     143, 43, 29, 45, 157, 47, 13, 111, 443, 51, 51, 451, 257, 57, 313, 271,
     179, 331, 363, 375, 127, 31, 33, 43, 33, 477, 35, 233, 357, 337, 37,
     71, 71, 37, 39, 127, 39, 39, 31, 113, 41, 251, 43, 21, 43, 45, 45, 161,
     89, 323, 47, 23, 47, 263],
    dtype=np.int64,
)
TURBO_F2 = np.asarray(
    [10, 12, 42, 16, 18, 20, 22, 24, 26, 84, 90, 32, 34, 108, 38, 120, 84,
     44, 46, 48, 50, 52, 36, 56, 58, 60, 62, 32, 198, 68, 210, 36, 74, 76,
     78, 120, 82, 84, 86, 44, 90, 46, 94, 48, 98, 40, 102, 52, 106, 72, 110,
     168, 114, 58, 118, 180, 122, 62, 84, 64, 66, 68, 420, 96, 74, 76, 234,
     80, 82, 252, 86, 44, 120, 92, 94, 48, 98, 80, 102, 52, 106, 48, 110,
     112, 114, 58, 118, 60, 122, 124, 84, 64, 66, 204, 140, 72, 74, 76, 78,
     240, 82, 252, 86, 88, 60, 92, 846, 48, 28, 80, 102, 104, 954, 96, 110,
     112, 114, 116, 354, 120, 610, 124, 420, 64, 66, 136, 420, 216, 444,
     456, 468, 80, 164, 504, 172, 88, 300, 92, 188, 96, 28, 240, 204, 104,
     212, 192, 220, 336, 228, 232, 236, 120, 244, 248, 168, 64, 130, 264,
     134, 408, 138, 280, 142, 480, 146, 444, 120, 152, 462, 234, 158, 80,
     96, 902, 166, 336, 170, 86, 174, 176, 178, 120, 182, 184, 186, 94, 190,
     480],
    dtype=np.int64,
)

# --- Rate matching sub-block interleaver (TS 36.212 §5.1.4.1.1) -------------
# Inter-column permutation pattern for turbo-coded channels (32 columns).
RM_PERM_TC = np.asarray(
    [0, 16, 8, 24, 4, 20, 12, 28, 2, 18, 10, 26, 6, 22, 14, 30,
     1, 17, 9, 25, 5, 21, 13, 29, 3, 19, 11, 27, 7, 23, 15, 31],
    dtype=np.int64,
)
# Inter-column permutation for convolutionally-coded channels (§5.1.4.2.1).
RM_PERM_CC = np.asarray(
    [1, 17, 9, 25, 5, 21, 13, 29, 3, 19, 11, 27, 7, 23, 15, 31,
     0, 16, 8, 24, 4, 20, 12, 28, 2, 18, 10, 26, 6, 22, 14, 30],
    dtype=np.int64,
)

# --- CRC generator polynomials (TS 36.212 §5.1.1), MSB-first incl. x^order --
CRC_POLYS = {
    "24A": (0x1864CFB, 24),
    "24B": (0x1800063, 24),
    "24C": (0x1B2B117, 24),  # NR PBCH/DCI (TS 38.212 5.1)
    "16": (0x11021, 16),
    "8": (0x19B, 8),
    "11": (0xE21, 11),       # NR UCI (TS 38.212 5.1)
    "6": (0x61, 6),          # NR small UCI
}

# --- Modulation (TS 36.211 §7.1) --------------------------------------------
MOD_BPSK, MOD_QPSK, MOD_16QAM, MOD_64QAM, MOD_256QAM = (
    "bpsk", "qpsk", "16qam", "64qam", "256qam")
BITS_PER_SYMBOL = {
    MOD_BPSK: 1, MOD_QPSK: 2, MOD_16QAM: 4, MOD_64QAM: 6, MOD_256QAM: 8,
}

# Gold sequence fast-forward (TS 36.211 §7.2)
GOLD_SEQ_NC = 1600
