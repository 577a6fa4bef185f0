"""Cell synchronisation: PSS/SSS detection, CFO estimation/correction.

Counterpart of the reference's `lib/src/phy/sync/{pss.c,sss.c,sync.c,cfo.c}`
and the find/track state machine in `lib/src/phy/ue/ue_sync.c`.

Design: PSS matched filtering is one batched FFT-domain correlation
(pss.c:83-194's FFT correlation, but over a whole batch of capture windows
and all three N_ID_2 hypotheses at once); SSS detection is a single
(B, 62) × (62, 2·168) real correlation matmul over every (N_ID_1, frame
phase) hypothesis — one matmul instead of the reference's per-hypothesis
loops.  CFO estimators: CP-based (cp.c) and PSS-based (pss.c cfo).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from srsran_4g_tpu.ops.ofdm import OfdmConfig
from srsran_4g_tpu.ops.zadoff_chu import pss_sequence

# --- PSS --------------------------------------------------------------------


@functools.lru_cache(maxsize=32)
def pss_time_domain(n_id_2: int, symbol_sz: int) -> np.ndarray:
    """Unit-energy time-domain PSS replica of length symbol_sz."""
    freq = np.zeros(symbol_sz, dtype=np.complex64)
    seq = pss_sequence(n_id_2)
    freq[symbol_sz - 31:] = seq[:31]
    freq[1:32] = seq[31:]
    t = np.fft.ifft(freq).astype(np.complex64)
    return (t / np.linalg.norm(t)).astype(np.complex64)


def pss_correlate(samples: jnp.ndarray, n_id_2: int, symbol_sz: int) -> jnp.ndarray:
    """Normalised matched-filter output (..., N) via FFT convolution.

    Output index n = correlation of the replica with samples[n : n+symbol_sz]
    (peak at the PSS symbol start).
    """
    n = samples.shape[-1]
    nfft = int(2 ** np.ceil(np.log2(n + symbol_sz)))
    replica = pss_time_domain(n_id_2, symbol_sz)
    rf = np.fft.fft(np.conj(replica[::-1]), nfft).astype(np.complex64)
    xf = jnp.fft.fft(samples, nfft, axis=-1)
    corr = jnp.fft.ifft(xf * jnp.asarray(rf), axis=-1)
    # full convolution index k corresponds to window start k - (symbol_sz-1)
    corr = corr[..., symbol_sz - 1:symbol_sz - 1 + n]
    # normalise by local energy
    power = jnp.cumsum(jnp.abs(samples) ** 2, axis=-1)
    pad = jnp.zeros_like(power[..., :1])
    cs = jnp.concatenate([pad, power], axis=-1)
    win = cs[..., symbol_sz:] - cs[..., :-symbol_sz]
    win = jnp.concatenate(
        [win, jnp.broadcast_to(win[..., -1:], win.shape[:-1] + (symbol_sz - 1,))],
        axis=-1,
    )
    return jnp.abs(corr) / jnp.sqrt(jnp.maximum(win, 1e-12))


def find_pss(samples: jnp.ndarray, symbol_sz: int) -> dict:
    """Search all three N_ID_2 over a capture window.

    Returns dict(n_id_2 (B,), offset (B,), peak (B,), corr (B,3,N)).
    """
    corr = jnp.stack(
        [pss_correlate(samples, i, symbol_sz) for i in range(3)], axis=-2
    )  # (..., 3, N)
    peak_per_id = jnp.max(corr, axis=-1)
    off_per_id = jnp.argmax(corr, axis=-1)
    n_id_2 = jnp.argmax(peak_per_id, axis=-1)
    peak = jnp.take_along_axis(peak_per_id, n_id_2[..., None], axis=-1)[..., 0]
    offset = jnp.take_along_axis(off_per_id, n_id_2[..., None], axis=-1)[..., 0]
    return dict(n_id_2=n_id_2, offset=offset, peak=peak, corr=corr)


def pss_cfo_estimate(
    pss_samples: jnp.ndarray, n_id_2: jnp.ndarray | int, symbol_sz: int
) -> jnp.ndarray:
    """CFO from the phase between the two halves of the received PSS symbol
    (pss.c srsran_pss_cfo_compute). Returns CFO in subcarrier units."""
    if isinstance(n_id_2, (int, np.integer)):
        replica = jnp.asarray(pss_time_domain(int(n_id_2), symbol_sz))
    else:
        reps = jnp.stack(
            [jnp.asarray(pss_time_domain(i, symbol_sz)) for i in range(3)]
        )
        replica = reps[n_id_2]
    y = pss_samples * jnp.conj(replica)
    half = symbol_sz // 2
    z = jnp.sum(jnp.conj(y[..., :half]) * y[..., half:], axis=-1)
    return jnp.angle(z) / jnp.pi


# --- CFO --------------------------------------------------------------------


def cp_cfo_estimate(cfg: OfdmConfig, samples: jnp.ndarray) -> jnp.ndarray:
    """CP-based CFO estimate over one subframe, in subcarrier units."""
    n = cfg.symbol_sz
    acc = jnp.zeros(samples.shape[:-1], jnp.complex64)
    pos = 0
    for l in range(cfg.nsymb_sf):
        cp = cfg.cp_len(l % cfg.nsymb_slot)
        cp_seg = samples[..., pos:pos + cp]
        tail = samples[..., pos + n:pos + n + cp]
        acc = acc + jnp.sum(jnp.conj(cp_seg) * tail, axis=-1)
        pos += cp + n
    return jnp.angle(acc) / (2 * jnp.pi)


def cfo_correct(samples: jnp.ndarray, cfo: jnp.ndarray, symbol_sz: int) -> jnp.ndarray:
    """Mix down by cfo (subcarrier units): x(n)·exp(-j2π·cfo·n/N)."""
    n = samples.shape[-1]
    ramp = jnp.arange(n, dtype=jnp.float32) / symbol_sz
    ph = -2j * jnp.pi * jnp.asarray(cfo, jnp.float32)[..., None] * ramp
    return samples * jnp.exp(ph.astype(jnp.complex64))


# --- SSS --------------------------------------------------------------------


@functools.lru_cache(maxsize=1)
def _sss_base() -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The s̃, c̃, z̃ m-sequences of TS 36.211 §6.11.2.1 (length 31, ±1)."""
    def mseq(taps: list[int]) -> np.ndarray:
        x = np.zeros(31, dtype=np.int64)
        x[4] = 1
        for i in range(26):
            x[i + 5] = sum(x[i + t] for t in taps) % 2
        return 1 - 2 * x

    s = mseq([2, 0])   # x5 = x2 + x0
    c = mseq([3, 0])   # x5 = x3 + x0
    z = mseq([4, 2, 1, 0])
    return s, c, z


@functools.lru_cache(maxsize=4)
def sss_sequences() -> np.ndarray:
    """(168, 2, 62) SSS for every N_ID_1 and subframe phase (0 → sf0,
    1 → sf5)."""
    s, c, z = _sss_base()
    out = np.zeros((168, 2, 62), dtype=np.float32)
    for nid1 in range(168):
        qp = nid1 // 30
        q = (nid1 + qp * (qp + 1) // 2) // 30
        mp = nid1 + q * (q + 1) // 2
        m0 = mp % 31
        m1 = (m0 + mp // 31 + 1) % 31
        for phase, (mm0, mm1) in enumerate(((m0, m1), (m1, m0))):
            d = np.zeros(62, dtype=np.float32)
            n = np.arange(31)
            s0 = s[(n + mm0) % 31]
            s1 = s[(n + mm1) % 31]
            c0 = c[(n + 0) % 31]  # placeholder, fixed below
            # even: d(2n) = s_{m0}(n)·c0(n); odd: d(2n+1) = s_{m1}(n)·c1(n)·z1^{(m0)}(n)
            # with c0/c1 depending on N_ID_2 — handled at correlation time
            d[0::2] = s0
            d[1::2] = s1 * z[(n + (mm0 % 8)) % 31]
            out[nid1, phase] = d
    return out


def sss_detect(
    sss_re: jnp.ndarray, n_id_2: int
) -> dict:
    """Detect N_ID_1 and frame phase from equalised SSS REs.

    Args:
      sss_re: (B, 62) equalised (or differentially coherent) SSS symbols.
      n_id_2: detected PSS index (for the c0/c1 scrambling).

    Returns dict(n_id_1 (B,), phase (B,) 0=sf0/1=sf5, corr (B, 336)).
    """
    s, c, z = _sss_base()
    n = np.arange(31)
    c0 = c[(n + n_id_2) % 31].astype(np.float32)
    c1 = c[(n + n_id_2 + 3) % 31].astype(np.float32)
    cand = sss_sequences().copy()  # (168, 2, 62)
    cand[..., 0::2] *= c0
    cand[..., 1::2] *= c1
    flat = cand.reshape(336, 62)
    corr = jnp.einsum(
        "bn,cn->bc", jnp.real(sss_re).astype(jnp.float32), jnp.asarray(flat)
    )
    best = jnp.argmax(corr, axis=-1)
    return dict(n_id_1=best // 2, phase=best % 2, corr=corr)


# --- fine frequency + SFO ---------------------------------------------------


def cedron_freq_estimate(x: jnp.ndarray) -> jnp.ndarray:
    """Cedron Dawg's exact 3-bin frequency estimator on the FFT peak
    (counterpart of `lib/src/phy/ch_estimation/cedron_freq_estimator.c`).

    x: (..., N) complex time-domain tone (+noise).  Returns the frequency
    in normalised cycles/sample (-0.5..0.5), resolved far below the bin
    spacing.
    """
    n = x.shape[-1]
    X = jnp.fft.fft(x, axis=-1)
    k = jnp.argmax(jnp.abs(X), axis=-1)

    def grab(off):
        return jnp.take_along_axis(X, ((k + off) % n)[..., None],
                                   axis=-1)[..., 0]

    z1, z2, z3 = grab(-1), grab(0), grab(1)
    # Cedron: f = k + real( (z1 - z3) / (2 z2 - z1 - z3) ) (parabolic-exact
    # for a complex tone in white noise)
    delta = jnp.real((z1 - z3) / (2.0 * z2 - z1 - z3 + 1e-12))
    freq = (k.astype(jnp.float32) + delta) / n
    return jnp.where(freq > 0.5, freq - 1.0, freq)


def sfo_estimate(timing_offsets: jnp.ndarray, frame_period_s: float = 0.01
                 ) -> jnp.ndarray:
    """Sample-frequency-offset from the drift of per-frame timing offsets
    (sfo.c srsran_sfo_estimate): least-squares slope of offset-vs-time,
    returned in samples/second.

    timing_offsets: (..., T) successive PSS timing offsets in samples.
    """
    t = timing_offsets.shape[-1]
    x = jnp.arange(t, dtype=jnp.float32) * frame_period_s
    xc = x - x.mean()
    y = timing_offsets.astype(jnp.float32)
    yc = y - y.mean(axis=-1, keepdims=True)
    slope = jnp.sum(xc * yc, axis=-1) / jnp.sum(xc * xc)
    return slope  # samples per second
