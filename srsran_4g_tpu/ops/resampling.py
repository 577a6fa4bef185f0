"""Sample-rate conversion: FFT integer resampler + polyphase arbitrary.

Counterpart of the reference's `lib/src/phy/resampling/{resampler.c,
resample_arb.c}` (used by the radio layer to convert between the PHY rate
and the device rate, radio.cc:327-355).

- `resample_fft`: rational L/M resampling in the frequency domain — one
  batched FFT, spectrum truncate/zero-pad, IFFT.  Exact for band-limited
  signals, and the natural batched formulation of the reference's FFT
  resampler.
- `resample_polyphase`: arbitrary-ratio polyphase interpolation with a
  windowed-sinc filter bank: output n gathers a length-NTAPS input window
  and dots it with the phase-selected filter — a batched gather + small
  matmul, streaming-friendly.
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np


def resample_fft(x: jnp.ndarray, up: int, down: int) -> jnp.ndarray:
    """Rational resample along the last axis: out_len = len * up // down."""
    n = x.shape[-1]
    n_out = n * up // down
    xf = jnp.fft.fft(x, axis=-1)
    nf_out = n_out
    half = min(n, nf_out) // 2
    yf = jnp.zeros(x.shape[:-1] + (nf_out,), dtype=xf.dtype)
    yf = yf.at[..., :half].set(xf[..., :half])
    yf = yf.at[..., nf_out - half:].set(xf[..., n - half:])
    return (jnp.fft.ifft(yf, axis=-1) * (n_out / n)).astype(jnp.complex64)


@functools.lru_cache(maxsize=64)
def _polyphase_bank(n_phases: int, n_taps: int, cutoff: float) -> np.ndarray:
    """(n_phases, n_taps) windowed-sinc interpolation filter bank."""
    idx = np.arange(n_phases * n_taps)
    t = (idx - n_phases * n_taps / 2) / n_phases
    h = np.sinc(cutoff * t) * cutoff
    h *= np.hamming(idx.size)
    bank = h.reshape(n_taps, n_phases).T[::-1]  # phase-major
    return np.ascontiguousarray(bank / bank.sum(axis=1, keepdims=True)).astype(
        np.float32
    )


def resample_polyphase(
    x: jnp.ndarray, rate: float, n_phases: int = 32, n_taps: int = 8
) -> jnp.ndarray:
    """Arbitrary-ratio resampler (rate = f_out / f_in), batched over the
    leading dims."""
    n_in = x.shape[-1]
    n_out = int(np.floor(n_in * rate))
    cutoff = min(1.0, rate)
    bank = jnp.asarray(_polyphase_bank(n_phases, n_taps, cutoff))

    t = np.arange(n_out) / rate  # fractional input positions
    base = np.floor(t).astype(np.int64)
    frac = t - base
    phase = np.minimum((frac * n_phases).astype(np.int64), n_phases - 1)
    # gather windows [base - n_taps/2 + 1 .. base + n_taps/2]
    offs = np.arange(n_taps) - n_taps // 2 + 1
    gidx = np.clip(base[:, None] + offs[None, :], 0, n_in - 1)  # (n_out, T)

    win = x[..., jnp.asarray(gidx)]  # (..., n_out, T)
    coef = bank[jnp.asarray(phase)]  # (n_out, T)
    return jnp.sum(win * coef.astype(win.dtype), axis=-1)
