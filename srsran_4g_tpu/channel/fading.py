"""Tapped-delay-line fading channel with 3GPP profiles and Doppler.

Counterpart of the reference's `lib/src/phy/channel/fading.c`
(EPA/EVA/ETU tap tables, fading.c:33-69; FFT overlap-save convolution).

Design: per-tap Rayleigh processes are generated with a sum-of-sinusoids
(Jakes) model — fully vectorised over (batch, taps, time-blocks) — and the
channel is applied in the frequency domain per OFDM-symbol-sized block, or
as a dense time-domain FIR for short filters.  A sharded overlap-save
variant with `ppermute` halo exchange lives in parallel/stream.py.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

# 3GPP TS 36.101 Annex B.2 tapped delay line profiles: (delay ns, power dB)
DELAY_PROFILES = {
    "epa": ((0, 0.0), (30, -1.0), (70, -2.0), (90, -3.0), (110, -8.0),
            (190, -17.2), (410, -20.8)),
    "eva": ((0, 0.0), (30, -1.5), (150, -1.4), (310, -3.6), (370, -0.6),
            (710, -9.1), (1090, -7.0), (1730, -12.0), (2510, -16.9)),
    "etu": ((0, -1.0), (50, -1.0), (120, -1.0), (200, 0.0), (230, 0.0),
            (500, 0.0), (1600, -3.0), (2300, -5.0), (5000, -7.0)),
}


@dataclass(frozen=True)
class FadingConfig:
    profile: str  # "epa" | "eva" | "etu"
    doppler_hz: float
    srate_hz: float
    n_sinusoids: int = 16

    @property
    def taps(self) -> tuple[np.ndarray, np.ndarray]:
        prof = DELAY_PROFILES[self.profile]
        delays = np.asarray([p[0] for p in prof]) * 1e-9 * self.srate_hz
        powers = 10 ** (np.asarray([p[1] for p in prof]) / 10.0)
        powers = powers / powers.sum()
        return delays, powers


@functools.lru_cache(maxsize=32)
def _jakes_params(cfg: FadingConfig, seed: int) -> tuple[np.ndarray, ...]:
    """Random sinusoid frequencies/phases per tap (host, deterministic)."""
    delays, powers = cfg.taps
    rng = np.random.default_rng(seed)
    n_taps = len(delays)
    n = cfg.n_sinusoids
    theta = rng.uniform(0, 2 * np.pi, size=(n_taps, n))
    phi = rng.uniform(0, 2 * np.pi, size=(n_taps, n))
    f = cfg.doppler_hz * np.cos(theta)  # per-sinusoid Doppler shift
    return delays, powers, f, phi


def tap_gains(cfg: FadingConfig, seed: int, t: jnp.ndarray) -> jnp.ndarray:
    """Complex tap gains (n_taps, len(t)) at times ``t`` (seconds)."""
    delays, powers, f, phi = _jakes_params(cfg, seed)
    fj = jnp.asarray(f, jnp.float32)[..., None]  # (taps, n, 1)
    pj = jnp.asarray(phi, jnp.float32)[..., None]
    ph = 2 * jnp.pi * fj * t[None, None, :] + pj
    g = jnp.mean(jnp.exp(1j * ph.astype(jnp.complex64)), axis=1)
    g = g * jnp.sqrt(jnp.asarray(powers, jnp.float32))[:, None].astype(jnp.complex64)
    # normalise the sum-of-sinusoids variance (mean of unit phasors has
    # variance 1/n per component)
    return g * jnp.sqrt(jnp.asarray(cfg.n_sinusoids, jnp.float32)).astype(jnp.complex64)


def freq_response(
    cfg: FadingConfig, seed: int, t: jnp.ndarray, freqs: jnp.ndarray
) -> jnp.ndarray:
    """Channel frequency response H (len(t), len(freqs)) complex64.

    freqs in cycles/sample (e.g. FFT bin / N); taps at fractional sample
    delays contribute exp(-j2π f d).
    """
    delays, _, _, _ = _jakes_params(cfg, seed)
    g = tap_gains(cfg, seed, t)  # (taps, T)
    d = jnp.asarray(delays, jnp.float32)
    steer = jnp.exp(
        (-2j * jnp.pi) * (d[:, None] * freqs[None, :]).astype(jnp.complex64)
    )  # (taps, F)
    return jnp.einsum("pt,pf->tf", g, steer)


def apply_grid(
    cfg: FadingConfig,
    seed: int,
    grid_tx: jnp.ndarray,
    symbol_times: np.ndarray,
    sc_freqs: np.ndarray,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Apply fading per OFDM symbol in the frequency domain.

    Valid while the channel is static over one symbol (Doppler ≪ 15 kHz),
    the standard assumption for these profiles.

    Args:
      grid_tx: (..., nsymb, nre).
      symbol_times: (nsymb,) seconds.
      sc_freqs: (nre,) cycles/sample of each subcarrier.

    Returns:
      (faded grid, H (nsymb, nre)).
    """
    h = freq_response(
        cfg, seed, jnp.asarray(symbol_times, jnp.float32), jnp.asarray(sc_freqs, jnp.float32)
    )
    return grid_tx * h, h
