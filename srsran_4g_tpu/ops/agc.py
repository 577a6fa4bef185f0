"""Automatic gain control (reference: lib/src/phy/agc/agc.c).

The reference runs a feedback loop adjusting RF gain from per-frame peak/
RSSI measurements.  The batched equivalent is a batched estimator +
exponential-tracking update that can run inside the jitted receive
pipeline; the returned gain multiplies the sample stream.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax.numpy as jnp


@dataclass(frozen=True)
class AgcConfig:
    target: float = 0.3  # target peak amplitude
    bandwidth: float = 0.7  # loop smoothing factor
    max_gain_db: float = 90.0
    min_gain_db: float = 0.0


def agc_step(
    cfg: AgcConfig, samples: jnp.ndarray, gain_db: jnp.ndarray
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """One AGC update per batch row.

    Args:
      samples: (..., N) frame of samples (pre-gain).
      gain_db: (...,) current gain.

    Returns: (scaled samples, new gain_db).
    """
    y = samples * (10.0 ** (gain_db[..., None] / 20.0)).astype(samples.dtype)
    peak = jnp.max(jnp.abs(y), axis=-1)
    err_db = 20.0 * jnp.log10(jnp.maximum(peak, 1e-9) / cfg.target)
    new_gain = jnp.clip(
        gain_db - cfg.bandwidth * err_db, cfg.min_gain_db, cfg.max_gain_db
    )
    return y, new_gain
