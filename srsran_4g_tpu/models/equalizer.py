"""Equalization / predecoding.

Counterpart of the reference's `lib/src/phy/mimo/precoding.c`
(srsran_predecoding_*): single-port ZF/MMSE with noise estimate, plus the
CSI weighting that scales LLRs by per-RE channel quality
(precoding.c:287-389).  SFBC (TM2) diversity decode for 2 ports.

All element-wise complex math on (..., nsymb, nre) tensors — elementwise work that
XLA fuses with the surrounding demodulation.
"""

from __future__ import annotations

import jax.numpy as jnp


def equalize_single(
    y: jnp.ndarray,
    h: jnp.ndarray,
    noise_var: jnp.ndarray | float,
    method: str = "mmse",
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Single-port equalisation.

    Args:
      y: (..., N) received REs.
      h: (..., N) channel estimate.
      noise_var: scalar or (...,) broadcastable complex-noise variance.

    Returns:
      (x_hat (..., N) complex64, eff_noise_var (..., N) float32) where
      eff_noise_var is the per-RE effective noise variance to feed the
      soft demodulator (ZF-normalised so the constellation stays unit
      energy).
    """
    hh = jnp.maximum(jnp.abs(h) ** 2, 1e-12)
    nv = jnp.asarray(noise_var, jnp.float32)
    while nv.ndim < y.ndim:
        nv = nv[..., None]
    if method == "zf":
        x = y * jnp.conj(h) / hh.astype(jnp.complex64)
    else:  # MMSE with ZF-consistent normalisation (unbiased estimate)
        x = y * jnp.conj(h) / (hh + nv).astype(jnp.complex64)
        bias = hh / (hh + nv)
        x = x / jnp.maximum(bias, 1e-6).astype(jnp.complex64)
    eff_nv = (nv / hh).astype(jnp.float32)
    return x.astype(jnp.complex64), eff_nv


def alamouti_decode_2x1(
    y: jnp.ndarray, h0: jnp.ndarray, h1: jnp.ndarray,
    noise_var: jnp.ndarray | float,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """SFBC (TM2) decode for 2 TX ports, 1 RX antenna (TS 36.211 §6.3.4.3).

    The LTE SFBC mapping over an RE pair (k even, k+1) is
      port0: [ x0, x1 ],  port1: [ -x1*, x0* ] (with 1/sqrt(2) power split).

    Args:
      y: (..., N) with N even — received REs in mapping order.
      h0/h1: (..., N) per-port channel estimates.

    Returns:
      (x_hat (..., N), eff_noise_var (..., N)).
    """
    y0 = y[..., 0::2]
    y1 = y[..., 1::2]
    g0 = h0[..., 0::2]
    g1 = h1[..., 0::2]  # assume h constant over the RE pair
    denom = jnp.maximum(jnp.abs(g0) ** 2 + jnp.abs(g1) ** 2, 1e-12)
    # standard Alamouti combining (note sqrt(2) restores unit symbol energy)
    x0 = (jnp.conj(g0) * y0 + g1 * jnp.conj(y1)) / denom * jnp.sqrt(2.0)
    # (conj(g1)·y0 − g0·conj(y1)) = −(|g0|²+|g1|²)·x1*/√2 → negate+conjugate
    x1 = -jnp.conj((jnp.conj(g1) * y0 - g0 * jnp.conj(y1)) / denom) * jnp.sqrt(2.0)
    x = jnp.stack([x0, x1], axis=-1).reshape(y.shape)
    nv = jnp.asarray(noise_var, jnp.float32)
    while nv.ndim < y.ndim:
        nv = nv[..., None]
    eff = 2.0 * nv / denom
    eff_nv = jnp.stack([eff, eff], axis=-1).reshape(y.shape).astype(jnp.float32)
    return x.astype(jnp.complex64), eff_nv


def sfbc_fstd_decode_4x1(
    y: jnp.ndarray, h: jnp.ndarray, noise_var: jnp.ndarray | float,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """SFBC-FSTD (TM2, 4 TX ports) decode for 1 RX antenna.

    The 4-port diversity mapping (precoding.c:1961, 36.211 §6.3.4.3) sends
    Alamouti pairs on port pair (0, 2) over REs (4i, 4i+1) and on
    (1, 3) over REs (4i+2, 4i+3):
      RE 4i:   p0 = x0,  p2 = -x1*;   RE 4i+1: p0 = x1, p2 = x0*
      RE 4i+2: p1 = x2,  p3 = -x3*;   RE 4i+3: p1 = x3, p3 = x2*
    (1/sqrt(2) power split per active pair).

    Args:
      y: (..., N) received REs, N a multiple of 4.
      h: (..., 4, N) per-port channel estimates.

    Returns (x_hat (..., N), eff_noise_var (..., N)).
    """
    def pair(ya, yb, ga, gb):
        den = jnp.maximum(jnp.abs(ga) ** 2 + jnp.abs(gb) ** 2, 1e-12)
        xa = (jnp.conj(ga) * ya + gb * jnp.conj(yb)) / den * jnp.sqrt(2.0)
        xb = (jnp.conj(ga) * yb - gb * jnp.conj(ya)) / den * jnp.sqrt(2.0)
        return xa, xb, den

    y0, y1, y2, y3 = (y[..., i::4] for i in range(4))
    g0 = h[..., 0, 0::4]
    g2 = h[..., 2, 0::4]
    g1 = h[..., 1, 2::4]
    g3 = h[..., 3, 2::4]
    x0, x1, d02 = pair(y0, y1, g0, g2)
    x2, x3, d13 = pair(y2, y3, g1, g3)
    x = jnp.stack([x0, x1, x2, x3], axis=-1).reshape(y.shape)
    nv = jnp.asarray(noise_var, jnp.float32)
    while nv.ndim < y.ndim:
        nv = nv[..., None]
    e02 = 2.0 * nv / d02
    e13 = 2.0 * nv / d13
    eff_nv = jnp.stack([e02, e02, e13, e13], axis=-1).reshape(y.shape)
    return x.astype(jnp.complex64), eff_nv.astype(jnp.float32)
