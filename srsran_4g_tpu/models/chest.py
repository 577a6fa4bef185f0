"""DL channel estimation from cell reference signals.

Counterpart of the reference's `lib/src/phy/ch_estimation/chest_dl.c`:
LS estimation at CRS pilots, noise-reducing smoothing filter (default
triangular, chest_dl.c:39), time/frequency interpolation to the full grid,
and noise-variance / RSRP / SNR estimators.

Design: pilot extraction is a gather with the static CRS pattern;
smoothing is a small depthwise convolution along the pilot-frequency axis;
interpolation is expressed as two precomputed sparse-as-dense matmuls
(pilot→subcarrier along frequency, pilot-symbol→symbol along time) so the
whole estimator is a couple of batched GEMMs — dense and trivially
batched over subframes/UEs.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from srsran_4g_tpu.models import grid as G
from srsran_4g_tpu.utils import constants as C


@dataclass(frozen=True)
class ChestConfig:
    cell: G.CellConfig
    smooth_len: int = 3  # triangular smoothing window over pilots (0 = off)
    interpolate_time: bool = True  # False = average pilot symbols (static ch.)
    wiener: bool = False  # MMSE (Wiener) freq filter instead of lin. interp
    wiener_delay_spread_us: float = 1.0  # assumed RMS delay spread
    wiener_snr_db: float = 20.0          # design SNR of the filter


@functools.lru_cache(maxsize=64)
def _freq_interp_matrix(cell: G.CellConfig, k0: int) -> np.ndarray:
    """(n_pilot_sc, nre) linear interpolation weights from the pilot comb
    (subcarriers k0 + 6m) to all subcarriers, with edge extrapolation."""
    n_p = 2 * cell.nof_prb
    pil_k = k0 + 6 * np.arange(n_p)
    w = np.zeros((n_p, cell.nre), dtype=np.float32)
    for k in range(cell.nre):
        j = np.searchsorted(pil_k, k)
        if j == 0:
            lo, hi = 0, 1
        elif j >= n_p:
            lo, hi = n_p - 2, n_p - 1
        else:
            lo, hi = j - 1, j
        t = (k - pil_k[lo]) / (pil_k[hi] - pil_k[lo])
        w[lo, k] = 1.0 - t
        w[hi, k] = t
    return w


@functools.lru_cache(maxsize=64)
def _time_interp_matrix(pilot_syms: tuple[int, ...], nsymb: int, interp: bool) -> np.ndarray:
    """(n_pilot_sym, nsymb) weights: linear interp/extrap or plain average."""
    n_s = len(pilot_syms)
    w = np.zeros((n_s, nsymb), dtype=np.float32)
    if not interp or n_s == 1:
        w[:, :] = 1.0 / n_s
        return w
    ps = np.asarray(pilot_syms, dtype=np.float64)
    for l in range(nsymb):
        j = np.searchsorted(ps, l)
        if j == 0:
            lo, hi = 0, 1
        elif j >= n_s:
            lo, hi = n_s - 2, n_s - 1
        else:
            lo, hi = j - 1, j
        t = (l - ps[lo]) / (ps[hi] - ps[lo])
        w[lo, l] = 1.0 - t
        w[hi, l] = t
    return w


def _smooth_kernel(n: int) -> np.ndarray:
    tri = np.minimum(np.arange(1, n + 1), np.arange(n, 0, -1)).astype(np.float32)
    return tri / tri.sum()


@functools.lru_cache(maxsize=64)
def _wiener_matrix(cell: G.CellConfig, k0: int, delay_spread_us: float,
                   snr_db: float) -> np.ndarray:
    """(n_pilot_sc, nre) complex MMSE interpolation matrix.

    Counterpart of the reference's matrix Wiener DL filter
    (`lib/src/phy/ch_estimation/wiener_dl.c`, hooked at chest_dl.c:144):
    W = R_dp (R_pp + sigma^2 I)^{-1} with an exponential-PDP frequency
    correlation r(dk) = 1 / (1 + j 2*pi*tau_rms*df*dk).  Precomputed at
    trace time -> one matmul per subframe at run time.
    """
    n_p = 2 * cell.nof_prb
    pil_k = k0 + 6 * np.arange(n_p)
    all_k = np.arange(cell.nre)
    df = 15e3
    tau = delay_spread_us * 1e-6

    def corr(dk):
        return 1.0 / (1.0 + 2j * np.pi * tau * df * dk)

    r_pp = corr(pil_k[:, None] - pil_k[None, :])
    r_dp = corr(all_k[:, None] - pil_k[None, :])
    sigma2 = 10.0 ** (-snr_db / 10.0)
    w = r_dp @ np.linalg.inv(r_pp + sigma2 * np.eye(n_p))
    return w.T.astype(np.complex64)  # (n_p, nre)


def estimate(
    cfg: ChestConfig, rx_grid: jnp.ndarray, subframe: int, port: int = 0
) -> dict[str, jnp.ndarray]:
    """Estimate the DL channel for one port from a received grid.

    Args:
      rx_grid: (..., nsymb, nre) complex64.

    Returns dict with:
      h:         (..., nsymb, nre) complex64 channel estimate
      noise_var: (...,) float32 noise variance estimate
      rsrp:      (...,) float32 average pilot power
      snr_db:    (...,) float32
    """
    cell = cfg.cell
    syms_np, scs_np = G.crs_pattern(cell, port)
    pilots_ref = jnp.asarray(G.crs_values(cell, port, subframe))  # (S, P)

    # per-symbol comb gather (combs differ between l=0 and l=4 symbols)
    rx_pil = rx_grid[..., jnp.asarray(syms_np)[:, None], jnp.asarray(scs_np)]
    # (..., S, P)
    h_ls = rx_pil * jnp.conj(pilots_ref)  # LS estimate (unit-power pilots)

    # triangular smoothing along the pilot axis
    if cfg.smooth_len > 1:
        ker = _smooth_kernel(cfg.smooth_len)
        pad = len(ker) // 2
        hp = jnp.pad(h_ls, [(0, 0)] * (h_ls.ndim - 1) + [(pad, pad)], mode="edge")
        h_sm = sum(
            ker[i] * hp[..., i:i + h_ls.shape[-1]] for i in range(len(ker))
        )
    else:
        h_sm = h_ls

    # noise estimate from the LS-vs-smoothed residual (chest_dl noise est.)
    resid = h_ls - h_sm
    noise_var = jnp.mean(jnp.abs(resid) ** 2, axis=(-1, -2)).astype(jnp.float32)
    # correct for the residual-variance shrinkage of the smoothing filter:
    # var(resid) = sigma^2 * (1 - 2*w0 + sum w^2) for symmetric kernels
    if cfg.smooth_len > 1:
        ker = _smooth_kernel(cfg.smooth_len)
        w0 = float(ker[len(ker) // 2])
        shrink = max(1.0 - 2.0 * w0 + float(np.sum(ker**2)), 1e-3)
        noise_var = noise_var / shrink

    rsrp = jnp.mean(jnp.abs(rx_pil) ** 2, axis=(-1, -2)).astype(jnp.float32)

    # interpolate: pilots (S, P) → (nsymb, nre) via two matmuls; the comb
    # offset k0 differs per CRS symbol, so stack per-symbol weight matrices
    if cfg.wiener:
        wf = jnp.asarray(
            np.stack([
                _wiener_matrix(cell, int(scs_np[s, 0] % 6),
                               cfg.wiener_delay_spread_us, cfg.wiener_snr_db)
                for s in range(len(syms_np))
            ])
        )  # (S, P, nre) complex
    else:
        wf = jnp.asarray(
            np.stack([
                _freq_interp_matrix(cell, int(scs_np[s, 0] % 6))
                for s in range(len(syms_np))
            ])
        )  # (S, P, nre)
    # HIGHEST: a GPU would otherwise run these complex64 products in TF32,
    # whose ~1e-3 relative error is an estimation-noise floor near -60 dB;
    # the products are small next to the receiver, so full f32 costs little
    h_freq = jnp.einsum("...sp,spk->...sk", h_sm, wf.astype(jnp.complex64),
                        precision=jax.lax.Precision.HIGHEST)
    wt = jnp.asarray(
        _time_interp_matrix(tuple(int(s) for s in syms_np), cell.nsymb,
                            cfg.interpolate_time)
    )
    h = jnp.einsum("...sk,sl->...lk", h_freq, wt.astype(jnp.complex64),
                   precision=jax.lax.Precision.HIGHEST)

    snr_db = 10.0 * jnp.log10(
        jnp.maximum(rsrp - noise_var, 1e-12) / jnp.maximum(noise_var, 1e-12)
    )
    return dict(h=h, noise_var=noise_var, rsrp=rsrp, snr_db=snr_db)
