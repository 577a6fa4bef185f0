"""MIMO layer mapping, precoding and detection, TS 36.211 §6.3.3/6.3.4.

Counterpart of the reference's `lib/src/phy/mimo/{layermap.c,precoding.c}`:
layer map/demap, TM3 (large-delay CDD) and TM4 (closed-loop) 2×2 spatial
multiplexing with codebook precoding, batched MMSE 2×2 detection, and PMI
selection (precoding.c:srsran_pmi_select) as a capacity argmax over the
codebook — evaluated for every RE of every subframe in one shot.

All 2×2 solves are closed-form (adjugate/determinant) element-wise complex
arithmetic — no linear-algebra library calls, pure elementwise work.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

# TS 36.211 Table 6.3.4.2.3-1: 2-port codebook (identity excluded for TM4
# rank 2 per spec; index 0 used by TM3)
_CODEBOOK_2TX_R1 = np.array(
    [[1, 1], [1, -1], [1, 1j], [1, -1j]], dtype=np.complex64
) / np.sqrt(2)
_CODEBOOK_2TX_R2 = np.stack(
    [
        np.array([[1, 0], [0, 1]], dtype=np.complex64) / np.sqrt(2),
        np.array([[1, 1], [1, -1]], dtype=np.complex64) / 2.0,
        np.array([[1, 1], [1j, -1j]], dtype=np.complex64) / 2.0,
    ]
)


def layer_map(codewords: list[jnp.ndarray], n_layers: int) -> jnp.ndarray:
    """Map codeword symbol streams to layers: (..., S) list → (..., L, S/L·cw)."""
    if len(codewords) == 1:
        d = codewords[0]
        s = d.shape[-1]
        assert s % n_layers == 0
        return d.reshape(d.shape[:-1] + (s // n_layers, n_layers)).swapaxes(-1, -2)
    assert len(codewords) == 2 and n_layers == 2
    return jnp.stack(codewords, axis=-2)


def layer_demap(layers: jnp.ndarray, n_codewords: int) -> list[jnp.ndarray]:
    if n_codewords == 1:
        x = layers.swapaxes(-1, -2)
        return [x.reshape(x.shape[:-2] + (-1,))]
    return [layers[..., 0, :], layers[..., 1, :]]


# The 2x2 precoding products below contract over 2 ports or layers.  Full
# f32 costs nothing at that size, and it keeps a GPU from running them in
# TF32 (~1e-3 relative error) where the CPU computes them exactly.
_F32 = jax.lax.Precision.HIGHEST


def precode_2x2(x: jnp.ndarray, pmi: int) -> jnp.ndarray:
    """(..., 2, S) layers → (..., 2, S) antenna ports, rank-2 codebook."""
    w = jnp.asarray(_CODEBOOK_2TX_R2[pmi])
    return jnp.einsum("ij,...js->...is", w, x, precision=_F32)


def cdd_precode_2x2(x: jnp.ndarray) -> jnp.ndarray:
    """TM3 open-loop: codebook 0 + large-delay CDD (per-symbol-index cycling).

    y = W · D(i) · U · x with U the 2x2 DFT and D(i) = diag(1, e^{-jπi}).
    """
    s = x.shape[-1]
    u = jnp.asarray(np.array([[1, 1], [1, np.exp(-2j * np.pi / 2)]],
                             dtype=np.complex64) / np.sqrt(2))
    i = jnp.arange(s)
    d1 = jnp.exp(-2j * jnp.pi * i / 2).astype(jnp.complex64)
    ux = jnp.einsum("ij,...js->...is", u, x, precision=_F32)
    ux = ux.at[..., 1, :].multiply(d1)
    w = jnp.asarray(_CODEBOOK_2TX_R2[0])
    return jnp.einsum("ij,...js->...is", w, ux, precision=_F32)


def sfbc_encode_2(syms: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """SFBC (TM2) transmit mapping for 2 ports, TS 36.211 §6.3.4.3.

    Over each RE pair (even k, k+1): port0 = [x0, x1],
    port1 = [-x1*, x0*], each scaled 1/sqrt(2) — the TX counterpart of
    `equalizer.alamouti_decode_2x1` (reference precoding.c
    srsran_precoding_diversity).

    Args:
      syms: (..., N) with N even.

    Returns (port0 (..., N), port1 (..., N)).
    """
    s = jnp.sqrt(2.0).astype(jnp.complex64)
    x0 = syms[..., 0::2]
    x1 = syms[..., 1::2]
    shape = syms.shape
    p0 = jnp.stack([x0, x1], axis=-1).reshape(shape) / s
    p1 = jnp.stack([-jnp.conj(x1), jnp.conj(x0)], axis=-1).reshape(shape) / s
    return p0, p1


def scatter_ctrl_syms(grid_tx: jnp.ndarray, idx, syms: jnp.ndarray,
                      add: bool = False) -> jnp.ndarray:
    """Scatter control-channel symbols onto their flat RE indices.

    On a single-port grid (..., nsymb, nre) the symbols go in as-is; on a
    2-port grid (..., 2, nsymb, nre) they are SFBC-mapped first — the
    reference transmits PBCH/PCFICH/PHICH/PDCCH with TX diversity whenever
    nof_ports == 2 (enb_dl.c puts every control channel on all ports via
    the precoding_diversity path)."""
    g = jnp.asarray(grid_tx)
    idx = jnp.asarray(idx)
    two_port = g.ndim == syms.ndim + 2 and g.shape[-3] == 2
    if not two_port:
        flat = g.reshape(g.shape[:-2] + (-1,))
        flat = (flat.at[..., idx].add(syms) if add
                else flat.at[..., idx].set(syms))
        return flat.reshape(g.shape)
    p0, p1 = sfbc_encode_2(syms)
    flat = g.reshape(g.shape[:-2] + (-1,))
    if add:
        flat = flat.at[..., 0, idx].add(p0)
        flat = flat.at[..., 1, idx].add(p1)
    else:
        flat = flat.at[..., 0, idx].set(p0)
        flat = flat.at[..., 1, idx].set(p1)
    return flat.reshape(g.shape)


def mmse_detect_2x2(
    y: jnp.ndarray, h: jnp.ndarray, noise_var
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Batched 2×2 MMSE detection.

    Args:
      y: (..., 2, S) received (2 RX ports).
      h: (..., 2, 2, S) channel h[rx, layer] (already incl. precoding).
      noise_var: scalar or broadcastable.

    Returns:
      (x_hat (..., 2, S), eff_noise_var (..., 2, S)) — per-layer symbol
      estimates with ZF-consistent scaling for the soft demapper.
    """
    nv = jnp.asarray(noise_var, jnp.float32)
    h00, h01 = h[..., 0, 0, :], h[..., 0, 1, :]
    h10, h11 = h[..., 1, 0, :], h[..., 1, 1, :]
    # G = H^H H + nv I (2x2 hermitian), rhs = H^H y
    a = jnp.abs(h00) ** 2 + jnp.abs(h10) ** 2 + nv
    d = jnp.abs(h01) ** 2 + jnp.abs(h11) ** 2 + nv
    b = jnp.conj(h00) * h01 + jnp.conj(h10) * h11  # G01
    r0 = jnp.conj(h00) * y[..., 0, :] + jnp.conj(h10) * y[..., 1, :]
    r1 = jnp.conj(h01) * y[..., 0, :] + jnp.conj(h11) * y[..., 1, :]
    det = a * d - jnp.abs(b) ** 2
    det = jnp.maximum(det, 1e-12)
    x0 = (d * r0 - b * r1) / det
    x1 = (a * r1 - jnp.conj(b) * r0) / det
    # unbiased scaling + effective noise: diag of MMSE error covariance
    bias0 = (d * (jnp.abs(h00) ** 2 + jnp.abs(h10) ** 2)
             - 2 * jnp.real(b * (jnp.conj(h01) * h00 + jnp.conj(h11) * h10))
             + jnp.abs(b) ** 2) / det
    # simpler: SINR-based scaling via the classic MMSE identities
    g00 = (jnp.abs(h00) ** 2 + jnp.abs(h10) ** 2)
    g11 = (jnp.abs(h01) ** 2 + jnp.abs(h11) ** 2)
    mu0 = (d * g00 - jnp.abs(b) ** 2) / det  # = [G^-1 H^H H]_00
    mu1 = (a * g11 - jnp.abs(b) ** 2) / det
    mu0 = jnp.clip(mu0, 1e-6, 1.0 - 1e-6)
    mu1 = jnp.clip(mu1, 1e-6, 1.0 - 1e-6)
    x0 = x0 / mu0.astype(x0.dtype)
    x1 = x1 / mu1.astype(x1.dtype)
    nv0 = (1.0 - mu0) / mu0
    nv1 = (1.0 - mu1) / mu1
    xh = jnp.stack([x0, x1], axis=-2).astype(jnp.complex64)
    env = jnp.stack([nv0, nv1], axis=-2).astype(jnp.float32)
    return xh, env


def pmi_select_2tx(
    h: jnp.ndarray, noise_var, rank: int = 1
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """PMI selection: argmax of post-precoding capacity over the codebook.

    Args:
      h: (..., n_rx, 2, S) estimated channel (per RE).

    Returns: (pmi (...,) int32, metric (..., n_pmi)).
    """
    nv = jnp.maximum(jnp.asarray(noise_var, jnp.float32), 1e-9)
    if rank == 1:
        metrics = []
        for w in _CODEBOOK_2TX_R1:
            hw = h[..., :, 0, :] * w[0] + h[..., :, 1, :] * w[1]
            snr = jnp.sum(jnp.abs(hw) ** 2, axis=-2) / nv
            metrics.append(jnp.mean(jnp.log2(1 + snr), axis=-1))
        m = jnp.stack(metrics, axis=-1)
        return jnp.argmax(m, axis=-1).astype(jnp.int32), m
    metrics = []
    for wi in range(1, 3):  # rank-2 TM4 codebook indices 1..2
        w = jnp.asarray(_CODEBOOK_2TX_R2[wi])
        hw = jnp.einsum("...rls,lk->...rks", h, w, precision=_F32)
        g00 = jnp.sum(jnp.abs(hw[..., :, 0, :]) ** 2, axis=-2)
        g11 = jnp.sum(jnp.abs(hw[..., :, 1, :]) ** 2, axis=-2)
        cap = jnp.log2(1 + g00 / nv) + jnp.log2(1 + g11 / nv)
        metrics.append(jnp.mean(cap, axis=-1))
    m = jnp.stack(metrics, axis=-1)
    return (jnp.argmax(m, axis=-1) + 1).astype(jnp.int32), m
