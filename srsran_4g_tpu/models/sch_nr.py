"""NR transport-channel chain (UL-SCH/DL-SCH), TS 38.212 §5.2.2/§6.2.

Counterpart of the reference's `lib/src/phy/phch/sch_nr.c`: TB CRC (16 or
24A), LDPC base-graph selection, code-block segmentation with CRC24B and
filler bits, per-CB LDPC encode + rate matching with rv, concatenation,
and the decode path with HARQ soft-buffers and CRC checks — all CBs of
the batch decoded together by the batched min-sum decoder (ops/ldpc.py).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import jax.numpy as jnp
import numpy as np

from srsran_4g_tpu.ops import crc as crc_ops
from srsran_4g_tpu.ops import ldpc

_FILLER_LLR = -64.0


@dataclass(frozen=True)
class NrSegm:
    tbs: int
    g: int
    qm: int
    rv: int
    bg: int
    z: int
    C: int
    K: int  # info bits per CB incl. fillers (Kb*Z)
    k_prime: int  # info bits per CB excl. fillers
    L_cb: int  # per-CB CRC length (0 when C == 1)
    L_tb: int  # TB CRC length (16 or 24)
    e_bits: tuple[int, ...]
    # per-CB payload (excl. CB CRC) lengths; NR TBS values make these equal,
    # arbitrary sizes put the remainder in the last CB
    data_lens: tuple[int, ...] = ()


@functools.lru_cache(maxsize=256)
def nr_segment(tbs: int, g: int, qm: int, rv: int = 0,
               n_layers: int = 1, target_rate: float | None = None) -> NrSegm:
    if rv not in (0, 1, 2, 3):
        raise ValueError(f"rv must be 0..3, got {rv}")
    a = tbs
    r = target_rate if target_rate is not None else a / max(g, 1)
    l_tb = 16 if a <= 3824 else 24
    b = a + l_tb
    bg = 2 if (a <= 292 or (a <= 3824 and r <= 0.67) or r <= 0.25) else 1
    kcb = 8448 if bg == 1 else 3840
    if b <= kcb:
        c, l_cb, bp = 1, 0, b
    else:
        l_cb = 24
        c = -(-b // (kcb - 24))
        bp = b + 24 * c
    kp = -(-bp // c)
    if bg == 1:
        kb = 22
    else:
        kb = 10 if b > 640 else (9 if b > 560 else (8 if b > 192 else 6))
    z = min(zz for s in ldpc.LIFT_SETS.values() for zz in s if kb * zz >= kp)
    k = (22 if bg == 1 else 10) * z

    gp = g // (n_layers * qm)
    e_list = []
    for j in range(c):
        if j <= c - 1 - (gp % c):
            e_list.append(n_layers * qm * (gp // c))
        else:
            e_list.append(n_layers * qm * (-(-gp // c)))
    assert sum(e_list) == g
    base = kp - l_cb
    lens = [base] * c
    lens[-1] = b - base * (c - 1)
    assert 0 < lens[-1] <= base
    return NrSegm(tbs=tbs, g=g, qm=qm, rv=rv, bg=bg, z=z, C=c, K=k,
                  k_prime=kp, L_cb=l_cb, L_tb=l_tb, e_bits=tuple(e_list),
                  data_lens=tuple(lens))


def _interleave_idx(e: int, qm: int) -> np.ndarray:
    """38.212 §5.4.2.2 bit interleaver: f[j·Qm+i] = e[i·E/Qm + j]
    (row-write, column-read over a Qm × E/Qm matrix)."""
    return np.arange(e).reshape(qm, e // qm).T.reshape(-1)


def encode(seg: NrSegm, tb_bits: jnp.ndarray) -> jnp.ndarray:
    """(B, tbs) → (B, G) rate-matched bits."""
    b = tb_bits.shape[0]
    crc_key = "16" if seg.L_tb == 16 else "24A"
    full = jnp.concatenate(
        [tb_bits.astype(jnp.int8), crc_ops.crc_compute(tb_bits, crc_key)],
        axis=-1)
    outs = []
    pos = 0
    cbs = []
    for ci in range(seg.C):
        dlen = seg.data_lens[ci]
        cb = full[:, pos:pos + dlen]
        pos += dlen
        if seg.L_cb:
            cb = jnp.concatenate([cb, crc_ops.crc_compute(cb, "24B")], axis=-1)
        n_fill = seg.K - dlen - seg.L_cb
        if n_fill:
            cb = jnp.concatenate(
                [cb, jnp.zeros((b, n_fill), jnp.int8)], axis=-1)
        cbs.append(cb)
    assert pos == seg.tbs + seg.L_tb
    stacked = jnp.stack(cbs, axis=1).reshape(b * seg.C, seg.K)
    cw = ldpc.encode(stacked, seg.bg, seg.z).reshape(b, seg.C, -1)
    for ci in range(seg.C):
        used = seg.data_lens[ci] + seg.L_cb
        sel = ldpc.rm_select(
            cw[:, ci], seg.bg, seg.z, seg.e_bits[ci], rv=seg.rv,
            n_filler=seg.K - used, k_prime=used)
        outs.append(sel[:, jnp.asarray(
            _interleave_idx(seg.e_bits[ci], seg.qm))])
    return jnp.concatenate(outs, axis=-1)


def decode(
    seg: NrSegm, llrs: jnp.ndarray,
    softbuffers: dict[int, jnp.ndarray] | None = None,
    n_iter: int = 15,
) -> tuple[jnp.ndarray, jnp.ndarray, dict[int, jnp.ndarray]]:
    """(B, G) LLRs → (tb_bits (B, tbs), crc_ok (B,), softbuffers)."""
    b = llrs.shape[0]
    if llrs.shape[-1] != seg.g:
        raise ValueError(f"llrs last dim {llrs.shape[-1]} != G={seg.g}")
    offs = np.cumsum([0, *seg.e_bits])
    bufs = []
    new_soft = {}
    for ci in range(seg.C):
        used = seg.data_lens[ci] + seg.L_cb
        n_fill = seg.K - used
        sb = softbuffers.get(ci) if softbuffers else None
        e_llr = llrs[:, offs[ci]:offs[ci + 1]]
        # undo the 38.212 §5.4.2.2 bit interleaver (scatter = argsort-free
        # inverse: position j·Qm+i came from e[i·E/Qm+j])
        inv = np.empty(seg.e_bits[ci], np.int64)
        inv[_interleave_idx(seg.e_bits[ci], seg.qm)] = np.arange(
            seg.e_bits[ci])
        e_llr = e_llr[:, jnp.asarray(inv)]
        buf = ldpc.rm_collect(
            e_llr, seg.bg, seg.z, rv=seg.rv,
            n_filler=n_fill, k_prime=used, softbuffer=sb)
        new_soft[ci] = buf
        if n_fill:
            buf = buf.at[:, used:seg.K].set(_FILLER_LLR)
        bufs.append(buf)
    stacked = jnp.stack(bufs, axis=1).reshape(b * seg.C, -1)
    hard = ldpc.decode(stacked, seg.bg, seg.z, n_iter=n_iter)
    hard = hard.reshape(b, seg.C, -1)

    payloads, cb_ok = [], []
    for ci in range(seg.C):
        used = seg.data_lens[ci] + seg.L_cb
        bits = hard[:, ci, :used]
        if seg.L_cb:
            cb_ok.append(crc_ops.crc_check(bits, "24B"))
            bits = bits[:, :-seg.L_cb]
        payloads.append(bits)
    full = jnp.concatenate(payloads, axis=-1)
    crc_key = "16" if seg.L_tb == 16 else "24A"
    ok = crc_ops.crc_check(full, crc_key)
    if cb_ok:
        ok = ok & jnp.all(jnp.stack(cb_ok, -1), axis=-1)
    return full[:, :seg.tbs], ok, new_soft
