"""DL-SCH transport-channel encode/decode, TS 36.212 §5.3.2.

Counterpart of the reference's `lib/src/phy/phch/sch.c`
(srsran_dlsch_encode/srsran_dlsch_decode2, sch.c:240,509,580): TB CRC24A,
code-block segmentation with per-CB CRC24B, turbo coding, rate matching with
redundancy versions and HARQ soft-buffers, and code-block (de)concatenation.

Design: segmentation is resolved to a *static plan* on the host (one or
two code-block size groups); each group's CBs across the whole batch of TBs
are decoded together as one `(B·C_g, ...)` tensor so the windowed turbo
decoder sees one big batch.  CRC checks are matmuls over the same batch.
Filler bits are handled per spec: encoded as 0, NULLed in rate matching,
pinned to a strong bit-0 LLR before decoding.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import jax.numpy as jnp
import numpy as np

from srsran_4g_tpu.ops import crc as crc_ops
from srsran_4g_tpu.ops import rate_match as rm
from srsran_4g_tpu.ops import turbo
from srsran_4g_tpu.ops.cbsegm import CbSegm, cbsegm

_FILLER_LLR = -64.0  # fillers are known 0-bits (negative ⇒ bit 0)


@dataclass(frozen=True)
class CbGroup:
    """A group of same-size code blocks within the TB (static plan)."""

    K: int
    count: int
    e_bits: tuple[int, ...]  # E per CB in this group
    n_filler: int  # filler bits in the first CB of this group (group of K2)
    first_cb_index: int


@dataclass(frozen=True)
class DlschPlan:
    tbs: int
    g: int  # total rate-matched bits for this codeword
    qm: int
    rv: int
    segm: CbSegm
    groups: tuple[CbGroup, ...]
    cb_data_len: tuple[int, ...]  # payload bits (excl. CB CRC) per CB


@functools.lru_cache(maxsize=256)
def dlsch_plan(tbs: int, g: int, qm: int, rv: int = 0, n_layers: int = 1) -> DlschPlan:
    s = cbsegm(tbs)
    # per-CB rate-matched length E (TS 36.212 §5.1.4.1.2)
    gp = g // (n_layers * qm)
    gamma = gp % s.C
    e_list = []
    for r in range(s.C):
        if r <= s.C - 1 - gamma:
            e_list.append(n_layers * qm * (gp // s.C))
        else:
            e_list.append(n_layers * qm * (-(-gp // s.C)))
    assert sum(e_list) == g, (sum(e_list), g)

    # CB ordering: the C2 smaller (K2) blocks first (sch.c:285, spec K- first)
    ks = [s.K2] * s.C2 + [s.K1] * s.C1
    groups = []
    idx = 0
    if s.C2:
        groups.append(
            CbGroup(K=s.K2, count=s.C2, e_bits=tuple(e_list[:s.C2]),
                    n_filler=s.F, first_cb_index=0)
        )
        idx = s.C2
    groups.append(
        CbGroup(K=s.K1, count=s.C1, e_bits=tuple(e_list[idx:]),
                n_filler=s.F if not s.C2 else 0, first_cb_index=idx)
    )
    data_len = [k - s.L_cb for k in ks]
    data_len[0] -= s.F
    return DlschPlan(
        tbs=tbs, g=g, qm=qm, rv=rv, segm=s,
        groups=tuple(groups), cb_data_len=tuple(data_len),
    )


def dlsch_encode(plan: DlschPlan, tb_bits: jnp.ndarray) -> jnp.ndarray:
    """Encode transport blocks.

    Args:
      plan: static plan from `dlsch_plan`.
      tb_bits: (B, tbs) information bits.

    Returns:
      (B, G) rate-matched codeword bits.
    """
    s = plan.segm
    b = tb_bits.shape[0]
    tb_crc = crc_ops.crc_compute(tb_bits, "24A")
    full = jnp.concatenate([tb_bits.astype(jnp.int8), tb_crc], axis=-1)

    outputs: list[jnp.ndarray] = []
    pos = 0
    for grp in plan.groups:
        segs = []
        for i in range(grp.count):
            n_fill = grp.n_filler if i == 0 else 0
            dlen = grp.K - s.L_cb - n_fill
            seg = full[:, pos:pos + dlen]
            pos += dlen
            if n_fill:
                seg = jnp.concatenate(
                    [jnp.zeros((b, n_fill), dtype=jnp.int8), seg], axis=-1
                )
            if s.L_cb:
                seg = jnp.concatenate(
                    [seg, crc_ops.crc_compute(seg, "24B")], axis=-1
                )
            segs.append(seg)
        # one turbo-encode scan for the whole size group: (B*count, K)
        stacked = jnp.stack(segs, axis=1).reshape(b * grp.count, grp.K)
        d = turbo.turbo_encode(stacked).reshape(b, grp.count, 3, grp.K + 4)
        for i in range(grp.count):
            n_fill = grp.n_filler if i == 0 else 0
            outputs.append(
                rm.rate_match(d[:, i], grp.K, plan.rv, grp.e_bits[i],
                              n_filler=n_fill)
            )
    assert pos == plan.tbs + 24
    return jnp.concatenate(outputs, axis=-1)


def dlsch_decode(
    plan: DlschPlan,
    llrs: jnp.ndarray,
    softbuffers: dict[int, jnp.ndarray] | None = None,
    n_iter: int = 5,
    window: int | None = 208,
    early_stop: bool = True,
    cb_shard: tuple[str, int] | None = None,
) -> tuple[jnp.ndarray, jnp.ndarray, dict[int, jnp.ndarray]]:
    """Decode transport blocks from codeword LLRs.

    Args:
      llrs: (B, G) float32, positive ⇒ bit 1.
      softbuffers: per-CB-index (B, 3, K+4) accumulated LLRs from earlier
        HARQ transmissions (as returned by this function), or None.
      cb_shard: optional (mesh_axis_name, axis_size) — inside `shard_map`,
        split the stacked (B·C) code-block lanes of the dominant turbo
        decode across that mesh axis (sp stream parallelism, SURVEY §2.7
        P9) and `all_gather` the hard bits back, so no chip decodes
        redundantly; results stay replicated over the axis.

    Returns:
      (tb_bits (B, tbs) int8, crc_ok (B,) bool, softbuffers dict).
    """
    s = plan.segm
    b = llrs.shape[0]
    new_soft: dict[int, jnp.ndarray] = {}

    # --- dematch + decode per size group -----------------------------------
    e_offsets = np.cumsum([0] + [e for grp in plan.groups for e in grp.e_bits])
    cb_payloads: list[jnp.ndarray] = []
    cb_crc_ok: list[jnp.ndarray] = []
    cb_idx = 0
    for grp in plan.groups:
        d_group = []
        for i in range(grp.count):
            n_fill = grp.n_filler if i == 0 else 0
            lo, hi = e_offsets[cb_idx], e_offsets[cb_idx + 1]
            sb = softbuffers.get(cb_idx) if softbuffers else None
            d_llr = rm.rate_dematch(
                llrs[:, lo:hi], grp.K, plan.rv, softbuffer=sb, n_filler=n_fill
            )
            new_soft[cb_idx] = d_llr
            if n_fill:
                d_llr = d_llr.at[:, 0, :n_fill].set(_FILLER_LLR)
            d_group.append(d_llr)
            cb_idx += 1
        # one decoder call per size group over (B*count, 3, K+4)
        stacked = jnp.stack(d_group, axis=1).reshape(b * grp.count, 3, grp.K + 4)
        early = ("24B" if s.L_cb else "24A") if early_stop else None
        if cb_shard is not None:
            import jax

            axis, size = cb_shard
            n_lanes = stacked.shape[0]
            pad = (-n_lanes) % size
            if pad:
                stacked = jnp.pad(stacked, ((0, pad), (0, 0), (0, 0)))
            loc = stacked.shape[0] // size
            i = jax.lax.axis_index(axis)
            sl = jax.lax.dynamic_slice_in_dim(stacked, i * loc, loc, 0)
            hard_loc, _ = turbo.turbo_decode(
                sl, n_iter=n_iter, window=window, early_crc=early
            )
            hard = jax.lax.all_gather(
                hard_loc, axis, axis=0, tiled=True)[:n_lanes]
        else:
            hard, _ = turbo.turbo_decode(
                stacked, n_iter=n_iter, window=window, early_crc=early
            )
        hard = hard.reshape(b, grp.count, grp.K)
        for i in range(grp.count):
            bits = hard[:, i]
            n_fill = grp.n_filler if i == 0 else 0
            if s.L_cb:
                cb_crc_ok.append(crc_ops.crc_check(bits, "24B"))
                bits = bits[:, :grp.K - s.L_cb]
            cb_payloads.append(bits[:, n_fill:])

    full = jnp.concatenate(cb_payloads, axis=-1)  # (B, tbs + 24)
    tb_ok = crc_ops.crc_check(full, "24A")
    if cb_crc_ok:
        tb_ok = tb_ok & jnp.all(jnp.stack(cb_crc_ok, axis=-1), axis=-1)
    return full[:, :plan.tbs], tb_ok, new_soft
