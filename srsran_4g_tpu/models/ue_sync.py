"""UE synchronisation FSM: FIND -> TRACK with CFO/timing loops + MIB.

Counterpart of `lib/src/phy/ue/ue_sync.c` (srsran_ue_sync_zerocopy:
FIND/TRACK state machine at :135, CFO tracking loops :232-240, timestamp
bookkeeping), `ue/ue_cell_search.c` and `ue/ue_mib.c`, and the UE sync
thread FSM of `srsue/src/phy/sync.cc` (CELL_SEARCH/SFN_SYNC/CAMPING).

Batched redesign: the host FSM holds only scalars (state, sample
offset, CFO accumulator); each call hands one subframe's samples to the
jitted find/track graphs.  Batch-of-streams operation (many UEs) falls
out of the leading batch dimension.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

import jax.numpy as jnp

from srsran_4g_tpu.models import pbch, sync, ue_dl
from srsran_4g_tpu.models import grid as G
from srsran_4g_tpu.ops.ofdm import OfdmConfig

FIND, TRACK = "FIND", "TRACK"


@dataclass
class UeSyncState:
    state: str = FIND
    sf_idx: int = 0            # 0..9 within the radio frame
    sfn: int = 0
    cell_id: int = -1
    cfo_hz_acc: float = 0.0    # integrated CFO (normalised units)
    sample_offset: int = 0
    out_of_sync_count: int = 0
    frames_tracked: int = 0


class UeSync:
    """Per-subframe driver (the srsran_ue_sync_zerocopy equivalent)."""

    PSS_THRESHOLD = 0.5
    CFO_ALPHA = 0.2            # CFO loop gain (ue_sync.c CFO EMA)

    def __init__(self, nof_prb: int) -> None:
        self.cfg = OfdmConfig(nof_prb=nof_prb)
        self.nof_prb = nof_prb
        self.s = UeSyncState()

    @property
    def sf_len(self) -> int:
        return self.cfg.sf_len

    def radio_error(self) -> None:
        """RF error callback → immediate resync (srsue/src/phy/sync.cc
        radio_error: an OVERFLOW/UNDERFLOW/LATE invalidates the sample
        timeline, so drop straight back to FIND instead of waiting for
        the out-of-sync counter)."""
        self.s.state = FIND
        self.s.out_of_sync_count = 0

    def zerocopy(self, samples: jnp.ndarray) -> dict:
        """Process one subframe-or-more of samples; returns status dict
        with 'in_sync', aligned subframe samples when tracking."""
        if self.s.state == FIND:
            found = ue_dl.cell_search(samples[None], self.nof_prb)
            peak = float(np.asarray(found["pss_peak"])[0])
            if peak < self.PSS_THRESHOLD:
                return dict(in_sync=False, state=FIND, peak=peak)
            self.s.cell_id = int(np.asarray(found["cell_id"])[0])
            self.s.cfo_hz_acc = float(np.asarray(found["cfo"])[0])
            # PSS sits in the last symbol of slot 0 -> subframe 0 or 5
            self.s.sf_idx = 0 if int(np.asarray(found["phase"])[0]) == 0 \
                else 5
            self.s.state = TRACK
            self.s.out_of_sync_count = 0
            return dict(in_sync=True, state=TRACK,
                        cell_id=self.s.cell_id, peak=peak,
                        sf_samples=found["sf_samples"][0])
        # TRACK: correct CFO, verify PSS at the expected position
        corr = sync.cfo_correct(samples[None],
                                jnp.asarray([self.s.cfo_hz_acc]),
                                self.cfg.symbol_sz)
        if self.s.sf_idx in (0, 5):
            found = sync.find_pss(corr, self.cfg.symbol_sz)
            peak = float(np.asarray(found["peak"])[0])
            if peak < self.PSS_THRESHOLD * 0.6:
                self.s.out_of_sync_count += 1
                if self.s.out_of_sync_count > 5:
                    self.s.state = FIND  # resync (radio_error recovery)
                in_sync = False
            else:
                self.s.out_of_sync_count = 0
                cfo_new = float(np.asarray(sync.pss_cfo_estimate(
                    jnp.take_along_axis(
                        corr, found["offset"][..., None]
                        + jnp.arange(self.cfg.symbol_sz), axis=-1),
                    found["n_id_2"], self.cfg.symbol_sz))[0])
                self.s.cfo_hz_acc += self.CFO_ALPHA * cfo_new
                in_sync = True
        else:
            in_sync = True
        out = dict(in_sync=in_sync, state=self.s.state,
                   sf_idx=self.s.sf_idx, sfn=self.s.sfn,
                   sf_samples=corr[0])
        self.s.sf_idx = (self.s.sf_idx + 1) % 10
        if self.s.sf_idx == 0:
            self.s.sfn = (self.s.sfn + 1) % 1024
            self.s.frames_tracked += 1
        return out


def decode_mib(cell_id: int, sf_samples: jnp.ndarray) -> dict:
    """ue_mib.c: OFDM-demodulate subframe 0 at the 6-PRB bandwidth,
    CRS-estimate the channel, and decode the PBCH."""
    from srsran_4g_tpu.models import chest
    from srsran_4g_tpu.ops import ofdm

    cfg = OfdmConfig(nof_prb=6)
    grid_rx = ofdm.demodulate(cfg, sf_samples)
    cell = G.CellConfig(nof_prb=6, cell_id=cell_id, cfi=1)
    est = chest.estimate(chest.ChestConfig(cell=cell), grid_rx, 0)
    return pbch.decode(cell, grid_rx, est["h"], est["noise_var"])
