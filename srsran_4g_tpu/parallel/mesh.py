"""Device mesh construction for the sharded PHY pipeline.

The reference scales with pipelined subframe workers + per-carrier threads
on one node (SURVEY.md §2.7 P1/P3) and with ZMQ/SCTP across processes (P9).
The answer here is a single SPMD program over a `jax.sharding.Mesh`:

- axis ``dp``: data parallel over subframes / UEs / transport blocks
  (the analog of P1 pipeline + P3 per-carrier workers, without the
  in-order-commit problem — batch results are already ordered);
- axis ``sp``: stream parallel over the time-sample axis of each subframe
  (the analog of the streaming sample pipeline), with CP/filter-tail halos
  exchanged between devices via `ppermute` (see parallel/stream.py).
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh


def make_mesh(dp: int | None = None, sp: int = 1, devices=None) -> Mesh:
    """Build a (dp, sp) mesh over the available devices."""
    devs = np.asarray(devices if devices is not None else jax.devices())
    n = devs.size
    if dp is None:
        dp = n // sp
    assert dp * sp == n, f"dp*sp={dp*sp} != {n} devices"
    return Mesh(devs.reshape(dp, sp), axis_names=("dp", "sp"))
