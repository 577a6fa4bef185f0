"""Multi-host (DCN) distribution: jax.distributed init + global meshes.

The reference distributes across processes with ZMQ sample streams and
SCTP signalling (SURVEY.md §2.8 P9).  The batched equivalent is
multi-controller JAX: every host runs the same SPMD program,
`jax.distributed.initialize` wires the coordination service, the mesh
spans all hosts' devices, and XLA routes collectives over the devices'
interconnect within a host and the network between hosts.

On a CPU test rig the same code path runs with
`jax_platforms=cpu` + `xla_force_host_platform_device_count=N` per
process — cross-process collectives go through XLA's CPU collectives,
which is how `tests/test_multihost.py` smoke-tests the DCN path with
two real OS processes and no accelerator.
"""

from __future__ import annotations

import numpy as np


def init_distributed(coordinator: str, num_processes: int,
                     process_id: int, local_device_count: int | None = None,
                     platform: str | None = None) -> None:
    """Initialize multi-controller JAX (call once per process, before any
    jax computation).

    coordinator: "host:port" of process 0.
    local_device_count: for CPU rigs, how many virtual devices this
    process exposes (sets xla_force_host_platform_device_count).
    """
    import os

    if local_device_count is not None:
        flags = os.environ.get("XLA_FLAGS", "")
        os.environ["XLA_FLAGS"] = (
            f"{flags} --xla_force_host_platform_device_count="
            f"{local_device_count}").strip()
    import jax

    if platform:
        jax.config.update("jax_platforms", platform)
    jax.distributed.initialize(coordinator_address=coordinator,
                               num_processes=num_processes,
                               process_id=process_id)


def make_global_mesh(dp: int | None = None, sp: int = 1):
    """(dp, sp) mesh over ALL processes' devices (jax.devices() is global
    after init_distributed)."""
    from srsran_4g_tpu.parallel.mesh import make_mesh

    return make_mesh(dp=dp, sp=sp)


def host_local_batch(mesh, x: np.ndarray):
    """Build a dp-sharded global array from this process's local shard.

    Every process passes its own slice of the global batch (the analog
    of each reference node reading its own sample stream); the returned
    jax.Array is globally addressable by the SPMD program."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    sharding = NamedSharding(mesh, P("dp"))
    return jax.make_array_from_process_local_data(sharding, x)
