"""dp-scaling measurement for the sharded pipeline step.

Runs the full encode→channel→receive→decode pipeline step over (dp, 1)
meshes of 1/2/4/8 devices with a FIXED PER-DEVICE batch (weak scaling)
and records step wall time + aggregate throughput.  On real accelerators
the dp axis is embarrassingly parallel (the only collective is the
final psum of the metrics), so weak-scaling efficiency tracks the
metric-psum overhead; on this CPU rig the virtual devices share the
host cores, so the numbers validate the SPMD path and measure the
sharding overhead rather than real speedup (noted in the JSON).

Writes artifacts/scaling.json and prints a markdown table.

Usage: python tools/scaling_bench.py [--per-dev 8] [--iters 5]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--per-dev", type=int, default=8)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--prb", type=int, default=15)
    args = ap.parse_args()

    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8")
    # virtual devices exist on the host platform only
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    import numpy as np

    from srsran_4g_tpu.models import grid as G, pdsch
    from srsran_4g_tpu.parallel import mesh as mesh_mod, pipeline

    cell = G.CellConfig(nof_prb=args.prb, cell_id=1, cfi=1)
    cfg = pdsch.PdschConfig(cell=cell, rnti=0x46, subframe=4, mod="16qam",
                            tbs=4392)
    rng = np.random.default_rng(0)
    rows = []
    for dp in (1, 2, 4, 8):
        mesh = mesh_mod.make_mesh(dp=dp, sp=1,
                                  devices=jax.devices()[:dp])
        step = pipeline.make_pipeline_step(cfg, mesh, snr_db=25.0, n_iter=4)
        b = args.per_dev * dp
        bits = rng.integers(0, 2, size=(b, cfg.tbs)).astype(np.int8)
        gb = pipeline.shard_batch(mesh, bits)
        key = jax.random.PRNGKey(0)
        out = step(gb, key)                       # compile + warm
        assert float(np.asarray(jax.device_get(out["bler"]))) == 0.0
        t0 = time.perf_counter()
        for i in range(args.iters):
            out = step(gb, jax.random.fold_in(key, i))
        jax.device_get(out["bler"])
        dt = (time.perf_counter() - t0) / args.iters
        sf_s = b / dt
        rows.append(dict(dp=dp, batch=b, step_ms=1e3 * dt,
                         subframes_per_s=sf_s))
        print(f"dp={dp}: batch={b} step={1e3*dt:.1f} ms "
              f"-> {sf_s:.0f} sf/s", file=sys.stderr, flush=True)

    base = rows[0]["subframes_per_s"] / rows[0]["dp"]
    for r in rows:
        r["weak_scaling_eff"] = r["subframes_per_s"] / (r["dp"] * base)
    result = dict(
        config=dict(prb=args.prb, mod="16qam", tbs=4392,
                    per_dev_batch=args.per_dev),
        note=("virtual CPU mesh: devices share the host cores, so "
              "efficiency measures SPMD/sharding overhead, not chip "
              "speedup; the dp axis's only collective is the metrics "
              "psum"),
        rows=rows,
    )
    os.makedirs("artifacts", exist_ok=True)
    with open("artifacts/scaling.json", "w") as f:
        json.dump(result, f, indent=1)
    print("| dp | batch | step ms | sf/s | weak-scaling eff |")
    print("|---|---|---|---|---|")
    for r in rows:
        print(f"| {r['dp']} | {r['batch']} | {r['step_ms']:.1f} | "
              f"{r['subframes_per_s']:.0f} | {r['weak_scaling_eff']:.2f} |")
    return 0


if __name__ == "__main__":
    sys.exit(main())
