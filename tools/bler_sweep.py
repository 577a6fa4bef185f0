"""BLER parity sweeps: LDPC chain and full PDSCH over SNR grids.

Counterparts of the reference's `ldpc_chain_test.c` (enc->AWGN->dec
word/bit error rates + throughput print) and `pdsch_test.c` /
`pusch_nr_bler_test.c` (CRC-OK over MCS/SNR sweeps).  Writes JSON
tables to artifacts/bler_ldpc.json and artifacts/bler_pdsch.json for
cross-round comparison.

Interrupted sweeps resume from artifacts/bler_sweep.ckpt.json: every
completed (channel, SNR) grid point is persisted atomically and skipped
on restart (utils/checkpoint.SweepCheckpoint).

Usage: python tools/bler_sweep.py [--cpu] [--frames 32]
"""

import sys, os; sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse
import json
import time

import numpy as np


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--frames", type=int, default=32)
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--checkpoint", default="artifacts/bler_sweep.ckpt.json")
    args = p.parse_args()

    if args.cpu:
        os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    import jax.numpy as jnp

    from srsran_4g_tpu.channel.awgn import awgn, snr_to_noise_var
    from srsran_4g_tpu.models import grid as G, pdsch, sch_nr

    from srsran_4g_tpu.utils.checkpoint import SweepCheckpoint

    rng = np.random.default_rng(0)
    out = {"ldpc": [], "pdsch": []}
    ckpt = SweepCheckpoint(args.checkpoint, meta={"frames": args.frames})

    # --- NR LDPC chain (BG1, one CB) over Eb/N0 --------------------------
    tbs, g_bits, qm = 4224, 12672, 4
    seg = sch_nr.nr_segment(tbs, g_bits, qm)
    rate = tbs / g_bits

    @jax.jit
    def ldpc_step(bits, key, nv):
        cw = sch_nr.encode(seg, bits)
        # BPSK map each bit, AWGN, LLR
        x = 1.0 - 2.0 * cw.astype(jnp.float32)
        y = x + jnp.sqrt(nv) * jax.random.normal(key, x.shape)
        llr = -2.0 * y / nv
        dec, ok, _ = sch_nr.decode(seg, llr)
        errs = jnp.sum(dec != bits, axis=-1)
        return jnp.sum(ok.astype(jnp.int32)), jnp.sum(errs)

    t_tot = 0.0
    for ebn0 in np.arange(0.5, 4.01, 0.5):
        key = f"ldpc/ebn0={float(ebn0):.2f}"
        bits = jnp.asarray(rng.integers(0, 2, (args.frames, tbs)).astype(np.int8))
        if key in ckpt:
            row = ckpt.get(key)
        else:
            nv = float(10 ** (-ebn0 / 10) / (2 * rate))
            t0 = time.perf_counter()
            n_ok, n_err = ldpc_step(bits, jax.random.PRNGKey(int(ebn0 * 10)), nv)
            n_ok, n_err = int(n_ok), int(n_err)
            t_tot += time.perf_counter() - t0
            row = dict(ebn0_db=round(float(ebn0), 2),
                       bler=round(1 - n_ok / args.frames, 4),
                       ber=round(n_err / (args.frames * tbs), 6))
            ckpt.put(key, row)
        out["ldpc"].append(row)
        print("ldpc", row, file=sys.stderr)
    info_bps = args.frames * tbs * 8 / max(t_tot, 1e-9)
    print(f"ldpc chain: {info_bps/1e6:.1f} Mb/s info (all points)",
          file=sys.stderr)

    # --- full PDSCH (50 PRB) CRC-OK over SNR x MCS -----------------------
    cell = G.CellConfig(nof_prb=50, cell_id=1, cfi=1)
    cases = [("qpsk", 4392, (-2.0, 6.0)), ("16qam", 12960, (4.0, 14.0)),
             ("64qam", 22920, (10.0, 22.0))]
    for mod, tbs_i, (lo, hi) in cases:
        cfg = pdsch.PdschConfig(cell=cell, rnti=0x46, subframe=4, mod=mod,
                                tbs=tbs_i)

        @jax.jit
        def pdsch_step(bits, key, nv):
            tx = pdsch.add_crs(cfg, pdsch.encode(cfg, bits))
            rx = awgn(key, tx, nv)
            o = pdsch.decode(cfg, rx)
            return jnp.sum(o["crc_ok"].astype(jnp.int32))

        for snr in np.linspace(lo, hi, 5):
            key = f"pdsch/{mod}/snr={float(snr):.1f}"
            bits = jnp.asarray(rng.integers(0, 2, (args.frames, tbs_i))
                               .astype(np.int8))
            if key in ckpt:
                row = ckpt.get(key)
            else:
                nv = float(snr_to_noise_var(float(snr)))
                n_ok = int(pdsch_step(bits, jax.random.PRNGKey(int(snr * 7)),
                                      nv))
                row = dict(mod=mod, tbs=tbs_i, snr_db=round(float(snr), 1),
                           bler=round(1 - n_ok / args.frames, 4))
                ckpt.put(key, row)
            out["pdsch"].append(row)
            print("pdsch", row, file=sys.stderr)

    os.makedirs("artifacts", exist_ok=True)
    with open("artifacts/bler_ldpc.json", "w") as f:
        json.dump(out["ldpc"], f, indent=1)
    with open("artifacts/bler_pdsch.json", "w") as f:
        json.dump(out["pdsch"], f, indent=1)
    ckpt.done()
    print(json.dumps({"metric": "pdsch_bler_points",
                      "value": len(out["pdsch"]), "unit": "rows"}))


if __name__ == "__main__":
    main()
