"""Two-process PHY end-to-end loopback over the native IQ bridge.

The framework's analog of the reference's ZMQ-based E2E system test
(test/run_lte.sh): an eNB process assembles DL subframes (CRS + sync +
PCFICH + PDSCH) and streams IQ samples over the native TCP bridge; a UE
process consumes the sample stream (sample count = clock), OFDM-demodulates,
estimates the channel from CRS and decodes the PDSCH, asserting zero block
errors on a shared pseudo-random payload.

Run standalone:
    python tools/phy_e2e.py enb --port 45111 --subframes 20 &
    python tools/phy_e2e.py ue  --port 45111 --subframes 20
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def make_cfg(nof_prb=6, cell_id=42, subframe=4):
    from srsran_4g_tpu.models import grid as G, pdsch

    cell = G.CellConfig(nof_prb=nof_prb, cell_id=cell_id, cfi=1)
    return pdsch.PdschConfig(
        cell=cell, rnti=0x46, subframe=subframe, mod="qpsk", tbs=408
    )


def payload(cfg, n_sf: int, seed: int = 1234) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2, size=(n_sf, cfg.tbs)).astype(np.int8)


def run_enb(port: int, n_sf: int) -> None:
    from srsran_4g_tpu.models import enb_dl
    from srsran_4g_tpu.runtime.native import IqBridgeTx

    cfg = make_cfg()
    bits = payload(cfg, n_sf)
    grid_tx = enb_dl.assemble_subframe(cfg, bits)
    samples = np.asarray(enb_dl.subframe_to_samples(cfg.cell, grid_tx))

    tx = IqBridgeTx(port)
    tx.accept()
    for i in range(n_sf):
        tx.send(samples[i])
    tx.close()
    print(f"enb: streamed {n_sf} subframes", flush=True)


def run_ue(port: int, n_sf: int) -> int:
    import jax.numpy as jnp

    from srsran_4g_tpu.models import ue_dl
    from srsran_4g_tpu.ops.ofdm import OfdmConfig
    from srsran_4g_tpu.runtime.native import IqBridgeRx

    cfg = make_cfg()
    ofdm = OfdmConfig(nof_prb=cfg.cell.nof_prb)
    rx = IqBridgeRx("127.0.0.1", port, timeout_ms=30000)
    frames = [rx.read(ofdm.sf_len) for _ in range(n_sf)]
    rx.close()
    rx_samples = jnp.asarray(np.stack(frames))
    out = ue_dl.receive_pdsch_subframe(cfg, rx_samples, n_iter=4)
    ok = np.asarray(out["crc_ok"])
    bits = np.asarray(out["bits"])
    expect = payload(cfg, n_sf)
    n_ok = int(ok.sum())
    match = bool((bits[ok] == expect[ok]).all()) if n_ok else False
    print(f"ue: {n_ok}/{n_sf} subframes CRC-OK, payload match={match}",
          flush=True)
    return 0 if n_ok == n_sf and match else 1


def main():
    p = argparse.ArgumentParser()
    p.add_argument("role", choices=["enb", "ue"])
    p.add_argument("--port", type=int, default=45111)
    p.add_argument("--subframes", type=int, default=10)
    args = p.parse_args()
    if args.role == "enb":
        run_enb(args.port, args.subframes)
        sys.exit(0)
    sys.exit(run_ue(args.port, args.subframes))


if __name__ == "__main__":
    main()
