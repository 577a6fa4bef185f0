"""srsENB process: eNB stack + accelerator PHY behind real transports.

The framework's counterpart of `srsenb/src/enb.cc:74` + `main.cc`: a
standalone eNodeB process that
  * streams DL IQ subframes to the UE over the native TCP sample bridge
    (`native/runtime.cc` rt_bridge — the reference's ZMQ virtual radio,
    `rf_zmq_imp.c`, sample count = clock) and reads the UE's UL stream,
  * connects S1AP to the EPC over TCP carrying the 3GPP-exact
    aligned-PER encodings (`stack/s1ap_per.py`; reference `s1ap.cc`
    SCTP), 4-byte length framing,
  * carries S1-U user-plane packets over GTP-U/UDP (`gtpu.cc`).

PRACH preambles arrive inside the UL sample stream and are detected by
FFT correlation at the RA occasions (`prach_worker.cc` analog).

Prints one final line `RESULT {json}`.

Usage: python -m srsran_4g_tpu.apps.srsenb --dl-port 45201 \
           --ul-port 45202 --epc-addr 127.0.0.1 --ttis 480
"""

from __future__ import annotations

import argparse
import json
import socket
import struct
import sys
import time


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description="srsENB (accelerator PHY)")
    ap.add_argument("--config", default=None, help="INI config (enb.conf)")
    ap.add_argument("--dl-port", type=int, default=45201,
                    help="IQ bridge port this eNB serves DL samples on")
    ap.add_argument("--ul-port", type=int, default=45202,
                    help="IQ bridge port the UE serves UL samples on")
    ap.add_argument("--ue-addr", default="127.0.0.1")
    ap.add_argument("--epc-addr", default="127.0.0.1")
    ap.add_argument("--s1ap-port", type=int, default=36412)
    ap.add_argument("--gtpu-port", type=int, default=2152)
    ap.add_argument("--prb", type=int, default=None)
    ap.add_argument("--snr", type=float, default=30.0)
    ap.add_argument("--ttis", type=int, default=480)
    ap.add_argument("--ues", type=int, default=1,
                    help="expected UE count (bounds PRACH scanning)")
    ap.add_argument("--tm", type=int, default=1, choices=(1, 3, 4),
                    help="transmission mode (3/4 = 2x2 spatial "
                         "multiplexing, enb.conf.example tm=/nof_ports=)")
    ap.add_argument("--tdd", action="store_true",
                    help="frame structure type 2 (UL/DL config 1); UL "
                         "subframes carry zeros on the DL bridge")
    ap.add_argument("--cc", type=int, default=1, choices=(1, 2),
                    help="component carriers (2 = SCell on its own DL "
                         "bridge at dl_port+50+2i; data-only carrier, "
                         "activated by MAC CE on good CQI)")
    ap.add_argument("-v", action="store_true")
    args = ap.parse_args(argv)

    from srsran_4g_tpu.utils import compile_cache

    compile_cache.enable()
    import jax.numpy as jnp
    import numpy as np

    from srsran_4g_tpu.apps.nodes import EnbNode
    from srsran_4g_tpu.config import load_config
    from srsran_4g_tpu.runtime.lte_air import LteAirPhy
    from srsran_4g_tpu.runtime.native import IqBridgeRx, IqBridgeTx
    from srsran_4g_tpu.stack import gtpu as GU

    cfg = load_config(args.config)
    nof_prb = args.prb if args.prb is not None else cfg.cell.nof_prb
    log = (lambda *a: print(*a, flush=True)) if args.v else (lambda *a: None)

    stats = {"prach": 0, "pdsch_ko": 0, "pusch_ko": 0, "pdsch_tx": 0,
             "pusch_tx": 0, "dci_tx": 0, "dl_ping_rx": 0, "ul_ping_rx": 0,
             "phich_ack": 0, "phich_nack": 0}
    # tm=3/4 selects the 2-port cell (2x2 MIMO air); the bridge then
    # carries both post-channel RX-antenna streams per TTI
    nof_ports = 2 if args.tm in (3, 4) else 1
    air = LteAirPhy(nof_prb=nof_prb, cell_id=cfg.cell.cell_id,
                    snr_db=args.snr, nof_ports=nof_ports,
                    nof_rx=nof_ports,
                    frame_type="tdd" if args.tdd else "fdd")

    # ---- S1AP over TCP (framed aligned-PER PDUs) -------------------------
    s1 = socket.create_connection((args.epc_addr, args.s1ap_port),
                                  timeout=30)
    s1.setblocking(False)
    s1_buf = bytearray()

    def tx_s1ap(pdu: bytes) -> None:
        s1.sendall(struct.pack(">I", len(pdu)) + pdu)

    # ---- GTP-U over UDP ---------------------------------------------------
    gtpu = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    gtpu.bind(("127.0.0.1", 0))
    gtpu.setblocking(False)
    epc_gtpu = (args.epc_addr, args.gtpu_port)
    # announce the S1-U endpoint (echo request; gtpu.cc echo handling)
    gtpu.sendto(GU.pack(GU.GtpuHeader(teid=0,
                                      msg_type=GU.GTPU_MSG_ECHO_REQUEST),
                        b""), epc_gtpu)

    def s1u_tx(teid: int, pkt: bytes) -> None:
        gtpu.sendto(GU.pack(GU.GtpuHeader(teid=teid), pkt), epc_gtpu)

    air_s = (LteAirPhy(nof_prb=nof_prb, cell_id=2, snr_db=args.snr,
                       seed=11)
             if args.cc == 2 else None)
    enb = EnbNode(air, stats, log, tx_s1ap=tx_s1ap, s1u_tx=s1u_tx,
                  tm=args.tm, air_s=air_s)
    enb.rrc.s1_setup()

    # ---- IQ bridges: serve DL first, then connect to the UEs' UL --------
    # UE i uses ports (dl_port + 2i, ul_port + 2i); the eNB broadcasts
    # the same DL subframe to every UE and SUMS the UL streams — the
    # multi-UE analog of rf_zmq's per-channel sample exchange
    dl_txs = []
    for i in range(args.ues):
        dl_txs.append(IqBridgeTx(args.dl_port + 2 * i))
    # SCell DL bridges bind BEFORE any accept so UEs can connect in
    # order (PCell DL, then SCell DL, then serve UL)
    scell_txs = []
    if args.cc == 2:
        for i in range(args.ues):
            scell_txs.append(IqBridgeTx(args.dl_port + 50 + 2 * i))
    print(f"srsenb: waiting for {args.ues} UE(s) on IQ port(s) "
          f"{args.dl_port}..", flush=True)
    for t in dl_txs:
        t.accept()
    for t in scell_txs:
        t.accept()
    ul_rxs = []
    for i in range(args.ues):
        ul_rx = None
        for _ in range(300):          # the UE binds its UL port right after
            try:
                ul_rx = IqBridgeRx(args.ue_addr, args.ul_port + 2 * i,
                                   timeout_ms=60000)
                break
            except OSError:
                time.sleep(0.1)
        if ul_rx is None:
            print("srsenb: UL bridge connect failed", flush=True)
            return 1
        ul_rxs.append(ul_rx)
    print("srsenb: IQ bridges up", flush=True)

    sf_len = air.ofdm.sf_len
    for tti in range(args.ttis):
        enb.tick()
        # control/user-plane ingress
        try:
            s1_buf += s1.recv(65536)
        except BlockingIOError:
            pass
        while len(s1_buf) >= 4:
            n = struct.unpack(">I", bytes(s1_buf[:4]))[0]
            if len(s1_buf) < 4 + n:
                break
            enb.rx_s1ap(bytes(s1_buf[4:4 + n]))
            del s1_buf[:4 + n]
        while True:
            try:
                raw, _ = gtpu.recvfrom(65536)
            except BlockingIOError:
                break
            hdr, payload = GU.unpack(raw)
            if hdr.msg_type == GU.GTPU_MSG_DATA_PDU:
                enb.rx_s1u(hdr.teid, payload)

        dl_samples, scell_samples = enb.step_dl(tti)
        # SISO: (1, sf_len) -> sf_len samples; 2x2: (1, 2rx, sf_len) ->
        # both RX-antenna streams concatenated (the UE reads 2*sf_len).
        # TDD UL subframes (step_dl -> None) stream zeros to keep the
        # sample clock running (rf_zmq's continuous-stream model).
        dl_np = (np.zeros(nof_ports * sf_len, np.complex64)
                 if dl_samples is None
                 else np.asarray(dl_samples)[0].reshape(-1))
        for t in dl_txs:
            t.send(dl_np)
        if scell_txs:
            # SCell is data-only: zeros between grants keep its sample
            # clock running
            s_np = (np.zeros(sf_len, np.complex64)
                    if scell_samples is None
                    else np.asarray(scell_samples)[0].reshape(-1))
            for t in scell_txs:
                t.send(s_np)
        ul = sum(rx.read(sf_len) for rx in ul_rxs)[None, :]
        ul_sf = air.sf_kind(tti) == "U" or air.frame_type == "fdd"
        # RA occasions: preambles ride the UL sample stream.  UEs stagger
        # their occasions — FDD at (2*idx+2)%10, TDD across the UL
        # subframes of the configuration (nodes.py prach_due) — so scan
        # every configured occasion until all UEs have PUCCH resources,
        # and still decode scheduled UL on a PRACH-detected TTI so other
        # UEs' PUSCH/ACK due that subframe is not dropped.
        if air.frame_type == "tdd":
            from srsran_4g_tpu.models import tdd as tdd_mod
            uls = [s for s in range(10)
                   if tdd_mod.sf_type(air.ul_dl_config, s) == "U"]
            ra_occasions = {uls[i % len(uls)] for i in range(args.ues)}
        else:
            ra_occasions = {(2 * i + 2) % 10 for i in range(args.ues)}
        got_prach = False
        if (ul_sf and tti % 10 in ra_occasions
                and len(enb.pucch_res) < args.ues):
            det = air.prach_rx(ul)
            if det is not None:
                enb.rach_detected(tti, det)
                got_prach = True
        if ul_sf and enb.need_ul():
            # pucch_scan=False on the detection TTI: the preamble sits on
            # the PUCCH PRBs and would read as a false SR, but scheduled
            # PUSCH/ACK from already-attached UEs must still be decoded.
            enb.rx_ul(tti, jnp.asarray(ul), pucch_scan=not got_prach)

    for t in dl_txs:
        t.close()
    for t in scell_txs:
        t.close()
    for rx in ul_rxs:
        rx.close()
    s1.close()
    gtpu.close()
    stats["dl_retx"] = enb.mac.metrics["dl_retx"]
    stats["scell_tx"] = enb.mac.metrics.get("scell_tx", 0)
    print("RESULT " + json.dumps(stats), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
