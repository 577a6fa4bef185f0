"""srsEPC process: MME + HSS + SPGW behind real sockets.

The framework's counterpart of `srsepc/src/main.cc:384`: a standalone
core-network process serving
  * S1AP on a TCP listener (the reference uses SCTP, `mme.cc:118-143`;
    TCP carries the same 3GPP-exact aligned-PER PDUs with a 4-byte
    length frame — justified substitute, SCTP needs kernel support),
  * GTP-U on UDP (reference `spgw/gtpu.cc`, port 2152),
and driving a DL ping train toward each attached UE over S1-U once its
default bearer is up (the SGi side of `test/run_lte.sh`'s ping check).

Prints one final line `RESULT {json}` with attach/ping counters.

Usage: python -m srsran_4g_tpu.apps.srsepc --s1ap-port 36412 \
           --gtpu-port 2152 --ues 1 --pings 2
"""

from __future__ import annotations

import argparse
import json
import select
import socket
import struct
import sys
import time


def _frame(pdu: bytes) -> bytes:
    return struct.pack(">I", len(pdu)) + pdu


class FrameReader:
    """Length-prefixed message reassembly over a TCP stream."""

    def __init__(self) -> None:
        self.buf = b""

    def feed(self, data: bytes) -> list[bytes]:
        self.buf += data
        out = []
        while len(self.buf) >= 4:
            n = struct.unpack(">I", self.buf[:4])[0]
            if len(self.buf) < 4 + n:
                break
            out.append(self.buf[4:4 + n])
            self.buf = self.buf[4 + n:]
        return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description="srsEPC")
    ap.add_argument("--s1ap-port", type=int, default=36412)
    ap.add_argument("--gtpu-port", type=int, default=2152)
    ap.add_argument("--ues", type=int, default=1,
                    help="provision N default subscribers (base IMSI + idx)")
    ap.add_argument("--pings", type=int, default=2,
                    help="DL pings per attached UE")
    ap.add_argument("--ping-interval", type=float, default=0.5)
    ap.add_argument("--burst-bytes", type=int, default=0,
                    help="after the ping train, push ONE DL burst of "
                         "this size (exceeds a narrow PCell's per-TTI "
                         "capacity, so a 2-CC eNB drains part of it on "
                         "the SCell - run_lte.py's CA criterion)")
    ap.add_argument("--hss-db", default=None,
                    help="optional CSV subscriber DB (user_db.csv format)")
    ap.add_argument("--timeout", type=float, default=300.0)
    args = ap.parse_args(argv)

    from srsran_4g_tpu.stack import gtpu as G
    from srsran_4g_tpu.stack.epc import Hss, Mme
    from srsran_4g_tpu.stack.usim import UsimConfig

    hss = Hss()
    if args.hss_db:
        hss.load_csv(args.hss_db)
    base = UsimConfig()
    for i in range(args.ues):
        imsi = str(int(base.imsi) + i).zfill(len(base.imsi))
        hss.add_subscriber(imsi, base.k, base.opc)
    mme = Mme(hss=hss)

    stats = {"attach": 0, "ul_ping_rx": 0, "dl_ping_tx": 0, "s1ap_rx": 0}
    mme.spgw.sgi_tx = lambda pkt: stats.__setitem__(
        "ul_ping_rx", stats["ul_ping_rx"] + 1)

    # GTP-U: the eNB announces itself with an Echo Request so the SPGW
    # learns the S1-U peer address (rf_imp-style probe, gtpu.cc echo)
    gtpu_sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    gtpu_sock.bind(("127.0.0.1", args.gtpu_port))
    s1u_peer: list = [None]

    def s1u_tx(teid: int, pkt: bytes) -> None:
        if s1u_peer[0] is not None:
            gtpu_sock.sendto(G.pack(G.GtpuHeader(teid=teid), pkt), s1u_peer[0])

    mme.spgw.s1u_tx = s1u_tx

    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind(("127.0.0.1", args.s1ap_port))
    srv.listen(1)
    print(f"srsepc: S1AP on tcp:{args.s1ap_port}, GTP-U on "
          f"udp:{args.gtpu_port}", flush=True)
    conn, addr = srv.accept()
    conn.setblocking(False)
    print(f"srsepc: eNB connected from {addr}", flush=True)
    reader = FrameReader()

    pings_sent: dict[str, int] = {}
    last_ping: dict[str, float] = {}
    burst_sent: set[str] = set()
    t_end = time.time() + args.timeout
    attached: set[str] = set()
    while time.time() < t_end:
        rs, _, _ = select.select([conn, gtpu_sock], [], [], 0.05)
        if conn in rs:
            data = conn.recv(65536)
            if not data:
                break               # eNB closed S1 — shut down
            for pdu in reader.feed(data):
                stats["s1ap_rx"] += 1
                for reply in mme.rx_s1ap(pdu):
                    conn.sendall(_frame(reply))
        if gtpu_sock in rs:
            raw, peer = gtpu_sock.recvfrom(65536)
            s1u_peer[0] = peer
            hdr, payload = G.unpack(raw)
            if hdr.msg_type == G.GTPU_MSG_DATA_PDU:
                mme.spgw.rx_s1u(hdr.teid, payload)
        # DL ping driver: once a session's S1-U DL TEID is known the
        # bearer is up end-to-end
        now = time.time()
        for imsi, sess in list(mme.spgw.sessions.items()):
            if not sess.enb_teid:
                continue
            if imsi not in attached:
                attached.add(imsi)
                stats["attach"] += 1
                print(f"srsepc: {imsi} attached, ip="
                      f"{'.'.join(str(b) for b in sess.ue_ip)}", flush=True)
            sent = pings_sent.get(imsi, 0)
            if sent < args.pings and now - last_ping.get(imsi, 0) \
                    >= args.ping_interval:
                pkt = bytes(16) + sess.ue_ip + f"ping0{sent:03d}".encode()
                mme.spgw.rx_sgi(pkt)
                pings_sent[imsi] = sent + 1
                last_ping[imsi] = now
                stats["dl_ping_tx"] += 1
            elif (args.burst_bytes and imsi not in burst_sent
                    and sent >= args.pings
                    and now - last_ping.get(imsi, 0) >= args.ping_interval):
                mme.spgw.rx_sgi(bytes(16) + sess.ue_ip
                                + bytes(args.burst_bytes))
                burst_sent.add(imsi)
                stats["dl_burst_tx"] = stats.get("dl_burst_tx", 0) + 1
    conn.close()
    srv.close()
    gtpu_sock.close()
    print("RESULT " + json.dumps(stats), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
