"""Full-system E2E: multi-UE <-> eNB over the accelerator PHY with OTA control.

The framework's counterpart of the reference's system test
`test/run_lte.sh` (srsEPC + srsENB + srsUE over ZMQ RF + netns), in its
single-process TTI-stepped shape: the node objects are the SAME classes
the three-process apps use (`srsran_4g_tpu/apps/nodes.py` +
`apps/srsue.py`/`srsenb.py`/`srsepc.py`), wired here by direct function
calls instead of sockets.  EVERY grant travels over the air exactly as
in the reference's `srsenb/src/stack/mac/mac.cc:639` → `srsue/src/phy/
lte/cc_worker.cc:259-301` contract:

  eNB MAC scheduler → DCI 1A/0 pack → PDCCH encode (CCE allocation) →
  OFDM → AWGN → UE blind decode over its search space → PDSCH/PUSCH at
  the granted allocation → HARQ-ACK on PUCCH format 1a at n_pucch =
  first CCE → scheduler dl_ack_info; SR on PUCCH format 1 requests UL
  grants; wideband CQI on PUCCH format 2 drives the scheduler's MCS.

Pass criteria mirror run_lte.sh:82-160: every UE attaches, exactly one
PRACH per UE, zero unrecovered PDSCH/PUSCH KO, 0% ping loss, and all
CQI reports at the target (15 at the default SNR).

Usage: python tools/run_lte.py [--ttis 400] [--pings 3] [--snr 30]
                               [--prb 6] [--ues 2]
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from srsran_4g_tpu.apps.nodes import EnbNode, UeNode, UePhy  # noqa: E402


def run(n_ttis: int, n_pings: int, snr_db: float, nof_prb: int = 6,
        n_ues: int = 1, n_cc: int = 1, burst_bytes: int = 0,
        fading_profile: str | None = None, doppler_hz: float = 5.0,
        tm: int = 1, si_1c: bool = False, tdd: bool = False,
        verbose: bool = False):
    from srsran_4g_tpu.runtime.lte_air import LteAirPhy
    from srsran_4g_tpu.stack.epc import Hss, Mme

    stats = {"prach": 0, "pdsch_ko": 0, "pusch_ko": 0, "pdsch_tx": 0,
             "pusch_tx": 0, "dl_ping_rx": 0, "ul_ping_rx": 0,
             "dci_tx": 0, "dci_missed": 0, "phich_ack": 0,
             "phich_nack": 0}
    log = (lambda *a: print(*a, flush=True)) if verbose else (lambda *a: None)

    fading = None
    if fading_profile:
        from srsran_4g_tpu.channel.fading import FadingConfig
        from srsran_4g_tpu.utils import constants as C

        fading = FadingConfig(fading_profile, doppler_hz,
                              C.symbol_sz(nof_prb) * 15e3)
    # tm=3/4 selects the 2x2 MIMO air (enb.conf.example:17-31
    # `tm=4 nof_ports=2`): 2-port SFBC control + CRS, dual-codeword
    # spatial-mux PDSCH once the UE reports rank 2
    nof_ports = 2 if tm in (3, 4) else 1
    air = LteAirPhy(nof_prb=nof_prb, snr_db=snr_db, fading=fading,
                    nof_ports=nof_ports, nof_rx=nof_ports,
                    frame_type="tdd" if tdd else "fdd", ul_dl_config=1)
    # carrier aggregation: a second carrier with its own cell id/PHY
    air_s = (LteAirPhy(nof_prb=nof_prb, cell_id=2, snr_db=snr_db, seed=11)
             if n_cc == 2 else None)

    # ----- EPC
    hss = Hss()
    mme = Mme(hss=hss)

    # ----- UEs
    ues = [UeNode(i, air, stats, log, tm=tm) for i in range(n_ues)]
    for ue in ues:
        ue.si_1c = si_1c
    ue_phys = [UePhy(ue, air, air_s) for ue in ues]
    for ue in ues:
        hss.add_subscriber(ue.ucfg.imsi, ue.ucfg.k, ue.ucfg.opc)

    # ----- eNB node, S1 wired straight into the in-process MME
    enb = EnbNode(air, stats, log, air_s=air_s, tm=tm)
    if si_1c:
        # broadcast SI on the compact format 1C (ra_dl.c:383; dci.c:346)
        enb.mac.si_dci_1c = True
    enb.rrc.tx_s1ap = lambda pdu: [enb.rrc.rx_s1ap(r)
                                   for r in mme.rx_s1ap(pdu)]
    enb.s1u_tx = mme.spgw.rx_s1u
    mme.spgw.sgi_tx = lambda pkt: stats.__setitem__(
        "ul_ping_rx", stats["ul_ping_rx"] + 1)
    mme.spgw.s1u_tx = enb.rx_s1u

    pings_sent = {ue.idx: 0 for ue in ues}
    attach_tti: dict[int, int] = {}

    for tti in range(n_ttis):
        for ue in ues:
            ue.tick()
        enb.tick()

        # 1. PRACH (once per UE, as in run_lte.sh's "exactly 1 PRACH");
        # short-circuited through the shared PHY in-process (the
        # three-process apps carry the preamble in the UL sample stream)
        for up in ue_phys:
            idx = up.prach_due(tti)
            if idx is not None:
                det = air.prach(idx)
                if det is not None:
                    enb.rach_detected(tti, det)

        # 2-3. eNB scheduling + DL subframe over the air
        dl_samples, scell_samples = enb.step_dl(tti)

        # 4. UE DL reception (OTA acquisition FSM then blind decode)
        if dl_samples is not None:
            for up in ue_phys:
                up.rx_dl(tti, dl_samples)
        if scell_samples is not None:
            for up in ue_phys:
                up.rx_dl_scell(tti, scell_samples)

        # 5. UL over the air (TDD: only on UL subframes)
        cqi_due = air.cqi_due(tti)
        ul_sf = air.sf_kind(tti) == "U" or air.frame_type == "fdd"
        grids = [ue.ul_grid(tti, cqi_due) for ue in ues] if ul_sf else []
        if ul_sf and (any(g is not None for g in grids) or enb.pusch_watch
                      or enb.ack_watch):
            ul_samples = air.combine_ul(grids, tti=tti)
            enb.rx_ul(tti, ul_samples)

        # 6. ping trains once attached
        for ue in ues:
            if ue.nas.is_registered() and ue.idx not in attach_tti:
                attach_tti[ue.idx] = tti
                log(f"tti {tti}: ue{ue.idx} ATTACHED ip="
                    f"{'.'.join(str(b) for b in ue.nas.ip_addr)}")
            if (burst_bytes and ue.idx == 0 and ue.idx in attach_tti
                    and tti == attach_tti[ue.idx] + 30):
                # one large DL burst after the SCell is active: exceeds
                # the PCell's per-TTI capacity so the SCell carries part
                sess = mme.spgw.sessions[ue.ucfg.imsi]
                mme.spgw.rx_sgi(bytes(16) + sess.ue_ip + bytes(burst_bytes))
            # TDD: the AttachComplete->ModifyBearer leg rides sparse UL
            # subframes, so the S1-U tunnel finishes a little later
            ping_gate = 2 if air.frame_type == "fdd" else 14
            if (ue.idx in attach_tti and pings_sent[ue.idx] < n_pings
                    and tti > attach_tti[ue.idx] + ping_gate
                    and (tti - attach_tti[ue.idx]) % 12 == 0):
                sess = mme.spgw.sessions[ue.ucfg.imsi]
                pkt = (bytes(16) + sess.ue_ip
                       + f"ping{ue.idx}{pings_sent[ue.idx]:03d}".encode())
                mme.spgw.rx_sgi(pkt)
                pings_sent[ue.idx] += 1

    stats["scell_tx"] = enb.mac.metrics["scell_tx"]
    if tm in (3, 4):
        # the flagship-mode criterion: spatial multiplexing actually ran
        ok_rank2 = stats.get("pdsch_tx_rank2", 0) > 0 \
            and stats.get("pdsch_rank2", 0) > 0
    else:
        ok_rank2 = True
    stats["dl_retx"] = enb.mac.metrics["dl_retx"]
    stats["si_1c_tx"] = enb.mac.metrics.get("si_1c_tx", 0)
    if si_1c:
        ok_rank2 = ok_rank2 and stats["si_1c_tx"] > 0
    total_pings = n_pings * len(ues) + (1 if burst_bytes else 0)
    impaired = fading_profile is not None or snr_db < 25
    all_cqi_target = all(
        c >= 13 for ue in ues for c in ue.cqi_sent[1:]) \
        if not impaired else True
    ok = (all(ue.nas.is_registered() for ue in ues)
          and stats["prach"] == len(ues)
          and stats["dl_ping_rx"] == total_pings
          and stats["ul_ping_rx"] >= total_pings
          and all_cqi_target and ok_rank2)
    if impaired:
        # HARQ-under-fire: losses must occur AND be recovered (attach +
        # 0% ping loss above, retransmissions on the affected link —
        # which link the fading realisation hits varies with the wire's
        # exact PDU sizes, so require DL retx only when DL KOs occurred;
        # UL recovery is implied by pusch_ko > 0 with 0% UL ping loss)
        ok = ok and (stats["pdsch_ko"] + stats["pusch_ko"]) > 0 \
            and (stats["pdsch_ko"] == 0 or stats["dl_retx"] > 0)
    else:
        ok = ok and stats["pdsch_ko"] == 0 and stats["pusch_ko"] == 0
    return ok, stats, ues, mme


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ttis", type=int, default=400)
    ap.add_argument("--pings", type=int, default=3)
    ap.add_argument("--snr", type=float, default=30.0)
    ap.add_argument("--prb", type=int, default=6)
    ap.add_argument("--ues", type=int, default=2)
    ap.add_argument("--cc", type=int, default=1, choices=(1, 2))
    ap.add_argument("--burst", type=int, default=0)
    ap.add_argument("--fading", choices=("epa", "eva", "etu"), default=None)
    ap.add_argument("--doppler", type=float, default=5.0)
    ap.add_argument("--tm", type=int, default=1, choices=(1, 3, 4))
    ap.add_argument("--si-1c", action="store_true",
                    help="broadcast SI on DCI format 1C")
    ap.add_argument("--tdd", action="store_true",
                    help="frame structure type 2, UL/DL config 1")
    ap.add_argument("-v", action="store_true")
    args = ap.parse_args()
    from srsran_4g_tpu.utils import compile_cache

    compile_cache.enable()

    if args.cc == 2 and not args.burst:
        args.burst = 1400
    ok, stats, ues, mme = run(args.ttis, args.pings, args.snr,
                              nof_prb=args.prb, n_ues=args.ues,
                              n_cc=args.cc, burst_bytes=args.burst,
                              fading_profile=args.fading,
                              doppler_hz=args.doppler, tm=args.tm,
                              si_1c=args.si_1c, tdd=args.tdd,
                              verbose=args.v)
    for ue in ues:
        print(f"ue{ue.idx}: attached={ue.nas.is_registered()} "
              f"crnti={ue.crnti:#x} cqi={ue.cqi_sent}")
    print(f"stats={stats}")
    print("E2E RESULT:", "PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
