"""NR SA system E2E over the real PHY + crash-handler behavior.

The SA counterpart of test_run_lte.py: SSB search -> registration with
5G-AKA + security -> PDU session -> ciphered SDAP/PDCP-NR ping train,
all transport over jitted PDSCH-NR/PUSCH-NR; plus the crash handler
(crash_handler.cc / emergency_handlers.h counterparts) exercised in a
real subprocess.
"""

import os
import signal
import subprocess
import sys
import tempfile
import time


def test_nr_sa_system_e2e():
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                    "tools"))
    import run_nr

    ok, stats, ue, amf = run_nr.run(n_slots=80, n_pings=2, snr_db=20.0)
    assert stats["ssb_found"] == 1
    assert stats["prach_detected"] == 1   # exactly one preamble, no false alarms
    assert ue.nas.state == "REGISTERED"
    assert stats["pdsch_ko"] == 0 and stats["pusch_ko"] == 0
    assert stats["dl_ping_rx"] == 2 and stats["ul_ping_rx"] == 2
    assert stats["ack_rx"] >= 1      # DL HARQ-ACKs carried on PUCCH-NR F1
    assert ok


def test_crash_handler_writes_backtrace_and_runs_hooks():
    with tempfile.TemporaryDirectory() as d:
        script = os.path.join(d, "victim.py")
        repo = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
        with open(script, "w") as f:
            f.write(f"""
import sys, os, time
sys.path.insert(0, {repo!r})
os.chdir({d!r})
from srsran_4g_tpu.utils import crash_handler
crash_handler.install()
crash_handler.add_emergency_handler(
    lambda: open("pcap_flushed", "w").write("yes"))
print("ready", flush=True)
time.sleep(30)
""")
        p = subprocess.Popen([sys.executable, script],
                             stdout=subprocess.PIPE, text=True)
        assert p.stdout.readline().strip() == "ready"
        p.send_signal(signal.SIGTERM)
        p.wait(timeout=10)
        assert p.returncode == 128 + signal.SIGTERM
        crash = os.path.join(d, "srsran.backtrace.crash")
        assert os.path.exists(crash)
        with open(crash) as f:
            content = f.read()
        assert "signal 15" in content and "victim.py" in content
        with open(os.path.join(d, "pcap_flushed")) as f:
            assert f.read() == "yes"
