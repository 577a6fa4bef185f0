"""Crash handler + emergency cleanup hooks.

Counterpart of `lib/src/common/crash_handler.cc` (writes
srsRAN.backtrace.crash on fatal signals) and
`lib/include/srsran/support/emergency_handlers.h` (registered cleanup
callbacks — e.g. PCAP flush — run before dying).

Python flavour: `faulthandler` dumps all-thread tracebacks to the crash
file on SIGSEGV/SIGABRT/..., a signal bridge runs the registered
emergency handlers on SIGTERM/SIGINT, and `atexit` covers clean exits.
"""

from __future__ import annotations

import atexit
import datetime
import faulthandler
import os
import signal
import sys
import traceback
from typing import Callable

CRASH_FILE = "srsran.backtrace.crash"

_handlers: list[Callable[[], None]] = []
_installed = False
_crash_fd = None


def add_emergency_handler(fn: Callable[[], None]) -> None:
    """Register a cleanup callback (emergency_handlers.h:25)."""
    _handlers.append(fn)


def _run_handlers() -> None:
    for fn in _handlers:
        try:
            fn()
        except Exception:
            pass


def _on_term(signum, frame) -> None:
    with open(CRASH_FILE, "a") as f:
        f.write(f"--- srsran_4g_tpu signal {signum} at "
                f"{datetime.datetime.now().isoformat()} ---\n")
        traceback.print_stack(frame, file=f)
    _run_handlers()
    sys.exit(128 + signum)


def install(crash_file: str | None = None) -> None:
    """Install fatal-signal tracebacks + emergency hooks (idempotent)."""
    global _installed, _crash_fd, CRASH_FILE
    if _installed:
        return
    if crash_file:
        CRASH_FILE = crash_file
    _crash_fd = open(CRASH_FILE, "a")
    # SIGSEGV/SIGFPE/SIGABRT/SIGBUS -> all-thread tracebacks to the file
    faulthandler.enable(file=_crash_fd, all_threads=True)
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            signal.signal(sig, _on_term)
        except (ValueError, OSError):
            pass  # not in the main thread / not supported
    atexit.register(_run_handlers)
    _installed = True
