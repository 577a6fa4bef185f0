"""ctypes bindings to the C++ host runtime (native/runtime.cc).

Auto-builds libsrsran_rt.so with the in-tree Makefile on first use
(g++ is part of the supported toolchain).  See native/runtime.cc for the
component ↔ reference mapping.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
_NATIVE_DIR = os.path.join(_ROOT, "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libsrsran_rt.so")
_lock = threading.Lock()
_lib = None


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if not os.path.exists(_LIB_PATH) or os.path.getmtime(
            _LIB_PATH
        ) < os.path.getmtime(os.path.join(_NATIVE_DIR, "runtime.cc")):
            subprocess.run(["make", "-C", _NATIVE_DIR, "-s"], check=True)
        lib = ctypes.CDLL(_LIB_PATH)
        c = ctypes
        lib.rt_rb_create.restype = c.c_void_p
        lib.rt_rb_create.argtypes = [c.c_size_t]
        lib.rt_rb_destroy.argtypes = [c.c_void_p]
        for f in (lib.rt_rb_size, lib.rt_rb_space):
            f.restype = c.c_size_t
            f.argtypes = [c.c_void_p]
        for f in (lib.rt_rb_write, lib.rt_rb_read):
            f.restype = c.c_size_t
            f.argtypes = [c.c_void_p, c.POINTER(c.c_float), c.c_size_t]

        lib.rt_bridge_tx_create.restype = c.c_void_p
        lib.rt_bridge_tx_create.argtypes = [c.c_uint16]
        lib.rt_bridge_tx_accept.restype = c.c_int
        lib.rt_bridge_tx_accept.argtypes = [c.c_void_p]
        lib.rt_bridge_tx_send.restype = c.c_int
        lib.rt_bridge_tx_send.argtypes = [c.c_void_p, c.POINTER(c.c_float), c.c_uint32]
        lib.rt_bridge_tx_destroy.argtypes = [c.c_void_p]
        lib.rt_bridge_rx_connect.restype = c.c_void_p
        lib.rt_bridge_rx_connect.argtypes = [c.c_char_p, c.c_uint16, c.c_int]
        lib.rt_bridge_rx_read.restype = c.c_int
        lib.rt_bridge_rx_read.argtypes = [c.c_void_p, c.POINTER(c.c_float), c.c_uint32]
        lib.rt_bridge_rx_count.restype = c.c_uint64
        lib.rt_bridge_rx_count.argtypes = [c.c_void_p]
        lib.rt_bridge_rx_destroy.argtypes = [c.c_void_p]

        lib.rt_pcap_open.restype = c.c_void_p
        lib.rt_pcap_open.argtypes = [c.c_char_p]
        lib.rt_pcap_write.restype = c.c_int
        lib.rt_pcap_write.argtypes = [c.c_void_p, c.POINTER(c.c_uint8), c.c_uint32]
        lib.rt_pcap_close.argtypes = [c.c_void_p]
        _lib = lib
        return lib


def _fptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


class RingBuffer:
    """SPSC IQ ring buffer (reference ringbuffer.c)."""

    def __init__(self, capacity_samples: int):
        self._lib = _load()
        self._h = self._lib.rt_rb_create(capacity_samples)

    def write(self, samples: np.ndarray) -> int:
        iq = np.ascontiguousarray(samples, dtype=np.complex64).view(np.float32)
        return self._lib.rt_rb_write(self._h, _fptr(iq), samples.size)

    def read(self, n: int) -> np.ndarray:
        out = np.zeros(2 * n, dtype=np.float32)
        got = self._lib.rt_rb_read(self._h, _fptr(out), n)
        return out.view(np.complex64)[:got]

    @property
    def size(self) -> int:
        return self._lib.rt_rb_size(self._h)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.rt_rb_destroy(self._h)
            self._h = None


class IqBridgeTx:
    """TX side of the virtual-radio TCP sample bridge (reference rf_zmq)."""

    def __init__(self, port: int):
        self._lib = _load()
        self._h = self._lib.rt_bridge_tx_create(port)
        if not self._h:
            raise OSError(f"cannot bind IQ bridge on port {port}")

    def accept(self) -> None:
        if self._lib.rt_bridge_tx_accept(self._h) != 0:
            raise OSError("accept failed")

    def send(self, samples: np.ndarray) -> None:
        iq = np.ascontiguousarray(samples, dtype=np.complex64).view(np.float32)
        if self._lib.rt_bridge_tx_send(self._h, _fptr(iq), samples.size) != 0:
            raise OSError("bridge send failed")

    def close(self) -> None:
        if self._h:
            self._lib.rt_bridge_tx_destroy(self._h)
            self._h = None


class IqBridgeRx:
    """RX side: reads advance the virtual sample clock."""

    def __init__(self, host: str, port: int, timeout_ms: int = 5000):
        self._lib = _load()
        self._h = self._lib.rt_bridge_rx_connect(host.encode(), port, timeout_ms)
        if not self._h:
            raise OSError(f"cannot connect IQ bridge to {host}:{port}")

    def read(self, n: int) -> np.ndarray:
        out = np.zeros(2 * n, dtype=np.float32)
        if self._lib.rt_bridge_rx_read(self._h, _fptr(out), n) != 0:
            raise OSError("bridge read failed")
        return out.view(np.complex64)

    @property
    def sample_count(self) -> int:
        return self._lib.rt_bridge_rx_count(self._h)

    def close(self) -> None:
        if self._h:
            self._lib.rt_bridge_rx_destroy(self._h)
            self._h = None


class PcapWriter:
    """Async pcap writer (reference mac_pcap_base: worker thread + queue)."""

    def __init__(self, path: str):
        self._lib = _load()
        self._h = self._lib.rt_pcap_open(path.encode())
        if not self._h:
            raise OSError(f"cannot open pcap {path}")

    def write(self, packet: bytes) -> bool:
        buf = (ctypes.c_uint8 * len(packet)).from_buffer_copy(packet)
        return self._lib.rt_pcap_write(self._h, buf, len(packet)) == 0

    def close(self) -> None:
        if self._h:
            self._lib.rt_pcap_close(self._h)
            self._h = None
