"""Turbo codec tests.

Parity model: reference lib/src/phy/fec/turbo/test/turbodecoder_test.c —
encode → BPSK → AWGN → decode, BER gates over the Eb/N0 1–8 dB range
(turbodecoder_test.c:52-53); `-t` mode asserts 0 errors at the operating
point.
"""

import numpy as np
import pytest

from srsran_4g_tpu.ops import turbo


def rsc_encode_direct(bits):
    """Independent straight-line RSC reference (TS 36.212 §5.1.3.2.1)."""
    r1 = r2 = r3 = 0
    par = []
    for u in bits:
        a = u ^ r2 ^ r3
        z = a ^ r1 ^ r3
        par.append(z)
        r1, r2, r3 = a, r1, r2
    # termination
    tail_sys, tail_par = [], []
    for _ in range(3):
        u = r2 ^ r3
        a = 0
        z = a ^ r1 ^ r3
        tail_sys.append(u)
        tail_par.append(z)
        r1, r2, r3 = a, r1, r2
    assert (r1, r2, r3) == (0, 0, 0)
    return np.array(par), np.array(tail_sys), np.array(tail_par)


def test_encoder_matches_direct():
    rng = np.random.default_rng(0)
    k = 40
    bits = rng.integers(0, 2, size=(1, k)).astype(np.int8)
    d = np.asarray(turbo.turbo_encode(bits))[0]
    # systematic part
    np.testing.assert_array_equal(d[0, :k], bits[0])
    p1, ts1, tp1 = rsc_encode_direct(list(bits[0]))
    np.testing.assert_array_equal(d[1, :k], p1)
    perm = turbo.qpp_permutation(k)
    p2, ts2, tp2 = rsc_encode_direct(list(bits[0][perm]))
    np.testing.assert_array_equal(d[2, :k], p2)
    # tail arrangement per TS 36.212 §5.1.3.2.2
    np.testing.assert_array_equal(d[0, k:], [ts1[0], tp1[1], ts2[0], tp2[1]])
    np.testing.assert_array_equal(d[1, k:], [tp1[0], ts1[2], tp2[0], ts2[2]])
    np.testing.assert_array_equal(d[2, k:], [ts1[1], tp1[2], ts2[1], tp2[2]])


def test_qpp_permutation_is_bijection():
    for k in (40, 512, 6144):
        p = turbo.qpp_permutation(k)
        assert np.array_equal(np.sort(p), np.arange(k))
        ip = turbo.qpp_inverse(k)
        np.testing.assert_array_equal(p[ip], np.arange(k))


def _awgn_llrs(d, ebn0_db, rng):
    """BPSK over AWGN: bit b → x = 1-2b; LLR = -2y/σ² (positive ⇒ 1)."""
    k = d.shape[-1] - 4
    rate = k / (3.0 * (k + 4))
    ebn0 = 10 ** (ebn0_db / 10)
    sigma2 = 1.0 / (2 * rate * ebn0)
    x = 1.0 - 2.0 * d.astype(np.float64)
    y = x + rng.standard_normal(d.shape) * np.sqrt(sigma2)
    return (-2.0 * y / sigma2).astype(np.float32)


@pytest.mark.parametrize("k", [40, 512])
def test_decode_noiseless(k):
    rng = np.random.default_rng(k)
    bits = rng.integers(0, 2, size=(2, k)).astype(np.int8)
    d = np.asarray(turbo.turbo_encode(bits)).astype(np.float32)
    llr = 8.0 * (2.0 * d - 1.0)  # positive ⇒ 1
    hard, _ = turbo.turbo_decode(llr, n_iter=2, window=None)
    np.testing.assert_array_equal(np.asarray(hard), bits)


def test_decode_awgn_operating_point():
    """0 bit errors at Eb/N0 = 3 dB, K=512 (well above waterfall)."""
    rng = np.random.default_rng(7)
    k, b = 512, 8
    bits = rng.integers(0, 2, size=(b, k)).astype(np.int8)
    d = np.asarray(turbo.turbo_encode(bits))
    llr = _awgn_llrs(d, 3.0, rng)
    hard, _ = turbo.turbo_decode(llr, n_iter=5, window=None)
    assert np.array_equal(np.asarray(hard), bits)


def test_decode_windowed_matches_full():
    rng = np.random.default_rng(11)
    k, b = 512, 4
    bits = rng.integers(0, 2, size=(b, k)).astype(np.int8)
    d = np.asarray(turbo.turbo_encode(bits))
    llr = _awgn_llrs(d, 2.0, rng)
    hard_f, app_f = turbo.turbo_decode(llr, n_iter=5, window=None)
    hard_w, app_w = turbo.turbo_decode(llr, n_iter=5, window=64, train=32)
    # windowed decode is an approximation; at this SNR both must be error-free
    assert np.array_equal(np.asarray(hard_f), bits)
    assert np.array_equal(np.asarray(hard_w), bits)


def test_ber_improves_with_snr():
    """Coded BER at 1.5 dB must beat 0.5 dB (waterfall region shape)."""
    rng = np.random.default_rng(3)
    k, b = 512, 16
    bits = rng.integers(0, 2, size=(b, k)).astype(np.int8)
    d = np.asarray(turbo.turbo_encode(bits))
    bers = []
    for ebn0 in (0.5, 1.5):
        llr = _awgn_llrs(d, ebn0, rng)
        hard, _ = turbo.turbo_decode(llr, n_iter=4, window=None)
        bers.append(np.mean(np.asarray(hard) != bits))
    assert bers[1] <= bers[0]
    assert bers[1] < 1e-2


def test_decode_k6144_windowed():
    rng = np.random.default_rng(5)
    k, b = 6144, 2
    bits = rng.integers(0, 2, size=(b, k)).astype(np.int8)
    d = np.asarray(turbo.turbo_encode(bits))
    llr = _awgn_llrs(d, 2.0, rng)
    hard, _ = turbo.turbo_decode(llr, n_iter=5, window=128, train=32)
    assert np.array_equal(np.asarray(hard), bits)


def test_ber_parity_artifact_vs_reference():
    """The committed side-by-side BER table (tools/ber_parity.py: the
    reference's own turbodecoder_test vs the framework decoder at
    identical noise sigma and equal full iterations) must show the
    framework within 0.2 dB of the reference waterfall at BER 1e-3.
    (Currently the framework is ~0.23 dB BETTER — the reference pays
    for its int16 LLR quantisation.)"""
    import json
    import os

    path = os.path.join(os.path.dirname(__file__), "..", "artifacts",
                        "ber_parity.json")
    d = json.load(open(path))
    assert d["k"] == 6144 and len(d["points"]) >= 5
    # positive divergence = framework worse; cap at +0.2 dB
    assert d["divergence_db"] <= 0.2, d
    # both curves reach the floor within the grid
    assert any(p["ref_ber"] == 0 for p in d["points"])
    assert any(p["fw_ber"] == 0 for p in d["points"])
