"""The GPU turbo kernel (ops/pallas/turbo_map.py) on the CPU.

The kernel runs here in the Pallas interpreter and must reproduce
`_map_windowed` exactly: it performs the same float32 operations in the
same order.  The dispatch tests check which half-iteration each platform
lowers to, by lowering the decoder for CUDA and for the CPU.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from srsran_4g_tpu.ops import turbo
from srsran_4g_tpu.ops.pallas import turbo_map


def _noisy_llrs(k, b, seed, sigma=0.7):
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, size=(b, k)).astype(np.int8)
    d = np.asarray(turbo.turbo_encode(bits)).astype(np.float32)
    llr = (2 * d - 1) * 2 + rng.standard_normal(d.shape).astype(np.float32) * sigma
    return bits, llr


# (K, window, train, batch): window 0 == last window (K=64), windows not
# dividing K so turbo_decode re-chooses them (1056 -> 176, 40 -> 40 with
# train 8), lane counts below, at and across the 128-lane block
@pytest.mark.parametrize("k,window,train,batch", [
    (512, 64, 32, 3),
    (256, 64, 16, 5),
    (64, 64, 16, 2),
    (40, 208, 8, 3),
    (1056, 208, 32, 4),
    (1024, 64, 32, 8),     # 128 lanes: one full block
    (1024, 64, 32, 9),     # 144 lanes: a full block and a partial one
    (2048, 128, 32, 17),   # 272 lanes: three blocks, the last partial
])
def test_interpret_matches_scan(k, window, train, batch):
    _, llr = _noisy_llrs(k, batch, seed=k + batch)
    h_x, a_x = turbo.turbo_decode(llr, n_iter=2, window=window, train=train,
                                  backend="xla")
    h_p, a_p = turbo.turbo_decode(llr, n_iter=2, window=window, train=train,
                                  backend="triton_interpret")
    np.testing.assert_array_equal(np.asarray(a_p), np.asarray(a_x))
    np.testing.assert_array_equal(np.asarray(h_p), np.asarray(h_x))


def test_half_iteration_matches_scan_directly():
    rng = np.random.default_rng(3)
    b, k, l, t = 6, 384, 96, 24
    lsa, lp = (jnp.asarray(rng.standard_normal((b, k)).astype(np.float32) * 3)
               for _ in range(2))
    ts, tp = (jnp.asarray(rng.standard_normal((b, 3)).astype(np.float32))
              for _ in range(2))
    ref = turbo._map_windowed(lsa, lp, ts, tp, l, t)
    got = turbo_map.map_windowed(lsa, lp, turbo._exact_boundary_beta(ts, tp),
                                 l, t, turbo._NEG, interpret=True)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


@pytest.mark.parametrize("crc_key", ["24A", "24B"])
def test_early_crc_loop_with_kernel(crc_key):
    from srsran_4g_tpu.ops import crc as crc_ops

    rng = np.random.default_rng(5)
    k, b = 512, 4
    payload = rng.integers(0, 2, size=(b, k - 24)).astype(np.int8)
    cb = np.asarray(crc_ops.crc_attach_np(payload, crc_key))
    d = np.asarray(turbo.turbo_encode(cb))
    sigma2 = 1.0 / (2 * (1 / 3) * 10 ** (1.5 / 10))
    y = 1 - 2 * d.astype(np.float64) + rng.standard_normal(d.shape) * np.sqrt(sigma2)
    llr = (-2 * y / sigma2).astype(np.float32)
    h_x, a_x = turbo.turbo_decode(llr, n_iter=4, window=128, train=32,
                                  backend="xla", early_crc=crc_key)
    h_p, a_p = turbo.turbo_decode(llr, n_iter=4, window=128, train=32,
                                  backend="triton_interpret",
                                  early_crc=crc_key)
    np.testing.assert_array_equal(np.asarray(h_p), np.asarray(h_x))
    np.testing.assert_array_equal(np.asarray(a_p), np.asarray(a_x))
    np.testing.assert_array_equal(np.asarray(h_p), cb)


def test_kernel_decodes_awgn():
    rng = np.random.default_rng(1)
    k, b = 512, 4
    bits = rng.integers(0, 2, size=(b, k)).astype(np.int8)
    d = np.asarray(turbo.turbo_encode(bits))
    rate = k / (3.0 * (k + 4))
    sigma2 = 1.0 / (2 * rate * 10 ** (3.0 / 10))
    y = (1 - 2 * d.astype(np.float64)) + rng.standard_normal(d.shape) * np.sqrt(sigma2)
    llr = (-2 * y / sigma2).astype(np.float32)
    hard, _ = turbo.turbo_decode(llr, n_iter=5, window=128, train=32,
                                 backend="triton_interpret")
    np.testing.assert_array_equal(np.asarray(hard), bits)


def _custom_calls(platform):
    d = jax.ShapeDtypeStruct((26, 3, 1028), jnp.float32)
    f = jax.jit(lambda x: turbo.turbo_decode(x, n_iter=2, early_crc="24B"))
    txt = f.trace(d).lower(lowering_platforms=(platform,)).as_text()
    return set(re.findall(r"custom_call @([\w$.]+)", txt))


def test_auto_lowers_to_scan_on_cpu():
    assert not any("triton" in c for c in _custom_calls("cpu"))


def test_auto_lowers_to_kernel_on_cuda():
    assert any("triton" in c for c in _custom_calls("cuda"))


def test_unknown_backend_is_rejected():
    _, llr = _noisy_llrs(64, 1, seed=0)
    with pytest.raises(ValueError, match="backend"):
        turbo.turbo_decode(llr, window=64, train=16, backend="mosaic")
