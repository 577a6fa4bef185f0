"""Correctness and timing checks of the receive path on the accelerator.

`chip_smoke.py` runs these as its phases on the card, and the `gpu`-marked
tests in `tests/test_gpu.py` call the same functions.  Each check raises
`AssertionError` on a wrong result and returns a dict of what it measured.
Sizes default to the bench cells (`bench.py`): 20 MHz (100 PRB) 64QAM with
TBS 75376, i.e. 13 code blocks of K=5824 per transport block.  The CPU
tests call them at small sizes to rehearse the code.

Timings are host-clock seconds around work that ends in
`block_until_ready`; they mean device time only on the accelerator.
"""

from __future__ import annotations

import contextlib
import functools
import subprocess
import time

import jax
import jax.numpy as jnp
import numpy as np

from srsran_4g_tpu.channel.awgn import awgn, snr_to_noise_var
from srsran_4g_tpu.models import grid as G
from srsran_4g_tpu.models import pdsch, pdsch_mimo
from srsran_4g_tpu.ops import crc as crc_ops
from srsran_4g_tpu.ops import turbo

BENCH_TBS = 75376
# |kernel - lax.scan| APP LLR bound: both run the same max-plus recursion
# in f32, differing at most in rounding of a few hundred additions of
# normalised metrics, i.e. ~1e-5 of the LLR scale; 1e-4 leaves margin
LLR_RTOL = 1e-4
# GPU vs CPU front end: chest/MIMO products run at full f32 precision
# (models/chest.py, models/mimo.py), so the equalised symbols differ only
# by f32 rounding in another summation and FMA order: 1e-4 of their scale.
# LLRs scale with 1/noise variance, and the CRS noise estimate subtracts a
# smoothed channel from pilots 30 dB stronger than the noise, so its f32
# rounding grows by the SNR (1e3): ~1e-4 of the LLR scale; bound 1e-3.
# Decoded bits and CRCs must be equal.
SYMBOL_RTOL = 1e-4
LLR_SCALE_RTOL = 1e-3


def nvidia_smi() -> str:
    """`name, power.limit` of the card(s), as nvidia-smi prints them."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"
    return r.stdout.strip()


def card() -> dict:
    """The default device; raises unless it is a GPU."""
    d = jax.devices()[0]
    info = dict(platform=d.platform, kind=d.device_kind,
                count=len(jax.devices()))
    if d.platform != "gpu":
        raise RuntimeError(f"no GPU: JAX's default device is {info}")
    info["nvidia_smi"] = nvidia_smi()
    return info


def memory(compiled) -> dict:
    """`memory_analysis()` of a compiled program, in bytes."""
    m = compiled.memory_analysis()
    if m is None:
        return {}
    return {f: getattr(m, f) for f in (
        "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes", "generated_code_size_in_bytes")}


def peak_bytes(device=None) -> int | None:
    stats = (device or jax.devices()[0]).memory_stats()
    return None if stats is None else stats.get("peak_bytes_in_use")


def _compile(fn, *args):
    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(*args).compile()
    return compiled, time.perf_counter() - t0


def _time(compiled, *args, reps: int) -> tuple[float, object]:
    """Seconds per call after one warm call, and the last result."""
    out = jax.block_until_ready(compiled(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = compiled(*args)
    out = jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps, out


@contextlib.contextmanager
def plain_turbo():
    """Route `turbo_decode` calls inside the block to `lax.scan`, so a
    receiver can be timed without the GPU kernel for comparison."""
    orig = turbo.turbo_decode
    turbo.turbo_decode = functools.partial(orig, backend="xla")
    try:
        yield
    finally:
        turbo.turbo_decode = orig


# --- turbo decoder: kernel vs lax.scan --------------------------------------


def turbo_parity(n_cb: int = 1664, k: int = 5824, n_iter: int = 4,
                 ebn0_db: float = 1.5, reps: int = 5,
                 kernel_backend: str = "auto", seed: int = 0) -> dict:
    """The windowed decoder on the kernel against `_map_windowed`.

    Code blocks carry a real CRC24B, so the early stop works as in the
    receiver.  AWGN at `ebn0_db` (rate 1/3, BPSK) makes most blocks need a
    few half-iterations.  Times both paths with the early stop and with all
    2·n_iter halves; requires identical hard decisions and CRCs, and APP
    LLRs within LLR_RTOL of the scale.
    """
    key = jax.random.PRNGKey(seed)
    kb, kn = jax.random.split(key)

    @jax.jit
    def make_llr(kb, kn):
        payload = jax.random.bernoulli(kb, 0.5, (n_cb, k - 24)).astype(jnp.int8)
        cb = jnp.concatenate([payload, crc_ops.crc_compute(payload, "24B")],
                             axis=-1)
        d = turbo.turbo_encode(cb).astype(jnp.float32)
        sigma2 = 1.0 / (2.0 * (1.0 / 3.0) * 10 ** (ebn0_db / 10))
        y = 1.0 - 2.0 * d + jnp.sqrt(sigma2) * jax.random.normal(kn, d.shape)
        return cb, -2.0 * y / sigma2

    cb, llr = jax.block_until_ready(make_llr(kb, kn))
    out: dict = dict(n_cb=n_cb, k=k, n_iter=n_iter, ebn0_db=ebn0_db)
    results = {}
    for name, backend in (("kernel", kernel_backend), ("xla", "xla")):
        for stop in ("early", "fixed"):
            fn = functools.partial(
                turbo.turbo_decode, n_iter=n_iter, backend=backend,
                early_crc="24B" if stop == "early" else None)
            compiled, c_s = _compile(fn, llr)
            run_s, (hard, app) = _time(compiled, llr, reps=reps)
            tag = f"{name}_{stop}"
            out[f"{tag}_compile_s"] = c_s
            out[f"{tag}_run_s"] = run_s
            out[f"{tag}_memory"] = memory(compiled)
            results[tag] = (hard, app)

    # one half-iteration alone: the kernel's own time against the plain
    # lax.scan version that XLA compiles, on the same inputs
    window = turbo.choose_window(k, 208, 32)
    half_args = (llr[:, 0, :k], llr[:, 1, :k], llr[:, 0, k:k + 3],
                 llr[:, 1, k:k + 3])
    kernel_half = functools.partial(
        turbo._map_windowed_kernel,
        interpret=kernel_backend == "triton_interpret")
    halves = {}
    for name, fn in (("kernel", kernel_half), ("xla", turbo._map_windowed)):
        half = functools.partial(fn, win_len=window, train_len=32)
        compiled, _ = _compile(half, *half_args)
        out[f"{name}_half_s"], halves[name] = _time(compiled, *half_args,
                                                    reps=reps)
    d, scale = _rel_diff(halves["kernel"], halves["xla"])
    out["half_max_abs_diff"] = d
    assert d <= LLR_RTOL * max(scale, 1.0), ("half", d, scale)

    for stop in ("early", "fixed"):
        hk, ak = (np.asarray(a) for a in results[f"kernel_{stop}"])
        hx, ax = (np.asarray(a) for a in results[f"xla_{stop}"])
        crc_k = np.asarray(crc_ops.crc_check(jnp.asarray(hk), "24B"))
        crc_x = np.asarray(crc_ops.crc_check(jnp.asarray(hx), "24B"))
        diff, scale = _rel_diff(ak, ax)
        out[f"{stop}_llr_max_abs_diff"] = diff
        out[f"{stop}_llr_scale"] = scale
        out[f"{stop}_crc_ok_fraction"] = float(crc_x.mean())
        out[f"{stop}_bit_errors_vs_sent"] = int(
            (hx != np.asarray(cb)).sum())
        assert np.array_equal(hk, hx), f"{stop}: hard decisions differ"
        assert np.array_equal(crc_k, crc_x), f"{stop}: CRCs differ"
        assert diff <= LLR_RTOL * max(scale, 1.0), (stop, diff, scale)
    return out


# --- receivers --------------------------------------------------------------


def siso_config(nof_prb: int = 100, mod: str = "64qam",
                tbs: int = BENCH_TBS) -> pdsch.PdschConfig:
    cell = G.CellConfig(nof_prb=nof_prb, cell_id=123, cfi=1)
    return pdsch.PdschConfig(cell=cell, rnti=0x1234, subframe=4, mod=mod,
                             tbs=tbs)


def tm4_config(nof_prb: int = 100, mod: str = "64qam",
               tbs: int = BENCH_TBS, pmi: int = 2):
    cell = G.CellConfig(nof_prb=nof_prb, cell_id=123, cfi=1, nof_ports=2)
    return pdsch_mimo.PdschMimoConfig(
        cell=cell, rnti=0x1234, subframe=4, mod0=mod, tbs0=tbs, mod1=mod,
        tbs1=tbs, tm="tm4", pmi=pmi)


# The bench's fixed 2x2 channel (bench.py main_mimo)
TM4_CHANNEL = np.array([[1.0 + 0.1j, 0.3 - 0.4j],
                        [0.2 + 0.4j, -0.9 + 0.2j]], np.complex64)


def siso_rx(cfg, batch: int, snr_db: float = 30.0, seed: int = 0):
    """(sent bits (B, tbs) int8, received grids) for the SISO receiver."""
    kb, kn = jax.random.split(jax.random.PRNGKey(seed))

    @jax.jit
    def make(kb, kn):
        bits = jax.random.bernoulli(kb, 0.5, (batch, cfg.tbs)).astype(jnp.int8)
        tx = pdsch.add_crs(cfg, pdsch.encode(cfg, bits))
        return bits, awgn(kn, tx, snr_to_noise_var(snr_db))

    return jax.block_until_ready(make(kb, kn))


def tm4_rx(cfg, batch: int, snr_db: float = 30.0, seed: int = 0):
    """(bits0, bits1, received (B, 2, nsymb, nre)) for the TM4 receiver."""
    k0, k1, kn = jax.random.split(jax.random.PRNGKey(seed), 3)
    nv = float(10 ** (-snr_db / 10))

    @jax.jit
    def make(k0, k1, kn):
        tb0 = jax.random.bernoulli(k0, 0.5, (batch, cfg.tbs0)).astype(jnp.int8)
        tb1 = jax.random.bernoulli(k1, 0.5, (batch, cfg.tbs1)).astype(jnp.int8)
        tx = pdsch.add_crs(cfg.cw[0], pdsch_mimo.encode(cfg, tb0, tb1))
        y = jnp.einsum("rt,btsk->brsk", TM4_CHANNEL, tx,
                       precision=jax.lax.Precision.HIGHEST)
        return tb0, tb1, awgn(kn, y, nv)

    return jax.block_until_ready(make(k0, k1, kn))


def siso_receiver(batch: int = 128, fused_batch: int | None = 256,
                  n_iter: int = 4, reps: int = 5, cfg=None) -> dict:
    """`pdsch.decode` end to end: every CRC passes and the payload is the
    one sent.  Times the receiver with the platform's turbo path and with
    `lax.scan` turbo; decodes one fused batch of `fused_batch` and reports
    its CRC fraction (it must also be 1.0)."""
    cfg = cfg or siso_config()
    bits, rx = siso_rx(cfg, batch)

    def dec(rx):
        o = pdsch.decode(cfg, rx, n_iter=n_iter)
        return o["bits"], o["crc_ok"]

    out: dict = dict(batch=batch, tbs=cfg.tbs, n_cb=cfg.plan.segm.C)
    for name, ctx in (("kernel", contextlib.nullcontext),
                      ("xla", plain_turbo)):
        with ctx():  # a fresh callable, so jit traces again under ctx
            compiled, c_s = _compile(lambda rx: dec(rx), rx)
        run_s, (got, ok) = _time(compiled, rx, reps=reps)
        ok = np.asarray(ok)
        out[f"{name}_compile_s"] = c_s
        out[f"{name}_run_s"] = run_s
        out[f"{name}_sf_per_s"] = batch / run_s
        out[f"{name}_memory"] = memory(compiled)
        out[f"{name}_crc_ok"] = float(ok.mean())
        assert ok.all(), f"{name}: crc_ok {ok.mean()}"
        assert np.array_equal(np.asarray(got), np.asarray(bits)), \
            f"{name}: decoded payload differs from what was sent"
    if fused_batch:
        fbits, frx = siso_rx(cfg, fused_batch, seed=1)
        compiled, c_s = _compile(dec, frx)
        run_s, (got, ok) = _time(compiled, frx, reps=1)
        out["fused_batch"] = fused_batch
        out["fused_compile_s"] = c_s
        out["fused_run_s"] = run_s
        out["fused_crc_ok"] = float(np.asarray(ok).mean())
        out["fused_bit_errors"] = int(
            (np.asarray(got) != np.asarray(fbits)).sum())
        assert out["fused_crc_ok"] == 1.0 and out["fused_bit_errors"] == 0, \
            out
    return out


def tm4_receiver(batch: int = 64, n_iter: int = 4, reps: int = 5,
                 cfg=None) -> dict:
    """`pdsch_mimo.decode` (TM4 2x2, both codewords): every CRC passes and
    both payloads are the ones sent."""
    cfg = cfg or tm4_config()
    tb0, tb1, rx = tm4_rx(cfg, batch)

    def dec(rx):
        o = pdsch_mimo.decode(cfg, rx, n_iter=n_iter)
        return o["bits0"], o["bits1"], o["crc_ok0"], o["crc_ok1"]

    compiled, c_s = _compile(dec, rx)
    run_s, (b0, b1, ok0, ok1) = _time(compiled, rx, reps=reps)
    out = dict(batch=batch, compile_s=c_s, run_s=run_s,
               sf_per_s=batch / run_s, memory=memory(compiled),
               crc_ok0=float(np.asarray(ok0).mean()),
               crc_ok1=float(np.asarray(ok1).mean()))
    assert out["crc_ok0"] == 1.0 and out["crc_ok1"] == 1.0, out
    assert np.array_equal(np.asarray(b0), np.asarray(tb0))
    assert np.array_equal(np.asarray(b1), np.asarray(tb1))
    return out


# --- the air path and the graft entry ---------------------------------------


def air_path(n_ttis: int = 300, n_pings: int = 2, nof_prb: int = 100) -> dict:
    """`tools/run_lte.py` over the air at 30 dB, one UE: must PASS."""
    import os
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if root not in sys.path:
        sys.path.insert(0, root)
    from tools import run_lte

    t0 = time.perf_counter()
    ok, stats, ues, _ = run_lte.run(n_ttis=n_ttis, n_pings=n_pings,
                                    snr_db=30.0, nof_prb=nof_prb, n_ues=1)
    out = dict(n_ttis=n_ttis, nof_prb=nof_prb, seconds=time.perf_counter() - t0,
               passed=bool(ok), stats=stats)
    assert ok, out
    return out


def graft_entry() -> dict:
    """Compile and call `__graft_entry__.entry()` once."""
    import __graft_entry__

    fn, args = __graft_entry__.entry()
    compiled, c_s = _compile(fn, *args)
    bits, crc_ok, snr_db = jax.block_until_ready(compiled(*args))
    out = dict(compile_s=c_s, bits_shape=tuple(bits.shape),
               crc_shape=tuple(crc_ok.shape),
               snr_finite=bool(np.isfinite(np.asarray(snr_db)).all()),
               memory=memory(compiled))
    assert out["snr_finite"], out
    return out


# --- the same graph on the accelerator and on the host CPU ------------------


def _rel_diff(a, b) -> tuple[float, float]:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max()), float(np.abs(b).max())


def gpu_vs_cpu(batch: int = 2, n_iter: int = 4, siso_cfg=None,
               tm4_cfg=None) -> dict:
    """SISO and TM4 receivers on the default device and on the host CPU.

    Equalised symbols agree within SYMBOL_RTOL and LLRs within
    LLR_SCALE_RTOL of their scale; decoded bits and CRCs are identical.  Rate dematching is a scatter-add;
    at these configurations (no repetition: E < 3(K+4)) no two LLRs share a
    target, so its GPU summation order does not enter.
    """
    cpu = jax.devices("cpu")[0]
    siso_cfg = siso_cfg or siso_config()
    tm4_cfg = tm4_cfg or tm4_config()
    _, rx = siso_rx(siso_cfg, batch, seed=2)
    _, _, rx2 = tm4_rx(tm4_cfg, batch, seed=3)

    def siso(rx):
        fe = pdsch.demap(siso_cfg, rx)
        o = pdsch.decode(siso_cfg, rx, n_iter=n_iter)
        return fe["x"], fe["llr"], o["bits"], o["crc_ok"]

    def tm4(rx):
        fe = pdsch_mimo.demap(tm4_cfg, rx)
        o = pdsch_mimo.decode(tm4_cfg, rx, n_iter=n_iter)
        return (fe["x"], jnp.stack([fe["llr0"], fe["llr1"]]),
                jnp.stack([o["bits0"], o["bits1"]]),
                jnp.stack([o["crc_ok0"], o["crc_ok1"]]))

    out: dict = dict(batch=batch)
    failures: list = []
    for name, fn, x in (("siso", siso, rx), ("tm4", tm4, rx2)):
        host = np.asarray(x)
        dev = jax.jit(fn)(jnp.asarray(host))
        ref = jax.jit(fn)(jax.device_put(host, cpu))
        ref_dev = {d for a in jax.tree.leaves(ref) for d in a.devices()}
        assert ref_dev == {cpu}, ref_dev
        for field, a, b, rtol in (("x", dev[0], ref[0], SYMBOL_RTOL),
                                  ("llr", dev[1], ref[1], LLR_SCALE_RTOL)):
            d, s = _rel_diff(a, b)
            out[f"{name}_{field}_max_abs_diff"] = d
            out[f"{name}_{field}_scale"] = s
            failures += [(name, field)] * (d > rtol * s)
        out[f"{name}_bits_equal"] = bool(
            np.array_equal(np.asarray(dev[2]), np.asarray(ref[2]))
            and np.array_equal(np.asarray(dev[3]), np.asarray(ref[3])))
        out[f"{name}_crc_ok"] = float(np.asarray(dev[3]).mean())
        failures += [(name, "bits")] * (not out[f"{name}_bits_equal"])
        failures += [(name, "crc")] * (out[f"{name}_crc_ok"] != 1.0)
    assert not failures, (failures, out)
    return out


# --- four cards --------------------------------------------------------------


def four_card(n_devices: int = 4, batch: int = 4, n_iter: int = 4,
              reps: int = 3, cfg=None) -> dict:
    """The mesh path on `n_devices` cards against one card.

    Runs `__graft_entry__.dryrun_multichip` (dp x sp=2 with `ppermute`
    halos and the `cb_shard` `all_gather`), then decodes the bench
    configuration over the same mesh and on one card and requires the
    bits and CRCs to be identical.  Each card's peak memory is reported,
    and every card must hold a share of the output.
    """
    from jax import shard_map
    from jax.sharding import NamedSharding, PartitionSpec as P

    import __graft_entry__
    from srsran_4g_tpu.parallel import mesh as mesh_mod

    devs = jax.devices()[:n_devices]
    assert len(devs) == n_devices, f"{len(devs)} devices, need {n_devices}"
    t0 = time.perf_counter()
    __graft_entry__.dryrun_multichip(n_devices)
    out: dict = dict(n_devices=n_devices, batch=batch,
                     dryrun_s=time.perf_counter() - t0)

    cfg = cfg or siso_config()
    sp = 2
    mesh = mesh_mod.make_mesh(dp=n_devices // sp, sp=sp, devices=devs)
    bits, rx = siso_rx(cfg, batch, seed=4)
    host_rx = np.asarray(rx)

    def local(rx, shard):
        o = pdsch.decode(cfg, rx, n_iter=n_iter, cb_shard=shard)
        return o["bits"], o["crc_ok"]

    sharded = shard_map(functools.partial(local, shard=("sp", sp)),
                        mesh=mesh, in_specs=P("dp"), out_specs=P("dp"),
                        check_vma=False)
    rx_sh = jax.device_put(host_rx, NamedSharding(mesh, P("dp")))
    compiled, out["mesh_compile_s"] = _compile(sharded, rx_sh)
    out["mesh_run_s"], (b_m, ok_m) = _time(compiled, rx_sh, reps=reps)
    out["mesh_memory"] = memory(compiled)
    out["mesh_output_devices"] = len(b_m.sharding.device_set)
    out["peak_bytes_per_device"] = [peak_bytes(d) for d in devs]

    rx_1 = jax.device_put(host_rx, devs[0])
    compiled1, out["one_card_compile_s"] = _compile(
        functools.partial(local, shard=None), rx_1)
    out["one_card_run_s"], (b_1, ok_1) = _time(compiled1, rx_1, reps=reps)

    b_m, ok_m = np.asarray(b_m), np.asarray(ok_m)
    out["crc_ok"] = float(ok_m.mean())
    out["bit_exact_vs_one_card"] = bool(
        np.array_equal(b_m, np.asarray(b_1))
        and np.array_equal(ok_m, np.asarray(ok_1)))
    assert out["bit_exact_vs_one_card"], out
    assert ok_m.all() and np.array_equal(b_m, np.asarray(bits)), out
    assert out["mesh_output_devices"] == n_devices, out
    assert all(p for p in out["peak_bytes_per_device"]
               if p is not None), out
    return out
