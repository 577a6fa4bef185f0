"""The accelerator checks (`srsran_4g_tpu.device_checks`) rehearsed on the
CPU at small sizes: the turbo kernel runs in the Pallas interpreter and the
receivers use 6 PRB, so the code that `chip_smoke.py` runs on the card is
exercised here end to end."""

import pytest

from srsran_4g_tpu import device_checks as dc

SISO = dict(nof_prb=6, mod="qpsk", tbs=600)


def test_card_refuses_the_cpu():
    with pytest.raises(RuntimeError, match="no GPU"):
        dc.card()


def test_turbo_parity_rehearsal():
    r = dc.turbo_parity(n_cb=6, k=512, n_iter=2, ebn0_db=1.0, reps=1,
                        kernel_backend="triton_interpret")
    assert r["early_llr_max_abs_diff"] == 0.0
    assert r["fixed_llr_max_abs_diff"] == 0.0


def test_siso_receiver_rehearsal():
    r = dc.siso_receiver(batch=2, fused_batch=4, reps=1,
                         cfg=dc.siso_config(**SISO))
    assert r["kernel_crc_ok"] == r["xla_crc_ok"] == r["fused_crc_ok"] == 1.0


def test_tm4_receiver_rehearsal():
    r = dc.tm4_receiver(batch=2, reps=1, cfg=dc.tm4_config(**SISO))
    assert r["crc_ok0"] == r["crc_ok1"] == 1.0


def test_gpu_vs_cpu_rehearsal():
    r = dc.gpu_vs_cpu(batch=2, siso_cfg=dc.siso_config(**SISO),
                      tm4_cfg=dc.tm4_config(**SISO))
    assert r["siso_crc_ok"] == r["tm4_crc_ok"] == 1.0


def test_graft_entry_rehearsal():
    r = dc.graft_entry()
    assert r["bits_shape"] == (4, 2000)


def test_plain_turbo_restores_the_decoder():
    from srsran_4g_tpu.ops import turbo

    orig = turbo.turbo_decode
    with dc.plain_turbo():
        assert turbo.turbo_decode.keywords == {"backend": "xla"}
    assert turbo.turbo_decode is orig
