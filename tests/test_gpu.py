"""Checks that need a CUDA device: the phases of `chip_smoke.py`.

Each test calls the `srsran_4g_tpu.device_checks` function that the
matching `chip_smoke.py` phase runs, at the bench sizes.  Elsewhere they
skip; run them on a card with

    JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/test_gpu.py
"""

import jax
import pytest

from srsran_4g_tpu import device_checks as dc

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu():
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a CUDA device")
    return dc.card()


def test_turbo_kernel_matches_scan(gpu):
    dc.turbo_parity()


def test_siso_receiver(gpu):
    dc.siso_receiver()


def test_tm4_receiver(gpu):
    dc.tm4_receiver()


def test_air_path(gpu):
    dc.air_path()


def test_graft_entry(gpu):
    dc.graft_entry()


def test_gpu_matches_cpu(gpu):
    dc.gpu_vs_cpu()


def test_four_cards(gpu):
    if len(jax.devices()) < 4:
        pytest.skip("needs four CUDA devices")
    dc.four_card(4)
