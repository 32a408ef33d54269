"""Card-only checks: the phases of chip_smoke.py as tests.

Marked ``gpu``; each skips (decided in the fixture, at run time) unless
JAX's first device is a GPU. Run on the card with

  JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/test_gpu.py
"""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


@pytest.fixture(scope="module")
def smoke():
    import jax

    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (JAX found "
                    f"{jax.devices()[0].platform})")
    import chip_smoke

    from cpuperformanceraytracer_tpu.utils.device import card_info

    return chip_smoke, chip_smoke.Smoke(card_info()), chip_smoke._sky()


@pytest.mark.gpu
@pytest.mark.parametrize("phase", ["forward", "parity", "train"])
def test_chip_phase(smoke, phase):
    module, s, tex = smoke
    getattr(module, phase)(s, tex)
