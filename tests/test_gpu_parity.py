"""Device-vs-host parity on a GPU, at the kernels' real widths (the
checks of chip_smoke.py's kernels phase). Skipped unless JAX's default
device is a GPU; on the card:

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/
"""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402

pytestmark = pytest.mark.gpu


def test_chain_widths_on_gpu(gpu):
    chip_smoke.check_chain(seed=0)


def test_dp_classes_on_gpu(gpu):
    from mandalorion_tpu.align.kernels import Q_STEPS, WIDTHS
    for width in WIDTHS:
        for max_q in Q_STEPS:
            chip_smoke.check_dp_class(width, max_q, seed=0, timing=False)


@pytest.mark.parametrize("band,length", [(30, 2000), (200, 2000),
                                         (400, 2500), (1000, 3000)])
def test_poa_windows_on_gpu(gpu, band, length):
    chip_smoke.check_poa(chip_smoke.poa_sets(band, 2, 4, length), band)
