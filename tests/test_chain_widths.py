"""The chain kernel at each segment-width class against the native
seed_chain_c (decoded chain and float32 score bits), on staged
candidates — the check chip_smoke.py's kernels phase makes on the card,
here at a small batch."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402


@pytest.mark.parametrize("width", [64, 128, 256, 512])
def test_chain_width_matches_seed_chain_c(width):
    from mandalorion_tpu.native import load_native
    if load_native() is None:
        pytest.skip("native library unavailable")
    out = chip_smoke.check_chain(seed=1, widths=(width,), batch=64,
                                 n_cand=96, verbose=False)
    assert out[width][2] > 0
