"""The fused device DP (solve_dp_fused: DP, start-cell pick and walk in
one jitted call) against the native host solver at every (target width,
row cap) class the aligner can dispatch, each at its fixed batch — the
same check chip_smoke.py's kernels phase makes on the card."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from mandalorion_tpu.align.kernels import Q_STEPS, WIDTHS  # noqa: E402


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("max_q", Q_STEPS)
def test_fused_rowscan_class_matches_native(width, max_q):
    from mandalorion_tpu.native import load_native
    if load_native() is None:
        pytest.skip("native library unavailable")
    chip_smoke.check_dp_class(width, max_q, seed=3, n=12, timing=False)
