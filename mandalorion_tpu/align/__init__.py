"""Splice-aware long-read alignment engine (replaces minimap2 + mappy).

Seed → chain → extend architecture (minimap2 paper, PAPERS.md), re-designed
array-first: vectorized rolling-hash minimizers over a sorted genome index,
diagonal-run collapse + segment chaining, splice-point search as a cumulative
-match scan, and batched banded affine-gap DP for inter-anchor gap fill (the
device DP in align/kernels.py). Emits extended PSL directly
(accuracy + long cs + oriented sequence), the reference pipeline's
interchange format (`emtrey.py:146-148`).
"""

from mandalorion_tpu.align.aligner import SpliceAligner  # noqa: F401
