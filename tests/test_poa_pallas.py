"""The device POA route (XLA forward pass + on-device walk, with the
native C++ graph staging) against the pure-Python graph oracle.

Consensus equality across randomized adaptive-band graphs exercises the
whole matrix contract (scores, tie-breaks, band offsets, insertion
origins); indel-heavy reads shift the band offsets between rows, which is
where the window realignment must stay exact."""

import numpy as np
import pytest

import synthdata
from mandalorion_tpu.align.encode import encode, decode
from mandalorion_tpu.poa.graph import PoaParams, poa_consensus
from mandalorion_tpu.poa.kernels import poa_consensus_batch


def _sets(n_iso, n_reads, length, err, seed0):
    rng = np.random.default_rng(seed0)
    sets = []
    for i in range(n_iso):
        true = synthdata.make_genome(length, seed=seed0 + i)
        sets.append([encode(synthdata.mutate_read(true, rng, err)[0])
                     for _ in range(n_reads)])
    return sets


def _indel_sets(n_iso, n_reads, length, n_edits, max_run, seed0):
    """Reads carrying several deletions and insertions of up to max_run
    bases each."""
    rng = np.random.default_rng(seed0)
    sets = []
    for i in range(n_iso):
        true = synthdata.make_genome(length, seed=seed0 + i)
        reads = []
        for _ in range(n_reads):
            r = true
            for _k in range(n_edits):
                p = int(rng.integers(20, len(r) - 20))
                if rng.random() < 0.5:
                    r = r[:p] + r[p + int(rng.integers(1, max_run + 1)):]
                else:
                    ins = "".join("ACGT"[int(x)] for x in
                                  rng.integers(0, 4, max_run))
                    r = r[:p] + ins + r[p:]
            reads.append(encode(r))
        sets.append(reads)
    return sets


@pytest.mark.parametrize("kind,band", [("subst", 20), ("indel", 24),
                                       ("indel_wide", 150)])
def test_pallas_matches_python_oracle(kind, band):
    if kind == "subst":
        sets = _sets(2, 6, 200, 0.03, 31)
    elif kind == "indel":
        sets = _indel_sets(2, 6, 300, 3, 3, 91)
    else:  # band 150 puts the window at W=512
        sets = _indel_sets(2, 5, 420, 4, 5, 17)
    params = PoaParams(band=band, adaptive=True)
    got = poa_consensus_batch(sets, params)
    for ss, cons in zip(sets, got):
        assert decode(poa_consensus(ss, params)) == decode(cons)


def test_mixed_bands_share_dispatches(monkeypatch):
    """Sets with their own bands run in the same lockstep dispatches (one
    per round), each problem with its own band, and match the oracle run
    at that set's band."""
    from mandalorion_tpu.poa import kernels as kn
    sets = _sets(3, 5, 300, 0.03, 7)
    bands = (16, 24, 40)
    calls = []
    orig = kn._dispatch_chunk
    monkeypatch.setattr(kn, "_dispatch_chunk",
                        lambda *a: calls.append(a[6].copy()) or orig(*a))
    got = poa_consensus_batch(sets, PoaParams(adaptive=True), bands)
    assert len(calls) == 4                      # rounds 1..4, one chunk
    assert list(calls[0][:3]) == list(bands)    # per-problem bands
    for ss, b, cons in zip(sets, bands, got):
        p = PoaParams(band=b, adaptive=True)
        assert decode(poa_consensus(ss, p)) == decode(cons)
    with pytest.raises(ValueError, match="one band per set"):
        poa_consensus_batch(sets[:2], PoaParams(adaptive=True), bands)
