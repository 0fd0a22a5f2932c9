"""Splice aligner tests: recover planted transcript structures exactly on
synthetic genomes, handle strand, clips, substitutions, and indels."""

import numpy as np
import pytest

import synthdata
from mandalorion_tpu.align import SpliceAligner
from mandalorion_tpu.align.chain import chain_segments, collapse_anchors
from mandalorion_tpu.align.encode import encode, kmer_hashes, minimizers
from mandalorion_tpu.align.extend import DpProblem, solve_dp_numpy
from mandalorion_tpu.align.index import build_index
from mandalorion_tpu.config import AlignConfig
from mandalorion_tpu.io.fastx import revcomp

EXONS = [(1000, 1400), (2000, 2400), (3000, 3600)]


@pytest.fixture(scope="module")
def setup():
    genome = synthdata.make_genome(12000, seed=42)
    genome = synthdata.plant_introns(genome, EXONS)
    aligner = SpliceAligner({"chr1": genome})
    return genome, aligner


def test_kmer_hash_consistency():
    codes = encode("ACGTACGTTGCAACGTT")
    h, valid = kmer_hashes(codes, 5)
    assert valid.all()
    # same k-mer at different positions hashes identically
    codes2 = encode("TTTTTACGTA")
    h2, _ = kmer_hashes(codes2, 5)
    assert h2[5] == h[0]
    # non-ACGT invalidates covering k-mers
    h3, v3 = kmer_hashes(encode("ACGTNACGTACGT"), 5)
    assert not v3[0] and not v3[4] and v3[5]


def test_minimizers_cover():
    codes = encode(synthdata.make_genome(2000, seed=1))
    pos, hsh = minimizers(codes, 15, 5)
    assert len(pos) > 2000 / 6  # density ~2/(w+1)
    assert (np.diff(pos) > 0).all()
    assert (np.diff(pos) <= 5).all()  # a minimizer at least every w


def test_chain_collapse():
    q = np.array([0, 10, 20, 100, 110], np.int64)
    t = np.array([500, 510, 520, 1600, 1610], np.int64)
    segs = collapse_anchors(q, t, 15)
    assert len(segs) == 2
    chain, score = chain_segments(segs, min_intron=30, max_intron=400000)
    assert len(chain) == 2
    assert chain[0].t_start == 500 and chain[1].t_start == 1600


def test_dp_global_and_extend():
    cfg = AlignConfig()
    q = encode("ACGTACGTAC")
    t = encode("ACGTTACGTAC")  # one T inserted in target => deletion
    res = solve_dp_numpy([DpProblem(q, t, "global")], cfg)[0]
    assert sum(dq for _o, dq, _dt in res.ops) == len(q)
    assert sum(dt for _o, _dq, dt in res.ops) == len(t)
    assert any(o == "D" for o, _q, _t in res.ops)
    # extend stops at divergence
    q2 = encode("ACGTACGTAAAAAAAA")
    t2 = encode("ACGTACGTCCCCCCCC")
    r2 = solve_dp_numpy([DpProblem(q2, t2, "extend_right")], cfg)[0]
    assert r2.q_len == 8 and r2.t_len == 8


def test_perfect_spliced_read(setup):
    genome, aligner = setup
    seq = synthdata.transcript_seq(genome, EXONS)
    recs = aligner.map_batch([("readP", seq)])
    assert len(recs) == 1
    r = recs[0]
    assert r.strand == "+"
    assert r.t_name == "chr1"
    assert r.t_starts == [s for s, _ in EXONS]
    assert r.block_sizes == [e - s for s, e in EXONS]
    assert r.mismatches == 0
    assert r.q_start == 0 and r.q_end == len(seq)
    assert r.accuracy == 1.0
    assert r.n_count == (2000 - 1400) + (3000 - 2400)
    # cs introns carry canonical motifs
    assert "~gt600ag" in r.cs and "~gt" in r.cs


def test_reverse_strand_read():
    # a true '-'-strand transcript: ct..ac introns on genome forward,
    # read = revcomp of the concatenated exons
    genome = synthdata.make_genome(12000, seed=43)
    genome = synthdata.plant_introns(genome, EXONS, strand="-")
    aligner = SpliceAligner({"chr1": genome})
    read = revcomp(synthdata.transcript_seq(genome, EXONS))
    recs = aligner.map_batch([("readR", read)])
    assert len(recs) == 1
    r = recs[0]
    assert r.strand == "-"
    assert r.t_starts == [s for s, _ in EXONS]
    assert r.block_sizes == [e - s for s, e in EXONS]
    assert r.mismatches == 0
    assert "~ct600ac" in r.cs
    assert r.sequence == read  # col 23 = original read orientation


def test_clipped_read(setup):
    genome, aligner = setup
    seq = synthdata.transcript_seq(genome, EXONS)
    padded = "CCCCC" + seq + "GGGGGGG"
    # pads are random-ish vs genome; extension should stop at the junk
    recs = aligner.map_batch([("readC", padded)])
    r = recs[0]
    assert r.t_starts[0] == 1000
    assert r.t_start == 1000 and r.t_end == 3600
    assert r.q_start <= 5 and len(padded) - r.q_end <= 7


def test_substitutions(setup):
    genome, aligner = setup
    rng = np.random.default_rng(9)
    seq = synthdata.transcript_seq(genome, EXONS)
    noisy, subs = synthdata.mutate_read(seq, rng, 0.02)
    recs = aligner.map_batch([("readS", noisy)])
    r = recs[0]
    assert r.t_starts == [s for s, _ in EXONS]
    assert r.matches + r.mismatches == len(seq)
    assert 0 < r.mismatches <= subs
    assert r.accuracy > 0.95
    assert r.cs.count("*") == r.mismatches


def test_indel_read(setup):
    genome, aligner = setup
    seq = synthdata.transcript_seq(genome, EXONS)
    # 3-base deletion inside exon 1, 2-base insertion inside exon 3
    mid1 = 200
    mid3 = 400 + 400 + 300
    mutated = seq[:mid1] + seq[mid1 + 3:mid3] + "GG" + seq[mid3:]
    recs = aligner.map_batch([("readI", mutated)])
    r = recs[0]
    assert r.t_start == 1000 and r.t_end == 3600
    assert r.t_base_insert == 3      # deletion from read view
    assert r.q_base_insert == 2
    assert r.n_count == 1200
    assert r.accuracy > 0.95


def test_multi_chrom_and_unmapped(setup):
    genome, _ = setup
    genome2 = synthdata.make_genome(8000, seed=99)
    aligner = SpliceAligner({"chrA": genome, "chrB": genome2})
    seq = genome2[3000:3800]
    recs = aligner.map_batch([
        ("hit", seq),
        ("junk", "ACGT" * 10),
    ])
    assert len(recs) == 1
    assert recs[0].t_name == "chrB"
    assert recs[0].t_start == 3000 and recs[0].t_end == 3800


def test_dp_backend_rowscan_identical(setup):
    import numpy as np
    from mandalorion_tpu.io.psl import format_psl
    genome, _ = setup
    rng = np.random.default_rng(13)
    seq = synthdata.transcript_seq(genome, EXONS)
    reads = []
    for i in range(6):
        r, _ = synthdata.mutate_read(seq, rng, 0.02)
        p = int(rng.integers(100, 1200))
        r = r[:p] + r[p + 2:]  # force an indel DP problem
        reads.append((f"x{i}", r))
    a_np = SpliceAligner({"chr1": genome}, AlignConfig(dp_backend="numpy"))
    a_js = SpliceAligner({"chr1": genome}, AlignConfig(dp_backend="rowscan"))
    out_np = [format_psl(r) for r in a_np.map_batch(reads)]
    out_js = [format_psl(r) for r in a_js.map_batch(reads)]
    assert out_np == out_js


def test_host_twin_identical_and_shares_index(setup):
    """host_twin pins a device-configured aligner to the host backends
    without rebuilding the index, and its alignments are bit-identical —
    the invariant behind module F's tiny-batch host routing
    (pipeline/stages.py)."""
    from mandalorion_tpu.io.psl import format_psl
    genome, _ = setup
    rng = np.random.default_rng(17)
    seq = synthdata.transcript_seq(genome, EXONS)
    reads = []
    for i in range(5):
        r, _ = synthdata.mutate_read(seq, rng, 0.02)
        reads.append((f"t{i}", r))
    a_dev = SpliceAligner({"chr1": genome},
                          AlignConfig(chain_backend="device",
                                      dp_backend="rowscan"))
    twin = a_dev.host_twin()
    assert twin.index is a_dev.index and twin.max_occ == a_dev.max_occ
    assert twin.cfg.chain_backend == "native"
    assert twin.cfg.dp_backend == "numpy"
    out_dev = [format_psl(r) for r in a_dev.map_batch(reads)]
    out_twin = [format_psl(r) for r in twin.map_batch(reads)]
    assert out_dev == out_twin and out_dev
    # already-host aligners come back unchanged
    a_host = SpliceAligner({"chr1": genome}, AlignConfig())
    assert a_host.host_twin() is a_host


def test_index_chunk_boundaries_lossless():
    """Chunked index building must produce the same minimizer set as a
    single-chunk build (windows spanning chunk boundaries included)."""
    from mandalorion_tpu.align.index import build_index
    genome = {"c": synthdata.make_genome(5000, seed=71)}
    a = build_index(genome, 15, 5, chunk=1000)
    b = build_index(genome, 15, 5, chunk=1 << 24)
    assert np.array_equal(a.sorted_hashes, b.sorted_hashes)
    assert np.array_equal(a.sorted_positions, b.sorted_positions)


def test_alignment_accuracy_guard():
    """Accuracy regression guard: 400 noisy reads (1% sub + occasional
    indels) from 12 multi-exon genes must recover exact exon structures
    for >= 99% of reads."""
    rng = np.random.default_rng(99)
    genome = synthdata.make_genome(400_000, seed=90)
    genes = []
    glist = list(genome)
    for g in range(12):
        base = 10_000 + g * 30_000
        exons = []
        pos = base
        for _ in range(int(rng.integers(2, 5))):
            ln = int(rng.integers(200, 800))
            exons.append((pos, pos + ln))
            pos += ln + int(rng.integers(200, 5000))
        for (s1, e1), (s2, e2) in zip(exons, exons[1:]):
            glist[e1], glist[e1 + 1] = "G", "T"
            glist[s2 - 2], glist[s2 - 1] = "A", "G"
        genes.append(exons)
    genome = "".join(glist)
    aligner = SpliceAligner({"chr1": genome})
    reads = []
    truth = []
    for gi, exons in enumerate(genes):
        t = synthdata.transcript_seq(genome, exons)
        for ri in range(34):
            r, _ = synthdata.mutate_read(t, rng, 0.01)
            if ri % 5 == 0:  # occasional small indel
                p = int(rng.integers(50, len(r) - 50))
                r = r[:p] + r[p + 2:] if ri % 10 else r[:p] + "AC" + r[p:]
            reads.append((f"g{gi}r{ri}", r))
            truth.append(tuple(s for s, _ in exons))
    from mandalorion_tpu.core.cleanpsl import clean_record
    recs = {r.q_name: r for r in aligner.map_batch(reads)}
    exact = 0
    close = 0
    for (name, _seq), t_starts in zip(reads, truth):
        rec = recs.get(name)
        if rec is None:
            continue
        # PSL blocks split at every indel (emtrey model); exon structure
        # emerges after the pipeline's small-gap merge (clean_psl)
        cleaned = clean_record(rec)
        got = tuple(cleaned.t_starts)
        if got == t_starts:
            exact += 1
            close += 1
        elif len(got) == len(t_starts) and all(
                abs(a - b) <= 6 for a, b in zip(got, t_starts)):
            # reads with errors at their first bases soft-clip 1-3 nt
            # (minimap2 does the same); error-adjacent junctions can slide
            # within the motif-search slack — the peak callers' windows
            # absorb both
            close += 1
    n = len(reads)
    assert exact / n >= 0.95, f"exact {exact}/{n}"
    assert close / n >= 0.995, f"within-6 {close}/{n}"


def test_adaptive_occ_cap_maps_tandem_repeats():
    """minimap2 -f analogue: a high-copy tandem array (every minimizer
    above the max_occ floor) still seeds because the cap rises to the
    index's top-frequency quantile; ordinary genomes keep the floor."""
    from mandalorion_tpu.align.index import frequency_occ_cap

    rng = np.random.default_rng(0)
    unique = synthdata.make_genome(400_000, seed=1)
    tandem = synthdata.make_genome(200, seed=3) * 300  # 60 kb, 300 copies
    genome = unique + tandem
    al = SpliceAligner({"chr1": genome}, AlignConfig())
    assert al.max_occ > al.cfg.max_occ  # the quantile raised the cap
    reads = []
    for i in range(10):
        s = 400_000 + int(rng.integers(0, 58_000))
        reads.append((f"t{i}",
                      synthdata.mutate_read(genome[s:s + 1500], rng,
                                            0.02)[0]))
    res = al.map_batch(reads)
    assert len(res) == 10  # previously 0: all seeds were over-frequent

    # ordinary genome: quantile tiny, the floor rules
    plain = SpliceAligner({"chr1": unique}, AlignConfig())
    assert plain.max_occ == plain.cfg.max_occ
    assert frequency_occ_cap(plain.index, 0.0, 200) == 200  # disabled


def test_occ_hist_quantile_matches_direct():
    """frequency_occ_cap via the persisted occurrence histogram gives
    exactly the direct np.quantile-over-run-lengths result."""
    from mandalorion_tpu.align.index import (
        _quantile_from_hist, build_index, occurrence_histogram)

    unique = synthdata.make_genome(150_000, seed=21)
    tandem = synthdata.make_genome(150, seed=22) * 120
    idx = build_index({"chr1": unique + tandem})
    h = np.asarray(idx.sorted_hashes)
    starts = np.append(True, h[1:] != h[:-1])
    lens = np.diff(np.flatnonzero(np.append(starts, True)))
    hist = occurrence_histogram(h)
    assert int(hist.sum()) == len(lens)
    for q in (0.5, 0.9, 0.999, 0.9998, 1.0):
        assert _quantile_from_hist(hist, q) == pytest.approx(
            float(np.quantile(lens, q))), q


@pytest.mark.parametrize("err,min_exact,min_close", [
    (0.03, 0.80, 0.96),
    (0.05, 0.70, 0.92),
    (0.08, 0.55, 0.85),
])
def test_error_rate_accuracy_gates(err, min_exact, min_close):
    """Quantitative module-A gates at nanopore-like error rates (VERDICT
    r1 #8): the measured figures (100% mapped; 100/97/97% structures within
    6 nt and 86/78/66% exact at 3/5/8% error) asserted as CI gates with
    margin, so aligner regressions fail tests rather than only showing up
    in prose."""
    rng = np.random.default_rng(int(err * 1000))
    genome = synthdata.make_genome(300_000, seed=71)
    genes = []
    glist = list(genome)
    for g in range(8):
        base = 10_000 + g * 35_000
        exons = []
        pos = base
        for _ in range(int(rng.integers(2, 5))):
            ln = int(rng.integers(250, 800))
            exons.append((pos, pos + ln))
            pos += ln + int(rng.integers(300, 6000))
        for (s1, e1), (s2, e2) in zip(exons, exons[1:]):
            glist[e1], glist[e1 + 1] = "G", "T"
            glist[s2 - 2], glist[s2 - 1] = "A", "G"
        genes.append(exons)
    genome = "".join(glist)
    aligner = SpliceAligner({"chr1": genome})
    reads, truth = [], []
    for gi, exons in enumerate(genes):
        t = synthdata.transcript_seq(genome, exons)
        for ri in range(25):
            r, _ = synthdata.mutate_read(t, rng, err)
            reads.append((f"g{gi}r{ri}", r))
            truth.append(tuple(s for s, _ in exons))
    from mandalorion_tpu.core.cleanpsl import clean_record
    recs = {r.q_name: r for r in aligner.map_batch(reads)}
    n = len(reads)
    assert len(recs) == n, f"mapping rate {len(recs)}/{n} at {err}"
    exact = close = 0
    for (name, _seq), t_starts in zip(reads, truth):
        cleaned = clean_record(recs[name])
        got = tuple(cleaned.t_starts)
        if got == t_starts:
            exact += 1
            close += 1
        elif len(got) == len(t_starts) and all(
                abs(a - b) <= 6 for a, b in zip(got, t_starts)):
            close += 1
    assert exact / n >= min_exact, f"exact {exact}/{n} at {err}"
    assert close / n >= min_close, f"within-6 {close}/{n} at {err}"
