"""Multi-device sharding tests on the 8-device virtual CPU mesh:
sharded scoring, quant psum merge, the mesh count-matrix collective, and
the REAL pipeline sharded end-to-end (byte-identical at N = 1, 2, 8 —
SURVEY §4 distributed level)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from mandalorion_tpu.parallel.dist import (
    _score_batch, mesh_count_matrix, sharded_batch_score,
    sharded_quant_merge)
from mandalorion_tpu.parallel.mesh import make_mesh, use_mesh


def _batch(rng, b, l):
    q = jnp.asarray(rng.integers(0, 4, size=(b, l)), jnp.int32)
    t = jnp.asarray(rng.integers(0, 4, size=(b, 128)), jnp.int32)
    return q, t


def test_devices_available():
    assert len(jax.devices()) == 8


@pytest.mark.parametrize("n", [1, 2, 8])
def test_sharded_scores_match_local(n):
    rng = np.random.default_rng(3)
    mesh = make_mesh(n, ("reads",))
    q, t = _batch(rng, 8 * n, 48)
    local = _score_batch(q, t)
    sharded = sharded_batch_score(mesh, q, t)
    assert np.array_equal(np.asarray(local), np.asarray(sharded))


def test_quant_merge_psum():
    mesh = make_mesh(4, ("reads",))
    rng = np.random.default_rng(4)
    partials = jnp.asarray(rng.integers(0, 5, size=(4, 6, 3)), jnp.int32)
    merged = sharded_quant_merge(mesh, partials)
    assert np.array_equal(np.asarray(merged),
                          np.asarray(partials.sum(axis=0)))


@pytest.mark.parametrize("n", [1, 2, 8])
def test_mesh_count_matrix(n):
    """The quant count psum merge == np.bincount, exactly (module Q's
    collective), including ragged (non-device-multiple) id streams."""
    rng = np.random.default_rng(5)
    mesh = make_mesh(n)
    for size in (0, 1, 7, 64, 101):
        ids = rng.integers(0, 30, size=size)
        got = mesh_count_matrix(mesh, ids, 30)
        expect = np.bincount(ids, minlength=30)
        assert np.array_equal(got, expect), (n, size)


@pytest.mark.parametrize("n", [2, 4, 8])
def test_sharded_index_lookup_matches_local(n):
    """Hash-axis index sharding over every device of a (possibly 2-D)
    mesh: per-device searchsorted + psum of the hit ranges, then a
    sharded gather of the kept positions == GenomeIndex.lookup on the
    replicated index, for several read orientations in one lookup."""
    import synthdata
    from mandalorion_tpu.align.encode import encode, minimizers
    from mandalorion_tpu.align.index import build_index
    from mandalorion_tpu.parallel.dist import ShardedIndex
    from mandalorion_tpu.parallel.mesh import make_mesh

    genome = {"chr1": synthdata.make_genome(60_000, seed=31),
              "chr2": synthdata.make_genome(30_000, seed=32)}
    idx = build_index(genome)
    rng = np.random.default_rng(7)
    groups = []
    for _ in range(3):
        s = int(rng.integers(0, 50_000))
        read, _ = synthdata.mutate_read(genome["chr1"][s:s + 2000], rng,
                                        0.05)
        groups.append(minimizers(encode(read), 15, 5)[1])
    max_occ = 8
    sharded = ShardedIndex(make_mesh(n), idx)
    assert sharded.mesh.devices.size == n
    off = np.cumsum([0] + [len(h) for h in groups])
    got_q, got_p = sharded.lookup(np.concatenate(groups), max_occ, off)
    for g, hashes in enumerate(groups):
        ref_q, ref_p = idx.lookup(hashes, max_occ)
        sel = (got_q >= off[g]) & (got_q < off[g + 1])
        assert len(ref_q) > 0
        assert np.array_equal(got_q[sel] - off[g], ref_q)
        assert np.array_equal(got_p[sel], ref_p)
    one_q, one_p = sharded.lookup(groups[0], max_occ)
    ref_q, ref_p = idx.lookup(groups[0], max_occ)
    assert np.array_equal(one_q, ref_q) and np.array_equal(one_p, ref_p)


# --------------------------- real pipeline sharded over the mesh ----------

def _run_small_pipeline(tmp, out, cfg, mesh=None):
    import os

    from mandalorion_tpu.pipeline.stages import run_pipeline
    ctx = use_mesh(mesh)
    with ctx:
        run_pipeline(os.path.join(tmp, out),
                     os.path.join(tmp, "genome.fasta"),
                     os.path.join(tmp, "ann.gtf"),
                     os.path.join(tmp, "reads.fasta"), cfg)
    blobs = {}
    for name in ("Isoforms.filtered.fasta", "Isoforms.filtered.clean.psl",
                 "Isoforms.filtered.clean.quant",
                 "Isoforms.filtered.clean.tpm"):
        with open(os.path.join(tmp, out, name), "rb") as fh:
            blobs[name] = fh.read()
    with open(os.path.join(tmp, out, "tmp", "reads2isoforms.txt"),
              "rb") as fh:
        blobs["r2i"] = fh.read()
    return blobs


@pytest.mark.parametrize("n", [1, 2, 8])
def test_pipeline_sharded_byte_identical(n, tmp_path):
    """The production APDFQ pipeline with every batched device dispatch
    sharded over an n-device mesh (chain DP on 'reads', DP fills, POA
    graph DP on 'loci', quant count psum) produces byte-identical
    artifacts to the single-device run (VERDICT r1 #1)."""
    from mandalorion_tpu.config import AlignConfig, PipelineConfig, PoaConfig
    from mandalorion_tpu.utils.simulate import make_dataset

    tmp = str(tmp_path)
    make_dataset(tmp, n_genes=2, n_reads_per_gene=12, genome_len=40_000)
    cfg = PipelineConfig(
        threads=1,
        align=AlignConfig(chain_backend="device", dp_backend="rowscan"),
        poa=PoaConfig(engine="graph"))
    ref = _run_small_pipeline(tmp, "out1", cfg, mesh=None)
    assert len(ref["Isoforms.filtered.fasta"]) > 0
    got = _run_small_pipeline(tmp, f"out{n}", cfg, mesh=make_mesh(n))
    for name in ref:
        assert got[name] == ref[name], name


@pytest.mark.parametrize("n", [2, 8])
def test_pipeline_sharded_index_byte_identical(n, tmp_path):
    """End-to-end sharded GENOME INDEX (AlignConfig.index_backend=
    'sharded'): seed lookups run against hash-range shards over the mesh
    (parallel.dist.ShardedIndex) through the full production
    aligner, and every artifact is byte-identical to the replicated-index
    run (VERDICT r2 #5)."""
    from mandalorion_tpu.config import AlignConfig, PipelineConfig
    from mandalorion_tpu.utils.simulate import make_dataset

    tmp = str(tmp_path)
    make_dataset(tmp, n_genes=2, n_reads_per_gene=10, genome_len=40_000)
    base = PipelineConfig(threads=1)
    ref = _run_small_pipeline(tmp, "rep", base, mesh=None)
    assert len(ref["Isoforms.filtered.fasta"]) > 0
    cfg = PipelineConfig(
        threads=1, align=AlignConfig(index_backend="sharded"))
    got = _run_small_pipeline(tmp, f"sh{n}", cfg, mesh=make_mesh(n))
    for name in ref:
        assert got[name] == ref[name], name


def test_cli_devices_flag_byte_identical(tmp_path):
    """`mando-tpu --devices N` installs the mesh around the run (VERDICT
    r2 #6): output matches the meshless CLI run byte for byte."""
    from mandalorion_tpu.pipeline.cli import main as cli_main
    from mandalorion_tpu.utils.simulate import make_dataset

    tmp = str(tmp_path)
    make_dataset(tmp, n_genes=2, n_reads_per_gene=10, genome_len=40_000)
    common = ["-G", f"{tmp}/genome.fasta", "-g", f"{tmp}/ann.gtf",
              "-f", f"{tmp}/reads.fasta", "-t", "1"]
    assert cli_main(["-p", f"{tmp}/o1"] + common) == 0
    assert cli_main(["-p", f"{tmp}/o4", "--devices", "4",
                     "--index_backend", "sharded"] + common) == 0
    for name in ("Isoforms.filtered.fasta", "Isoforms.filtered.clean.psl",
                 "Isoforms.filtered.clean.quant"):
        with open(f"{tmp}/o1/{name}", "rb") as a, \
                open(f"{tmp}/o4/{name}", "rb") as b:
            assert a.read() == b.read(), name


def test_dispatch_batch_pads_and_slices():
    """dispatch_batch under a 4-device mesh pads a ragged batch to the
    device multiple and slices every output back: the same values as
    the meshless call."""
    from mandalorion_tpu.parallel.mesh import dispatch_batch
    fn = jax.jit(lambda a, b: (a * 2 + b[:, None], b.sum() + 0 * b))
    a = np.arange(18, dtype=np.int32).reshape(6, 3)
    b = np.arange(6, dtype=np.int32)
    ref = dispatch_batch(fn, [a, b])
    with use_mesh(make_mesh(4)):
        got = dispatch_batch(fn, [a, b])
    assert got[0].shape == (6, 3) and got[1].shape == (6,)
    assert np.array_equal(got[0], ref[0])
    assert np.array_equal(got[1], ref[1])


@pytest.mark.parametrize("n", [2, 4])
def test_staged_module_a_under_mesh(n, tmp_path, monkeypatch):
    """With a replicated index, module A keeps the native staged path
    under a mesh (the chain and fused-DP dispatches shard their batch)
    and emits byte-identical records; the Python staging never runs."""
    import os
    from mandalorion_tpu.align.aligner import SpliceAligner
    from mandalorion_tpu.config import AlignConfig
    from mandalorion_tpu.io.fastx import fastx_to_dict, read_fastx
    from mandalorion_tpu.native import load_native
    from mandalorion_tpu.utils.simulate import make_dataset
    if load_native() is None:
        pytest.skip("native library unavailable")
    d = str(tmp_path)
    make_dataset(d, n_genes=2, n_reads_per_gene=10, genome_len=40_000)
    genome = fastx_to_dict(os.path.join(d, "genome.fasta"))
    reads = [(nm, sq) for nm, sq, _q in
             read_fastx(os.path.join(d, "reads.fasta"))]
    dev = SpliceAligner(genome, AlignConfig(chain_backend="device",
                                            dp_backend="rowscan"))
    ref = [str(r) for r in dev.map_batch(reads)]
    assert ref

    def no_python_staging(*_a, **_k):
        raise AssertionError("module A left the native staged path")

    monkeypatch.setattr(SpliceAligner, "_chain_batch_device",
                        no_python_staging)
    with use_mesh(make_mesh(n)):
        got = [str(r) for r in dev.map_batch(reads)]
    assert got == ref
