"""Full-pipeline golden test: the REFERENCE Mando.py run end-to-end (with
stub minimap2 replaying OUR alignments and stub abpoa forcing its
first-sequence consensus fallback) against our pipeline on the same data.

Strict equality: read->isoform assignment (Mando_isoforms.read_stat.txt)
and the quant matrix (same isoform names, same per-sample counts).
Structural equality: filtered-isoform exon architecture (the consensus
SEQUENCES differ by design — star consensus corrects read errors the
reference's fallback keeps — so realigned coordinates may wobble by a few
bases at soft ends; junction structure must match)."""

import os
import stat
import subprocess
import sys

import numpy as np
import pytest

import oracle
import synthdata
from mandalorion_tpu.config import AlignConfig, PipelineConfig
from mandalorion_tpu.io.fastx import revcomp, write_fasta
from mandalorion_tpu.io.psl import read_psl
from mandalorion_tpu.pipeline.stages import run_pipeline

pytestmark = pytest.mark.skipif(
    not oracle.reference_available(), reason="reference tree not mounted")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def golden(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("golden_e2e")
    rng = np.random.default_rng(321)
    genome = synthdata.make_genome(25000, seed=99)
    g1 = [(3000, 3600), (5000, 5500), (7000, 7700)]
    g2 = [(14000, 14800), (16000, 16600)]
    genome = synthdata.plant_introns(genome, g1)
    genome = synthdata.plant_introns(genome, g2, strand="-")
    (tmp / "genome.fasta").write_text(f">chr1\n{genome}\n")
    t1 = synthdata.transcript_seq(genome, g1)
    t2 = revcomp(synthdata.transcript_seq(genome, g2))
    reads = []
    for i in range(30):
        r, _ = synthdata.mutate_read(t1, rng, 0.01)
        reads.append((f"a{i}", r))
    for i in range(18):
        r, _ = synthdata.mutate_read(t2, rng, 0.01)
        reads.append((f"b{i}", r))
    write_fasta(str(tmp / "reads.fasta"), reads)
    (tmp / "ann.gtf").write_text(
        synthdata.gtf_lines("chr1", "G1", "T1", g1)
        + synthdata.gtf_lines("chr1", "G2", "T2", g2, strand="-"))

    # ours (also emits the SAM the reference replay stub uses)
    ours = tmp / "ours"
    cfg = PipelineConfig(align=AlignConfig(emit_sam=True), threads=2)
    run_pipeline(str(ours), str(tmp / "genome.fasta"),
                 str(tmp / "ann.gtf"), str(tmp / "reads.fasta"), cfg)
    reads_sam = ours / "tmp" / "mm2Alignments.sam"

    # stub tools for the reference
    bin_dir = tmp / "bin"
    bin_dir.mkdir()
    mm2 = bin_dir / "minimap2"
    mm2.write_text(f"""#!/bin/bash
for arg in "$@"; do
  if [[ "$arg" == *Isoform_Consensi* ]]; then
    python3 {REPO}/tools/_align_stub.py {tmp}/genome.fasta "$arg"
    exit 0
  fi
done
cat {reads_sam}
""")
    mm2.chmod(0o755)
    (bin_dir / "abpoa").write_text("#!/bin/bash\nexit 0\n")
    (bin_dir / "abpoa").chmod(0o755)
    (bin_dir / "scp").write_text("#!/bin/bash\ncp \"$@\"\n")
    (bin_dir / "scp").chmod(0o755)

    env = dict(os.environ)
    env["PYTHONPATH"] = (os.path.join(REPO, "tests", "stubs")
                         + os.pathsep + env.get("PYTHONPATH", ""))
    env["PATH"] = str(bin_dir) + os.pathsep + env.get("PATH", "")
    ref = tmp / "ref"
    ref.mkdir()
    proc = subprocess.run(
        [sys.executable, os.path.join(oracle.REFERENCE, "Mando.py"),
         "-p", str(ref), "-g", str(tmp / "ann.gtf"),
         "-G", str(tmp / "genome.fasta"),
         "-f", str(tmp / "reads.fasta"),
         "-t", "2", "--mm2_path", str(mm2)],
        env=env, capture_output=True, text=True, timeout=600,
        cwd=str(ref))  # the reference writes ./abpoa.messages to its cwd
    assert proc.returncode == 0, proc.stderr[-2000:]
    return tmp, ours, ref


def test_read_assignment_identical(golden):
    _tmp, ours, ref = golden
    assert (ours / "Mando_isoforms.read_stat.txt").read_text() == \
           (ref / "Mando_isoforms.read_stat.txt").read_text()


def test_quant_identical(golden):
    _tmp, ours, ref = golden
    mine = (ours / "Isoforms.filtered.clean.quant").read_text().splitlines()
    theirs = (ref / "Isoforms.filtered.clean.quant").read_text().splitlines()
    # same isoforms, same counts (header carries the same sample path)
    assert mine == theirs


def test_structures_match(golden):
    _tmp, ours, ref = golden

    def structures(path):
        out = {}
        for r in read_psl(str(path)):
            out[r.q_name] = (r.strand, len(r.block_sizes),
                             tuple(r.t_starts[1:]),  # junction starts
                             tuple(t + s for t, s in
                                   zip(r.t_starts, r.block_sizes))[:-1])
        return out

    mine = structures(ours / "Isoforms.filtered.clean.psl")
    theirs = structures(ref / "Isoforms.filtered.clean.psl")
    assert set(mine) == set(theirs)
    for name in mine:
        assert mine[name] == theirs[name], name


def test_genes_identical(golden):
    """Names, loci, chromosomes, best genes and overlap sets must match;
    locus coordinates get a small tolerance — the reference's consensus is
    a RANDOMLY chosen member read (unseeded permutation, SURVEY §5.9), so
    its realigned ends wobble by a few bases run to run when that read has
    end errors."""
    _tmp, ours, ref = golden
    mine = (ours / "Isoforms.filtered.clean.genes").read_text().splitlines()
    theirs = (ref / "Isoforms.filtered.clean.genes").read_text().splitlines()
    assert len(mine) == len(theirs)
    for m_line, t_line in zip(mine, theirs):
        m = m_line.split("\t")
        t = t_line.split("\t")
        assert m[0] == t[0] and m[1] == t[1] and m[2] == t[2]
        assert abs(int(m[3]) - int(t[3])) <= 10
        assert abs(int(m[4]) - int(t[4])) <= 10
        assert m[5] == t[5]
        assert sorted(m[6].split(",")) == sorted(t[6].split(","))


def test_golden_with_whitelist(tmp_path):
    """-W whitelisting end-to-end vs the reference: polyA BED written from
    the annotation, whitelist honored through module F."""
    rng = np.random.default_rng(55)
    genome = synthdata.make_genome(20000, seed=60)
    g1 = [(3000, 3700), (5000, 5900)]
    genome = synthdata.plant_introns(genome, g1)
    (tmp_path / "genome.fasta").write_text(f">chr1\n{genome}\n")
    t1 = synthdata.transcript_seq(genome, g1)
    reads = []
    for i in range(20):
        r, _ = synthdata.mutate_read(t1, rng, 0.01)
        reads.append((f"w{i}", r))
    write_fasta(str(tmp_path / "reads.fasta"), reads)
    (tmp_path / "ann.gtf").write_text(
        synthdata.gtf_lines("chr1", "G1", "T1", g1, tags=' tag "basic";'))

    ours = tmp_path / "ours"
    cfg = PipelineConfig(align=AlignConfig(emit_sam=True), threads=1,
                         white_list_polyA=("basic",))
    run_pipeline(str(ours), str(tmp_path / "genome.fasta"),
                 str(tmp_path / "ann.gtf"), str(tmp_path / "reads.fasta"),
                 cfg)
    my_bed = (ours / "tmp" / "polyAWhiteList.bed").read_text()
    assert my_bed.strip()

    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    (bin_dir / "minimap2").write_text(f"""#!/bin/bash
for arg in "$@"; do
  if [[ "$arg" == *Isoform_Consensi* ]]; then
    python3 {REPO}/tools/_align_stub.py {tmp_path}/genome.fasta "$arg"
    exit 0
  fi
done
cat {ours}/tmp/mm2Alignments.sam
""")
    (bin_dir / "minimap2").chmod(0o755)
    (bin_dir / "abpoa").write_text("#!/bin/bash\nexit 0\n")
    (bin_dir / "abpoa").chmod(0o755)
    (bin_dir / "scp").write_text("#!/bin/bash\ncp \"$@\"\n")
    (bin_dir / "scp").chmod(0o755)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "tests", "stubs")
    env["PATH"] = str(bin_dir) + os.pathsep + env.get("PATH", "")
    ref = tmp_path / "ref"
    ref.mkdir()
    proc = subprocess.run(
        [sys.executable, os.path.join(oracle.REFERENCE, "Mando.py"),
         "-p", str(ref), "-g", str(tmp_path / "ann.gtf"),
         "-G", str(tmp_path / "genome.fasta"),
         "-f", str(tmp_path / "reads.fasta"),
         "-t", "1", "-W", "basic", "--mm2_path", str(bin_dir / "minimap2")],
        env=env, capture_output=True, text=True, timeout=600,
        cwd=str(ref))  # the reference writes ./abpoa.messages to its cwd
    assert proc.returncode == 0, proc.stderr[-2000:]
    ref_bed = (ref / "tmp" / "polyAWhiteList.bed").read_text()
    assert my_bed == ref_bed
    assert (ours / "Mando_isoforms.read_stat.txt").read_text() == \
           (ref / "Mando_isoforms.read_stat.txt").read_text()
    assert (ours / "Isoforms.filtered.clean.quant").read_text() == \
           (ref / "Isoforms.filtered.clean.quant").read_text()


@pytest.mark.skip(reason=(
    "UNVERIFIED vs real abPOA: the abpoa binary is absent in this "
    "environment (zero egress), so byte-equality of Isoform_Consensi.fasta "
    "against `abpoa -M 5 -r 0 [-S]` (SpliceDefineConsensus.py:915-919) "
    "cannot be tested. What IS verified: the graph engine implements "
    "abPOA's convex dual-affine scoring model and is optimal vs a "
    "brute-force convex Gotoh oracle (tests/test_poa.py), and the device "
    "kernel is bit-identical to the Python engine. abPOA's exact traceback "
    "tie-break order and adaptive-band shape remain unpinned."))
def test_consensus_fasta_matches_real_abpoa_binary():
    raise AssertionError("requires the real abpoa binary")
