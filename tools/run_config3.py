#!/usr/bin/env python3
"""Config-3-scale integration run (BASELINE.md): chromosome-scale genome,
~100k reads, full APDFQ with per-stage timing. Validates robustness and
throughput beyond the bench workload.

Usage: python tools/run_config3.py [n_genes] [reads_per_gene] [genome_mbp]
"""

import json
import os
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main():
    from mandalorion_tpu.config import PipelineConfig
    from mandalorion_tpu.pipeline.stages import run_pipeline
    from mandalorion_tpu.utils.simulate import make_chromosome_dataset

    n_genes = int(sys.argv[1]) if len(sys.argv) > 1 else 100
    per_gene = int(sys.argv[2]) if len(sys.argv) > 2 else 1000
    mbp = int(sys.argv[3]) if len(sys.argv) > 3 else 50

    tmp = tempfile.mkdtemp(prefix="config3_")
    print(f"generating {mbp} Mbp genome and {n_genes * per_gene} reads ...",
          flush=True)
    t_gen = time.time()
    make_chromosome_dataset(tmp, n_genes, per_gene, mbp)
    print(f"  ({time.time() - t_gen:.0f}s)", flush=True)

    n_reads = n_genes * per_gene
    cfg = PipelineConfig()
    t0 = time.time()
    run_pipeline(os.path.join(tmp, "out"),
                 os.path.join(tmp, "genome.fasta"),
                 os.path.join(tmp, "ann.gtf"),
                 os.path.join(tmp, "reads.fasta"), cfg)
    dt = time.time() - t0

    out = os.path.join(tmp, "out")
    n_iso = sum(1 for l in open(os.path.join(out, "Isoforms.filtered.fasta"))
                if l.startswith(">"))
    quant_lines = sum(1 for _ in open(
        os.path.join(out, "Isoforms.filtered.clean.quant"))) - 1
    timing = open(os.path.join(out, "tmp", "timing.tsv")).read()
    print(timing)
    print(json.dumps({
        "n_reads": n_reads, "genome_mbp": mbp, "wall_s": round(dt, 1),
        "reads_per_s": round(n_reads / dt, 1),
        "isoforms": n_iso, "quant_rows": quant_lines,
        "expected_isoforms": n_genes,
    }))


if __name__ == "__main__":
    main()
