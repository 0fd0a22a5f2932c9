#!/usr/bin/env python3
"""Batched graph-POA kernel throughput (banded storage, poa/kernels.py).

Measures input bases/sec through `poa_consensus_batch` at a given batch
width — the per-locus isoform axis the pipeline's module D batches over —
plus the sequential Python engine for reference. Runs on whatever device
JAX selects (its default accelerator; pass --cpu to force the host).
Prints one JSON line.
"""

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--isoforms", type=int, default=64)
    ap.add_argument("--reads", type=int, default=12)
    ap.add_argument("--length", type=int, default=800)
    ap.add_argument("--python-engine", action="store_true",
                    help="also time the sequential PoaGraph engine")
    args = ap.parse_args()
    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")

    import numpy as np
    import synthdata
    from mandalorion_tpu.align.encode import encode
    from mandalorion_tpu.poa.graph import PoaParams, poa_consensus
    from mandalorion_tpu.poa.kernels import poa_consensus_batch

    rng = np.random.default_rng(0)
    seq_sets, truths = [], []
    for i in range(args.isoforms):
        true = synthdata.make_genome(args.length, seed=500 + i)
        reads = []
        for _r in range(args.reads):
            seq, _ = synthdata.mutate_read(true, rng, 0.01)
            reads.append(encode(seq))
        seq_sets.append(reads)
        truths.append(true)
    total_bases = sum(len(s) for ss in seq_sets for s in ss)
    params = PoaParams()

    poa_consensus_batch(seq_sets, params)  # compile warmup (same shapes)
    t0 = time.time()
    consensi = poa_consensus_batch(seq_sets, params)
    dt = time.time() - t0
    from mandalorion_tpu.align.encode import decode
    exact = sum(int(decode(c) == t) for c, t in zip(consensi, truths))

    out = {
        "metric": "graph-POA kernel input bases per sec (batched)",
        "bases_per_s": round(total_bases / dt),
        "isoforms": args.isoforms,
        "reads_per_isoform": args.reads,
        "read_len": args.length,
        "exact_consensus": f"{exact}/{args.isoforms}",
        "wall_s": round(dt, 2),
    }
    if args.python_engine:
        t0 = time.time()
        for ss in seq_sets:
            poa_consensus(ss, params)
        out["python_engine_bases_per_s"] = round(
            total_bases / (time.time() - t0))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
