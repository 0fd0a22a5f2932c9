#!/usr/bin/env python3
"""Profile the device-path module A (chain=device dp=rowscan) on the bench
workload: per-phase wall attribution (chain dispatch+fetch / DP
dispatch+fetch / native staging, the rest) against the host path.

Usage: python tools/profile_device_path.py [n_reads_per_gene]
"""

import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import numpy as np
    from mandalorion_tpu.config import AlignConfig
    from mandalorion_tpu.utils.simulate import make_dataset
    from mandalorion_tpu.align.aligner import SpliceAligner
    from mandalorion_tpu.io.fastx import read_fastx, fastx_to_dict

    rpg = int(sys.argv[1]) if len(sys.argv) > 1 else 75
    with tempfile.TemporaryDirectory() as tmp:
        n = make_dataset(tmp, n_genes=4, n_reads_per_gene=rpg,
                         genome_len=120_000)
        genome = fastx_to_dict(os.path.join(tmp, "genome.fasta"))
        reads = [(nm, sq) for nm, sq, _q in
                 read_fastx(os.path.join(tmp, "reads.fasta"))]
        cfg = AlignConfig(chain_backend="device", dp_backend="rowscan")
        al = SpliceAligner(genome, cfg)
        host = SpliceAligner(genome, AlignConfig())

        # warm both paths (compiles, native lib)
        out_dev = al.map_batch(reads)
        out_host = host.map_batch(reads)
        assert len(out_dev) == len(out_host) == n, (len(out_dev), n)
        assert all(str(a) == str(b) for a, b in zip(out_dev, out_host)), \
            "device/host mismatch"

        # host reference timing
        t0 = time.time()
        host.map_batch(reads)
        t_host = time.time() - t0

        # phase attribution on the device path: monkeypatch boundaries
        import mandalorion_tpu.align.chain_kernel as ck
        import mandalorion_tpu.align.kernels as kn
        times = {}
        orig_chain = ck.chain_batch_rows
        orig_solve = kn.solve_dp_fused

        def timed_chain(*a, **k):
            t = time.time()
            r = orig_chain(*a, **k)
            times["chain_total"] = times.get("chain_total", 0) \
                + time.time() - t
            return r

        def timed_solve(*a, **k):
            t = time.time()
            r = orig_solve(*a, **k)
            times["dp_total"] = times.get("dp_total", 0) + time.time() - t
            return r

        # the staged path imports both at call time from their modules
        ck.chain_batch_rows = timed_chain
        kn.solve_dp_fused = timed_solve

        t0 = time.time()
        al.map_batch(reads)
        t_dev = time.time() - t0
        ck.chain_batch_rows = orig_chain
        kn.solve_dp_fused = orig_solve

        staging = t_dev - times.get("chain_total", 0) \
            - times.get("dp_total", 0)
        print(f"\nreads={n}")
        print(f"host module A:            {t_host*1000:8.1f} ms")
        print(f"device module A:          {t_dev*1000:8.1f} ms")
        print(f"  chain (stage+disp+fetch):{times.get('chain_total',0)*1000:7.1f} ms")
        print(f"  dp    (stage+disp+fetch):{times.get('dp_total',0)*1000:7.1f} ms")
        print(f"  native staging (rest):   {staging*1000:7.1f} ms")

        # finer: cProfile the device batch
        import cProfile
        import pstats
        pr = cProfile.Profile()
        pr.enable()
        al.map_batch(reads)
        pr.disable()
        st = pstats.Stats(pr)
        st.sort_stats("cumulative")
        print("\ntop cumulative:")
        st.print_stats(22)


if __name__ == "__main__":
    main()
