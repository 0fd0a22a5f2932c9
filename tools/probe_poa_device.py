#!/usr/bin/env python3
"""Measure the batched graph-POA device kernel's cold and warm throughput
on JAX's default device (bases/s over the same 16x20x2kb workload
bench.py uses for the native engine)."""

import time

import numpy as np


def main():
    from mandalorion_tpu.runtime import enable_compilation_cache
    enable_compilation_cache()
    from mandalorion_tpu.poa.graph import PoaParams
    from mandalorion_tpu.poa.kernels import poa_consensus_batch

    rng = np.random.default_rng(0)

    def noisy(base, err=0.05):
        out = []
        for b in base:
            r = rng.random()
            if r < err * 0.4:
                continue
            if r < err * 0.7:
                out.append(int(rng.integers(0, 4)))
                out.append(int(b))
            elif r < err:
                out.append(int(rng.integers(0, 4)))
            else:
                out.append(int(b))
        return np.array(out, np.uint8)

    sets = []
    for _ in range(16):
        base = rng.integers(0, 4, 2000).astype(np.uint8)
        sets.append([noisy(base) for _ in range(20)])
    params = PoaParams(band=30, adaptive=True)

    bases = sum(len(s) for ss in sets for s in ss)
    t0 = time.time()
    poa_consensus_batch(sets, params)  # cold (compiles)
    cold = time.time() - t0
    t0 = time.time()
    poa_consensus_batch(sets, params)
    warm = time.time() - t0
    print(f"device POA: cold {cold:.1f}s ({bases / cold:.0f} bases/s) "
          f"warm {warm:.1f}s ({bases / warm:.0f} bases/s) "
          f"[{bases} input bases, 16 isoforms x 20 reads x ~2kb]")


if __name__ == "__main__":
    main()
