#!/usr/bin/env python3
"""Smoke test of the pipeline's device route on one GPU.

    python chip_smoke.py [--seed N]               # phases `kernels`, `pipeline`
    python chip_smoke.py --devices 4 [--seed N]   # only the 4-card mesh phase

Runs in one process that owns the card. Exits nonzero, with no `ok` line,
when JAX's default device is not a GPU, when any device result differs
from the host engine, or when any phase raises; it never falls back to the
CPU. The last stdout line is
`{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}`.

Phases:
- kernels: compiles every device kernel class at real widths (chain DP
  at 64-512 segments x 1024 candidates, the fused affine DP at every
  (width, rows) class with its fixed batch, the graph-POA forward + walk
  at W 256-2048) and requires exact equality with the host engines
  (seed_chain_c, solve_dp_native, the native POA engine). Every kernel is
  integer DP or float32 add/compare without a matrix product, so the
  tolerance is equality.
- pipeline: `mando-tpu` on the config-3 shape cut to 200 reads per gene,
  device backends vs host backends on the same data in this process;
  the 7 user-facing output files must be byte-identical.
- --devices 4: the same on a 4-card mesh, plain and with the sharded
  index, each byte-compared with the 1-card device run.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

# the user-facing outputs of one run (out dir), compared byte for byte
OUTPUT_FILES = (
    "Isoforms.filtered.fasta", "Isoforms.filtered.clean.psl",
    "Isoforms.filtered.clean.gtf", "Isoforms.filtered.clean.quant",
    "Isoforms.filtered.clean.tpm", "Isoforms.filtered.clean.genes",
    "Mando_isoforms.read_stat.txt")

T0 = time.time()


def log(msg: str) -> None:
    print(f"[{time.time() - T0:7.1f}s] {msg}", flush=True)


def card() -> str:
    """`name, power limit` of the card(s), as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip()
    return " | ".join(line.strip() for line in out.splitlines())


def compare_outputs(dir_a: str, dir_b: str) -> list:
    """Names of OUTPUT_FILES whose bytes differ (or are missing) between
    two run directories."""
    bad = []
    for name in OUTPUT_FILES:
        pa, pb = os.path.join(dir_a, name), os.path.join(dir_b, name)
        if not (os.path.exists(pa) and os.path.exists(pb)):
            bad.append(name)
            continue
        with open(pa, "rb") as fa, open(pb, "rb") as fb:
            if fa.read() != fb.read():
                bad.append(name)
    return bad


def mem_summary(compiled) -> str:
    m = compiled.memory_analysis()
    if m is None:
        return "memory_analysis n/a"
    return (f"args {m.argument_size_in_bytes / 2**20:.1f} MiB, "
            f"out {m.output_size_in_bytes / 2**20:.1f} MiB, "
            f"temp {m.temp_size_in_bytes / 2**20:.1f} MiB")


def timed_runs(compiled, args, n=3) -> float:
    """Median seconds of n runs of a compiled call, each ended by
    block_until_ready."""
    import jax
    ts = []
    for _ in range(n):
        t = time.perf_counter()
        jax.block_until_ready(compiled(*args))
        ts.append(time.perf_counter() - t)
    return statistics.median(ts)


# ---------------------------------------------------------------- chain

def chain_candidates(seed: int, n_cand: int = 1024):
    """Staged chain-kernel candidates (native stage_seed_batch_c) from
    reads of a 4 Mbp one-chromosome genome: spliced 1%-error reads plus
    long indel-rich reads that carry hundreds of segments. One
    chromosome means each (read, strand) candidate is exactly the chain
    seed_chain_c picks for that orientation."""
    from mandalorion_tpu.align.aligner import SpliceAligner
    from mandalorion_tpu.align.encode import encode
    from mandalorion_tpu.config import AlignConfig
    from mandalorion_tpu.native import native_stage_seed_batch
    from mandalorion_tpu.utils.simulate import make_genome, mutate_read

    rng = np.random.default_rng(seed)
    genome = make_genome(4_000_000, seed=seed + 11)
    reads = []
    while len(reads) < n_cand:
        pos = int(rng.integers(0, len(genome) - 120_000))
        if len(reads) % 16 == 15:
            # indel-rich long read: one 1-3 bp indel every ~30 bases
            r = genome[pos:pos + int(rng.integers(6000, 20000))]
            out, i = [], 0
            while i < len(r):
                step = int(rng.integers(20, 40))
                out.append(r[i:i + step])
                i += step
                if rng.random() < 0.5:
                    i += int(rng.integers(1, 4))
                else:
                    out.append("ACGT"[int(rng.integers(0, 4))]
                               * int(rng.integers(1, 4)))
            r = "".join(out)
        else:
            exons = []
            for _ in range(int(rng.integers(2, 7))):
                ln = int(rng.integers(150, 1200))
                exons.append(genome[pos:pos + ln])
                pos += ln + int(rng.integers(200, 20_000))
            r, _ = mutate_read("".join(exons), rng, 0.01)
        reads.append(r)
    aligner = SpliceAligner({"chr1": genome}, AlignConfig())
    codes = [encode(r) for r in reads]
    read_off = np.zeros(len(codes) + 1, np.int64)
    np.cumsum([len(c) for c in codes], out=read_off[1:])
    seeded = native_stage_seed_batch(
        np.concatenate(codes), read_off, aligner.cfg.kmer,
        aligner.cfg.window, aligner.max_occ, 100, aligner.index,
        aligner.cfg.max_intron)
    n, c_read, c_strand, _c_chrom, c_tbase, c_nseg, segs = seeded
    n = min(n, n_cand)
    return aligner, codes, n, c_read, c_strand, c_tbase, c_nseg, segs


def check_chain_costs(max_diff: int = 400_000) -> int:
    """The chain kernel's float32 gap costs, compiled for the device, vs
    numpy's separately rounded multiply and add, bit for bit: the indel
    cost at every gap size 0..max_diff and the intron cost at every
    frexp exponent 1..63 (an FMA contraction would differ in the last
    bit). Returns the number of values compared."""
    import jax
    from mandalorion_tpu.align.chain_kernel import indel_cost, intron_cost
    diff = np.arange(max_diff + 1, dtype=np.float32)
    # intron_cost(d) takes the frexp exponent e of d: d = 2**(e-1) covers
    # every e from 1 to 63 (and d = 0 clamps to 1, e = 1)
    d_pow = np.float32(2.0) ** np.arange(-1, 63, dtype=np.float32)
    f = jax.jit(lambda d, p, z: (indel_cost(d, 4.0, 0.3, z),
                                 intron_cost(p, 12.0, z)))
    # the kernel's zero comes from an input; so does this one
    zero = np.zeros((), np.int32)
    got_i, got_n = (np.asarray(x) for x in f(diff, d_pow, zero))
    want_i = np.float32(4.0) + np.float32(0.3) * diff
    e = np.frexp(np.maximum(d_pow, np.float32(1.0)))[1].astype(np.float32)
    want_n = np.float32(12.0) + np.float32(0.01) * e
    bad_i = int((got_i.view(np.int32) != want_i.view(np.int32)).sum())
    bad_n = int((got_n.view(np.int32) != want_n.view(np.int32)).sum())
    if bad_i or bad_n:
        raise AssertionError(f"chain costs differ from numpy in {bad_i} "
                             f"indel and {bad_n} intron values")
    return len(diff) + len(d_pow)


def check_chain(seed: int, widths=(64, 128, 256, 512), batch: int = 1024,
                n_cand: int = 1024, verbose: bool = True):
    """Chain kernel at each segment width vs seed_chain_c: the decoded
    chain (segments after overlap trim) and the score's float32 bits.
    Returns per-width (compile_s, run_s, n_checked)."""
    import jax
    import jax.numpy as jnp
    from mandalorion_tpu.align.chain_kernel import _chain_fn
    from mandalorion_tpu.align.chain_kernel import _unpack_chain
    from mandalorion_tpu.align.encode import revcomp_codes
    from mandalorion_tpu.native import native_seed_chain

    aligner, codes, n, c_read, c_strand, c_tbase, c_nseg, segs = \
        chain_candidates(seed, n_cand)
    cfg, idx = aligner.cfg, aligner.index
    want = []
    for c in range(n):
        q = codes[c_read[c]]
        q = q if c_strand[c] == 0 else revcomp_codes(q)
        q0, qe, t0, te, score, _ci = native_seed_chain(
            q, cfg.kmer, cfg.window, aligner.max_occ, 100,
            idx.sorted_hashes, idx.bucket_lo, idx.bucket_bits,
            idx.sorted_positions, idx.chrom_offsets, cfg.min_intron,
            cfg.max_intron)
        want.append((np.stack([q0, qe, t0, te]).astype(np.int64).copy(),
                     np.float32(score)))
    out = {}
    for width in widths:
        fit = [c for c in range(n) if c_nseg[c] <= width][:batch]
        args = [np.zeros((batch, width), np.int32) for _ in range(5)]
        for a, s in zip(args, segs):
            a[:len(fit)] = s[fit, :width]
        nseg = np.zeros(batch, np.int32)
        nseg[:len(fit)] = c_nseg[fit]
        dev_args = [jnp.asarray(a) for a in args + [nseg]]
        fn = _chain_fn(cfg.min_intron, cfg.max_intron, 1, 12.0, 4.0, 0.3,
                       width)
        t = time.perf_counter()
        compiled = fn.lower(*dev_args).compile()
        compile_s = time.perf_counter() - t
        run_s = timed_runs(compiled, dev_args)
        rows = np.asarray(jax.device_get(compiled(*dev_args)))
        parent, best, score = _unpack_chain(rows, width)
        for b, c in enumerate(fit):
            chain_idx, at = [], int(best[b])
            while at >= 0:
                chain_idx.append(at)
                at = int(parent[b, at])
            got, prev_q, prev_t = [], -1, -1
            qs, qe, ts, te = (s[c] for s in segs[:4])
            for i in reversed(chain_idx):
                trim = max(prev_q - qs[i], prev_t - ts[i], 0)
                if qs[i] + trim >= qe[i] or ts[i] + trim >= te[i]:
                    continue
                got.append((qs[i] + trim, qe[i], ts[i] + trim + c_tbase[c],
                            te[i] + c_tbase[c]))
                prev_q, prev_t = qe[i], te[i]
            w_segs, w_score = want[c]
            if score[b] > 0 and got:
                g = np.array(got, np.int64).T
                if not (g.shape == w_segs.shape and (g == w_segs).all()
                        and score[b].view(np.int32)
                        == w_score.view(np.int32)):
                    raise AssertionError(
                        f"chain width {width} candidate {c}: device "
                        f"{g.T.tolist()[:4]}.. score {score[b]!r} != host "
                        f"{w_segs.T.tolist()[:4]}.. score {w_score!r}")
            elif w_segs.shape[1]:
                raise AssertionError(f"chain width {width} candidate {c}: "
                                     "device found no chain, host did")
        out[width] = (compile_s, run_s, len(fit))
        if verbose:
            log(f"chain width {width:3d} x batch {batch}: {len(fit)} "
                f"candidates equal to seed_chain_c (max nseg "
                f"{int(nseg.max())}); compile {compile_s:.2f}s, run "
                f"{run_s * 1e3:.2f} ms; {mem_summary(compiled)}")
    return out


# ------------------------------------------------------------ affine DP

def dp_class_problems(rng, width: int, max_q: int, n: int):
    """n DpProblems whose (target width, row cap) class is exactly
    (width, max_q): modes cycle global / extend_right / extend_left."""
    from mandalorion_tpu.align.extend import DpProblem
    from mandalorion_tpu.align.kernels import Q_STEPS, WIDTHS
    wi, qi = WIDTHS.index(width), Q_STEPS.index(max_q)
    t_lo = WIDTHS[wi - 1] if wi else 1
    q_lo = Q_STEPS[qi - 1] + 1 if qi else 1
    modes = ("global", "extend_right", "extend_left")
    probs = []
    for k in range(n):
        nq = int(rng.integers(q_lo, max_q + 1))
        nt = int(rng.integers(t_lo, width))
        q = rng.integers(0, 4, nq).astype(np.uint8)
        t = q.copy()
        sub = rng.random(nq) < 0.05
        t[sub] = rng.integers(0, 4, int(sub.sum()))
        if nt > nq:
            t = np.concatenate([t, rng.integers(0, 4, nt - nq)
                                .astype(np.uint8)])
        probs.append(DpProblem(q, t[:nt].copy(), modes[k % 3]))
    return probs


def check_dp_class(width: int, max_q: int, seed: int, n=None,
                   timing: bool = True):
    """The fused device DP on one (width, rows) class vs solve_dp_native,
    on real problems: the class's fixed dispatch batch is filled with
    problems of exactly that class and packed by pack_fused_chunk, as
    solve_dp_fused packs them. The compiled function's output on those
    arrays is checked, equal to solve_dp_fused's (the staged module-A
    entry) and to the host solver, then timed on the same arrays, so the
    time covers the DP, the start-cell pick and the walk of every
    problem. Returns (batch, compile_s, run_s, mem, mean walk steps)."""
    import jax.numpy as jnp
    from mandalorion_tpu.align.extend import solve_dp_native
    from mandalorion_tpu.align.kernels import (
        _dispatch_batch, _merge_steps, _rowscan_fused_fn, _unpack_fused,
        pack_fused_chunk, solve_dp_fused)
    from mandalorion_tpu.config import AlignConfig

    cfg = AlignConfig()
    batch = _dispatch_batch(width, max_q)
    rng = np.random.default_rng(seed + width * 7 + max_q)
    probs = dp_class_problems(rng, width, max_q, n or batch)
    # descriptors as stage_fill_batch_c emits them: problem k is read k;
    # extend_left problems are stored reversed and read back reversed
    mode_id = {"global": 0, "extend_right": 1, "extend_left": 2}
    q_parts, t_parts = [], []
    desc = np.zeros((6, len(probs)), np.int64)
    t_off = 0
    for k, p in enumerate(probs):
        left = p.mode == "extend_left"
        q_parts.append(p.q[::-1] if left else p.q)
        t_parts.append(p.t[::-1] if left else p.t)
        nq, nt = len(p.q), len(p.t)
        desc[:, k] = (k, mode_id[p.mode], nq if left else 0,
                      t_off + nt if left else t_off, nq, nt)
        t_off += nt
    read_off = np.zeros(len(probs) + 1, np.int64)
    np.cumsum([len(q) for q in q_parts], out=read_off[1:])
    oriented = np.concatenate(q_parts)
    genome = np.concatenate(t_parts)
    probs_desc = tuple(desc[i] for i in range(6))
    first = range(min(len(probs), batch))   # the first dispatch
    args = [jnp.asarray(a) for a in pack_fused_chunk(
        probs_desc, first, batch, max_q, width, oriented, read_off,
        genome)]
    fn = _rowscan_fused_fn(cfg.match, cfg.mismatch, cfg.gap_open,
                           cfg.gap_extend, cfg.end_bonus, cfg.zdrop, max_q,
                           width)
    compile_s, compiled = None, fn
    if timing:
        t = time.perf_counter()
        compiled = fn.lower(*args).compile()
        compile_s = time.perf_counter() - t
    c_meta, c_ks, c_buf = _unpack_fused(np.asarray(compiled(*args)))
    meta, ks, buf, on_host = solve_dp_fused(probs_desc, oriented, read_off,
                                            genome, cfg)
    k = len(first)
    assert not on_host.any()
    assert (np.array_equal(meta[:k], c_meta[:k])
            and np.array_equal(ks[:k], c_ks[:k])
            and np.array_equal(buf[:k], c_buf[:k, :buf.shape[1]])), \
        f"DP class ({width}, {max_q}): solve_dp_fused != compiled call"
    want = solve_dp_native(probs, cfg)
    for k, (p, w) in enumerate(zip(probs, want)):
        if p.mode == "global":
            qi, tj = len(p.q), len(p.t)
        else:
            qi, tj = int(meta[k, 0]), int(meta[k, 1])
        if p.mode != "global" and int(meta[k, 2]) <= 0:
            got = ([], 0, 0)
        else:
            got = (_merge_steps(buf[k, :ks[k]]), qi, tj)
        if got != (w.ops, w.q_len, w.t_len):
            raise AssertionError(
                f"DP class ({width}, {max_q}) problem {k} ({p.mode}, "
                f"q {len(p.q)} t {len(p.t)}): device {got[1:]} "
                f"{got[0][:6]} != host {(w.q_len, w.t_len)} {w.ops[:6]}")
    steps = float(ks.mean())
    if not timing:
        return batch, None, None, None, steps
    return (batch, compile_s, timed_runs(compiled, args),
            mem_summary(compiled), steps)


# ------------------------------------------------------------------ POA

def poa_sets(seed: int, n_iso: int, n_reads: int, length: int,
             err: float = 0.05):
    """Read sets (encoded) around random true sequences, bench.py's
    POA workload generator."""
    from mandalorion_tpu.align.encode import encode
    from mandalorion_tpu.utils.simulate import make_genome, mutate_read
    rng = np.random.default_rng(seed)
    sets = []
    for i in range(n_iso):
        true = make_genome(length, seed=seed * 1000 + i)
        sets.append([encode(mutate_read(true, rng, err)[0])
                     for _ in range(n_reads)])
    return sets


def check_poa(sets, band: int) -> None:
    """poa_consensus_batch (device forward + walk, native graph staging)
    vs the native C++ engine, consensus by consensus."""
    from mandalorion_tpu.native import native_poa_consensus
    from mandalorion_tpu.poa.graph import PoaParams
    from mandalorion_tpu.poa.kernels import poa_consensus_batch
    params = PoaParams(band=band, adaptive=True)
    got = poa_consensus_batch(sets, params)
    for i, (ss, g) in enumerate(zip(sets, got)):
        w = native_poa_consensus(ss, params)
        if not np.array_equal(g, w):
            raise AssertionError(f"POA band {band} set {i}: device "
                                 f"consensus ({len(g)} nt) != native "
                                 f"({len(w)} nt)")


def poa_last_round(sets, band: int):
    """Run poa_consensus_batch and return the arguments of its last device
    dispatch (a mature graph per set aligning the final read) together
    with the consensus wall seconds."""
    from mandalorion_tpu.poa import kernels as kn
    from mandalorion_tpu.poa.graph import PoaParams
    seen = []
    orig = kn._dispatch_chunk

    def record(*a):
        seen.append(a)
        return orig(*a)

    kn._dispatch_chunk = record
    try:
        t = time.perf_counter()
        kn.poa_consensus_batch(sets, PoaParams(band=band, adaptive=True))
        wall = time.perf_counter() - t
    finally:
        kn._dispatch_chunk = orig
    return seen[-1], wall


def time_poa_kernels(rec):
    """Compile and time the XLA POA forward pass, the walk, and the fused
    jitted pair on one recorded dispatch."""
    import jax
    import jax.numpy as jnp
    from mandalorion_tpu.poa import kernels as kn
    base, preds, nn, ends, qq, ql, band, W, l_cap, pp = rec
    n_hi = jnp.int32(int(nn.max()))
    dp = (pp.match, pp.mismatch, pp.gap_open, pp.gap_extend, pp.gap_open2,
          pp.gap_extend2, W, pp.adaptive)
    fwd = jax.jit(jax.vmap(
        lambda b, p, n, q, l, bd, h: kn._align_rows(b, p, n, q, l, bd, h,
                                                    *dp),
        in_axes=(0, 0, 0, 0, 0, 0, None)))
    f_args = [jnp.asarray(x) for x in (base, preds, nn, qq, ql, band)] + [
        n_hi]
    t = time.perf_counter()
    fwd_c = fwd.lower(*f_args).compile()
    fwd_compile = time.perf_counter() - t
    mats = fwd_c(*f_args)
    walk = jax.jit(jax.vmap(
        lambda p, n, e, l, hp, op, d1, d2, of, ec: kn._traceback_from_mats(
            p, n, e, l, hp, op, d1, d2, of, ec, pp.gap_open, pp.gap_extend,
            pp.gap_open2, pp.gap_extend2, W, l_cap)))
    w_args = [jnp.asarray(x) for x in (preds, nn, ends, ql)] + list(mats)
    t = time.perf_counter()
    walk_c = walk.lower(*w_args).compile()
    walk_compile = time.perf_counter() - t
    fused_args = [jnp.asarray(x)
                  for x in (base, preds, nn, ends, qq, ql, band)]
    t = time.perf_counter()
    fused_c = kn._align_traceback_batch.lower(
        *fused_args, n_hi, *dp).compile()
    fused_compile = time.perf_counter() - t
    return {
        "shape": (f"B={base.shape[0]} n_cap={base.shape[1]} W={W} "
                  f"l_cap={l_cap} p_cap={preds.shape[2]} "
                  f"n_hi={int(nn.max())}"),
        "forward_s": timed_runs(fwd_c, f_args),
        "walk_s": timed_runs(walk_c, w_args),
        "fused_s": timed_runs(fused_c, fused_args + [n_hi]),
        "compile_s": (fwd_compile, walk_compile, fused_compile),
        "mem": mem_summary(fused_c),
    }


# --------------------------------------------------------------- phases

def phase_kernels(seed: int, card_s: str) -> None:
    from mandalorion_tpu.align.kernels import Q_STEPS, WIDTHS
    log("phase kernels: exact equality with the host engines (integer DP "
        "and float32 chain costs; no matrix product, so TF32 cannot "
        "arise)")
    n_cost = check_chain_costs()
    log(f"chain gap costs: {n_cost} float32 values (indel cost at every "
        "gap size 0..400000, intron cost at every exponent 1..63) equal "
        "numpy's bit for bit: no FMA contraction")
    check_chain(seed)
    log(f"affine DP classes (fused rowscan: DP + start pick + walk, on "
        f"a full batch of problems of the class), XLA-compiled, on "
        f"{card_s}:")
    print("  width  rows  batch  walk_steps  compile_s  run_ms  us/problem"
          "  memory")
    for width in WIDTHS:
        for max_q in Q_STEPS:
            batch, c_s, r_s, mem, steps = check_dp_class(width, max_q, seed)
            print(f"  {width:5d} {max_q:5d} {batch:6d} {steps:11.1f} "
                  f"{c_s:10.2f} {r_s * 1e3:7.2f} {r_s * 1e6 / batch:10.2f}"
                  f"  {mem}", flush=True)
    log("all 25 DP classes equal to solve_dp_native")
    # POA: window classes W 256..2048 (band sets W), n_cap up to 4096
    for band, n_iso, n_reads, length in ((30, 4, 6, 2000),
                                         (200, 2, 4, 2000),
                                         (400, 2, 4, 2500),
                                         (1000, 2, 3, 3000),
                                         (30, 2, 5, 3600)):
        sets = poa_sets(seed + band + length, n_iso, n_reads, length)
        t = time.perf_counter()
        check_poa(sets, band)
        log(f"POA band {band} ({n_iso} x {n_reads} reads x {length} nt): "
            f"device consensus == native; {time.perf_counter() - t:.1f}s "
            "incl. compiles")
    # bench.py's POA shape: 16 isoforms x 20 reads x 2 kb
    sets = poa_sets(seed, 16, 20, 2000)
    check_poa(sets, 30)
    rec, wall = poa_last_round(sets, 30)
    bases = sum(len(s) for ss in sets for s in ss)
    from mandalorion_tpu.native import native_poa_consensus
    from mandalorion_tpu.poa.graph import PoaParams
    t = time.perf_counter()
    for ss in sets:
        native_poa_consensus(ss, PoaParams(band=30, adaptive=True))
    host_wall = time.perf_counter() - t
    tm = time_poa_kernels(rec)
    log(f"POA 16x20x2kb on {card_s}: device consensus {wall:.3f}s "
        f"({bases / wall:.0f} bases/s, warm) vs native engine one thread "
        f"{host_wall:.3f}s ({bases / host_wall:.0f} bases/s)")
    log(f"POA last round [{tm['shape']}]: forward "
        f"{tm['forward_s'] * 1e3:.2f} ms, walk {tm['walk_s'] * 1e3:.2f} ms,"
        f" fused {tm['fused_s'] * 1e3:.2f} ms; compile s (fwd, walk, "
        f"fused) {tuple(round(x, 2) for x in tm['compile_s'])}; "
        f"{tm['mem']}")


@contextlib.contextmanager
def device_route_probe():
    """Count module A's routes and host-solved DP problems (the staged
    native path must be the one taken on a replicated index) and time the
    device layers: seconds inside the chain-kernel, affine-DP, sharded
    index and POA dispatches, each including its host packing and the
    blocking fetch."""
    from mandalorion_tpu.align import chain_kernel, kernels
    from mandalorion_tpu.align.aligner import SpliceAligner
    from mandalorion_tpu.parallel.dist import ShardedIndex
    from mandalorion_tpu.poa import kernels as poa_kernels
    counts = {"staged_dp_calls": 0, "dp_on_host": 0, "python_staging": 0,
              "chain_s": 0.0, "dp_s": 0.0, "lookup_s": 0.0,
              "poa_dispatches": 0, "poa_s": 0.0}
    patched = []

    def wrap(owner, name, key, after=None):
        orig = getattr(owner, name)

        def timed(*a, **k):
            t = time.perf_counter()
            res = orig(*a, **k)
            if key:
                counts[key] += time.perf_counter() - t
            if after:
                after(res)
            return res

        patched.append((owner, name, orig))
        setattr(owner, name, timed)

    def on_fused(res):
        counts["staged_dp_calls"] += 1
        counts["dp_on_host"] += int(res[3].sum())

    wrap(kernels, "solve_dp_fused", "dp_s", on_fused)
    wrap(kernels, "solve_dp_rowscan", "dp_s")
    wrap(chain_kernel, "chain_batch_rows", "chain_s")
    wrap(chain_kernel, "chain_batch_jax", "chain_s")
    wrap(ShardedIndex, "lookup", "lookup_s")
    wrap(SpliceAligner, "_chain_batch_device", None,
         lambda _res: counts.__setitem__("python_staging",
                                         counts["python_staging"] + 1))
    wrap(poa_kernels, "_dispatch_chunk", "poa_s",
         lambda _res: counts.__setitem__("poa_dispatches",
                                         counts["poa_dispatches"] + 1))
    try:
        yield counts
    finally:
        for owner, name, orig in reversed(patched):
            setattr(owner, name, orig)


def run_cli(data: str, out: str, extra: list) -> dict:
    """mando-tpu on a dataset; its console output goes to out/run.log.
    Returns wall and XLA compile seconds and per-stage seconds."""
    import jax
    from mandalorion_tpu.pipeline import cli
    compile_s = [0.0]

    def on_event(event, duration, **_kw):
        if event == "/jax/core/compile/backend_compile_duration":
            compile_s[0] += duration

    jax.monitoring.register_event_duration_secs_listener(on_event)
    os.makedirs(out, exist_ok=True)
    argv = ["-p", out, "-G", os.path.join(data, "genome.fasta"),
            "-g", os.path.join(data, "ann.gtf"),
            "-f", os.path.join(data, "reads.fasta"),
            "-t", str(os.cpu_count() or 1)] + extra
    t = time.perf_counter()
    try:
        with open(os.path.join(out, "run.log"), "w") as fh, \
                contextlib.redirect_stdout(fh):
            rc = cli.main(argv)
    finally:
        jax.monitoring.unregister_event_duration_listener(on_event)
    wall = time.perf_counter() - t
    if rc != 0:
        raise RuntimeError(f"mando-tpu {' '.join(extra)} exited {rc}")
    stages = {}
    with open(os.path.join(out, "tmp", "timing.tsv")) as fh:
        next(fh)
        for line in fh:
            name, sec = line.split("\t")[:2]
            stages[name] = float(sec)
    return {"wall": wall, "compile": compile_s[0], "stages": stages}


DEVICE_ARGS = ["--chain_backend", "device", "--dp_backend", "rowscan",
               "--consensus_backend", "device"]
HOST_ARGS = ["--chain_backend", "native", "--dp_backend", "numpy",
             "--consensus_backend", "native"]


def report_run(tag: str, res: dict, n_reads: int, card_s: str) -> None:
    stages = " ".join(f"{k}={v:.2f}" for k, v in res["stages"].items())
    log(f"{tag}: {n_reads / res['wall']:.1f} reads/s ({res['wall']:.1f}s "
        f"wall, of which XLA compile {res['compile']:.1f}s) on {card_s}; "
        f"stages s: {stages}")


def phase_pipeline(seed: int, card_s: str, tmp: str, n_genes: int = 100,
                   per_gene: int = 200, mbp: int = 50) -> None:
    from mandalorion_tpu.utils.simulate import make_chromosome_dataset
    log(f"phase pipeline: config-3 shape (1 chromosome, {mbp} Mbp, "
        f"{n_genes} genes), reduced: {per_gene} reads per gene instead of "
        "1000, for the run's time limit")
    data = os.path.join(tmp, "c3")
    n_reads = make_chromosome_dataset(data, n_genes, per_gene, mbp, seed)
    log(f"generated {n_reads} reads")
    with device_route_probe() as counts:
        dev = run_cli(data, os.path.join(tmp, "dev"), DEVICE_ARGS)
    report_run("device route", dev, n_reads, card_s)
    if counts["python_staging"] or not counts["staged_dp_calls"]:
        raise AssertionError(f"module A left the native staged path: "
                             f"{counts}")
    log(f"module A took the native staged path "
        f"({counts['staged_dp_calls']} fused DP calls); "
        f"{counts['dp_on_host']} DP problems outside the device envelope "
        "went to the host solver")
    log(f"device layers (dispatch + packing + blocking fetch): chain "
        f"{counts['chain_s']:.1f}s, affine DP {counts['dp_s']:.1f}s, POA "
        f"{counts['poa_s']:.1f}s in {counts['poa_dispatches']} dispatches")
    host = run_cli(data, os.path.join(tmp, "host"), HOST_ARGS)
    report_run("host route (same process; live backend = no fork pools)",
               host, n_reads, card_s)
    bad = compare_outputs(os.path.join(tmp, "dev"), os.path.join(tmp, "host"))
    if bad:
        raise AssertionError(f"device vs host outputs differ: {bad}")
    log(f"device route == host route, byte for byte: {len(OUTPUT_FILES)} "
        "files")


def phase_devices4(seed: int, card_s: str, tmp: str,
                   n_genes: int = 100, per_gene: int = 20,
                   mbp: int = 50) -> None:
    import jax
    from mandalorion_tpu.utils.simulate import make_chromosome_dataset
    if len(jax.devices()) < 4:
        raise RuntimeError(f"--devices 4 needs 4 GPUs, JAX sees "
                           f"{len(jax.devices())}")
    log(f"phase devices4: config-3 shape (1 chromosome, {mbp} Mbp, "
        f"{n_genes} genes), reduced: {per_gene} reads per gene instead of "
        "1000, because the device POA route (~90 reads/s on one card) "
        "runs three times here on four cards")
    data = os.path.join(tmp, "c3")
    n_reads = make_chromosome_dataset(data, n_genes, per_gene, mbp, seed)
    log(f"generated {n_reads} reads")
    one = run_cli(data, os.path.join(tmp, "one"), DEVICE_ARGS)
    report_run("1-card device route", one, n_reads, card_s)
    for tag, extra in (("mesh4", ["--devices", "4"]),
                       ("mesh4-sharded-index",
                        ["--devices", "4", "--index_backend", "sharded"])):
        with device_route_probe() as counts:
            res = run_cli(data, os.path.join(tmp, tag), DEVICE_ARGS + extra)
        report_run(f"{tag} device route", res, n_reads, card_s)
        log(f"{tag}: module A took the "
            f"{'Python' if counts['python_staging'] else 'native'} staged "
            f"path ({counts['staged_dp_calls']} fused DP calls); device "
            f"layers: chain {counts['chain_s']:.1f}s, affine DP "
            f"{counts['dp_s']:.1f}s, sharded index {counts['lookup_s']:.1f}"
            f"s, POA {counts['poa_s']:.1f}s in {counts['poa_dispatches']} "
            "dispatches")
        bad = compare_outputs(os.path.join(tmp, "one"),
                              os.path.join(tmp, tag))
        if bad:
            raise AssertionError(f"{tag} differs from 1 card: {bad}")
        log(f"{tag} == 1-card run, byte for byte: {len(OUTPUT_FILES)} "
            "files")
    peaks = [(d.memory_stats() or {}).get("peak_bytes_in_use")
             for d in jax.devices()]
    log("peak_bytes_in_use per device: " + ", ".join(
        "n/a" if p is None else f"{p / 2**20:.0f} MiB" for p in peaks))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--devices", type=int, default=1, choices=[1, 4],
                    help="4: run only the 4-card mesh phase")
    args = ap.parse_args(argv)

    import jax
    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: JAX's default device is "
              f"{devices[0].platform}, not a GPU", file=sys.stderr)
        return 2
    card_s = card()
    print(card_s, flush=True)
    print(f"jax {jax.__version__}, {len(devices)} x "
          f"{devices[0].device_kind}", flush=True)
    from mandalorion_tpu.runtime import enable_compilation_cache
    log(f"compilation cache: {enable_compilation_cache()}")
    with tempfile.TemporaryDirectory() as tmp:
        if args.devices == 4:
            phase_devices4(args.seed, card_s, tmp)
        else:
            phase_kernels(args.seed, card_s)
            phase_pipeline(args.seed, card_s, tmp)
    peak = devices[0].memory_stats()["peak_bytes_in_use"]
    print(f"peak_bytes_in_use {peak} ({peak / 2**30:.2f} GiB) on {card_s}")
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
