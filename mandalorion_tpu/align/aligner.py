"""Splice-aware read-to-genome aligner (minimap2 `-ax splice:hq --cs=long
-uf -G 400k --secondary=no` replacement, `Mando.py:316-319`).

Per batch: vectorized minimizers for both read orientations → index lookup
→ per-chromosome diagonal-segment chaining → best strand/chromosome chain →
intron splice-point fills + batched DP gap fills + end extensions → extended
PSL emission (blocks split at every indel, exactly emtrey's block model).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from mandalorion_tpu.align.chain import (
    Segment, chain_segments, collapse_anchors)
from mandalorion_tpu.align.encode import encode, minimizers, revcomp_codes
from mandalorion_tpu.align.extend import (
    DpProblem, DpResult, solve_dp_numpy, splice_fill)
from mandalorion_tpu.align.index import build_index
from mandalorion_tpu.config import AlignConfig
from mandalorion_tpu.io.psl import PslRecord

from mandalorion_tpu.align.encode import decode as _decode


@dataclass
class _Pending:
    """A read alignment awaiting batched DP results."""

    name: str
    seq: str
    strand: str
    q_codes: np.ndarray            # aligned-orientation query codes
    chrom_idx: int
    ops: List[Tuple[str, int, int, int]]  # (kind, q0, t0, length) + DP slots
    dp_slots: List[int]            # indices into the batch problem list


class SpliceAligner:
    """Genome-indexed splice aligner. Thread the same instance through
    batches; the index is a numpy pytree (replicable across hosts)."""

    def __init__(self, genome: Dict[str, str],
                 cfg: Optional[AlignConfig] = None):
        self.cfg = cfg or AlignConfig()
        from mandalorion_tpu.align.index import (
            cached_index, frequency_occ_cap)
        self.index = cached_index(genome, self.cfg.kmer, self.cfg.window,
                                  getattr(self.cfg, "index_cache", ""))
        # minimap2 -f analogue: raise the seed occurrence cap to the
        # index's top-frequency quantile so repeat/tandem regions seed
        self.max_occ = frequency_occ_cap(
            self.index, getattr(self.cfg, "occ_frac", 0.0),
            self.cfg.max_occ)
        backend = getattr(self.cfg, "dp_backend", "numpy")
        if backend not in ("numpy", "rowscan"):
            raise ValueError(f"unknown dp_backend {backend!r} "
                             "(expected 'numpy' or 'rowscan')")
        if backend == "rowscan" or \
                getattr(self.cfg, "chain_backend", "native") == "device":
            # device compute selected: persist kernel compiles across
            # runs, and bring the backend up HERE so that runtime.fork_ok
            # turns false — module A then keeps every device dispatch in
            # this process instead of forking workers that would each
            # open (and reserve most of) the accelerator
            from mandalorion_tpu.runtime import enable_compilation_cache
            enable_compilation_cache()
            import jax
            jax.devices()
        # DP problems of the staged device path that fell outside the
        # device envelope (MAX_Q_DEVICE / MAX_T_DEVICE) and were solved by
        # the host solver instead
        self.dp_on_host = 0
        # hash-axis-sharded genome index (SURVEY §2.3: the alternative to
        # per-host replication for indexes beyond one host's memory):
        # seed lookups route through parallel.dist.ShardedIndex, each
        # device owning one hash-range shard, byte-identical to the
        # replicated path (tests/test_parallel.py)
        self._sharded = None
        if getattr(self.cfg, "index_backend", "replicated") == "sharded":
            from mandalorion_tpu.parallel.mesh import pipeline_mesh
            mesh = pipeline_mesh()
            if mesh is not None:
                from mandalorion_tpu.parallel.dist import ShardedIndex
                self._sharded = ShardedIndex(mesh, self.index)
        if backend == "rowscan":
            from mandalorion_tpu.align.kernels import solve_dp_rowscan
            self.dp_backend = solve_dp_rowscan
        else:
            # 'numpy' resolves to the bit-identical native C++ solver when
            # available (solve_dp_native falls back to solve_dp_numpy)
            from mandalorion_tpu.align.extend import solve_dp_native
            self.dp_backend = solve_dp_native

    def host_twin(self) -> "SpliceAligner":
        """An aligner sharing this instance's index but pinned to the
        host compute backends. For tiny batches (module F realigns a
        handful of isoform consensi) a device round trip per dispatch
        dominates the work itself; the backend-parity invariant (all
        chain/DP backends bit-identical, tests/test_kernels.py) makes
        routing them to the host output-identical. No index rebuild."""
        if getattr(self.cfg, "chain_backend", "native") != "device" and \
                getattr(self.cfg, "dp_backend", "numpy") == "numpy" and \
                self._sharded is None:
            return self
        import dataclasses
        twin = object.__new__(SpliceAligner)
        twin.cfg = dataclasses.replace(self.cfg, chain_backend="native",
                                       dp_backend="numpy",
                                       index_backend="replicated")
        twin.index = self.index
        twin.max_occ = self.max_occ
        twin._sharded = None
        twin.dp_on_host = 0
        from mandalorion_tpu.align.extend import solve_dp_native
        twin.dp_backend = solve_dp_native
        return twin

    # ------------------------------------------------------------ seeding

    def _sharded_seeds(self, orientations: Sequence[np.ndarray]):
        """Seed many read orientations through the mesh-sharded index in
        one lookup (two device dispatches): per orientation,
        [(chrom_idx, [Segment, ...]), ...] in ascending chrom order, as
        GenomeIndex.seed_segments gives on the replicated index."""
        cfg = self.cfg
        mins = [minimizers(qc, cfg.kmer, cfg.window) for qc in orientations]
        off = np.zeros(len(mins) + 1, np.int64)
        np.cumsum([len(h) for _p, h in mins], out=off[1:])
        qidx, gpos = self._sharded.lookup(
            np.concatenate([h for _p, h in mins]) if len(mins)
            else np.zeros(0, np.uint64), self.max_occ, off)
        cut = np.searchsorted(qidx, off)
        out = []
        for g, (pos, _h) in enumerate(mins):
            qi, gp = qidx[cut[g]:cut[g + 1]] - off[g], gpos[cut[g]:cut[g + 1]]
            qpos = pos[qi]
            ci, _local = self.index.position_to_chrom(gp)
            out.append([(int(c), collapse_anchors(qpos[ci == c], gp[ci == c],
                                                  cfg.kmer))
                        for c in np.unique(ci)])
        return out

    def _chain_for(self, codes: np.ndarray
                   ) -> Tuple[Optional[List[Segment]], float, int]:
        """Best chain for one read orientation: (chain, score, chrom_idx)."""
        cfg = self.cfg
        idx = self.index
        if self._sharded is not None:
            seeded = self._sharded_seeds([codes])[0]
            best_chain, best_score, best_ci = None, 0.0, -1
            for c, segs in seeded:
                chain, score = chain_segments(
                    segs, min_intron=cfg.min_intron,
                    max_intron=cfg.max_intron)
                if chain and score > best_score:
                    best_chain, best_score, best_ci = chain, score, int(c)
            return best_chain, best_score, best_ci
        if idx.bucket_lo is not None:
            from mandalorion_tpu.native import native_seed_chain
            res = native_seed_chain(
                codes, cfg.kmer, cfg.window, self.max_occ, 100,
                idx.sorted_hashes, idx.bucket_lo, idx.bucket_bits,
                idx.sorted_positions, idx.chrom_offsets, cfg.min_intron,
                cfg.max_intron)
            if res is not None:
                q0, qe, t0, te, score, ci = res
                if len(q0) == 0:
                    return None, 0.0, -1
                chain = [Segment(int(a), int(b), int(c), int(d))
                         for a, b, c, d in zip(q0, qe, t0, te)]
                return chain, score, ci
        seeded = self.index.seed_segments(codes, self.max_occ)
        if seeded is None:  # no native library: numpy seeding path
            pos, hashes = minimizers(codes, cfg.kmer, cfg.window)
            if len(pos) == 0:
                return None, 0.0, -1
            qidx, gpos = self.index.lookup(hashes, self.max_occ)
            if len(qidx) == 0:
                return None, 0.0, -1
            qpos = pos[qidx]
            ci, _local = self.index.position_to_chrom(gpos)
            seeded = [(int(c), collapse_anchors(qpos[ci == c],
                                                gpos[ci == c], cfg.kmer))
                      for c in np.unique(ci)]
        best_chain, best_score, best_ci = None, 0.0, -1
        for c, segs in seeded:
            chain, score = chain_segments(
                segs, min_intron=cfg.min_intron, max_intron=cfg.max_intron)
            if chain and score > best_score:
                best_chain, best_score, best_ci = chain, score, int(c)
        return best_chain, best_score, best_ci

    def _chain_both(self, codes: np.ndarray):
        """Best chain over both read orientations (forward wins score
        ties, minimap2's primary-alignment analogue). Returns
        (chain, strand, chrom_idx, oriented_q_codes) or None. Uses the
        fused native both-orientation call when available."""
        cfg = self.cfg
        idx = self.index
        if idx.bucket_lo is not None and self._sharded is None:
            from mandalorion_tpu.native import native_seed_chain2
            res = native_seed_chain2(
                codes, cfg.kmer, cfg.window, self.max_occ, 100,
                idx.sorted_hashes, idx.bucket_lo, idx.bucket_bits,
                idx.sorted_positions, idx.chrom_offsets, cfg.min_intron,
                cfg.max_intron)
            if res is not None:
                q0, qe, t0, te, _score, ci, strand = res
                if strand < 0 or len(q0) == 0:
                    return None
                chain = [Segment(int(a), int(b), int(c), int(d))
                         for a, b, c, d in zip(q0, qe, t0, te)]
                if strand == 0:
                    return chain, "+", ci, codes
                return chain, "-", ci, revcomp_codes(codes)
        rc = revcomp_codes(codes)
        chain_f, score_f, ci_f = self._chain_for(codes)
        chain_r, score_r, ci_r = self._chain_for(rc)
        if chain_f is None and chain_r is None:
            return None
        if score_f >= score_r:
            return chain_f, "+", ci_f, codes
        return chain_r, "-", ci_r, rc

    # ------------------------------------------------------------- filling

    def _fill(self, name: str, seq: str, strand: str, q_codes: np.ndarray,
              chain: List[Segment], chrom_idx: int,
              problems: List[DpProblem]) -> Optional[_Pending]:
        cfg = self.cfg
        g = self.index.seq_codes
        ops: List[Tuple[str, int, int, int]] = []
        dp_slots: List[int] = []

        def add_dp(q0: int, t0: int, q_arr: np.ndarray, t_arr: np.ndarray,
                   mode: str) -> None:
            dp_slots.append(len(problems))
            problems.append(DpProblem(q_arr, t_arr, mode))
            ops.append(("DP", q0, t0, len(dp_slots) - 1))

        chrom_off = int(self.index.chrom_offsets[chrom_idx])
        chrom_end = chrom_off + int(self.index.chrom_sizes[chrom_idx])
        first, last = chain[0], chain[-1]
        # left end extension (reversed extend problem); never cross the
        # chromosome boundary
        lq = min(first.q_start, cfg.max_end_extend)
        if lq > 0:
            lt = min(first.t_start - chrom_off, lq + cfg.band_width)
            add_dp(first.q_start, first.t_start,
                   q_codes[first.q_start - lq:first.q_start][::-1].copy(),
                   g[first.t_start - lt:first.t_start][::-1].copy(),
                   "extend_left")

        # Give every intron gap slack: repeated bases around a junction let
        # anchors run past the true splice site, which would pin the intron
        # at a motif-blind position. Pull both flanks back so the
        # splice-point search can slide the junction onto the motif.
        slack = cfg.splice_slack
        chain = [Segment(s.q_start, s.q_end, s.t_start, s.t_end)
                 for s in chain]
        for a, b in zip(chain, chain[1:]):
            dq = b.q_start - a.q_end
            dt = b.t_start - a.t_end
            if dt - dq >= cfg.min_intron and dq >= 0:
                s_back = min(slack, (a.length - 1) // 2)
                s_fwd = min(slack, (b.length - 1) // 2)
                a.q_end -= s_back
                a.t_end -= s_back
                b.q_start += s_fwd
                b.t_start += s_fwd

        prev: Optional[Segment] = None
        for seg in chain:
            if prev is not None:
                dq = seg.q_start - prev.q_end
                dt = seg.t_start - prev.t_end
                if dt - dq >= cfg.min_intron and dq >= 0:
                    q = q_codes[prev.q_end:seg.q_start]
                    splits = np.arange(dq + 1)
                    donor = np.stack([
                        g[prev.t_end + splits],
                        g[prev.t_end + splits + 1]], axis=1)
                    acc_base = seg.t_start - (dq - splits)
                    acceptor = np.stack([
                        g[acc_base - 2], g[acc_base - 1]], axis=1)
                    s, _m = splice_fill(
                        q, g[prev.t_end:prev.t_end + dq] if dq else
                        np.zeros(0, np.uint8),
                        g[seg.t_start - dq:seg.t_start] if dq else
                        np.zeros(0, np.uint8),
                        donor, acceptor, strand, cfg.noncanonical_penalty)
                    if s > 0:
                        ops.append(("M", prev.q_end, prev.t_end, s))
                    ops.append(("N", prev.q_end + s, prev.t_end + s,
                                dt - dq))
                    if dq - s > 0:
                        ops.append(("M", prev.q_end + s,
                                    seg.t_start - (dq - s), dq - s))
                elif dq == dt:
                    if dq > 0:
                        ops.append(("M", prev.q_end, prev.t_end, dq))
                elif dq == 0:
                    ops.append(("D", prev.q_end, prev.t_end, dt))
                elif dt == 0:
                    ops.append(("I", prev.q_end, prev.t_end, dq))
                else:
                    if dq * dt <= 4_000_000:
                        add_dp(prev.q_end, prev.t_end,
                               q_codes[prev.q_end:seg.q_start].copy(),
                               g[prev.t_end:seg.t_start].copy(), "global")
                    else:  # degenerate huge gap: crude I+D fill
                        ops.append(("I", prev.q_end, prev.t_end, dq))
                        ops.append(("D", seg.q_start, prev.t_end, dt))
            ops.append(("M", seg.q_start, seg.t_start, seg.length))
            prev = seg

        rq = min(len(q_codes) - last.q_end, cfg.max_end_extend)
        if rq > 0:
            rt = min(chrom_end - last.t_end, rq + cfg.band_width)
            add_dp(last.q_end, last.t_end,
                   q_codes[last.q_end:last.q_end + rq].copy(),
                   g[last.t_end:last.t_end + rt].copy(), "extend_right")
        return _Pending(name, seq, strand, q_codes, chrom_idx, ops, dp_slots)

    # ------------------------------------------------------------ emission

    def _emit(self, pend: _Pending, results: List[DpResult],
              modes: List[str]) -> Optional[PslRecord]:
        """Stitch structural + DP ops into runs and build the PSL record."""
        runs = self._build_runs(pend, results, modes)
        return self._runs_to_psl(pend, runs)

    def _build_runs(self, pend: _Pending, results: List[DpResult],
                    modes: List[str]) -> List[Tuple[str, int, int, int]]:
        """Resolve DP slots into concrete (op, q0, t0, len) runs, sorted."""
        runs: List[Tuple[str, int, int, int]] = []  # (op, q0, t0, len)

        def push(op: str, q0: int, t0: int, ln: int) -> None:
            if ln > 0:
                runs.append((op, q0, t0, ln))

        for kind, q0, t0, ln in pend.ops:
            if kind == "DP":
                slot = pend.dp_slots[ln]  # already a global batch index
                res = results[slot]
                if not res.ops:
                    continue
                if modes[slot] == "extend_left":
                    # solved on reversed arrays: alignment covers
                    # q[q0-q_len:q0] / t[t0-t_len:t0], ops reversed
                    qq, tt = q0 - res.q_len, t0 - res.t_len
                    op_list = list(reversed(res.ops))
                else:
                    qq, tt = q0, t0
                    op_list = res.ops
                for op, dq, dt in op_list:
                    push(op, qq, tt, dq if op != "D" else dt)
                    qq += dq
                    tt += dt
            else:
                push(kind, q0, t0, ln)

        runs.sort(key=lambda r: (r[1], r[2]))
        return runs

    _OP_ID = {"M": 0, "I": 1, "D": 2, "N": 3}

    def _runs_to_psl(self, pend: _Pending,
                     runs: List[Tuple[str, int, int, int]]
                     ) -> Optional[PslRecord]:
        if runs:
            from mandalorion_tpu.native import native_emit_psl
            op_id = self._OP_ID
            arr = np.array([(op_id[op], q0, t0, ln)
                            for op, q0, t0, ln in runs], np.int64)
            res = native_emit_psl(
                pend.q_codes, self.index.seq_codes,
                arr[:, 0].astype(np.int8), np.ascontiguousarray(arr[:, 1]),
                np.ascontiguousarray(arr[:, 2]),
                np.ascontiguousarray(arr[:, 3]))
            if res is not None:
                stats, bs, bq, bt, cs_str = res
                return self._psl_record(
                    pend, stats, bs.tolist(), bq.tolist(), bt.tolist(),
                    cs_str)
        return self._runs_to_psl_numpy(pend, runs)

    def _psl_record(self, pend: _Pending, stats, block_sizes, q_starts,
                    t_starts, cs_str) -> Optional[PslRecord]:
        """Assemble the PslRecord from emitted stats + merged blocks
        (shared by the native and numpy emission paths)."""
        if not block_sizes:
            return None
        matches, mismatches, nI, I, nD, D, n_bases = (
            int(x) for x in stats[:7])
        q = pend.q_codes
        chrom_off = int(self.index.chrom_offsets[pend.chrom_idx])
        denom = matches + mismatches + I + D
        return PslRecord(
            matches=matches, mismatches=mismatches, rep_matches=0,
            n_count=n_bases, q_num_insert=nI, q_base_insert=I,
            t_num_insert=nD, t_base_insert=D, strand=pend.strand,
            q_name=pend.name, q_size=len(q), q_start=q_starts[0],
            q_end=q_starts[-1] + block_sizes[-1],
            t_name=self.index.chrom_names[pend.chrom_idx],
            t_size=int(self.index.chrom_sizes[pend.chrom_idx]),
            t_start=t_starts[0] - chrom_off,
            t_end=t_starts[-1] + block_sizes[-1] - chrom_off,
            block_count=len(block_sizes), block_sizes=block_sizes,
            q_starts=q_starts,
            t_starts=[t - chrom_off for t in t_starts],
            accuracy=matches / denom if denom else 0.0,
            cs=cs_str, sequence=pend.seq)

    def _runs_to_psl_numpy(self, pend: _Pending,
                           runs: List[Tuple[str, int, int, int]]
                           ) -> Optional[PslRecord]:
        g = self.index.seq_codes
        q = pend.q_codes
        matches = mismatches = 0
        n_bases = nI = I = nD = D = 0
        cs_parts: List[str] = []
        block_sizes: List[int] = []
        q_starts: List[int] = []
        t_starts: List[int] = []

        def open_block(q0: int, t0: int, ln: int) -> None:
            if block_sizes and (t_starts[-1] + block_sizes[-1] == t0
                                and q_starts[-1] + block_sizes[-1] == q0):
                block_sizes[-1] += ln
            else:
                block_sizes.append(ln)
                q_starts.append(q0)
                t_starts.append(t0)

        for op, q0, t0, ln in runs:
            if op == "M":
                open_block(q0, t0, ln)
                eq = q[q0:q0 + ln] == g[t0:t0 + ln]
                n_eq = int(eq.sum())
                matches += n_eq
                mismatches += ln - n_eq
                # emit cs: decode whole run once, slice strings per segment
                q_str = _decode(q[q0:q0 + ln])
                if n_eq == ln:
                    cs_parts.append("=" + q_str)
                else:
                    g_low = _decode(g[t0:t0 + ln]).lower()
                    q_low = q_str.lower()
                    edges = np.flatnonzero(np.diff(eq.astype(np.int8))) + 1
                    bounds = [0] + edges.tolist() + [ln]
                    for b0, b1 in zip(bounds, bounds[1:]):
                        if eq[b0]:
                            cs_parts.append("=" + q_str[b0:b1])
                        else:
                            for o in range(b0, b1):
                                cs_parts.append("*" + g_low[o] + q_low[o])
            elif op == "I":
                nI += 1
                I += ln
                cs_parts.append("+" + _decode(q[q0:q0 + ln]).lower())
            elif op == "D":
                nD += 1
                D += ln
                cs_parts.append("-" + _decode(g[t0:t0 + ln]).lower())
            elif op == "N":
                n_bases += ln
                cs_parts.append(
                    "~" + _decode(g[t0:t0 + 2]).lower() + str(ln)
                    + _decode(g[t0 + ln - 2:t0 + ln]).lower())

        return self._psl_record(
            pend, (matches, mismatches, nI, I, nD, D, n_bases),
            block_sizes, q_starts, t_starts, "".join(cs_parts))

    # -------------------------------------------------------------- public

    def map_batch(self, reads: Sequence[Tuple[str, str]]
                  ) -> List[PslRecord]:
        """Align a batch of (name, seq) reads; primary alignments only."""
        if getattr(self.cfg, "chain_backend", "native") == "device":
            out = self._map_batch_device_staged(reads)
            if out is not None:
                return out
            picks = self._chain_batch_device(reads)
        else:
            backend = getattr(self.cfg, "dp_backend", "numpy")
            if backend == "numpy" and self.index.bucket_lo is not None \
                    and self._sharded is None:
                out = self._map_batch_native(reads)
                if out is not None:
                    return out
            picks = [self._chain_both(encode(seq)) for _name, seq in reads]
        problems: List[DpProblem] = []
        pendings: List[_Pending] = []
        for (name, seq), picked in zip(reads, picks):
            if picked is None:
                continue
            chain, strand, ci, q_codes = picked
            if float(sum(s.length for s in chain)) < cfg_min_len(self.cfg):
                continue
            pend = self._fill(name, seq, strand, q_codes, chain, ci,
                              problems)
            if pend is not None:
                pendings.append(pend)
        modes = [p.mode for p in problems]
        if getattr(self.cfg, "dp_backend", "numpy") == "rowscan":
            from mandalorion_tpu.align.kernels import fits_device
            self.dp_on_host += sum(
                not fits_device(len(p.q), len(p.t)) for p in problems)
        results = self.dp_backend(problems, self.cfg)
        out: List[PslRecord] = []
        for pend in pendings:
            rec = self._emit(pend, results, modes)
            if rec is not None:
                out.append(rec)
        return out

    def _map_batch_device_staged(self, reads: Sequence[Tuple[str, str]]
                                 ) -> Optional[List[PslRecord]]:
        """Device-path map_batch with NATIVE staging (VERDICT r4 #1): the
        three host phases between the two device dispatches — candidate
        seeding, chain pick + gap fill, DP-result emission — run as
        single batched C calls (stage_*_batch_c), so the device path
        shares the fused host path's staging engine and the whole module
        costs exactly TWO device fetch round trips per batch:

            C seed -> [chain kernel, 1 fetch] -> C fill ->
            [fused DP kernel, 1 fetch] -> C emit

        Bit-identical to the Python-staged path (and therefore to the
        host path): tests/test_stage_native.py byte-compares all three.
        Under a pipeline mesh both dispatches shard their batch over the
        devices. Returns None (caller falls back to the Python staging)
        when the native library is missing or the index is sharded (its
        seeds come from the devices, not the C seeder).
        Replaces minimap2 (Mando.py:316-319) on the device route."""
        from mandalorion_tpu.native import (
            load_native, native_stage_seed_batch, native_stage_fill_batch,
            native_stage_emit_batch)
        if load_native() is None or self._sharded is not None or \
                self.index.bucket_lo is None:
            return None
        cfg = self.cfg
        if getattr(cfg, "dp_backend", "numpy") != "rowscan":
            return None
        code_list = [encode(seq) for _name, seq in reads]
        read_off = np.zeros(len(reads) + 1, np.int64)
        np.cumsum([len(c) for c in code_list], out=read_off[1:])
        codes_all = (np.concatenate(code_list) if code_list
                     else np.zeros(0, np.uint8))

        seeded = native_stage_seed_batch(
            codes_all, read_off, cfg.kmer, cfg.window, self.max_occ, 100,
            self.index, cfg.max_intron)
        if seeded is None:
            return None
        n_cand, c_read, c_strand, c_chrom, c_tbase, c_nseg, segs = seeded
        if n_cand == 0:
            return []

        from mandalorion_tpu.align.chain_kernel import chain_batch_rows
        rows = chain_batch_rows(
            *segs, c_nseg, n_cand, min_intron=cfg.min_intron,
            max_intron=cfg.max_intron)

        strand, chrom, oriented, run_off, runs, probs = \
            native_stage_fill_batch(
                codes_all, read_off, n_cand, c_read, c_strand, c_chrom,
                c_tbase, c_nseg, segs, rows, self.index,
                cfg_min_len(cfg), cfg.min_intron, cfg.match, cfg.mismatch,
                cfg.gap_open, cfg.gap_extend, cfg.end_bonus,
                getattr(cfg, "zdrop", 0), cfg.band_width,
                cfg.max_end_extend, cfg.splice_slack,
                cfg.noncanonical_penalty)

        from mandalorion_tpu.align.kernels import solve_dp_fused
        meta, ks, buf, on_host = solve_dp_fused(
            probs, oriented, read_off, self.index.seq_codes, cfg)
        self.dp_on_host += int(on_host.sum())

        stats, blk_off, bs, bq, bt, cs_off, cs_raw = \
            native_stage_emit_batch(
                oriented, read_off, self.index.seq_codes, strand, run_off,
                runs, probs, on_host, meta, ks, buf, cfg.match,
                cfg.mismatch, cfg.gap_open, cfg.gap_extend, cfg.end_bonus,
                getattr(cfg, "zdrop", 0))

        out: List[PslRecord] = []
        for ri, (name, seq) in enumerate(reads):
            if strand[ri] < 0 or stats[ri, 7] == 0:
                continue
            b0, b1 = int(blk_off[ri]), int(blk_off[ri + 1])
            pend = _Pending(
                name, seq, "+" if strand[ri] == 0 else "-",
                oriented[read_off[ri]:read_off[ri + 1]],
                int(chrom[ri]), [], [])
            rec = self._psl_record(
                pend, stats[ri], bs[b0:b1].tolist(), bq[b0:b1].tolist(),
                bt[b0:b1].tolist(),
                cs_raw[cs_off[ri]:cs_off[ri + 1]].decode())
            if rec is not None:
                out.append(rec)
        return out

    def _chain_batch_device(self, reads: Sequence[Tuple[str, str]]):
        """Device chaining: seed every (read, orientation, chromosome)
        candidate on the host, run ALL chain DPs in one batched jit call
        (align/chain_kernel.py), then pick each read's best chain with
        map_batch's tie-breaks (strict > over candidates in forward-first,
        chromosome-ascending order). Returns per-read picks in
        _chain_both's format."""
        from mandalorion_tpu.align.chain_kernel import chain_batch_jax
        cfg = self.cfg
        cands = []  # (read_idx, strand, chrom, q_codes)
        seg_lists: List[List[Segment]] = []
        orients = []  # (read_idx, strand, q_codes), forward first
        for ri, (_name, seq) in enumerate(reads):
            codes = encode(seq)
            orients += [(ri, "+", codes), (ri, "-", revcomp_codes(codes))]
        if self._sharded is not None:
            sharded = self._sharded_seeds([qc for _r, _s, qc in orients])
        for o, (ri, strand, qc) in enumerate(orients):
            seeded = (sharded[o] if self._sharded is not None
                      else self.index.seed_segments(qc, self.max_occ))
            if seeded is None:  # no native library
                pos, hashes = minimizers(qc, cfg.kmer, cfg.window)
                if len(pos) == 0:
                    continue
                qidx, gpos = self.index.lookup(hashes, self.max_occ)
                if len(qidx) == 0:
                    continue
                qpos = pos[qidx]
                ci, _l = self.index.position_to_chrom(gpos)
                seeded = [(int(c),
                           collapse_anchors(qpos[ci == c], gpos[ci == c],
                                            cfg.kmer))
                          for c in np.unique(ci)]
            for c, segs in seeded:
                cands.append((ri, strand, int(c), qc))
                seg_lists.append(segs)
        chains = chain_batch_jax(
            seg_lists, min_intron=cfg.min_intron, max_intron=cfg.max_intron)
        picks: List[Optional[tuple]] = [None] * len(reads)
        best_score = [0.0] * len(reads)
        for (ri, strand, c, qc), (chain, score) in zip(cands, chains):
            if chain and score > best_score[ri]:
                best_score[ri] = score
                picks[ri] = (chain, strand, c, qc)
        return picks

    def _fused_args(self, codes: np.ndarray, min_chain: float) -> tuple:
        """The shared argument tuple for the fused native entry points
        (index + chain constants + DP/fill parameters)."""
        cfg = self.cfg
        return (codes, cfg.kmer, cfg.window, self.max_occ, 100, self.index,
                cfg.min_intron, cfg.max_intron, 1, 12.0, 4.0, 0.3, 512,
                min_chain, cfg.match, cfg.mismatch, cfg.gap_open,
                cfg.gap_extend, cfg.end_bonus, getattr(cfg, "zdrop", 0),
                cfg.band_width, cfg.max_end_extend, cfg.splice_slack,
                cfg.noncanonical_penalty)

    def _map_batch_native(self, reads: Sequence[Tuple[str, str]]
                          ) -> Optional[List[PslRecord]]:
        """Fully-fused native per-read path: one C call does seed+chain,
        gap fill (splice-point search + affine DP), run assembly, and
        extended-PSL emission — bit-identical to the staged Python path
        (tests/test_native.py asserts it). Returns None when the native
        library is unavailable (caller falls back)."""
        from mandalorion_tpu.native import native_align_read
        out: List[PslRecord] = []
        for name, seq in reads:
            codes = encode(seq)
            res = native_align_read(
                *self._fused_args(codes, cfg_min_len(self.cfg)))
            if res is None:
                return None
            strand, ci, stats, bs, bq, bt, cs = res
            if strand is None:
                continue
            pend = _Pending(name, seq, "+" if strand == 0 else "-",
                            codes if strand == 0 else revcomp_codes(codes),
                            ci, [], [])
            rec = self._psl_record(pend, stats, bs, bq, bt, cs)
            if rec is not None:
                out.append(rec)
        return out

    def _map_batch_runs_native(self, reads: Sequence[Tuple[str, str]]):
        """Fused runs-mode twin of map_batch_runs (one C call per read;
        bit-identical runs — tests assert it). None when unavailable."""
        from mandalorion_tpu.native import native_align_read_runs
        out = []
        for name, seq in reads:
            codes = encode(seq)
            # min_chain 0: the staged runs path applies no min-chain gate
            res = native_align_read_runs(*self._fused_args(codes, 0.0))
            if res is None:
                return None
            strand, _ci, runs = res
            if strand is None:
                continue
            q_codes = codes if strand == 0 else revcomp_codes(codes)
            out.append((name, "+" if strand == 0 else "-", q_codes, runs))
        return out

    def map_all_targets(self, name: str, seq: str) -> List[PslRecord]:
        """Emit one alignment per target sequence with a viable chain (both
        strands considered, better one kept) — the `-N <many>` analogue
        used for allele typing (utils/hla.py)."""
        cfg = self.cfg
        per_chrom: Dict[int, Tuple[List[Segment], float, str, np.ndarray]] = {}
        codes = encode(seq)
        for strand, q_codes in (("+", codes), ("-", revcomp_codes(codes))):
            pos, hashes = minimizers(q_codes, cfg.kmer, cfg.window)
            if len(pos) == 0:
                continue
            qidx, gpos = self.index.lookup(hashes, self.max_occ)
            if len(qidx) == 0:
                continue
            qpos = pos[qidx]
            ci, _local = self.index.position_to_chrom(gpos)
            for c in np.unique(ci):
                mask = ci == c
                segs = collapse_anchors(qpos[mask], gpos[mask], cfg.kmer)
                chain, score = chain_segments(
                    segs, min_intron=cfg.min_intron,
                    max_intron=cfg.max_intron)
                if chain and (int(c) not in per_chrom
                              or score > per_chrom[int(c)][1]):
                    per_chrom[int(c)] = (chain, score, strand, q_codes)
        out: List[PslRecord] = []
        for c, (chain, score, strand, q_codes) in sorted(per_chrom.items()):
            if score < cfg_min_len(cfg):
                continue
            problems: List[DpProblem] = []
            pend = self._fill(name, seq, strand, q_codes, chain, c, problems)
            if pend is None:
                continue
            modes = [p.mode for p in problems]
            results = self.dp_backend(problems, cfg)
            rec = self._emit(pend, results, modes)
            if rec is not None:
                out.append(rec)
        return out

    def map_batch_runs(self, reads: Sequence[Tuple[str, str]]):
        """Like map_batch but returns raw (name, strand, q_codes, runs)
        tuples — the op-level interface used by the star consensus
        (poa/star.py). Honors cfg.chain_backend like map_batch."""
        if getattr(self.cfg, "chain_backend", "native") == "device":
            picks = self._chain_batch_device(reads)
        else:
            backend = getattr(self.cfg, "dp_backend", "numpy")
            if backend == "numpy" and self.index.bucket_lo is not None:
                out = self._map_batch_runs_native(reads)
                if out is not None:
                    return out
            picks = [self._chain_both(encode(seq)) for _name, seq in reads]
        problems: List[DpProblem] = []
        pendings: List[_Pending] = []
        for (name, seq), picked in zip(reads, picks):
            if picked is None:
                continue
            chain, strand, ci, q_codes = picked
            pend = self._fill(name, seq, strand, q_codes, chain, ci,
                              problems)
            if pend is not None:
                pendings.append(pend)
        modes = [p.mode for p in problems]
        results = self.dp_backend(problems, self.cfg)
        out = []
        for pend in pendings:
            runs = self._build_runs(pend, results, modes)
            out.append((pend.name, pend.strand, pend.q_codes, runs))
        return out


def cfg_min_len(cfg: AlignConfig) -> float:
    return float(cfg.min_chain_score)
