"""Batched segment chaining on device (pure JAX, jit/vmap).

The same collinear-chain DP as align/chain.chain_segments, expressed over
padded (B, MAX_SEG) segment arrays: lax.scan over segment index i with the
candidate-predecessor max vectorized across the lane axis, vmapped over the
read batch. Tie-breaks match the numpy path exactly (first max), so the two
backends are interchangeable (tests/test_chain_kernel.py).

This is the 'chain' stage of the seed-chain-extend device pipeline
(BASELINE.json north star); the extend stage is align/kernels.py.
"""

from __future__ import annotations

import functools
from typing import List, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from mandalorion_tpu.align.chain import Segment

NEG = np.float32(-1e18)
MAX_SEG = 512  # matches chain_segments' cap


def _rounded(x, zero):
    """x, rounded to float32 before its next use. XLA's CPU backend fuses
    a multiply that feeds an add into one FMA, which rounds once where
    numpy and the native build (-ffp-contract=off) round twice; OR-ing
    the bits with an int32 zero the compiler cannot prove is zero (one
    derived from a kernel input) breaks the multiply-add pair."""
    bits = jax.lax.bitcast_convert_type(x, jnp.int32) | zero
    return jax.lax.bitcast_convert_type(bits, jnp.float32)


def indel_cost(diff, indel_open, indel_scale, zero):
    """float32 cost of a non-intron gap of |dt - dq| = diff, rounded like
    numpy's separate multiply and add on every backend (chip_smoke.py
    checks every diff bit for bit on the card)."""
    return indel_open + _rounded(indel_scale * diff, zero)


def intron_cost(diff, intron_penalty, zero):
    """float32 cost of an intron gap: frexp exponent instead of log2,
    exact in every backend (see chain.py chain_segments)."""
    _, e = jnp.frexp(jnp.maximum(diff, 1.0))
    return intron_penalty + _rounded(0.01 * e.astype(jnp.float32), zero)


@functools.lru_cache(maxsize=16)
def _chain_fn(min_intron: int, max_intron: int, match: int,
              intron_penalty: float, indel_open: float, indel_scale: float,
              max_seg: int):
    def one(qs, qe, ts, te, cov, n_seg):
        """Positions are int32 (per-read offsets; coordinates normalized
        host-side so spans fit int32 exactly); scores are float32. The
        score term uses cov (anchor-covered length, Segment.score_len);
        geometry stays span-based — mirrors chain.chain_segments."""
        lens_i = qe - qs
        zero = jnp.minimum(n_seg, 0)  # n_seg >= 0; see _rounded
        covf = cov.astype(jnp.float32)
        valid_seg = jnp.arange(max_seg) < n_seg
        score0 = jnp.where(valid_seg, covf * match, NEG)

        def step(carry, i):
            score, parent = carry
            dq = qs[i] - qe
            dt = ts[i] - te
            overlap = jnp.maximum(jnp.maximum(-dq, -dt), 0
                                  ).astype(jnp.float32)
            j_idx = jnp.arange(max_seg)
            valid = ((j_idx < i) & valid_seg
                     & (dq > -lens_i) & (dt > -lens_i)
                     & (dt <= max_intron)
                     & (qe <= qe[i]) & (te <= te[i]))
            gap_q = jnp.maximum(dq, 0)
            gap_t = jnp.maximum(dt, 0)
            diff = jnp.abs(gap_t - gap_q).astype(jnp.float32)
            is_intron = (gap_t - gap_q) >= min_intron
            cost = jnp.where(
                is_intron, intron_cost(diff, intron_penalty, zero),
                indel_cost(diff, indel_open, indel_scale, zero))
            cand = score + covf[i] * match - cost - overlap * match
            cand = jnp.where(valid, cand, -jnp.inf)
            j = jnp.argmax(cand)
            better = (cand[j] > score[i]) & valid_seg[i]
            score = score.at[i].set(jnp.where(better, cand[j], score[i]))
            parent = parent.at[i].set(jnp.where(better, j, -1))
            return (score, parent), None

        parent0 = jnp.full(max_seg, -1, jnp.int32)
        (score, parent), _ = jax.lax.scan(
            step, (score0, parent0), jnp.arange(1, max_seg))
        best = jnp.argmax(score)
        # ONE packed output row: int16 parent table (MAX_SEG=512 fits) +
        # best index + the winning score's raw bits — one device-to-host
        # copy per batch instead of three
        score_bits = jax.lax.bitcast_convert_type(
            score[best], jnp.int16)  # (2,)
        return jnp.concatenate([
            parent.astype(jnp.int16), best.astype(jnp.int16)[None],
            score_bits])

    return jax.jit(jax.vmap(one))


def _unpack_chain(rows: np.ndarray, max_seg: int):
    """Split the packed (B, max_seg+3) int16 rows back into
    (parent, best, best_score)."""
    parent = rows[:, :max_seg]
    best = rows[:, max_seg].astype(np.int64)
    best_score = np.ascontiguousarray(
        rows[:, max_seg + 1:max_seg + 3]).view(np.float32)[:, 0]
    return parent, best, best_score


def chain_batch_rows(qs: np.ndarray, qe: np.ndarray, ts: np.ndarray,
                     te: np.ndarray, cov: np.ndarray, n_seg: np.ndarray,
                     n_cand: int, *, min_intron: int, max_intron: int,
                     match: int = 1, intron_penalty: float = 12.0,
                     indel_open: float = 4.0, indel_scale: float = 0.3
                     ) -> np.ndarray:
    """Dispatch PRE-PACKED candidate rows (native stage_seed_batch_c
    output: prepare_segments already applied, t normalized, zero padding)
    through the chain kernel and return the raw packed int16 rows
    (parent table + best + score bits) for the native traceback
    (stage_fill_batch_c). ONE dispatch, ONE fetch.

    The segment axis buckets to the batch's actual max (pow2, floor 64):
    typical candidates carry tens of segments, so scanning the full
    MAX_SEG=512 lanes burned 8x the chain compute AND fetched 8x the
    bytes for zero-information padding lanes. The DP
    over a narrower lane set is value-identical for every real segment
    (padding is score-masked), so the traceback and scores match the
    512-lane form bit for bit (tests/test_stage_native.py)."""
    Bp = 64
    while Bp < n_cand:
        Bp *= 2
    msb = 64
    hi = int(n_seg[:n_cand].max()) if n_cand else 0
    while msb < hi:
        msb *= 2
    msb = min(msb, MAX_SEG)

    def fit(a):
        a = a[:, :msb] if a.ndim == 2 else a
        if a.shape[0] >= Bp:
            return np.ascontiguousarray(a[:Bp])
        out = np.zeros((Bp,) + a.shape[1:], a.dtype)
        out[:a.shape[0]] = a
        return out

    from mandalorion_tpu.parallel.mesh import dispatch_batch
    fn = _chain_fn(min_intron, max_intron, match, intron_penalty,
                   indel_open, indel_scale, msb)
    rows = dispatch_batch(fn, [fit(a) for a in (qs, qe, ts, te, cov,
                                                n_seg)])
    return rows[:n_cand]


def chain_batch_jax(per_read_segments: List[List[Segment]], *,
                    min_intron: int, max_intron: int, match: int = 1,
                    intron_penalty: float = 12.0, indel_open: float = 4.0,
                    indel_scale: float = 0.3
                    ) -> List[Tuple[List[Segment], float]]:
    """Chain many reads' segments in one device call. Oversized reads
    (> MAX_SEG segments after the same prefilter/sort as the numpy path)
    are truncated to the longest MAX_SEG segments, matching
    chain_segments' cap. Segments must share one chromosome per read
    (normalized t offsets must fit int32)."""
    B = len(per_read_segments)
    if B == 0:
        return []
    from mandalorion_tpu.align.chain import prepare_segments
    prepped: List[List[Segment]] = [
        prepare_segments(segs, max_intron, MAX_SEG) if segs else []
        for segs in per_read_segments]

    # pad the batch dim to a power-of-two bucket (floor 64): the vmapped
    # chain fn then compiles for a bounded shape set (cached persistently)
    # instead of retracing on every batch size; padding rows carry
    # n_seg=0 and produce empty chains, sliced off below
    Bp = 64
    while Bp < B:
        Bp *= 2
    qs = np.zeros((Bp, MAX_SEG), np.int32)
    qe = np.zeros((Bp, MAX_SEG), np.int32)
    ts = np.zeros((Bp, MAX_SEG), np.int32)
    te = np.zeros((Bp, MAX_SEG), np.int32)
    cov = np.zeros((Bp, MAX_SEG), np.int32)
    n_seg = np.zeros(Bp, np.int32)
    for b, segs in enumerate(prepped):
        n_seg[b] = len(segs)
        t_base = min((s.t_start for s in segs), default=0)
        for i, s in enumerate(segs):
            qs[b, i], qe[b, i] = s.q_start, s.q_end
            ts[b, i] = s.t_start - t_base
            te[b, i] = s.t_end - t_base
            cov[b, i] = s.score_len

    # under a pipeline mesh the candidate batch shards over the devices
    # (module A's 'reads' axis); padding rows have n_seg=0 and produce
    # empty chains, sliced off below
    from mandalorion_tpu.parallel.mesh import dispatch_batch
    fn = _chain_fn(min_intron, max_intron, match, intron_penalty,
                   indel_open, indel_scale, MAX_SEG)
    rows = dispatch_batch(fn, [qs, qe, ts, te, cov, n_seg])
    parent, best, best_score = _unpack_chain(rows[:B], MAX_SEG)

    out: List[Tuple[List[Segment], float]] = []
    for b, segs in enumerate(prepped):
        if not segs:
            out.append(([], 0.0))
            continue
        chain_idx = []
        at = int(best[b])
        while at >= 0:
            chain_idx.append(at)
            at = int(parent[b, at])
        chain_idx.reverse()
        chain: List[Segment] = []
        prev_q = prev_t = -1
        for idx in chain_idx:
            s = segs[idx]
            trim = max(prev_q - s.q_start, prev_t - s.t_start, 0)
            q0, t0 = s.q_start + trim, s.t_start + trim
            if q0 >= s.q_end or t0 >= s.t_end:
                continue
            chain.append(Segment(q0, s.q_end, t0, s.t_end))
            prev_q, prev_t = s.q_end, s.t_end
        out.append((chain, float(best_score[b])))
    return out
