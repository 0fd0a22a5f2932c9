"""Batched affine-gap DP on the device, in plain JAX that XLA compiles.

The DP is vmapped over problems and `lax.scan`ned over query rows; the
target axis is the vector axis (lane j holds target base j-1, lane 0 is
the DP boundary column). The horizontal (deletion) state's in-row
dependency collapses to one prefix-max scan (affine gap re-opening never
beats extending), so each row is a handful of vector ops. The rows emit
per-cell traceback pointer bits; tie-break rules match the numpy oracle
(align/extend.py) and the native C++ solver exactly, so every backend is
interchangeable.

Two entry points share the bucketing below:
- `solve_dp_rowscan` — DpProblem lists in, DpResults out (pointer matrix
  fetched, walked on the host);
- `solve_dp_fused`   — the staged module-A path: DP, start-cell pick and
  traceback walk in one jitted call per (width, rows) class.

Problems are bucketed by target width (WIDTHS) and quantized query-row
cap (Q_STEPS); only problems beyond MAX_T_DEVICE / MAX_Q_DEVICE fall
back to the host solver.
"""

from __future__ import annotations

import functools
from typing import List, Sequence, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from mandalorion_tpu.align.extend import DpProblem, DpResult, _solve_one
from mandalorion_tpu.config import AlignConfig

NEG = -(10 ** 9)
# width buckets for the target axis (lanes = target + 1 boundary column);
# 2304 covers the largest end extension (max_end_extend + band = 2176)
WIDTHS = (128, 256, 512, 1024, 2304)
MAX_T_DEVICE = WIDTHS[-1] - 1
MAX_Q_DEVICE = 2048


def _shift_right(x, fill=NEG):
    """out[..., j] = x[..., j-1]; out[..., 0] = fill. Lane-axis shift."""
    rolled = jnp.roll(x, 1, axis=x.ndim - 1)
    jidx = jax.lax.broadcasted_iota(jnp.int32, x.shape, x.ndim - 1)
    return jnp.where(jidx >= 1, rolled, fill)


def _cummax(x):
    """Inclusive prefix max along the lane axis via doubling."""
    jidx = jax.lax.broadcasted_iota(jnp.int32, x.shape, x.ndim - 1)
    d = 1
    n = x.shape[-1]
    while d < n:
        rolled = jnp.roll(x, d, axis=x.ndim - 1)
        x = jnp.maximum(x, jnp.where(jidx >= d, rolled, NEG))
        d *= 2
    return x


def row_step(h_prev, e_prev, t_codes, q_col, jidx, *, match, mismatch,
             go, ge):
    """One DP row. All arrays (..., width). q_col broadcastable (..., 1).
    Returns (h_row, e_row, packed_ptr_bits)."""
    open_e = h_prev - go - ge
    ext_e = e_prev - ge
    e_row = jnp.maximum(open_e, ext_e)
    e_ext = ext_e > open_e
    # t_codes lane j holds target base j-1, so sub is already aligned to
    # cell column j; only the H row shifts
    sub = jnp.where(t_codes == q_col, match, -mismatch)
    diag = _shift_right(h_prev) + sub
    b = jnp.where(jidx == 0, e_row, jnp.maximum(diag, e_row))
    # F via collapsed prefix-max: F[j] = max_{k<j}(B[k]+ge*k) - go - ge*j
    scan = _cummax(b + ge * jidx)
    f_row = _shift_right(scan) - go - ge * jidx
    f_ext = (_shift_right(f_row) - ge) > (_shift_right(b) - go - ge)
    h_row = diag
    code = jnp.zeros_like(jidx)
    take_e = e_row > h_row
    h_row = jnp.where(take_e, e_row, h_row)
    code = jnp.where(take_e, 1, code)
    take_f = f_row > h_row
    h_row = jnp.where(take_f, f_row, h_row)
    code = jnp.where(take_f, 2, code)
    h_row = jnp.where(jidx == 0, e_row, h_row)
    code = jnp.where(jidx == 0, 1, code)
    packed = (code | (e_ext.astype(jnp.int32) << 2)
              | (f_ext.astype(jnp.int32) << 3))
    return h_row, e_row, packed


def _row0(jidx, go, ge):
    h0 = jnp.where(jidx == 0, 0, -(go + ge * jidx))
    ptr0 = jnp.where(jidx == 0, 0,
                     2 | (jnp.where(jidx > 1, 1, 0) << 3))
    return h0, ptr0.astype(jnp.int32)


@functools.lru_cache(maxsize=64)
def _rowscan_fn(match, mismatch, go, ge, max_q, end_bonus=0, zdrop=0,
                width=128):
    def one(q, t_codes, qlen, tlen):
        """q (max_q,), t_codes (width,) with lane j = base j-1."""
        jidx = jax.lax.broadcasted_iota(jnp.int32, (1, width), 1)
        t2 = t_codes[None, :]
        h0, ptr0 = _row0(jidx, go, ge)

        def step(carry, q_i):
            h_prev, e_prev = carry
            h, e, packed = row_step(
                h_prev, e_prev, t2, q_i[None, None], jidx,
                match=match, mismatch=mismatch, go=go, ge=ge)
            return (h, e), (h, packed)

        (_h, _e), (hs, ptrs) = jax.lax.scan(
            step, (h0, jnp.full((1, width), NEG, jnp.int32)), q)
        hs = jnp.concatenate([h0[None], hs], axis=0)[:, 0, :]
        ptrs = jnp.concatenate([ptr0[None], ptrs], axis=0)[:, 0, :]
        iidx = jnp.arange(max_q + 1)[:, None]
        jj = jnp.arange(width)[None, :]
        valid = (iidx >= 1) & (iidx <= qlen) & (jj <= tlen)
        if zdrop > 0:
            # minimap2 -z: exclude the first row whose raw best falls
            # more than zdrop below the running best, and every row
            # after it — the vector form of the oracle's loop break
            raw = jnp.max(jnp.where(valid, hs, NEG), axis=1)
            run = jnp.maximum(jax.lax.cummax(raw), 0)  # baseline H[0,0]=0
            prev = jnp.concatenate([jnp.zeros(1, run.dtype), run[:-1]])
            cutf = (raw < prev - zdrop) & (iidx[:, 0] >= 1)  # row 0 = base
            first_cut = jnp.min(jnp.where(cutf, iidx[:, 0], max_q + 2))
            valid = valid & (iidx < first_cut)
        masked = jnp.where(valid, hs, NEG)
        masked = masked + jnp.where((iidx == qlen) & valid, end_bonus, 0)
        flat = jnp.argmax(masked)
        best_i, best_j = flat // width, flat % width
        best = masked.reshape(-1)[flat]
        final = hs[qlen, tlen]
        return ptrs, jnp.stack([best_i, best_j, best, final])

    return jax.jit(jax.vmap(one))


def solve_dp_rowscan(problems: Sequence[DpProblem], cfg: AlignConfig
                     ) -> List[DpResult]:
    """Device DP over a problem list (pointer matrices walked on the
    host)."""
    return _solve_batched(problems, cfg, _dispatch_rowscan)


def _dispatch_rowscan(q_arr, t_arr, qlen, tlen, cfg, max_q, width):
    from mandalorion_tpu.parallel.mesh import dispatch_batch
    fn = _rowscan_fn(cfg.match, cfg.mismatch, cfg.gap_open, cfg.gap_extend,
                     max_q, cfg.end_bonus, getattr(cfg, "zdrop", 0), width)
    # under a pipeline mesh the problem batch shards over the devices
    # (module A's 'reads' axis); padding rows carry qlen=0
    return dispatch_batch(fn, [q_arr, t_arr, qlen[:, 0].copy(),
                               tlen[:, 0].copy()])


# ------------------------------------------------------------ shared glue

def _traceback_walk(max_steps):
    """Vmapped on-device pointer walk (the host _traceback's state machine
    verbatim): returns per-problem op-step codes (1 M, 2 I, 3 D, reverse
    order) and counts, so only O(q+t) bytes reach the host instead of the
    O(q*t) pointer matrix."""
    def one(ptr, qi, tj):
        buf0 = jnp.zeros(max_steps, jnp.int8)

        def cond(c):
            st, i, j, k, _ = c
            return ((i > 0) | (j > 0)) & (k < max_steps)

        def step(c):
            st, i, j, k, buf = c
            p = ptr[i, j]
            code = p & 3
            is_h = st == 0
            h_diag = is_h & (code == 0) & (i > 0) & (j > 0)
            h_to_e = is_h & ~h_diag & (code == 1)
            h_to_f = is_h & ~h_diag & (code != 1)
            is_e = st == 1
            is_f = st == 2
            emit = h_diag | is_e | is_f
            opc = jnp.where(h_diag, 1, jnp.where(is_e, 2, 3)).astype(
                jnp.int8)
            buf = jnp.where(emit, buf.at[k].set(opc), buf)
            k = k + emit.astype(jnp.int32)
            i = i - (h_diag | is_e).astype(jnp.int32)
            j = j - (h_diag | is_f).astype(jnp.int32)
            e_next = jnp.where((p >> 2) & 1, 1, 0)
            f_next = jnp.where((p >> 3) & 1, 2, 0)
            st = jnp.where(
                h_diag, 0,
                jnp.where(h_to_e, 1,
                          jnp.where(h_to_f, 2,
                                    jnp.where(is_e, e_next,
                                              jnp.where(is_f, f_next,
                                                        st)))))
            return st, i, j, k, buf

        _, _, _, k, buf = jax.lax.while_loop(
            cond, step,
            (jnp.int32(0), jnp.int32(qi), jnp.int32(tj), jnp.int32(0),
             buf0))
        return buf, k

    return jax.vmap(one)


def _merge_steps(steps: np.ndarray) -> List[Tuple[str, int, int]]:
    """Reverse-order step codes -> merged (op, dq, dt) runs (the host
    _traceback's output contract)."""
    ops: List[Tuple[str, int, int]] = []
    for c in steps[::-1]:
        op = "MID"[c - 1]
        dq = 1 if op != "D" else 0
        dt = 1 if op != "I" else 0
        if ops and ops[-1][0] == op:
            ops[-1] = (op, ops[-1][1] + dq, ops[-1][2] + dt)
        else:
            ops.append((op, dq, dt))
    return ops


def _traceback(ptr: np.ndarray, qi: int, tj: int
               ) -> List[Tuple[str, int, int]]:
    """Walk packed pointer bits to merged op runs (oracle-compatible)."""
    ops: List[Tuple[str, int, int]] = []
    i, j = qi, tj
    state = "H"
    while i > 0 or j > 0:
        p = int(ptr[i, j])
        if state == "H":
            code = p & 3
            if code == 0 and i > 0 and j > 0:
                ops.append(("M", 1, 1))
                i -= 1
                j -= 1
            elif code == 1:
                state = "E"
            else:
                state = "F"
        elif state == "E":
            ops.append(("I", 1, 0))
            state = "E" if (p >> 2) & 1 else "H"
            i -= 1
        else:
            ops.append(("D", 0, 1))
            state = "F" if (p >> 3) & 1 else "H"
            j -= 1
    ops.reverse()
    merged: List[Tuple[str, int, int]] = []
    for op, dq, dt in ops:
        if merged and merged[-1][0] == op:
            merged[-1] = (op, merged[-1][1] + dq, merged[-1][2] + dt)
        else:
            merged.append((op, dq, dt))
    return merged


def _width_for(tlen: int) -> int:
    for w in WIDTHS:
        if tlen + 1 <= w:
            return w
    raise ValueError(tlen)


# quantized query-row caps: together with WIDTHS this fixes the FULL set
# of kernel shapes the aligner can ever dispatch (<= 5x5 combos, each with
# one fixed batch size from _dispatch_batch) — so compiles are bounded per
# process and hit the persistent cache across processes; with a floating
# batch size and row cap nearly every read batch would recompile.
Q_STEPS = (8, 32, 128, 512, MAX_Q_DEVICE)
# per-dispatch pointer-cell budget (int32 cells; 64M = 256 MB of pointer
# matrix, the same again for the stacked H rows). A first guess carried
# over unmeasured; padding is masked, so it moves time, never output.
CELLS_CAP = 64 * 1024 * 1024


def fits_device(nq: int, nt: int) -> bool:
    """True when a (query, target) DP problem is inside the device
    envelope; the rest go to the host solver."""
    return 0 < nq <= MAX_Q_DEVICE and 0 < nt <= MAX_T_DEVICE


def _quant_q(longest: int) -> int:
    for q in Q_STEPS:
        if longest <= q:
            return q
    raise ValueError(longest)


def _dispatch_batch(width: int, max_q: int) -> int:
    """Fixed problem count for a (width, max_q) class: the largest power
    of two from 8 to 1024 whose pointer matrix stays under CELLS_CAP (8
    when even that exceeds it)."""
    cap = max(8, CELLS_CAP // ((max_q + 1) * width))
    n = 8
    while n * 2 <= min(cap, 1024):
        n *= 2
    return n


def _promote_buckets(buckets: dict) -> dict:
    """Dispatch-count-aware class promotion: when folding every
    (width, rows) class into the largest one yields FEWER dispatches,
    promote. It trades padded compute for fewer dispatches and blocking
    fetches; whether that pays on this device is not measured yet.
    Padding is output-neutral (kernels mask by qlen/tlen)."""
    if len(buckets) <= 1:
        return buckets
    w_max = max(k[0] for k in buckets)
    q_max = max(k[1] for k in buckets)
    n_promo = _dispatch_batch(w_max, q_max)
    baseline = sum(
        -(-len(v) // _dispatch_batch(w, q))
        for (w, q), v in buckets.items())
    total = sum(len(v) for v in buckets.values())
    if -(-total // n_promo) < baseline:
        merged = [i for k in sorted(buckets) for i in buckets[k]]
        return {(w_max, q_max): merged}
    return buckets


def _solve_batched(problems: Sequence[DpProblem], cfg: AlignConfig,
                   dispatch) -> List[DpResult]:
    """Problems bucket by (target-width, quantized query-row) class; each
    class dispatches in fixed-size chunks (one compiled kernel per class).
    Only degenerate problems (query > MAX_Q_DEVICE rows or target >
    MAX_T_DEVICE) fall back to the host solver."""
    results: List[DpResult] = [None] * len(problems)  # type: ignore
    buckets: dict = {}
    for i, p in enumerate(problems):
        if fits_device(len(p.q), len(p.t)):
            key = (_width_for(len(p.t)), _quant_q(len(p.q)))
            buckets.setdefault(key, []).append(i)
        else:
            results[i] = _solve_one(p, cfg)
    buckets = _promote_buckets(buckets)
    for width, max_q in sorted(buckets):
        fit_idx = buckets[(width, max_q)]
        N = _dispatch_batch(width, max_q)
        for c0 in range(0, len(fit_idx), N):
            _solve_chunk(fit_idx[c0:c0 + N], N, problems, cfg, dispatch,
                         max_q, width, results)
    return results


def _solve_chunk(chunk_idx: List[int], N: int,
                 problems: Sequence[DpProblem], cfg: AlignConfig,
                 dispatch, max_q: int, width: int,
                 results: List[DpResult]) -> None:
    """One fixed-shape dispatch: exactly N problem rows (padded with
    qlen=0/tlen=0 rows past the chunk)."""
    q_arr = np.zeros((N, max_q), np.int32)
    t_arr = np.full((N, width), 9, np.int32)   # 9 matches nothing
    qlen = np.zeros((N, 1), np.int32)
    tlen = np.zeros((N, 1), np.int32)
    for slot, i in enumerate(chunk_idx):
        p = problems[i]
        q_arr[slot, :len(p.q)] = p.q
        t_arr[slot, 1:1 + len(p.t)] = p.t
        qlen[slot, 0] = len(p.q)
        tlen[slot, 0] = len(p.t)

    ptr, meta = dispatch(q_arr, t_arr, qlen, tlen, cfg, max_q, width)

    starts: List[Tuple[int, int, int]] = []  # (slot, qi, tj)
    for slot, i in enumerate(chunk_idx):
        p = problems[i]
        nq, nt = len(p.q), len(p.t)
        if p.mode == "global":
            qi, tj = nq, nt
        else:
            qi, tj = int(meta[slot, 0]), int(meta[slot, 1])
            if int(meta[slot, 2]) <= 0:
                results[i] = DpResult([], 0, 0)
                continue
        starts.append((slot, qi, tj))

    for slot, qi, tj in starts:
        results[chunk_idx[slot]] = DpResult(
            _traceback(ptr[slot], qi, tj), qi, tj)


# ---------------------------------------------------- staged device path

@functools.lru_cache(maxsize=64)
def _rowscan_fused_fn(match, mismatch, go, ge, end_bonus, zdrop, max_q,
                      width):
    """DP + start-cell pick (global corner vs best cell) + traceback walk
    in one jitted call with one packed int8 output (see _unpack_fused):
    the host never blocks on meta between fill and walk, and the O(q*t)
    pointer matrix stays on the device."""
    raw = _rowscan_fn(match, mismatch, go, ge, max_q, end_bonus, zdrop,
                      width)
    walk = _traceback_walk(max_q + width + 2)

    def fused(q, t, qlen, tlen, is_global):
        ptr, meta = raw(q, t, qlen[:, 0], tlen[:, 0])
        qi = jnp.where(is_global, qlen[:, 0], meta[:, 0])
        tj = jnp.where(is_global, tlen[:, 0], meta[:, 1])
        dead = (~is_global) & (meta[:, 2] <= 0)
        qi = jnp.where(dead, 0, qi)
        tj = jnp.where(dead, 0, tj)
        buf, ks = walk(ptr, qi, tj)
        meta8 = jax.lax.bitcast_convert_type(
            meta[:, :4].astype(jnp.int32), jnp.int8).reshape(
            meta.shape[0], 16)
        ks8 = jax.lax.bitcast_convert_type(ks[:, None].astype(jnp.int32),
                                           jnp.int8).reshape(
            meta.shape[0], 4)
        return jnp.concatenate([meta8, ks8, buf], axis=1)

    return jax.jit(fused)


def _unpack_fused(rows: np.ndarray):
    """Split packed fused-DP rows into (meta, ks, buf)."""
    n = rows.shape[0]
    meta = np.ascontiguousarray(rows[:, :16]).view(np.int32).reshape(n, 4)
    ks = np.ascontiguousarray(rows[:, 16:20]).view(np.int32)[:, 0]
    return meta, ks, rows[:, 20:]


def solve_dp_fused(probs, oriented: np.ndarray, read_off: np.ndarray,
                   genome: np.ndarray, cfg: AlignConfig):
    """Solve the staged device path's DP problem DESCRIPTORS
    (stage_fill_batch_c output) on device, returning per-problem packed
    fused results for the native emit phase:
    (meta (n,4) int32, ks (n,) int32, buf (n,S) int8 reverse-order step
    codes, on_host (n,) uint8). Device-ineligible problems get
    on_host=1 and untouched rows — stage_emit_batch_c solves them inline
    with the same bit-identical host solver. Bucketing, class promotion,
    and fixed dispatch shapes are _solve_batched's (shared helpers), so
    this entry adds no new compiled kernel shapes. Under a pipeline mesh
    each dispatch's batch shards over the devices."""
    prob_nq, prob_nt = probs[4], probs[5]
    n = len(prob_nq)
    on_host = np.zeros(n, np.uint8)
    buckets: dict = {}
    for i in range(n):
        nq, nt = int(prob_nq[i]), int(prob_nt[i])
        if fits_device(nq, nt):
            buckets.setdefault((_width_for(nt), _quant_q(nq)),
                               []).append(i)
        else:
            on_host[i] = 1
    meta = np.zeros((n, 4), np.int32)
    ks = np.zeros(n, np.int32)
    if not buckets:
        return meta, ks, np.zeros((n, 1), np.int8), on_host
    buckets = _promote_buckets(buckets)
    S = max(mq + w + 2 for w, mq in buckets)
    buf = np.zeros((n, S), np.int8)
    from mandalorion_tpu.parallel.mesh import dispatch_batch
    for width, max_q in sorted(buckets):
        fit_idx = buckets[(width, max_q)]
        N = _dispatch_batch(width, max_q)
        fn = _rowscan_fused_fn(
            cfg.match, cfg.mismatch, cfg.gap_open, cfg.gap_extend,
            cfg.end_bonus, getattr(cfg, "zdrop", 0), max_q, width)
        for c0 in range(0, len(fit_idx), N):
            chunk = fit_idx[c0:c0 + N]
            rows = dispatch_batch(fn, pack_fused_chunk(
                probs, chunk, N, max_q, width, oriented, read_off, genome))
            m, k_arr, b = _unpack_fused(rows)
            idx = np.asarray(chunk, np.int64)
            meta[idx] = m[:len(chunk)]
            ks[idx] = k_arr[:len(chunk)]
            buf[idx, :b.shape[1]] = b[:len(chunk)]
    return meta, ks, buf, on_host


def pack_fused_chunk(probs, chunk, N: int, max_q: int, width: int,
                     oriented: np.ndarray, read_off: np.ndarray,
                     genome: np.ndarray) -> list:
    """The fixed-shape host arrays of one fused-DP dispatch for problem
    descriptors `chunk` (indices into `probs`): [q (N, max_q), t (N,
    width) with lane j = base j-1, qlen (N, 1), tlen (N, 1), is_global
    (N,)]; rows past the chunk are padding (qlen = tlen = 0)."""
    prob_read, prob_mode, prob_q0, prob_t0, prob_nq, prob_nt = probs
    q_arr = np.zeros((N, max_q), np.int32)
    t_arr = np.full((N, width), 9, np.int32)   # 9 matches nothing
    qlen = np.zeros((N, 1), np.int32)
    tlen = np.zeros((N, 1), np.int32)
    is_global = np.zeros(N, bool)
    for slot, i in enumerate(chunk):
        ri = int(prob_read[i])
        q = oriented[read_off[ri]:read_off[ri + 1]]
        mode = int(prob_mode[i])
        q0, t0 = int(prob_q0[i]), int(prob_t0[i])
        nq, nt = int(prob_nq[i]), int(prob_nt[i])
        if mode == 2:  # extend_left: reversed arrays
            q_arr[slot, :nq] = q[q0 - nq:q0][::-1]
            t_arr[slot, 1:1 + nt] = genome[t0 - nt:t0][::-1]
        else:
            q_arr[slot, :nq] = q[q0:q0 + nq]
            t_arr[slot, 1:1 + nt] = genome[t0:t0 + nt]
        qlen[slot, 0] = nq
        tlen[slot, 0] = nt
        is_global[slot] = mode == 0
    return [q_arr, t_arr, qlen, tlen, is_global]
