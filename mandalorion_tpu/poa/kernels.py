"""Batched seq-to-graph POA DP (the device route of the graph engine).

Replaces abPOA's SIMD seq-to-DAG alignment (SURVEY §2.2) the XLA way: the
graph lives on the host as columnar padded arrays in topological-rank
space, and the O(nodes x query) DP runs as one jitted `lax.fori_loop` over
ranks with full-row vector ops, `vmap`ped over a batch of (graph, query)
problems — many isoforms' reads aligned per device dispatch. Traceback
(cheap, sequential) walks the state matrices on the device (a while_loop;
the O(nodes x query) matrices never leave the device) and feeds
`PoaGraph.apply_path`.

Gap model: abPOA's convex dual-affine (gap_open/gap_extend +
gap_open2/gap_extend2) — two deletion states carried across graph edges,
two insertion states resolved per row with prefix-max scans (see
poa/graph.py for why the collapse is exact).

Bit-identical contract: scores, tie-breaks (first-max predecessor,
diag >= D1 >= D2, strict-> insertions I1 before I2, D open wins ties over
extend), band semantics, and traceback order all match `PoaGraph.align`
(tests/test_poa.py asserts equality), so the kernel and the Python engine
are interchangeable per read.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Sequence, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from mandalorion_tpu.poa.graph import NEG, PoaGraph, PoaParams

# one batched DP dispatch is chunked to stay under this many DP cells
# (4 packed traceback matrices + the in-flight DP state ~ 16-32 bytes per
# cell: 64M cells ~ 1-2 GB of device memory). A first guess carried over
# unmeasured; chunking never changes the output.
MAX_CELLS_PER_DISPATCH = 64 * 1024 * 1024


def _pow2_at_least(n: int, floor: int = 64) -> int:
    p = floor
    while p < n:
        p *= 2
    return p


def graph_arrays(graph: PoaGraph, n_cap: int, p_cap: int,
                 order: Optional[List[int]] = None
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, List[int]]:
    """Columnar rank-space arrays for one graph, padded to (n_cap, p_cap):
    (base_r, preds_r, is_end_r, order). preds_r holds predecessor ranks + 1
    (0 = virtual source row), -1 padding."""
    if order is None:
        order = graph.topo_order()
    rank = {v: r for r, v in enumerate(order)}
    n = len(order)
    base_r = np.zeros(n_cap, np.int32)
    preds_r = np.full((n_cap, p_cap), -1, np.int32)
    is_end_r = np.zeros(n_cap, bool)
    for r, v in enumerate(order):
        base_r[r] = graph.base[v]
        ps = graph.preds[v]
        if ps:
            for c, u in enumerate(ps):
                preds_r[r, c] = rank[u] + 1
        else:
            preds_r[r, 0] = 0
        is_end_r[r] = not graph.succs[v]
    return base_r, preds_r, is_end_r, order


def _off_row(t, n_nodes, qlen, eff_band, W: int):
    """Absolute column where matrix row t's stored window starts. The
    window [off, off+W) always covers the row's band [j0, j1] (the host
    guarantees W >= 2*eff_band+2 or W >= qlen+1), and every absolute
    column outside the band is NEG by the band-local masking semantics,
    so windowed reads with NEG fill are bit-exact vs the full-width
    oracle. off <= j0 always (clip can only lower it)."""
    center = t * qlen // jnp.maximum(n_nodes, 1)
    return jnp.clip(center - eff_band, 0,
                    jnp.maximum(0, qlen + 1 - W))


def _align_rows(base_r, preds_r, n_nodes, q, qlen, band, n_hi,
                match: int, mismatch: int, o1: int, e1: int,
                o2: int, e2: int, W: int, adaptive: bool = False):
    """One (graph, query) convex-affine DP in banded storage: matrix row
    r holds only the W-wide window starting at offs[r] (absolute column j
    lives at stored column j - offs[r]; static mode: _off_row's diagonal
    formula, adaptive mode: the score-following -S band, bit-identical to
    PoaGraph.align). Returns the traceback's packed windowed inputs —
    (hpack, opack, d1p, d2p), each (N+1, W) int32, plus the per-row
    window offsets and the per-row H value at column qlen (endcol).
    `band` is this problem's own half-width (a traced scalar, so problems
    with different bands share one dispatch). Vmapped over the batch axis
    by the caller."""
    n_cap = base_r.shape[0]
    cidx = jnp.arange(W, dtype=jnp.int32)

    band = jnp.int32(band)
    eff_band = (band if adaptive
                else jnp.maximum(band, jnp.abs(n_nodes - qlen) + 16))

    # row 0 (off = 0): convex insertion boundary, band-local
    g0 = -jnp.minimum(o1 + e1 * cidx, o2 + e2 * cidx)
    g0 = jnp.where(cidx == 0, 0, g0)
    g0 = jnp.where(cidx > jnp.minimum(qlen, eff_band), NEG, g0)
    score0 = jnp.full((n_cap + 1, W), NEG, jnp.int32).at[0].set(g0)
    d1m = jnp.full((n_cap + 1, W), NEG, jnp.int32)
    d2m = jnp.full((n_cap + 1, W), NEG, jnp.int32)
    # the traceback's per-cell decisions, PACKED at the source (the walk
    # reads one mat per state instead of five):
    #   hpack = op | op0 << 3 | (node0 + 2) << 6     (row 0: op=1 -> 1)
    #   opack = orig1 | orig2 << 16                   (qlen < 2^16 gate)
    hpackm = jnp.zeros((n_cap + 1, W), jnp.int32).at[0].set(1)
    opackm = jnp.zeros((n_cap + 1, W), jnp.int32)
    # D backpointers: packed (pred_row << 1) | took_extension per cell —
    # the first-max pred in declared order (strict > updates), so the
    # traceback follows them instead of re-deriving the pred via 2*p_cap
    # score/d gathers per deletion step (the walk's former hot cost)
    d1pm = jnp.zeros((n_cap + 1, W), jnp.int32)
    d2pm = jnp.zeros((n_cap + 1, W), jnp.int32)
    offs0 = jnp.zeros(n_cap + 1, jnp.int32)
    bestc0 = jnp.zeros(n_cap + 1, jnp.int32)  # first-max col per H row
    # per-row H value at absolute column qlen (NEG outside the window):
    # the walk's end-rank selection needs ONLY this column, so the full
    # score matrix never streams out
    endc0 = jnp.full(n_cap + 1, NEG, jnp.int32).at[0].set(
        jnp.max(jnp.where(cidx == qlen, g0, NEG)))

    p_cap = preds_r.shape[1]

    # q with a leading boundary slot and W trailing zeros so the per-row
    # window read below is one contiguous dynamic slice instead of a
    # per-lane gather (reads past qlen are band-masked)
    q_ext = jnp.concatenate(
        [jnp.zeros(1, jnp.int32), q.astype(jnp.int32),
         jnp.zeros(W, jnp.int32)])
    neg_pad = jnp.full(W + 1, NEG, jnp.int32)

    def body(r, carry):
        (score, d1, d2, hpk, opk, d1pt, d2pt, offs, bestc, endc) = carry
        base_v = base_r[r - 1]
        if adaptive:
            # -S band: one past the first-max column of the best pred row
            c = jnp.int32(NEG)
            for p in range(p_cap):
                pr = preds_r[r - 1, p]
                prc = jnp.maximum(pr, 0)
                c = jnp.maximum(c, jnp.where(pr >= 0, bestc[prc], NEG))
            center = c + 1
        else:
            center = r * qlen // jnp.maximum(n_nodes, 1)
        off = jnp.clip(center - eff_band, 0,
                       jnp.maximum(0, qlen + 1 - W))
        offs = offs.at[r].set(off)
        jabs = off + cidx                    # absolute columns
        j0 = jnp.maximum(0, center - eff_band)
        j1 = jnp.minimum(qlen, center + eff_band)
        masked = (jabs < j0) | (jabs > j1)

        # query base consumed by diag at absolute column j is q[j-1]
        qm1 = jax.lax.dynamic_slice(q_ext, (off,), (W,))
        sub = jnp.where(qm1 == base_v, match, -mismatch).astype(jnp.int32)

        # predecessor reads over the extended absolute range
        # [off-1, off+W-1] (W+1 wide: position e+1 is column jabs[e], the
        # leading -1 column feeds the diagonal). A predecessor row's
        # window starts at off_p, so its stored lanes sit at a constant
        # shift rel0 = off-1-off_p: one contiguous slice from a NEG-padded
        # copy of the row (out-of-window lanes land in the padding and/or
        # are masked by `ok`); for |rel0| beyond the pad the clamp engages
        # but `ok` is then all-false, so values never leak
        eabs = (off - 1) + jnp.arange(W + 1, dtype=jnp.int32)
        best_prev = jnp.full(W + 1, NEG, jnp.int32)
        best_rank = jnp.full(W + 1, -2, jnp.int32)
        d1_row = jnp.full(W, NEG, jnp.int32)
        d2_row = jnp.full(W, NEG, jnp.int32)
        d1_ptr = jnp.zeros(W, jnp.int32)
        d2_ptr = jnp.zeros(W, jnp.int32)
        for p in range(p_cap):
            pr = preds_r[r - 1, p]
            prc = jnp.maximum(pr, 0)
            off_p = offs[prc]
            rel = eabs - off_p
            ok = (pr >= 0) & (rel >= 0) & (rel < W) & (eabs >= 0)
            start = jnp.clip((off - 1 - off_p) + (W + 1), 0, 2 * W + 1)

            def shifted(mat):
                mrow = jax.lax.dynamic_index_in_dim(mat, prc, axis=0,
                                                    keepdims=False)
                padded = jnp.concatenate([neg_pad, mrow, neg_pad])
                win = jax.lax.dynamic_slice(padded, (start,), (W + 1,))
                return jnp.where(ok, win, NEG)

            row_p = shifted(score)
            d1_p = shifted(d1)
            d2_p = shifted(d2)
            better = row_p > best_prev
            best_prev = jnp.where(better, row_p, best_prev)
            best_rank = jnp.where(better, pr, best_rank)
            c1_open = row_p[1:] - (o1 + e1)
            c1_ext = d1_p[1:] - e1
            c1 = jnp.maximum(c1_open, c1_ext)
            b1 = c1 > d1_row
            d1_ptr = jnp.where(
                b1, (prc << 1) | (c1_ext > c1_open), d1_ptr)
            d1_row = jnp.where(b1, c1, d1_row)
            c2_open = row_p[1:] - (o2 + e2)
            c2_ext = d2_p[1:] - e2
            c2 = jnp.maximum(c2_open, c2_ext)
            b2 = c2 > d2_row
            d2_ptr = jnp.where(
                b2, (prc << 1) | (c2_ext > c2_open), d2_ptr)
            d2_row = jnp.where(b2, c2, d2_row)
        d1_row = jnp.where(masked, NEG, d1_row)
        d2_row = jnp.where(masked, NEG, d2_row)

        # H pre-insertion: diag >= D1 >= D2 on ties
        row = jnp.where(jabs == 0, NEG, best_prev[:-1] + sub)
        rowo = jnp.zeros(W, jnp.int32)
        rown = jnp.where(jabs == 0, -2, best_rank[:-1])
        m = d1_row > row
        row = jnp.where(m, d1_row, row)
        rowo = jnp.where(m, 2, rowo)
        m = d2_row > row
        row = jnp.where(m, d2_row, row)
        rowo = jnp.where(m, 4, rowo)

        # insertions may only open from in-band cells (band-local)
        row = jnp.where(masked, NEG, row)

        fin = row
        fino = rowo
        org_out = []
        for oo, ee, code in ((o1, e1, 1), (o2, e2, 3)):
            # prefix-max carry from the masked columns < off: their vals
            # are NEG + ee*j (monotone), so the carry into the window is
            # acc = NEG + ee*(off-1) with origin off-1 (ee>0) / 0 (ee==0)
            vals = row + ee * jabs
            acc_c = jnp.where(off > 0, NEG + ee * (off - 1),
                              jnp.int32(NEG - 1))
            if ee > 0:
                org_c = jnp.where(off > 0, off - 1, -1)
            else:
                org_c = jnp.where(off > 0, 0, -1)
            acc = jnp.maximum(jax.lax.cummax(vals), acc_c)
            prev_acc = jnp.concatenate([acc_c[None], acc[:-1]])
            is_new = vals > prev_acc
            org = jnp.maximum(
                jax.lax.cummax(jnp.where(is_new, jabs, -1)), org_c)
            ins = acc - oo - ee * jabs
            m = ins > fin
            fin = jnp.where(m, ins, fin)
            fino = jnp.where(m, code, fino)
            org_out.append(jnp.where(m, org, 0))

        # band mask on the stored H row
        fin = jnp.where(masked, NEG, fin)

        score = jax.lax.dynamic_update_slice(score, fin[None], (r, 0))
        d1 = jax.lax.dynamic_update_slice(d1, d1_row[None], (r, 0))
        d2 = jax.lax.dynamic_update_slice(d2, d2_row[None], (r, 0))
        hrow = fino | (rowo << 3) | ((rown + 2) << 6)
        orow = org_out[0] | (org_out[1] << 16)
        hpk = jax.lax.dynamic_update_slice(hpk, hrow[None], (r, 0))
        opk = jax.lax.dynamic_update_slice(opk, orow[None], (r, 0))
        d1pt = jax.lax.dynamic_update_slice(d1pt, d1_ptr[None], (r, 0))
        d2pt = jax.lax.dynamic_update_slice(d2pt, d2_ptr[None], (r, 0))
        endc = endc.at[r].set(
            jnp.max(jnp.where(jabs == qlen, fin, NEG)))
        # first-max column of the stored row (all-NEG rows pin to 0),
        # matching PoaGraph.align's best_col rule for the adaptive band
        row_best = jnp.max(fin)
        bcol = jnp.where(row_best <= NEG, 0,
                         off + jnp.argmax(fin).astype(jnp.int32))
        bestc = bestc.at[r].set(bcol)
        return (score, d1, d2, hpk, opk, d1pt, d2pt, offs, bestc, endc)

    # n_hi: the batch's actual max node count (traced scalar — rows past
    # any item's own n are computed but never read; rows past n_hi are
    # skipped entirely, which matters when padding rounds n_cap up)
    out = jax.lax.fori_loop(
        1, n_hi + 1, body,
        (score0, d1m, d2m, hpackm, opackm, d1pm, d2pm, offs0, bestc0,
         endc0))
    # walk inputs only: hpack, opack, d1p, d2p, offs, endcol
    return out[3], out[4], out[5], out[6], out[7], out[9]


def _align_traceback(base_r, preds_r, n_nodes, is_end_r, q, qlen, band,
                     n_hi, match: int, mismatch: int, o1: int, e1: int,
                     o2: int, e2: int, W: int, adaptive: bool = False):
    """DP + on-device traceback for one problem. The windowed state
    matrices (O(nodes x W)) never leave the device — only the path steps
    (O(nodes + query) ints) are returned:
    (steps[k] = (qi, rank), n_steps), written in reverse order.
    qi == -1: node deleted; rank == -1: query base inserted."""
    (hpack, opack, d1p, d2p, offs, endcol) = _align_rows(
        base_r, preds_r, n_nodes, q, qlen, band, n_hi,
        match, mismatch, o1, e1, o2, e2, W, adaptive)
    return _traceback_from_mats(
        preds_r, n_nodes, is_end_r, qlen, hpack, opack, d1p, d2p,
        offs, endcol, o1, e1, o2, e2, W, q.shape[0])


def _traceback_from_mats(preds_r, n_nodes, is_end_r, qlen,
                         hpack, opack, d1p, d2p, offs, endcol,
                         o1, e1, o2, e2, W, l_cap):
    """The on-device pointer walk over the forward pass's packed
    traceback matrices.

    Every per-cell decision is packed AT THE SOURCE into three int32
    mats read with one gather each (hpack: op | op0<<3 | (node0+2)<<6;
    opack: orig1 | orig2<<16; d1p/d2p: deletion backpointers
    (pred_row << 1) | ext), and the state machine is branchless selects
    instead of vmapped cond/switch — under vmap every branch of a cond
    executes for the whole batch, so the r4 per-step cost was ~25
    gathers (d_case alone re-derived its predecessor from 2*p_cap
    score/d reads); it is now 4. The end-rank selection reads the
    per-row `endcol` vector (H at absolute column qlen), so the score
    matrix never streams out of the forward at all. Semantics are
    step-for-step identical to the r4 walk."""
    n_cap = preds_r.shape[0]

    def cell(mat, t, j, fill=NEG):
        """mat value at matrix row t, ABSOLUTE column j (fill outside
        the stored window — exactly the band-local masked value)."""
        rel = j - offs[t]
        ok = (rel >= 0) & (rel < W)
        return jnp.where(ok, mat[t, jnp.clip(rel, 0, W - 1)], fill)

    # end rank: first max of H[r, qlen] over real end ranks — argmax's
    # first-occurrence rule IS PoaGraph.align's ascending-order tie-break
    end_mask = jnp.concatenate([jnp.zeros(1, bool), is_end_r])
    end_mask &= jnp.arange(n_cap + 1) <= n_nodes
    br = jnp.argmax(jnp.where(end_mask, endcol, NEG - 1)).astype(
        jnp.int32)

    max_steps = n_cap + l_cap + 2
    buf0 = jnp.zeros((max_steps, 2), jnp.int32)

    # traceback states: 0 H (final op), 1 H0 (pre-insertion op),
    # 2 D1, 3 D2, 4 INS (emitting an insertion run down to column `tgt`)
    def cond(c):
        st, r, j, tgt, k, _ = c
        return ((r > 0) | (j > 0)) & (r >= 0) & (k < max_steps)

    def step(c):
        st, r, j, tgt, k, buf = c
        hv = cell(hpack, r, j, 0)
        ov = cell(opack, r, j, 0)
        orig1v = ov & 0xFFFF
        orig2v = ov >> 16
        dptr = jnp.where(st == 2, cell(d1p, r, j, 0), cell(d2p, r, j, 0))

        h_active = (st == 0) | (st == 1)
        d_active = (st == 2) | (st == 3)
        at_row0 = r == 0
        opv = jnp.where(st == 1, (hv >> 3) & 7, hv & 7)
        node0v = (hv >> 6) - 2
        h_is_diag = (~at_row0) & (opv == 0)
        h_is_ins = (~at_row0) & ((opv == 1) | (opv == 3))
        ins_t = jnp.where(opv == 1, orig1v, orig2v)
        d_pr = dptr >> 1
        d_ext = (dptr & 1) == 1

        # emissions (an H deletion transition emits nothing; the slot at
        # k is overwritten by the next emitting step, and k bounds reads)
        emit_diag = h_active & h_is_diag
        emit_ins = (st == 4) | (h_active & (at_row0 | h_is_ins))
        do_emit = emit_diag | emit_ins | d_active
        qi_e = jnp.where(d_active, -1, j - 1)
        rk_e = jnp.where(emit_diag | d_active, r - 1, -1)
        buf = jax.lax.dynamic_update_slice(
            buf, jnp.stack([qi_e, rk_e])[None].astype(jnp.int32), (k, 0))
        k = k + do_emit.astype(jnp.int32)

        # next state per source state (same transitions as the r4 walk)
        st_h = jnp.where(
            at_row0, 0,
            jnp.where(h_is_diag, 0,
                      jnp.where(h_is_ins,
                                jnp.where(j - 1 > ins_t, 4, 1),
                                jnp.where(opv == 2, 2, 3))))
        r_h = jnp.where(h_is_diag, node0v, r)
        j_h = jnp.where(at_row0 | h_is_diag | h_is_ins, j - 1, j)
        tgt_h = jnp.where(h_is_ins, ins_t, tgt)
        st_i = jnp.where(j - 1 > tgt, 4, 1)

        st_n = jnp.where(h_active, st_h,
                         jnp.where(d_active,
                                   jnp.where(d_ext, st, 0), st_i))
        r_n = jnp.where(h_active, r_h, jnp.where(d_active, d_pr, r))
        j_n = jnp.where(h_active, j_h, jnp.where(d_active, j, j - 1))
        tgt_n = jnp.where(h_active, tgt_h, tgt)
        return (st_n.astype(jnp.int32), r_n.astype(jnp.int32),
                j_n.astype(jnp.int32), tgt_n.astype(jnp.int32), k, buf)

    _, _, _, _, k, buf = jax.lax.while_loop(
        cond, step,
        (jnp.int32(0), br, jnp.int32(qlen), jnp.int32(0), jnp.int32(0),
         buf0))
    return buf, k


_align_traceback_batch = jax.jit(
    jax.vmap(_align_traceback, in_axes=(0,) * 7 + (None,) * 9),
    static_argnames=("match", "mismatch", "o1", "e1", "o2", "e2", "W",
                     "adaptive"))


def _item_width(n_nodes: int, qlen: int, band: int, l_cap: int,
                adaptive: bool = False) -> int:
    """Banded-storage window width for one item: wide enough that its
    per-row band [j0, j1] fits (adaptive: half-width exactly `band`;
    static: eff_band widens with |nodes - qlen| drift, see _align_rows),
    rounded up to a power of two of the 128-lane tile (floor 256) —
    coarse quantization keeps the compiled-shape set small (over-width is
    safe: lanes beyond the band are NEG-masked)."""
    eff = band if adaptive else max(band, abs(n_nodes - qlen) + 16)
    need = min(qlen + 1, 2 * eff + 2)
    need = min(-(-(l_cap + 1) // 128) * 128, need)
    return _pow2_at_least(need, floor=256)


def align_graph_batch(graphs: Sequence[PoaGraph],
                      queries: Sequence[np.ndarray],
                      params: Optional[PoaParams] = None,
                      bands: Optional[Sequence[int]] = None
                      ) -> List[List[Tuple[int, Optional[int]]]]:
    """Align query[i] to graph[i] for every i in one (chunked) device
    dispatch; returns alignment paths for PoaGraph.apply_path. `bands`
    gives each problem its own band half-width (default params.band)."""
    params = params or PoaParams()
    assert len(graphs) == len(queries)
    if bands is None:
        bands = [params.band] * len(graphs)
    if not graphs:
        return []
    from mandalorion_tpu.runtime import enable_compilation_cache
    enable_compilation_cache()  # POA kernel shapes persist across runs
    orders = [g.topo_order() for g in graphs]
    # rank-row cap: pow2 up to 1024, then 512-steps — the DP cost is
    # LINEAR in n_cap (one grid/loop row each), so pow2 padding wasted
    # up to 2x the rows on mature graphs (a 2150-node graph padded to
    # 4096); 512-quantization bounds the waste at 31% while keeping the
    # compiled-shape set small (and persistent-cached)
    n_max = max(len(o) for o in orders)
    n_cap = (_pow2_at_least(n_max) if n_max <= 1024
             else -(-n_max // 512) * 512)
    if max(len(q) for q in queries) >= (1 << 16):
        # the packed traceback mats hold insertion origins in 16-bit
        # halves; reads this long are far outside the consensus regime —
        # the host C++ engine (the production default) has no such limit
        raise ValueError("device POA path: query >= 65536 bases "
                         "unsupported (use the host engine)")
    l_cap = _pow2_at_least(max(len(q) for q in queries))
    p_max = max(1, max((len(g.preds[v]) for g in graphs
                        for v in range(len(g.base))), default=1))
    p_cap = _pow2_at_least(p_max, floor=4)  # bucketed: caps recompiles
    # group items by their own 128-rounded window width so one wide
    # outlier no longer widens (and shrinks the chunks of) the whole
    # batch; W values are 128-multiples, bounding recompiles
    by_width: dict = {}
    for i, (order, q) in enumerate(zip(orders, queries)):
        w = _item_width(len(order), len(q), bands[i], l_cap,
                        params.adaptive)
        by_width.setdefault(w, []).append(i)
    paths: List[Optional[List[Tuple[int, Optional[int]]]]] = (
        [None] * len(graphs))
    for W in sorted(by_width):
        idxs = by_width[W]
        per_item = (n_cap + 1) * W
        chunk = max(1, MAX_CELLS_PER_DISPATCH // per_item)
        for c0 in range(0, len(idxs), chunk):
            _run_graph_chunk(idxs[c0:c0 + chunk], graphs, queries, orders,
                             bands, n_cap, l_cap, p_cap, W, params, paths)
    return paths  # type: ignore[return-value]


def _dispatch_chunk(base, preds, nn, ends, qq, ql, band, W, l_cap, pp):
    """The device part of one chunk dispatch: packed rank-space arrays
    and per-problem bands in, host (buf, ks) reverse-order step arrays
    out. Under a pipeline mesh the isoform axis shards over the devices
    (zero padding rows, n_nodes=0 and qlen=0, give empty paths)."""
    from mandalorion_tpu.parallel.mesh import dispatch_batch
    n_hi = jnp.int32(int(nn.max()))
    return dispatch_batch(
        lambda *a: _align_traceback_batch(
            *a, n_hi, pp.match, pp.mismatch, pp.gap_open, pp.gap_extend,
            pp.gap_open2, pp.gap_extend2, W, pp.adaptive),
        [base, preds, nn, ends, qq, ql, band])


def _run_graph_chunk(batch, graphs, queries, orders, bands, n_cap, l_cap,
                     p_cap, W, params, paths) -> None:
    """Dispatch one chunk of (graph, query) problems; write each problem's
    alignment path into paths[original_index]."""
    # pad the batch dim to a power-of-two bucket (floor 8) so the vmapped
    # DP compiles for a bounded shape set instead of retracing every
    # round as graphs finish; padding rows (n_nodes=0, qlen=0) terminate
    # their traceback immediately and are never read back
    Bp = _pow2_at_least(len(batch), floor=8)
    base = np.zeros((Bp, n_cap), np.int32)
    preds = np.full((Bp, n_cap, p_cap), -1, np.int32)
    ends = np.zeros((Bp, n_cap), bool)
    nn = np.zeros(Bp, np.int32)
    qq = np.zeros((Bp, l_cap), np.int32)
    ql = np.zeros(Bp, np.int32)
    band = np.zeros(Bp, np.int32)
    for bi, gi in enumerate(batch):
        b, p, e, _ = graph_arrays(graphs[gi], n_cap, p_cap, orders[gi])
        base[bi], preds[bi], ends[bi] = b, p, e
        nn[bi] = len(orders[gi])
        q = queries[gi]
        qq[bi, :len(q)] = q
        ql[bi] = len(q)
        band[bi] = bands[gi]
    buf, ks = _dispatch_chunk(base, preds, nn, ends, qq, ql, band, W, l_cap,
                              params)
    for bi, gi in enumerate(batch):
        order = orders[gi]
        steps = buf[bi, :ks[bi]][::-1]
        paths[gi] = [(int(qi), order[rank] if rank >= 0 else None)
                     for qi, rank in steps]


class NativePoaGraph:
    """A POA graph held in C++ between device rounds (native/poa.cpp
    GraphHandle) — the device consensus path's host staging (topo order,
    rank-space arrays, applying the traceback, the consensus walk) runs
    natively instead of through PoaGraph's Python adjacency loops, which
    were ~40% of the device path's wall time. Same graph semantics as
    PoaGraph/poa_consensus_c (bit-identical, tests/test_poa.py)."""

    def __init__(self, seq_codes: np.ndarray):
        from mandalorion_tpu.native import load_native
        self._lib = load_native()
        seq = np.ascontiguousarray(seq_codes, np.uint8)
        self._h = self._lib.poa_graph_new_c(seq.ctypes.data, len(seq))

    def close(self) -> None:
        if getattr(self, "_h", None):
            try:
                self._lib.poa_graph_free_c(self._h)
            except Exception:
                pass  # interpreter teardown may unload the lib first
            self._h = None

    __del__ = close

    def n_nodes(self) -> int:
        return int(self._lib.poa_graph_nodes_c(self._h))

    def max_preds(self) -> int:
        return int(self._lib.poa_graph_maxp_c(self._h))

    def fill_arrays(self, base_row: np.ndarray, preds_row: np.ndarray,
                    ends_row: np.ndarray) -> int:
        """Write this graph's rank-space arrays into the given batch-row
        slices (preds pre-filled -1); caches the topo order for
        apply_steps. Returns the node count."""
        n = self._lib.poa_graph_arrays_c(
            self._h, base_row.shape[0], preds_row.shape[1],
            base_row.ctypes.data, preds_row.ctypes.data,
            ends_row.ctypes.data)
        if n < 0:
            raise ValueError("poa_graph_arrays_c: caps too small")
        return int(n)

    def apply_steps(self, q: np.ndarray, buf_rows: np.ndarray,
                    k: int) -> None:
        """Thread query q along the device walk's reverse-order (qi,
        rank) steps (ranks resolve via the last fill_arrays order)."""
        qa = np.ascontiguousarray(q, np.uint8)
        b = np.ascontiguousarray(buf_rows[:k], np.int32)
        self._lib.poa_graph_apply_c(self._h, qa.ctypes.data,
                                    b.ctypes.data, int(k))

    def consensus(self) -> np.ndarray:
        out = np.empty(self.n_nodes() + 1, np.uint8)
        n = self._lib.poa_graph_consensus_handle_c(self._h,
                                                   out.ctypes.data)
        return out[:n].copy()


def _poa_consensus_batch_native(seq_sets, params, bands
                                ) -> List[np.ndarray]:
    """poa_consensus_batch with C++-held graphs: same lockstep rounds and
    the same chunked device dispatches (_dispatch_chunk), but the
    per-round topo/array staging and path application never touch Python
    adjacency lists, and the walk's steps go straight to C."""
    graphs = [NativePoaGraph(s[0]) for s in seq_sets]
    max_reads = max((len(s) for s in seq_sets), default=0)
    for k in range(1, max_reads):
        live = [i for i, s in enumerate(seq_sets) if k < len(s)]
        if not live:
            break
        queries = [seq_sets[i][k] for i in live]
        nodes = [graphs[i].n_nodes() for i in live]
        n_max = max(nodes)
        n_cap = (_pow2_at_least(n_max) if n_max <= 1024
                 else -(-n_max // 512) * 512)
        if max(len(q) for q in queries) >= (1 << 16):
            raise ValueError("device POA path: query >= 65536 bases "
                             "unsupported (use the host engine)")
        l_cap = _pow2_at_least(max(len(q) for q in queries))
        p_cap = _pow2_at_least(
            max(graphs[i].max_preds() for i in live), floor=4)
        by_width: dict = {}
        for pos, i in enumerate(live):
            w = _item_width(nodes[pos], len(queries[pos]), bands[i],
                            l_cap, params.adaptive)
            by_width.setdefault(w, []).append(pos)
        for W in sorted(by_width):
            idxs = by_width[W]
            per_item = (n_cap + 1) * W
            chunk = max(1, MAX_CELLS_PER_DISPATCH // per_item)
            for c0 in range(0, len(idxs), chunk):
                batch = idxs[c0:c0 + chunk]
                Bp = _pow2_at_least(len(batch), floor=8)
                base = np.zeros((Bp, n_cap), np.int32)
                preds = np.full((Bp, n_cap, p_cap), -1, np.int32)
                ends = np.zeros((Bp, n_cap), bool)
                nn = np.zeros(Bp, np.int32)
                qq = np.zeros((Bp, l_cap), np.int32)
                ql = np.zeros(Bp, np.int32)
                band = np.zeros(Bp, np.int32)
                for bi, pos in enumerate(batch):
                    g = graphs[live[pos]]
                    nn[bi] = g.fill_arrays(base[bi], preds[bi], ends[bi])
                    q = queries[pos]
                    qq[bi, :len(q)] = q
                    ql[bi] = len(q)
                    band[bi] = bands[live[pos]]
                buf, ks = _dispatch_chunk(base, preds, nn, ends, qq, ql,
                                          band, W, l_cap, params)
                for bi, pos in enumerate(batch):
                    graphs[live[pos]].apply_steps(
                        queries[pos], buf[bi], int(ks[bi]))
    out = [g.consensus() for g in graphs]
    for g in graphs:
        g.close()
    return out


def poa_consensus_batch(seq_sets: Sequence[List[np.ndarray]],
                        params: Optional[PoaParams] = None,
                        bands: Optional[Sequence[int]] = None
                        ) -> List[np.ndarray]:
    """Graph-POA consensus of many isoforms at once: reads are threaded in
    lockstep rounds — round k aligns the k-th read of every still-growing
    graph in one batched dispatch (the per-locus isoform axis, mirroring
    the reference's one-abpoa-process-per-isoform at SDC.py:915-919).
    `bands` gives each set its own band half-width (default params.band),
    carried per problem into the shared dispatch. Graphs live in C++
    between rounds when the native library is present (NativePoaGraph);
    the pure-Python PoaGraph path is the fallback and the parity
    oracle."""
    params = params or PoaParams()
    if bands is None:
        bands = [params.band] * len(seq_sets)
    if len(bands) != len(seq_sets):
        raise ValueError("poa_consensus_batch: one band per set")
    from mandalorion_tpu.runtime import enable_compilation_cache
    enable_compilation_cache()
    from mandalorion_tpu.native import load_native
    if load_native() is not None:
        return _poa_consensus_batch_native(seq_sets, params, bands)
    graphs = [PoaGraph(s[0]) for s in seq_sets]
    max_reads = max((len(s) for s in seq_sets), default=0)
    for k in range(1, max_reads):
        live = [i for i, s in enumerate(seq_sets) if k < len(s)]
        if not live:
            break
        paths = align_graph_batch([graphs[i] for i in live],
                                  [seq_sets[i][k] for i in live], params,
                                  [bands[i] for i in live])
        for i, path in zip(live, paths):
            graphs[i].apply_path(seq_sets[i][k], path)
    return [g.consensus() for g in graphs]
