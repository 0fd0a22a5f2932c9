"""Sharded collective steps used by the mesh-integrated pipeline.

The production integration lives in the batched dispatch sites themselves
(align/chain_kernel.py, align/kernels.py, poa/kernels.py consult
parallel.mesh.pipeline_mesh and shard their batch axes); this module holds
the explicitly-collective pieces: the quant count-matrix psum merge
(module Q's cross-shard reduction, `mesh_count_matrix`), sharded alignment
scoring, and the hash-axis-sharded genome-index lookup (the path to
indexes larger than one host's memory). SURVEY §2.3 merge collectives.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np

import jax
import jax.numpy as jnp
try:
    from jax import shard_map  # jax >= 0.8
except ImportError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map

import inspect as _inspect

# the replication-check kwarg was renamed check_rep -> check_vma in 0.8
_CHECK_KW = ("check_vma" if "check_vma"
             in _inspect.signature(shard_map).parameters else "check_rep")
from jax.sharding import Mesh, PartitionSpec as P

from mandalorion_tpu.align.kernels import row_step, _row0, NEG


def _score_batch(q_codes: jnp.ndarray, t_codes: jnp.ndarray,
                 match: int = 1, mismatch: int = 2, go: int = 2,
                 ge: int = 1) -> jnp.ndarray:
    """Vectorized alignment scores for a padded read batch: (B, L) query
    codes vs (B, 128) target windows -> (B,) best global scores. The row
    math is shared with the device DP (align/kernels.row_step)."""

    def one(q, t):
        jidx = jax.lax.broadcasted_iota(jnp.int32, (1, 128), 1)
        h0, _ = _row0(jidx, go, ge)
        # tie the scan carry to the (possibly sharded) input so its
        # varying-manual-axes match under shard_map
        h0 = h0 + 0 * t[0]

        def step(carry, q_i):
            h, e = carry
            h2, e2, _ = row_step(h, e, t[None, :], q_i[None, None], jidx,
                                 match=match, mismatch=mismatch, go=go,
                                 ge=ge)
            return (h2, e2), None

        e0 = jnp.full((1, 128), NEG, jnp.int32) + 0 * t[0]
        (h, _e), _ = jax.lax.scan(step, (h0, e0), q)
        return jnp.max(h)

    return jax.vmap(one)(q_codes, t_codes)


def sharded_batch_score(mesh: Mesh, q_codes, t_codes):
    """Data-parallel alignment scoring over the 'reads' axis."""
    spec = P("reads") if "loci" not in mesh.axis_names else P(("reads",))

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P("reads", None), P("reads", None)),
        out_specs=P("reads"))
    def run(q, t):
        return _score_batch(q, t)

    return run(q_codes, t_codes)


def sharded_quant_merge(mesh: Mesh, per_device_counts):
    """psum per-device (isoforms, samples) partial count matrices — the
    collective replacing assignReadsToIsoforms' single-process count
    (SURVEY §2.3 merge collectives). Input: (n_devices, I, S) stacked
    partials on a 1D mesh; returns the merged (I, S) matrix."""
    axis = mesh.axis_names[0]

    @functools.partial(shard_map, mesh=mesh,
                       in_specs=P(axis, None, None),
                       out_specs=P(None, None))
    def run(counts):
        return jax.lax.psum(counts[0], axis)

    return run(per_device_counts)


def shard_index_arrays(index, n_shards: int):
    """Split a GenomeIndex's (sorted_hashes, sorted_positions) into
    n_shards hash-range shards for device sharding. Split points snap to
    bucket boundaries so equal hashes never straddle shards (a hash's
    occurrence count — the max_occ repeat filter — stays exact on its
    owner shard). Returns (hashes (n,S), positions (n,S), lens (n,)),
    padded with the max-hash sentinel."""
    import numpy as np
    total = len(index.sorted_hashes)
    cuts = [0]
    for i in range(1, n_shards):
        target = i * total // n_shards
        b = int(np.searchsorted(index.bucket_lo, target, side="left"))
        cuts.append(int(index.bucket_lo[min(b, len(index.bucket_lo) - 1)]))
    cuts.append(total)
    cuts = sorted(cuts)
    lens = np.array([cuts[i + 1] - cuts[i] for i in range(n_shards)],
                    np.int32)
    width = max(int(lens.max()), 1)
    hashes = np.full((n_shards, width), np.uint64(0xFFFFFFFFFFFFFFFF))
    positions = np.zeros((n_shards, width), np.int64)
    for i in range(n_shards):
        sl = slice(cuts[i], cuts[i + 1])
        hashes[i, :lens[i]] = index.sorted_hashes[sl]
        positions[i, :lens[i]] = index.sorted_positions[sl].astype(np.int64)
    return hashes, positions, lens


def _pad_pow2(a: np.ndarray, fill) -> np.ndarray:
    """Pad a 1-D array to a power-of-two length (floor 64) so that batches
    of any size share a handful of compiled shapes."""
    n = 64
    while n < len(a):
        n *= 2
    return np.concatenate([a, np.full(n - len(a), fill, a.dtype)])


class ShardedIndex:
    """A genome index's (hash, position) arrays split into hash-range
    shards, one per mesh device and resident there (SURVEY §2.3's
    sharded-index alternative to per-host index replication). A lookup
    is two dispatches for any number of queries: each device
    binary-searches its own shard for every query and a psum merges the
    global hit ranges (one shard owns each hash); after the host's seed
    filter, each device gathers the kept hit positions that fall in its
    shard and a psum merges them. Runs under the x64 context (the 64-bit
    minimizer hashes would truncate in 32-bit mode)."""

    def __init__(self, mesh: Mesh, index):
        from jax.sharding import NamedSharding
        self.mesh = mesh
        axes = tuple(mesh.axis_names)
        hashes, positions, lens = shard_index_arrays(
            index, int(mesh.devices.size))
        starts = np.concatenate([[0], np.cumsum(lens)[:-1]])

        def put(a):
            return jax.device_put(a, NamedSharding(
                mesh, P(axes, *([None] * (a.ndim - 1)))))

        with jax.enable_x64(True):
            self._hashes = put(hashes)
            self._positions = put(positions)
            self._lens = put(lens.astype(np.int64))
            self._starts = put(starts.astype(np.int64))
        shard = dict(mesh=mesh, **{_CHECK_KW: False})  # psum replicates

        @functools.partial(shard_map, in_specs=(P(axes, None), P(axes),
                                                P(axes), P(None)),
                           out_specs=(P(None), P(None)), **shard)
        def ranges(h2, ln2, st2, q):
            h, ln, st = h2[0], ln2[0], st2[0]
            lo = jnp.searchsorted(h, q, side="left")
            hi = jnp.searchsorted(h, q, side="right")
            # hits into this shard's sentinel padding do not count
            cnt = jnp.minimum(hi - lo, jnp.maximum(ln - lo, 0))
            return (jax.lax.psum(jnp.where(cnt > 0, st + lo, 0), axes),
                    jax.lax.psum(cnt, axes))

        @functools.partial(shard_map, in_specs=(P(axes, None), P(axes),
                                                P(axes), P(None)),
                           out_specs=P(None), **shard)
        def gather(p2, ln2, st2, idx):
            p, ln, st = p2[0], ln2[0], st2[0]
            local = idx - st
            own = (local >= 0) & (local < ln)
            got = jnp.take(p, jnp.clip(local, 0, p.shape[0] - 1))
            return jax.lax.psum(jnp.where(own, got, 0), axes)

        self._ranges, self._gather = jax.jit(ranges), jax.jit(gather)

    def lookup(self, queries: np.ndarray, max_occ: int,
               group_off: Optional[np.ndarray] = None):
        """GenomeIndex.lookup over the shards: (query_idx, genome_position)
        anchor pairs, query-major in index order, byte-identical to the
        replicated lookup. `group_off` splits the queries into read
        orientations (the seed filter is per orientation); query_idx then
        indexes the concatenated queries."""
        from mandalorion_tpu.align.index import ragged_index, seed_keep
        from mandalorion_tpu.parallel.mesh import fetch_global
        queries = np.asarray(queries, np.uint64)
        nq = len(queries)
        if group_off is None:
            group_off = np.array([0, nq], np.int64)
        with jax.enable_x64(True):
            lo, cnt = self._ranges(self._hashes, self._lens, self._starts,
                                   _pad_pow2(queries, 0))
            lo = fetch_global(lo)[:nq].astype(np.int64)
            cnt = fetch_global(cnt)[:nq].astype(np.int64)
            keep = np.zeros(nq, bool)
            for a, b in zip(group_off[:-1], group_off[1:]):
                keep[a:b] = seed_keep(cnt[a:b], max_occ)
            qidx = np.nonzero(keep)[0]
            idx = ragged_index(lo[keep], lo[keep] + cnt[keep])
            if len(idx) == 0:
                return np.zeros(0, np.int64), np.zeros(0, np.int64)
            gpos = self._gather(self._positions, self._lens, self._starts,
                                _pad_pow2(idx, -1))
            gpos = fetch_global(gpos)[:len(idx)].astype(np.int64)
        return np.repeat(qidx, cnt[keep]), gpos


def mesh_count_matrix(mesh: Mesh, flat_ids: "np.ndarray",
                      num_segments: int) -> "np.ndarray":
    """The quant count matrix's cross-shard reduction (module Q): the
    flattened (isoform*n_samples + sample) id stream shards over ALL mesh
    axes, each device segment-sums its shard, and the partial matrices
    merge with one psum riding ICI — the collective replacing
    assignReadsToIsoforms' single-process count loop
    (`assignReadsToIsoforms.py:27-48`, SURVEY §2.3). Integer counts, so
    the merge is exact: byte-identical to np.bincount on one device.

    flat_ids: int array of segment ids; returns int64 counts[num_segments].
    """
    import numpy as np
    from mandalorion_tpu.parallel.mesh import shard_batch

    axes = tuple(mesh.axis_names)
    n_dev = int(mesh.devices.size)
    ids = np.asarray(flat_ids, np.int32)
    # pad to a device multiple with the overflow bucket (dropped after
    # the merge) BEFORE sharding — zero would be a real isoform id
    padded_n = max(((len(ids) + n_dev - 1) // n_dev) * n_dev, n_dev)
    padded = np.full(padded_n, num_segments, np.int32)
    padded[:len(ids)] = ids
    (ids_sharded,), _n = shard_batch(mesh, [padded])

    @functools.partial(shard_map, mesh=mesh,
                       in_specs=(P(axes),),
                       out_specs=P(None),
                       **{_CHECK_KW: False})  # psum replication is real
    def run(shard_ids):
        counts = jax.ops.segment_sum(
            jnp.ones_like(shard_ids, jnp.int32), shard_ids,
            num_segments=num_segments + 1)
        return jax.lax.psum(counts, axes)

    from mandalorion_tpu.parallel.mesh import fetch_global
    merged = fetch_global(run(ids_sharded))
    return merged[:num_segments].astype(np.int64)
