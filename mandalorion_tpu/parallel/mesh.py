"""Device mesh construction + the pipeline-mesh context.

The production APDFQ stages dispatch their batched device work (chain DP,
affine-gap DP, POA graph DP, quant count merge) through a handful of entry
points; installing a mesh with `use_mesh` makes every one of them shard its
batch axis over the mesh devices (data parallel; XLA partitions the jitted
computation) and merge cross-shard results with collectives (psum for the
quant count matrix). This is the device-mesh replacement for the
reference's three multiprocessing pools (SURVEY §2.3): same decomposition, device axes
instead of forked processes, byte-identical outputs (tests/test_parallel).
"""

from __future__ import annotations

import contextlib
from typing import List, Optional, Sequence, Tuple

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

_PIPELINE_MESH: Optional[Mesh] = None


def pipeline_mesh() -> Optional[Mesh]:
    """The mesh installed by use_mesh (None = single-device execution)."""
    return _PIPELINE_MESH


@contextlib.contextmanager
def use_mesh(mesh: Optional[Mesh]):
    """Install `mesh` as the pipeline mesh for the duration of the block;
    every batched device dispatch inside shards over it."""
    global _PIPELINE_MESH
    prev = _PIPELINE_MESH
    _PIPELINE_MESH = mesh
    try:
        yield mesh
    finally:
        _PIPELINE_MESH = prev


def batch_sharding(mesh: Mesh, ndim: int) -> NamedSharding:
    """Sharding for a batch-major array: dim 0 split over ALL mesh axes,
    remaining dims replicated."""
    spec = P(mesh.axis_names, *([None] * (ndim - 1)))
    return NamedSharding(mesh, spec)


def shard_batch(mesh: Mesh, arrays: Sequence[np.ndarray],
                pad_multiple: int = 1) -> Tuple[List[jax.Array], int]:
    """Pad each array's batch dim to a common multiple of the device count
    (and `pad_multiple`) with zeros-like rows, then device_put with the
    batch sharding. Returns (sharded arrays, original batch size)."""
    n_dev = int(mesh.devices.size)
    b = arrays[0].shape[0]
    step = int(np.lcm(n_dev, max(pad_multiple, 1)))
    padded_b = max(((b + step - 1) // step) * step, step)
    out: List[jax.Array] = []
    for a in arrays:
        if padded_b != b:
            pad = np.zeros((padded_b - b,) + a.shape[1:], a.dtype)
            a = np.concatenate([a, pad], axis=0)
        out.append(jax.device_put(a, batch_sharding(mesh, a.ndim)))
    return out, b


def fetch_global(x) -> np.ndarray:
    """Materialize a (possibly cross-process-sharded) device array on
    EVERY process as numpy. Single-process: a plain fetch. Multi-process
    (jax.distributed): batch-dim-0-sharded arrays are not fully
    addressable on any one host, so all-gather the shards first — this is
    what lets the production dispatch entry points (chain DP, rowscan DP)
    run unchanged on a >1-process global mesh (SURVEY §5.8)."""
    if jax.process_count() > 1 and isinstance(x, jax.Array) \
            and not x.is_fully_addressable:
        if x.is_fully_replicated:
            return np.asarray(x.addressable_shards[0].data)
        from jax.experimental import multihost_utils
        return np.asarray(multihost_utils.process_allgather(x, tiled=True))
    return np.asarray(x)


def dispatch_batch(fn, arrays: Sequence[np.ndarray]):
    """Call a jitted fn on batch-major host arrays and fetch its outputs
    (an array or a tuple of arrays) as numpy. With a pipeline mesh
    installed the batch axis shards over every mesh device (zero padding
    rows, sliced off the outputs); otherwise one device runs it."""
    mesh = pipeline_mesh()
    if mesh is None:
        out = fn(*[jnp.asarray(a) for a in arrays])
        return jax.tree.map(np.asarray, out)
    args, b = shard_batch(mesh, list(arrays))
    return jax.tree.map(lambda x: fetch_global(x)[:b], fn(*args))


def make_mesh(n_devices: Optional[int] = None,
              axis_names: Tuple[str, ...] = ("reads", "loci")) -> Mesh:
    """Build a mesh over the first n devices. With two axes the device
    count factors as (n // loci, loci) with loci the largest power of two
    <= sqrt(n); falls back to 1D when n is prime-ish or axes == 1."""
    devices = jax.devices()
    n = n_devices if n_devices is not None else len(devices)
    if n > len(devices):
        raise ValueError(
            f"requested a {n}-device mesh but only {len(devices)} JAX "
            f"device(s) are visible ({[str(d) for d in devices]}); for a "
            "virtual CPU mesh set JAX_PLATFORMS=cpu and XLA_FLAGS="
            "--xla_force_host_platform_device_count=N before JAX "
            "initializes")
    devices = devices[:n]
    if len(axis_names) == 1 or n == 1:
        return Mesh(np.array(devices), axis_names[:1])
    loci = 1
    while loci * 2 <= int(np.sqrt(n)) and n % (loci * 2) == 0:
        loci *= 2
    if n % loci:
        loci = 1
    reads = n // loci
    if loci == 1:
        return Mesh(np.array(devices), axis_names[:1])
    grid = np.array(devices).reshape(reads, loci)
    return Mesh(grid, axis_names[:2])


def multihost_init(coordinator: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None,
                   timeout_s: int = 300) -> None:
    """jax.distributed bootstrap for multi-host pods. Explicit arguments
    are a contract: if the caller names a coordinator/process topology and
    initialization fails, that is a misconfigured pod run and must abort
    loudly (silently proceeding single-process would corrupt a sharded
    run). With no arguments, a cluster environment that JAX detects
    provides the topology, and an 'already initialized' state or the
    absence of any cluster (a single-process run) is tolerated. Exercised for real by
    tests/test_multihost.py: two CPU-backend processes through this
    function, a global mesh, and a cross-process psum."""
    try:
        jax.distributed.initialize(coordinator_address=coordinator,
                                   num_processes=num_processes,
                                   process_id=process_id,
                                   initialization_timeout=timeout_s)
    except (RuntimeError, ValueError) as e:
        if "already" in str(e).lower() and (
                coordinator is None and num_processes is None):
            return  # idempotent no-arg init on an initialized runtime
        if coordinator is None and num_processes is None \
                and process_id is None:
            return  # single-process run without a distributed environment
        raise RuntimeError(
            f"jax.distributed.initialize failed for coordinator="
            f"{coordinator} num_processes={num_processes} "
            f"process_id={process_id}: {e}") from e
