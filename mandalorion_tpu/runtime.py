"""JAX runtime knobs shared by every device entry point.

The device compute path dispatches a bounded set of kernel shapes
(quantized width / query-depth / batch buckets in align/kernels.py,
align/chain_kernel.py, poa/kernels.py). Persisting their XLA compilations
to disk means a pipeline process pays each compile once per cache
directory, not once per run.
"""

from __future__ import annotations

import os

_ENABLED = False

# fixed in-checkout default: the directory is part of the cache key, so a
# path that moved with the working directory or the process would never hit
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    ".jax_cache")


def enable_compilation_cache() -> str:
    """Turn on JAX's persistent compilation cache for every kernel.
    JAX_COMPILATION_CACHE_DIR, when set, is the only directory used (JAX
    reads it itself); otherwise the cache lives at DEFAULT_CACHE_DIR
    (`<repo>/.jax_cache`). Idempotent; returns the directory in use."""
    global _ENABLED
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    cache_dir = env or DEFAULT_CACHE_DIR
    if _ENABLED:
        return cache_dir
    import jax
    if not env:
        os.makedirs(cache_dir, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    # cache every kernel: the dispatch set is small and quantized, so the
    # entry count stays bounded; even sub-second compiles add up
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    _ENABLED = True
    return cache_dir


def fork_ok() -> bool:
    """True when forking a worker pool is safe: no live JAX backend (its
    XLA thread pools deadlock in forked children, and a child that
    touched the accelerator would open it a second time) and no other
    threads in this process (Python 3.12 warns on any multi-threaded
    fork). Merely having imported jax is fine. Pool sites use fork when
    this holds (cheap copy-on-write inheritance of big read-only state
    like the genome index) and fall back to spawn or serial otherwise."""
    import sys
    import threading
    if threading.active_count() > 1:
        return False
    if "jax" not in sys.modules:
        return True
    try:
        from jax._src import xla_bridge
        return not xla_bridge._backends
    except Exception:
        return False
