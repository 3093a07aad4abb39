"""Persistent XLA compilation cache — the reference's .cso blob cache.

The reference checks for a compiled shader blob on disk before invoking the
HLSL compiler (Common/d3dUtil.cpp:238-257, used by Simulation.cpp:461) so a
warm start skips all shader compilation.  The JAX equivalent is the XLA
persistent compilation cache: compiled executables are keyed by HLO +
compile options and written to a directory, so a second process reloads
them instead of recompiling.

Where the cache lives: the directory named by ``JAX_COMPILATION_CACHE_DIR``
when that variable is set (JAX reads it itself; nothing here overrides it),
otherwise the fixed in-checkout ``.jax_cache`` (git-ignored).  The path is
part of the cache's key, so it must not move between runs.

Call enable_compilation_cache() before the first jit compilation.
"""

from __future__ import annotations

import os

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compilation_cache(default_dir: str = DEFAULT_DIR) -> str:
    """Turn on the persistent compilation cache and return its directory:
    ``JAX_COMPILATION_CACHE_DIR`` if set, else ``default_dir``.  Safe to call
    repeatedly."""
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = default_dir
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    # Cache everything: the default 1 s minimum compile time would skip the
    # many sub-second helper jits that still add up across a process.
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    return path
