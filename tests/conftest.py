"""Test configuration: CPU JAX with 8 virtual devices so sharding tests run
everywhere.  ``JAX_PLATFORMS`` set by the caller wins (the GPU-marked tests
run with ``JAX_PLATFORMS=cuda``; see README)."""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

from fluidsimulation.utils.cache import enable_compilation_cache  # noqa: E402

# Persistent compilation cache: the fast tier is compile-bound on a small
# machine, and XLA:CPU executables cache like GPU ones.  Without
# JAX_COMPILATION_CACHE_DIR the CPU entries go to their own fixed directory,
# apart from the programs' .jax_cache.
enable_compilation_cache(
    os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                 ".jax_cache_cpu")
)

# The `slow` marker is registered once, in pyproject.toml
# [tool.pytest.ini_options] — no duplicate registration here.
