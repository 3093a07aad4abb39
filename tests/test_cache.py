"""Where the persistent compilation cache lives (utils/cache.py)."""

import jax

from fluidsimulation.utils import cache


def test_cache_honours_env_dir(monkeypatch, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, that directory is the cache and
    no other directory is set or created."""
    before = jax.config.jax_compilation_cache_dir
    env_dir = str(tmp_path / "from_env")
    fallback = tmp_path / "fallback"
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env_dir)
    assert cache.enable_compilation_cache(str(fallback)) == env_dir
    assert jax.config.jax_compilation_cache_dir == before
    assert not fallback.exists()


def test_cache_uses_fixed_dir_without_env(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        assert cache.enable_compilation_cache(str(tmp_path)) == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == str(tmp_path)
        assert cache.enable_compilation_cache() == cache.DEFAULT_DIR
        assert cache.DEFAULT_DIR.endswith(".jax_cache")
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
