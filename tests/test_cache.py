"""Where the persistent compile cache lives (`utils/cache.py`)."""

import os

import jax

from bundleadjustment_tpu.utils import cache


def test_env_var_wins_and_nothing_is_set(monkeypatch, tmp_path):
    monkeypatch.setenv(cache.ENV_VAR, str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert cache.cache_dir() == str(tmp_path)
    assert cache.enable_persistent_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_default_is_fixed_checkout_dir(monkeypatch):
    monkeypatch.delenv(cache.ENV_VAR, raising=False)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert cache.cache_dir() == os.path.join(repo, ".jax_cache")
    # the test process is pinned to the CPU platform: cache stays off
    assert cache.enable_persistent_cache() is None
