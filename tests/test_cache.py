"""The compilation-cache directory rule (libhpc_tpu/utils/cache.py): the
environment's JAX_COMPILATION_CACHE_DIR wins and no other directory is set
in code; otherwise one fixed, git-ignored path inside the checkout."""

import os

import pytest

from libhpc_tpu.utils import cache


@pytest.fixture
def updates(monkeypatch):
    """Record jax.config.update calls instead of changing this process."""
    calls = {}
    monkeypatch.setattr(cache.jax.config, "update",
                        lambda k, v: calls.__setitem__(k, v))
    return calls


def test_env_dir_wins_and_code_sets_none(monkeypatch, updates, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert cache.cache_dir() == str(tmp_path)
    assert cache.enable_compilation_cache() == str(tmp_path)
    assert "jax_compilation_cache_dir" not in updates


def test_default_dir_is_fixed_in_checkout(monkeypatch, updates):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = cache.enable_compilation_cache()
    assert path == cache.DEFAULT_DIR == os.path.join(cache.REPO_ROOT,
                                                     ".jax_cache")
    assert updates["jax_compilation_cache_dir"] == path
    assert os.path.isfile(os.path.join(cache.REPO_ROOT, "libhpc_tpu",
                                       "utils", "cache.py"))


def test_default_dir_is_git_ignored():
    with open(os.path.join(cache.REPO_ROOT, ".gitignore")) as f:
        ignored = {ln.strip() for ln in f}
    assert ".jax_cache/" in ignored


@pytest.mark.parametrize("var", ["LIBHPC_JAX_CACHE", "HOME"])
def test_other_variables_do_not_move_the_cache(monkeypatch, updates,
                                               tmp_path, var):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setenv(var, str(tmp_path))
    assert cache.enable_compilation_cache() == cache.DEFAULT_DIR
