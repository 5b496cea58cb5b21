"""The compilation-cache helper: JAX_COMPILATION_CACHE_DIR wins and is
left to JAX; otherwise the cache goes to <checkout>/.jax_cache."""
import os

import jax

from sdr_receiver_dvb_t2_tpu.utils import jaxcache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _recorded(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.append((k, v)))
    return calls


def test_env_dir_is_used_and_nothing_set(monkeypatch, tmp_path):
    calls = _recorded(monkeypatch)
    env = {"JAX_COMPILATION_CACHE_DIR": str(tmp_path)}
    assert jaxcache.enable_compile_cache(env) == str(tmp_path)
    assert calls == []


def test_default_is_the_checkout(monkeypatch):
    calls = _recorded(monkeypatch)
    want = os.path.join(ROOT, ".jax_cache")
    assert jaxcache.enable_compile_cache({}) == want
    assert ("jax_compilation_cache_dir", want) in calls
    # the default directory is one git ignores
    assert ".jax_cache/" in open(os.path.join(ROOT, ".gitignore")).read()
