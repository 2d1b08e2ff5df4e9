"""Where the persistent compilation cache lives (utils/cache.py)."""
import os

from procgen2_tpu.utils import cache


def test_cache_dir_env_var_honoured(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert cache.compilation_cache_dir() == str(tmp_path)


def test_cache_dir_default_inside_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = cache.compilation_cache_dir()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert path == os.path.join(root, ".jax_cache")
    assert os.path.isdir(os.path.join(cache.CHECKOUT, "procgen2_tpu"))
    with open(os.path.join(root, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
