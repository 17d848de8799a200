"""Persistent compile cache location: ``JAX_COMPILATION_CACHE_DIR`` when
set (and then nothing else is set in code), else a fixed ``.jax_cache``
directory at the root of the checkout."""
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

_CHILD = r"""
import jax, vidgraph_tpu
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
jax.jit(lambda x: x * 2 + 1)(jax.numpy.arange(4.0)).block_until_ready()
print(vidgraph_tpu.compile_cache_dir())
print(jax.config.jax_compilation_cache_dir)
"""


def _child(env_dir=None):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["PYTHONPATH"] = str(REPO)
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = str(env_dir)
    out = subprocess.run([sys.executable, "-c", _CHILD], env=env,
                         cwd=REPO, capture_output=True, text=True,
                         timeout=300, check=True)
    return out.stdout.strip().splitlines()[-2:]


def test_env_var_is_honoured_and_cache_lands_there(tmp_path):
    cache = tmp_path / "cc"
    ours, jax_dir = _child(cache)
    assert ours == jax_dir == str(cache)
    assert cache.is_dir() and any(cache.iterdir())


def test_default_is_fixed_path_in_checkout():
    ours, jax_dir = _child()
    assert ours == jax_dir == str(REPO / ".jax_cache")


def test_cache_dir_is_independent_of_cwd(tmp_path, monkeypatch):
    import vidgraph_tpu

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.chdir(tmp_path)
    assert vidgraph_tpu.compile_cache_dir() == str(REPO / ".jax_cache")
