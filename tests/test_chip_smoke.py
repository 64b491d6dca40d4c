"""chip_smoke.py refuses to run without a GPU, and the command-line
compile cache follows JAX_COMPILATION_CACHE_DIR or <checkout>/.jax_cache.
"""
import os
import shutil
import subprocess
import sys

import jax
import pytest

from pyratbay_tpu import compile_cache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize('alone', [False, True])
def test_chip_smoke_fails_without_gpu(tmp_path, alone):
    """On a CPU-only host, and in a directory holding nothing of the
    repo but the script, it exits nonzero and prints no result."""
    script = os.path.join(ROOT, 'chip_smoke.py')
    cwd = ROOT
    env = dict(os.environ, JAX_PLATFORMS='cpu')
    if alone:
        shutil.copy(script, tmp_path / 'chip_smoke.py')
        script = str(tmp_path / 'chip_smoke.py')
        cwd = str(tmp_path)
        env.pop('PYTHONPATH', None)
    proc = subprocess.run(
        [sys.executable, script], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_compile_cache_follows_env(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv('JAX_COMPILATION_CACHE_DIR', str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_default_is_checkout(monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv('JAX_COMPILATION_CACHE_DIR', raising=False)
    try:
        path = compile_cache.enable_compile_cache()
        assert path == os.path.join(ROOT, '.jax_cache')
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update('jax_compilation_cache_dir', before)
