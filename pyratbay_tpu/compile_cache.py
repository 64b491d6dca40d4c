"""Persistent XLA compile cache for the command-line entry points.

Called by `pbay-tpu`, bench.py and chip_smoke.py (never at import):
compiling the full-width programs takes tens of seconds, and a cache
at a fixed path lets later runs skip it.
"""
import os

__all__ = ['enable_compile_cache']

CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def enable_compile_cache():
    """Point JAX's persistent compile cache at a fixed directory.

    If JAX_COMPILATION_CACHE_DIR is set, JAX already reads it and
    nothing is set here.  Otherwise the cache goes to
    <checkout>/.jax_cache (listed in .gitignore).  Returns the
    directory in use.
    """
    env = os.environ.get('JAX_COMPILATION_CACHE_DIR')
    if env:
        return env
    import jax
    path = os.path.join(CHECKOUT, '.jax_cache')
    jax.config.update('jax_compilation_cache_dir', path)
    return path
