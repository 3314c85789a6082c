"""Persistent-compilation-cache configuration (one policy, shared).

CLI runs are one-shot processes: without the persistent compilation
cache every invocation would pay the full XLA compile.  The reference
binaries have no analog (ahead-of-time C++ compilation); this module is
the rebuild's equivalent of `make`.

Policy:

  * `JAX_COMPILATION_CACHE_DIR` set (JAX's own variable): JAX reads it
    itself and nothing here touches the cache configuration;
  * otherwise the cache lives at the fixed path `<checkout>/.jax_cache`
    (listed in .gitignore).  The path is fixed so that every process
    started from the same checkout finds the same executables.
"""

import os

import jax

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def default_cache_dir():
    """The fixed cache path used when JAX_COMPILATION_CACHE_DIR is unset."""
    return os.path.join(CHECKOUT, ".jax_cache")


def configure_cache():
    """Point JAX's persistent compilation cache at `default_cache_dir()`
    unless JAX_COMPILATION_CACHE_DIR is set.  Returns the directory in
    use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    cache_dir = default_cache_dir()
    os.makedirs(cache_dir, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    return cache_dir
