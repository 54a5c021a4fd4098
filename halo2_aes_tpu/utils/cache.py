"""Persistent XLA compilation cache for accelerator backends.

Cuts repeat cold starts: compiled executables are reloaded from disk,
leaving only trace and lowering time.
Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and
this module sets no other path; otherwise the cache lives at the fixed
path ``<repo>/ptau/xla_cache`` (the path is part of what makes later
runs hit).  The CPU backend is excluded — jaxlib segfaults
deserializing cached CPU executables of the big limb-arithmetic graphs
(reproduced twice on a CPU host)."""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "ptau", "xla_cache")


def enable_compile_cache() -> bool:
    """Turn the persistent cache on for a non-CPU backend; returns
    whether it did."""
    import jax

    if jax.default_backend() == "cpu":
        return False
    if not os.environ.get(ENV_VAR):
        os.makedirs(DEFAULT_DIR, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return True
