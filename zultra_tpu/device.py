"""Platform decisions for the device engine, made in one place.

``on_gpu`` is the one test of the platform: the paths that exist only on
an NVIDIA GPU (the CUDA cost-DP kernel, the queued stream begin-phase)
switch on there, and everywhere else the plain XLA forms run.
``enable_compile_cache`` points JAX's persistent compilation cache at one
directory, so every entry point of the package shares it.
"""

from __future__ import annotations

import os
from pathlib import Path

import jax

# The cache's fixed home when JAX_COMPILATION_CACHE_DIR is unset: inside
# the checkout (git-ignored), so its path, which is part of every cache
# key, stays the same from one run to the next.
DEFAULT_CACHE_DIR = Path(__file__).resolve().parent.parent / ".jax_cache"


def on_gpu() -> bool:
    """True when JAX's default backend is a CUDA GPU."""
    return jax.default_backend() == "gpu"


def enable_compile_cache() -> str:
    """Use ``$JAX_COMPILATION_CACHE_DIR`` if set, else DEFAULT_CACHE_DIR,
    as the persistent compilation cache, keeping every compilation that
    takes a second or more. Returns the directory."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(DEFAULT_CACHE_DIR)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
