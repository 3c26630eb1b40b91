"""Process-level runtime policy shared by the CLIs: compute dtype and the
persistent compile cache."""
from __future__ import annotations

import os
from typing import Mapping, Optional

import jax

# <checkout>/.jax_cache — a fixed path, so every run of this checkout finds
# what an earlier one compiled (the directory is part of the cache key)
REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def default_compute_dtype(backend: Optional[str] = None) -> str:
    """Activation dtype when the user names none: bf16 compute with f32
    accumulation on the GPU, float32 elsewhere (the CPU has no fast bf16
    path). ``--compute_dtype`` overrides it in every CLI."""
    backend = backend or jax.default_backend()
    return "bfloat16" if backend == "gpu" else "float32"


def compile_cache_dir(environ: Mapping[str, str] = os.environ,
                      backend: Optional[str] = None) -> Optional[str]:
    """The directory this program sets for JAX's persistent compile cache,
    or None: when ``JAX_COMPILATION_CACHE_DIR`` is set JAX reads it itself
    and no other directory is set in code, and the CPU backend (tests,
    small runs) compiles fast enough to go without."""
    if environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    if (backend or jax.default_backend()) == "cpu":
        return None
    return REPO_CACHE_DIR


def setup_compile_cache() -> None:
    """Point JAX's persistent compile cache at :func:`compile_cache_dir`.
    Call once per process, before the first compilation."""
    path = compile_cache_dir()
    if path is not None:
        jax.config.update("jax_compilation_cache_dir", path)
