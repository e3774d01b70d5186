"""XLA compile settings: GPU compile flags and the persistent cache.

The proving kernels are big straight-line integer graphs that XLA compiles
slowly; caching compiled executables on disk makes every process after the
first start fast, and the flags below make the first compile faster.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, the cache lives there and
nowhere else. Otherwise it lives at a fixed directory inside the checkout
(``.cache/xla``, git-ignored): the path is part of what makes a later
process find the entries, so it never depends on a temp name, a pid or the
time.
"""

from __future__ import annotations

import os

REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
DEFAULT_CACHE_DIR = os.path.join(REPO_ROOT, ".cache", "xla")


# XLA:GPU compiles each kernel module's LLVM IR on one thread by default.
# On a 4096-point G1 witness MSM, splitting it over the host's 16 cores cut
# the first compile from 103 s to 75 s, and GEMM autotuning off saved 3 s
# more, with no change in run time (NVIDIA H100 80GB HBM3, 700 W; PERF.md)
GPU_COMPILE_FLAGS = (
    "--xla_gpu_enable_llvm_module_compilation_parallelism=true",
    f"--xla_gpu_force_compilation_parallelism={os.cpu_count() or 1}",
    "--xla_gpu_autotune_level=0",
)


def set_xla_flags() -> None:
    """Add GPU_COMPILE_FLAGS to XLA_FLAGS; flags already there win. Call it
    before JAX initialises its backend (the first device query or jit)."""
    flags = os.environ.get("XLA_FLAGS", "").split()
    names = {f.split("=")[0] for f in flags}
    flags += [f for f in GPU_COMPILE_FLAGS if f.split("=")[0] not in names]
    os.environ["XLA_FLAGS"] = " ".join(flags)


def compile_cache_dir() -> str:
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_CACHE_DIR


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at compile_cache_dir()."""
    import jax

    path = compile_cache_dir()
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return path
