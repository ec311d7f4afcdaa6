# coding=utf-8
"""Process set-up shared by the entry points (main.py, bench.py,
chip_smoke.py): the persistent compilation cache and the device check of
measurement scripts."""

from __future__ import annotations

import os

# The cache lives at one fixed path inside the checkout: the path is part of
# the cache key, so a directory that moves between runs never hits.
CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".cache",
    "jax",
)


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    ``JAX_COMPILATION_CACHE_DIR``, when set, is honoured as JAX reads it and
    no directory is set here; otherwise the cache goes to :data:`CACHE_DIR`.
    Call before the first compilation."""
    import jax

    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    return CACHE_DIR


def require_gpu():
    """Return ``jax.devices()`` if they are GPUs; raise otherwise.  Timings
    and device metrics are only meaningful on the accelerator, so a
    measurement never falls back to the CPU."""
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise RuntimeError(
            f"no GPU found: JAX runs on {devices[0].platform!r} "
            f"({devices[0].device_kind}); refusing to measure on it"
        )
    return devices
