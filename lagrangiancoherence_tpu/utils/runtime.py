"""Run-time set-up for the GPU entry points (``bench.py``, ``chip_smoke.py``).

* ``enable_compile_cache``: JAX's persistent compilation cache.  Where
  ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this module
  sets nothing; otherwise the cache goes to ``<checkout>/.jax_cache``, a
  fixed path (the path is part of the cache key, so a moving directory
  never hits) that ``.gitignore`` lists.  CPU test runs use no cache
  (tests/conftest.py).
* ``require_gpu``: the measurement paths refuse to run anywhere but a GPU —
  a number taken on XLA:CPU is never reported as a device number.
* ``card_info``: the card's name and power limit from ``nvidia-smi``, read
  in a child process that does not import JAX, so the one JAX process stays
  the only one on the card.
"""
from __future__ import annotations

import os
import subprocess

__all__ = ["compile_cache_dir", "enable_compile_cache", "require_gpu",
           "card_info"]

CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"
_CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def compile_cache_dir() -> str:
    """``$JAX_COMPILATION_CACHE_DIR`` if set, else ``<checkout>/.jax_cache``."""
    return os.environ.get(CACHE_ENV) or os.path.join(_CHECKOUT, ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on the persistent compilation cache; returns its directory."""
    path = compile_cache_dir()
    if not os.environ.get(CACHE_ENV):
        import jax
        jax.config.update("jax_compilation_cache_dir", path)
    return path


def require_gpu(devices=None):
    """Return ``devices`` (default ``jax.devices()``) if they are GPUs, else
    raise ``RuntimeError`` naming what JAX found instead."""
    if devices is None:
        import jax
        devices = jax.devices()
    platforms = sorted({d.platform for d in devices})
    if platforms != ["gpu"]:
        raise RuntimeError(
            f"no GPU: JAX found platform(s) {platforms}; this measurement "
            f"runs only on a GPU and does not fall back to the CPU")
    return devices


def card_info() -> list[str]:
    """``nvidia-smi --query-gpu=name,power.limit`` lines, one per card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]
