"""Tracing / profiling hooks — the observability the reference lacks.

SURVEY.md §5: the reference's only performance artifact is a wall-clock
print in the research driver (/root/reference/LCS/area_of_influence.py:
169,293-295).  This module provides:

* ``trace(dir)``: context manager around ``jax.profiler`` emitting a
  Perfetto/XPlane trace of everything inside;
* ``stage_timer``: accumulating per-stage wall-clock timers with a summary
  report (the granularity of the reference's stage banners);
* ``device_memory_stats``: current per-device HBM usage snapshot.
"""
from __future__ import annotations

import collections
import time
from contextlib import contextmanager

from .logging import logger

__all__ = ["trace", "StageTimer", "device_memory_stats"]


@contextmanager
def trace(log_dir: str):
    """Profile everything inside the context into ``log_dir`` (viewable with
    TensorBoard or Perfetto)."""
    import jax
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
        logger.info("profiler trace written to %s", log_dir)


class StageTimer:
    """Accumulating wall-clock stage timers.

    >>> timers = StageTimer()
    >>> with timers("propagation"):
    ...     run()
    >>> timers.report()
    """

    def __init__(self):
        self.totals: dict[str, float] = collections.defaultdict(float)
        self.counts: dict[str, int] = collections.defaultdict(int)

    @contextmanager
    def __call__(self, stage: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[stage] += time.perf_counter() - t0
            self.counts[stage] += 1

    def report(self) -> str:
        lines = [f"{k:30s} {self.totals[k]:9.3f}s / {self.counts[k]}x"
                 for k in sorted(self.totals, key=self.totals.get,
                                 reverse=True)]
        out = "\n".join(lines)
        logger.info("stage timings:\n%s", out)
        return out


def device_memory_stats() -> dict[str, dict]:
    """Per-device memory statistics (bytes in use / limit), when the backend
    exposes them (GPUs do; CPU returns {})."""
    import jax
    out = {}
    for d in jax.devices():
        stats = getattr(d, "memory_stats", lambda: None)()
        if stats:
            out[str(d)] = {k: stats[k] for k in
                           ("bytes_in_use", "bytes_limit", "peak_bytes_in_use")
                           if k in stats}
    return out
