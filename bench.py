"""Flagship benchmark: global 0.25-degree FTLE field throughput on one GPU.

Config (BASELINE.json "metric"): 1440x721 parcel grid, 8-day backward
integration at 6-hourly winds (33 time levels), SETTLS_order=4,
traj_interp_order=3, float32 — i.e. (33-1) * (2 + 4*4) = 576 full-grid
spline interpolations per field, the exact workload the reference runs
through scipy ``map_coordinates`` one call at a time
(/root/reference/LCS/trajectory.py:80-124).

Runs only on a GPU: with no GPU it exits nonzero before timing anything.
Prints ONE JSON line with fields/s and s/field (median and spread of the
timed runs, each ending in ``block_until_ready``), compile time, peak
device memory, the device as JAX reports it and the card's name and power
limit.  ``vs_baseline`` is the speedup over the measured reference
implementation (131.9 s/field, scipy map_coordinates path, single-core CPU;
testing/oracle.py).

Usage: ``python bench.py [--seed S]``
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp

    from lagrangiancoherence_tpu.grid import global_quarter_degree_grid
    from lagrangiancoherence_tpu.models.pipeline import ftle_pipeline
    from lagrangiancoherence_tpu.testing.flows import jet_wave_winds
    from lagrangiancoherence_tpu.testing.oracle import \
        REFERENCE_SECONDS_PER_FIELD
    from lagrangiancoherence_tpu.utils.runtime import (card_info,
                                                       enable_compile_cache,
                                                       require_gpu)

    try:
        devices = require_gpu()
    except RuntimeError as e:
        print(f"bench: {e}", file=sys.stderr)
        return 1
    cache = enable_compile_cache()
    cards = card_info()

    grid = global_quarter_degree_grid()
    u, v = jet_wave_winds(grid.lats, grid.lons, 33, seed=args.seed)
    u_j, v_j = jnp.asarray(u), jnp.asarray(v)
    dt = -6.0 * 3600.0

    t0 = time.perf_counter()
    compiled = ftle_pipeline.lower(u_j, v_j, dt, grid, settls_order=4,
                                   interp_order=3).compile()
    compile_s = time.perf_counter() - t0
    out = compiled(u_j, v_j, dt).block_until_ready()   # warm-up
    if not np.isfinite(np.asarray(out)[2:-2]).all():
        print("bench: non-finite FTLE off the pole rows", file=sys.stderr)
        return 1

    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        compiled(u_j, v_j, dt).block_until_ready()
        times.append(time.perf_counter() - t0)
    s_per_field = float(np.median(times))
    peak = devices[0].memory_stats().get("peak_bytes_in_use")

    rec = {
        "metric": "global 0.25deg FTLE fields/sec (1440x721, 8-day, "
                  "SETTLS-4, f32)",
        "value": 1.0 / s_per_field,
        "unit": "fields/sec",
        "s_per_field_median": s_per_field,
        "s_per_field_min": min(times),
        "s_per_field_max": max(times),
        "reps": len(times),
        "compile_s": compile_s,
        "peak_bytes_in_use": peak,
        "vs_baseline": REFERENCE_SECONDS_PER_FIELD / s_per_field,
        "device": {"platform": devices[0].platform,
                   "kind": devices[0].device_kind,
                   "count": len(jax.devices())},
        "card": cards[0],
        "compile_cache": cache,
        "seed": args.seed,
    }
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
