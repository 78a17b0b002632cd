"""Committed f32 end-to-end accuracy bound (always-on CI variant).

The accelerator serving path runs the whole pipeline in float32 while the
parity metric (BASELINE.json, <=1e-5) is defined against the f64 scipy
oracle (the reference's LCS/LCS.py:152-154 semantics).  This test pins the
f32 *accumulation* divergence class — 8 SETTLS steps of roundoff through
the scan — on CPU, so the bound holds in every CI run; ``chip_smoke.py``
checks the same bound on the GPU at the 0.25-degree flagship width.
"""
import jax
import jax.numpy as jnp
import numpy as np

from lagrangiancoherence_tpu.grid import Grid
from lagrangiancoherence_tpu.models.pipeline import ftle_pipeline
from lagrangiancoherence_tpu.testing.flows import jet_wave_winds
from lagrangiancoherence_tpu.testing.oracle import oracle_ftle

# 1.5e-3 bounds the f32 trajectory-divergence class while failing loudly
# on tap/fold corruption (O(1e-2)+).
LOG_FTLE_P99_BOUND = 1.5e-3


def test_f32_log_ftle_p99_vs_f64_oracle():
    ny, nx = 181, 360   # 1-degree global
    nt, dt = 9, -6.0 * 3600.0
    lats = np.linspace(-90.0, 90.0, ny)
    lons = np.linspace(-180.0, 179.0, nx)
    grid = Grid(lats=lats, lons=lons, cyclic_x=True)
    u, v = jet_wave_winds(lats, lons, nt, dtype=np.float64)

    # the suite conftest enables x64; the serving path is f32 — drop to
    # 32-bit defaults for the pipeline leg only
    with jax.enable_x64(False):
        got = np.asarray(ftle_pipeline(
            jnp.asarray(u, jnp.float32), jnp.asarray(v, jnp.float32), dt,
            grid, settls_order=2, interp_order=3))
    assert got.dtype == np.float32

    want = oracle_ftle(u, v, lats, lons, dt, settls_order=2,
                       interp_order=3, cyclic_x=True)

    mask = np.isfinite(want) & np.isfinite(got) & (want > 0) & (got > 0)
    # exclude the order-1/'constant' pole rows: the oracle's pole path is
    # itself an approximation band (/root/reference/LCS/tools.py:34-39)
    mask[:4] = mask[-4:] = False
    err = np.abs(np.log(got[mask]) - np.log(want[mask]))
    p99 = float(np.percentile(err, 99))
    assert p99 <= LOG_FTLE_P99_BOUND, (
        f"p99 |dlog-FTLE(f32 vs f64 oracle)| = {p99:.2e} > "
        f"{LOG_FTLE_P99_BOUND}")
