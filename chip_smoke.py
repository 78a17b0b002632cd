"""Smoke run of the FTLE system on one GPU at the 0.25-degree flagship.

    python chip_smoke.py            # phases 1-5 on one card
    python chip_smoke.py --four     # the four-card paths only

Phases, all in this one process, which is the only one on the card:

1. device: platform, kind and count as JAX reports them, and whether h5py
   (the CLI's file I/O) imports.  Stops unless the platform is ``gpu``.
2. flagship: ``ftle_pipeline`` on the global 0.25-degree grid (1440 x 721
   parcels), an 8-day backward window of 6-hourly winds (33 levels),
   SETTLS-4, cubic, float32.  Compile time, ``memory_analysis()``, s/field
   (median and spread), peak device memory, finiteness.  Then, on the same
   winds, the device time and bytes of one F=4 gather group at the
   flagship departure points and of the prefilter of the 33-level stacks.
3. served API: ``LCS(timestep=-21600, SETTLS_order=4)(isglobal=True,
   truncation=20)`` on the same record — regrid to the 0.5-degree common
   grid, T20, the scan with its per-step progress callback, the gradient.
4. series: ``runners.ftle_series(batch="auto")`` over a 36-level record
   (4 windows of 33, one vmapped program); window 0 against phase 2.
5. accuracy at full width against float64 references: log-FTLE against the
   scipy oracle (1440 x 721, 5 levels), the grid's-own-last-column fold
   case, the prefilter against scipy and the T20 truncation against numpy.

``--four`` runs only ``ftle_sharded`` on a 4-row mesh and on a 2 x 2
(y, x) mesh and ``ftle_batch`` over 4 windows, each against single-card
runs, and prints the per-device shards of every sharded input.

Every number is printed beside the card's name and power limit.  The last
line of standard output is ``{"ok": true, "device": {...}}``, printed only
when every phase passed.  A failed phase, a host without a GPU, or a
directory without the package beside this script gives a nonzero exit.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import tempfile
import time
import traceback

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
DT = -6.0 * 3600.0          # 6-hourly levels, backward in time
LEVELS = 33                 # 8-day window
SERIES_LEVELS = 36          # 4 windows of 33 at stride 1
ACCURACY_LEVELS = 5         # ~72 oracle map_coordinates calls at 1440 x 721
POLE_ROWS = 4               # rows excluded at each pole in log-FTLE checks:
# the order-1/'constant' pole path is itself an approximation band
# (the reference's LCS/tools.py:34-39); tests/test_f32_accuracy.py does too

# p99 |log-FTLE(float32) - log-FTLE(reference)|: the float32 trajectory
# divergence class stays below it, tap or fold corruption (>= 1e-2) does not
# (tests/test_f32_accuracy.py)
LOG_FTLE_P99_BOUND = 1.5e-3
# FTLE norms below this are zero in exact arithmetic: parcels the latitude
# clamp collapsed onto a pole have no deformation (float64 gives <= 1e-15,
# float32 roundoff ~1e-6; the next-smallest float64 norm at 0.5 degrees is
# 6e-5 and 0.002 % of points lie below 1e-3).  Their log is undefined, so
# they are compared by value: |got - want| must stay below this too.
ZERO_NORM = 1e-4
# fold case, rtol = atol: float32 interpolation of ~20 m/s winds is good to
# ~4e-7 of the bound's scale (XLA:CPU); a floor moved across the
# period-(n-1) fold changes values by ~1.7e-2
FOLD_TOL = 2e-6
# max |float32 - float64| / max |float64| of the dense-matmul operators
# (prefilter, T20): float32 roundoff of 360- to 1440-long dot products is
# ~1.2e-6 (XLA:CPU); TF32 products would give >= 1e-4
MATMUL_REL_BOUND = 1e-5


def last_line(devices) -> dict:
    """The contract's last line for ``devices`` (as ``jax.devices()``)."""
    d = devices[0]
    return {"ok": True, "device": {"platform": d.platform,
                                   "kind": d.device_kind,
                                   "count": len(devices)}}


class Report:
    """Prints each result beside the card and collects failed checks."""

    def __init__(self, card: str):
        self.card = card
        self.failures: list[str] = []

    def __call__(self, phase: str, **values):
        items = ", ".join(f"{k}={v!r}" for k, v in values.items())
        print(f"[{phase}] {items}  [card: {self.card}]", flush=True)

    def check(self, phase: str, name: str, value, bound):
        ok = bool(value <= bound)          # NaN fails
        self(phase, **{name: value, "bound": bound,
                       "result": "pass" if ok else "FAIL"})
        if not ok:
            self.failures.append(f"{phase}: {name}={value!r} > {bound!r}")

    def phase(self, name: str, fn, *args):
        """Run one phase; a failure is reported and the next phase runs."""
        t0 = time.perf_counter()
        try:
            out = fn(self, *args)
        except Exception:  # noqa: BLE001 — report every phase, then fail
            traceback.print_exc()
            self.failures.append(f"{name}: raised (traceback on stderr)")
            print(f"[{name}] FAILED  [card: {self.card}]", flush=True)
            return None
        self(name, phase_wall_s=time.perf_counter() - t0)
        return out


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _record(u, v, grid):
    """(time, latitude, longitude) Fields of 6-hourly winds."""
    from lagrangiancoherence_tpu import Field
    times = np.datetime64("2000-01-01T00:00", "ns") \
        + np.arange(u.shape[0]) * np.timedelta64(6, "h")
    dims = ("time", "latitude", "longitude")
    coords = dict(time=times, latitude=grid.lats, longitude=grid.lons)
    return Field(u, dims, coords, name="u"), Field(v, dims, coords, name="v")


def check_ftle(rep, phase, got, want, against):
    """Compare FTLE norm fields off the pole rows: p99 |d log-FTLE| where
    ``want`` is a real norm, and |got - want| where ``want`` is zero to
    roundoff (below ``ZERO_NORM``)."""
    rows = np.zeros(want.shape, bool)
    rows[POLE_ROWS:-POLE_ROWS] = True
    zero = rows & (np.abs(want) < ZERO_NORM)
    live = rows & ~zero
    err = np.abs(np.log(got[live]) - np.log(want[live]))   # NaN if got <= 0
    rep(phase, against=against, compared=int(live.sum()),
        zero_norm_points=int(zero.sum()),
        maxabs=float(np.max(np.abs(got[live] - want[live]))))
    rep.check(phase, "p99_dlogftle", float(np.percentile(err, 99)),
              LOG_FTLE_P99_BOUND)
    rep.check(phase, "max_abs_diff_at_zero_norm",
              float(np.max(np.abs(got[zero] - want[zero]), initial=0.0)),
              ZERO_NORM)


def _peak_bytes(device):
    return (device.memory_stats() or {}).get("peak_bytes_in_use")


def _nonfinite_off_pole(field):
    return int((~np.isfinite(field[..., 2:-2, :])).sum())


def device_busy_seconds(trace_dir: str, plane: str = "/device:GPU:0"):
    """Busy time of ``plane`` in the one profiler trace under ``trace_dir``:
    the union of the event intervals on its stream lines (kernels and
    copies).  Returns ``(seconds, names of the lines counted)``."""
    from jax.profiler import ProfileData
    paths = glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                      recursive=True)
    if len(paths) != 1:
        raise RuntimeError(f"expected one trace under {trace_dir}: {paths}")
    planes = {p.name: p for p in ProfileData.from_file(paths[0]).planes}
    if plane not in planes:
        raise RuntimeError(f"no {plane} in the trace: {sorted(planes)}")
    lines = [ln for ln in planes[plane].lines if ln.name.startswith("Stream")]
    if not lines:
        raise RuntimeError(f"no stream lines in {plane}: "
                           f"{[ln.name for ln in planes[plane].lines]}")
    spans = sorted((e.start_ns, e.end_ns) for ln in lines
                   for e in ln.events)
    busy, end = 0.0, float("-inf")
    for s, e in spans:
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy * 1e-9, [ln.name for ln in lines]


def device_seconds(fn, *args, calls: int = 10):
    """Per-call device busy time of jitted ``fn`` from a profiler trace of
    ``calls`` back-to-back calls, beside the host clock over as many calls
    ending in ``block_until_ready``."""
    import jax
    jax.block_until_ready(fn(*args))                     # compile, warm up
    t0 = time.perf_counter()
    jax.block_until_ready([fn(*args) for _ in range(calls)])
    host_s = (time.perf_counter() - t0) / calls
    with tempfile.TemporaryDirectory() as d:
        with jax.profiler.trace(d):
            jax.block_until_ready([fn(*args) for _ in range(calls)])
        busy, lines = device_busy_seconds(d)
    return busy / calls, host_s, lines


def _shards(arr):
    return [(s.device.id, tuple(s.data.shape)) for s in arr.addressable_shards]


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_flagship(rep, grid, u, v):
    import jax
    import jax.numpy as jnp

    from lagrangiancoherence_tpu.models.pipeline import ftle_pipeline

    u_j, v_j = jnp.asarray(u), jnp.asarray(v)
    t0 = time.perf_counter()
    compiled = ftle_pipeline.lower(u_j, v_j, DT, grid, settls_order=4,
                                   interp_order=3).compile()
    ma = compiled.memory_analysis()
    rep("flagship", grid=grid.shape, levels=u.shape[0], dtype=str(u.dtype),
        compile_s=time.perf_counter() - t0,
        argument_bytes=ma.argument_size_in_bytes,
        output_bytes=ma.output_size_in_bytes,
        temp_bytes=ma.temp_size_in_bytes,
        generated_code_bytes=ma.generated_code_size_in_bytes)
    out = compiled(u_j, v_j, DT).block_until_ready()
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        compiled(u_j, v_j, DT).block_until_ready()
        times.append(time.perf_counter() - t0)
    field = np.asarray(out)
    rep("flagship", s_per_field_median=float(np.median(times)),
        s_per_field_min=min(times), s_per_field_max=max(times),
        runs=len(times),
        peak_bytes_in_use=_peak_bytes(jax.devices()[0]))
    rep.check("flagship", "nonfinite_off_pole_rows",
              _nonfinite_off_pole(field), 0)
    return field


def phase_layers(rep, grid, u, v):
    """Device time and bytes of one F=4 gather group and of the prefilter,
    at the flagship's shapes and departure points."""
    import jax
    import jax.numpy as jnp

    from lagrangiancoherence_tpu.models.settls import parcel_propagation_core
    from lagrangiancoherence_tpu.ops.interp import (interp_at_parcels_multi,
                                                    prefilter)

    u_j, v_j = jnp.asarray(u), jnp.asarray(v)
    px, py = parcel_propagation_core(u_j, v_j, DT, grid, settls_order=4,
                                     interp_order=3)
    bounds = dict(y_min=grid.y_min, y_max=grid.y_max,
                  x_min=grid.x_min, x_max=grid.x_max)
    pre = jax.jit(lambda f: prefilter(f, order=3))
    group = jax.jit(lambda r, c, x, y: interp_at_parcels_multi(
        r, c, x, y, order=3, **bounds))
    raw = jnp.stack([u_j[0], v_j[0], u_j[1], v_j[1]])
    coeffs = pre(raw)
    ny, nx = grid.shape
    n, f, b = ny * nx, 4, 4          # parcels, fields, bytes per float32

    dev_s, host_s, lines = device_seconds(group, raw, coeffs, px, py)
    tap_bytes = f * n * 16 * b       # 4 x 4 cubic taps per field
    pole_bytes = f * n * 4 * b       # order-1 pole taps, every parcel
    compulsory = 2 * f * n * b + 2 * n * b + f * n * b
    rep("gather_group", fields=f, parcels=n, device_s=dev_s,
        host_clock_s=host_s, tap_bytes=tap_bytes, pole_tap_bytes=pole_bytes,
        compulsory_bytes=compulsory,
        tap_bytes_per_s=(tap_bytes + pole_bytes) / dev_s,
        compulsory_bytes_per_s=compulsory / dev_s,
        groups_per_field=(u.shape[0] - 1) * 5, stream_lines=lines)

    uv = jnp.stack([u_j, v_j])
    dev_s, host_s, _ = device_seconds(pre, uv)
    levels = u.shape[0]
    flops = 2 * 2 * levels * (ny * ny * nx + nx * nx * ny)
    nbytes = 2 * (2 * levels * n * b) + (ny * ny + nx * nx) * b
    rep("prefilter", fields=2, levels=levels, device_s=dev_s,
        host_clock_s=host_s, flops=flops, bytes=nbytes,
        flop_per_s=flops / dev_s, bytes_per_s=nbytes / dev_s)


def phase_api(rep, grid, u, v):
    from lagrangiancoherence_tpu import LCS

    U, V = _record(u, v, grid)
    lcs = LCS(timestep=DT, SETTLS_order=4)
    for label in ("first_call_s", "second_call_s"):
        t0 = time.perf_counter()
        out = lcs(u=U, v=V, isglobal=True, truncation=20)
        rep("api", **{label: time.perf_counter() - t0})
    rep("api", shape=out.shape, dims=out.dims)
    if out.shape != (1, 360, 721):
        raise RuntimeError(f"served path shape {out.shape} != (1, 360, 721)")
    rep.check("api", "nonfinite_off_pole_rows", _nonfinite_off_pole(out.data),
              0)


def phase_series(rep, grid, u, v, window, flagship):
    from lagrangiancoherence_tpu.runners import ftle_series

    U, V = _record(u, v, grid)
    t0 = time.perf_counter()
    series = ftle_series(U, V, DT, window=window, stride=1, settls_order=4,
                         interp_order=3, batch="auto")
    rep("series", windows=series.shape[0], shape=series.shape,
        wall_s_with_compile=time.perf_counter() - t0)
    if flagship is None:
        raise RuntimeError("no flagship field to compare with")
    check_ftle(rep, "series", series.data[0], flagship,
               "window 0 vs the flagship phase")


def phase_accuracy(rep, grid, seed):
    import jax.numpy as jnp

    from lagrangiancoherence_tpu.models.pipeline import ftle_pipeline
    from lagrangiancoherence_tpu.testing.flows import jet_wave_winds
    from lagrangiancoherence_tpu.testing.oracle import oracle_ftle

    u, v = jet_wave_winds(grid.lats, grid.lons, ACCURACY_LEVELS, seed=seed,
                          dtype=np.float64)
    got = np.asarray(ftle_pipeline(
        jnp.asarray(u, jnp.float32), jnp.asarray(v, jnp.float32), DT, grid,
        settls_order=4, interp_order=3))
    t0 = time.perf_counter()
    want = oracle_ftle(u, v, grid.lats, grid.lons, DT, settls_order=4,
                       interp_order=3, cyclic_x=True)
    rep("accuracy", grid=grid.shape, levels=ACCURACY_LEVELS,
        oracle_host_s=time.perf_counter() - t0)
    check_ftle(rep, "accuracy", got, want, "float64 scipy oracle")


def phase_fold(rep):
    """The grid's own last column scales to exactly n, which wrap-folds to
    1.0, the edge of the tap -1 mirror zone (ops/interp.py
    ``scale_positions``): fusion or FMA contraction that moves it by one
    ulp takes other taps."""
    import jax
    import jax.numpy as jnp

    from lagrangiancoherence_tpu.ops.interp import (interp_at_parcels_multi,
                                                    prefilter)
    from lagrangiancoherence_tpu.testing.oracle import oracle_map_coordinates

    ny, nx = 16, 128
    lats = np.linspace(-90.0, 90.0, ny)
    lons = np.linspace(-180.0, 180.0 - 360.0 / nx, nx)
    bounds = dict(y_min=lats[0], y_max=lats[-1], x_min=lons[0],
                  x_max=lons[-1])
    LON, LAT = np.meshgrid(np.deg2rad(lons), np.deg2rad(lats))
    w = 20.0 * np.cos(LAT) + 2.0 * np.cos(3 * LON) * np.sin(2 * LAT)
    raw = np.stack([w, 0.5 * w]).astype(np.float32)
    px = np.broadcast_to(lons, (ny, nx)).astype(np.float32)
    py = np.broadcast_to(lats[:, None], (ny, nx)).astype(np.float32)
    got = np.asarray(jax.jit(lambda r, x, y: interp_at_parcels_multi(
        r, prefilter(r, order=3), x, y, order=3, **bounds))(
            jnp.asarray(raw), jnp.asarray(px), jnp.asarray(py)))
    want = np.stack([oracle_map_coordinates(
        raw[k].astype(np.float64), lats, lons, px.astype(np.float64),
        py.astype(np.float64), order=3) for k in range(2)])
    excess = np.abs(got - want) / (FOLD_TOL + FOLD_TOL * np.abs(want))
    rep("fold", maxabs_vs_f64_oracle=float(np.abs(got - want).max()),
        last_column_maxabs=float(np.abs(got - want)[..., -1].max()))
    rep.check("fold", "max_err_over_tolerance", float(excess.max()), 1.0)


def phase_prefilter(rep, grid, seed):
    import jax.numpy as jnp
    from scipy.ndimage import spline_filter1d

    from lagrangiancoherence_tpu.ops.interp import prefilter
    from lagrangiancoherence_tpu.testing.flows import jet_wave_winds

    x = jet_wave_winds(grid.lats, grid.lons, 1, seed=seed,
                       dtype=np.float64)[0][0]
    want = spline_filter1d(spline_filter1d(x, order=3, mode="wrap", axis=0),
                           order=3, mode="wrap", axis=1)
    got = np.asarray(prefilter(jnp.asarray(x, jnp.float32), order=3))
    rel = float(np.abs(got - want).max() / np.abs(want).max())
    rep.check("prefilter", "rel_err_vs_scipy_f64", rel, MATMUL_REL_BOUND)


def phase_sht(rep, seed):
    import jax.numpy as jnp

    from lagrangiancoherence_tpu.grid import global_half_degree_grid
    from lagrangiancoherence_tpu.ops.sht import truncate, truncation_operators
    from lagrangiancoherence_tpu.testing.flows import jet_wave_winds

    g = global_half_degree_grid()
    x = jet_wave_winds(g.lats, g.lons, 1, seed=seed, dtype=np.float64)[0][0]
    x = x + np.random.default_rng(seed).normal(size=x.shape)
    T = 20
    S = truncation_operators(g.lats, T)
    spec = np.fft.rfft(x, axis=-1)
    out = np.zeros_like(spec)
    out[:, :T + 1] = np.einsum("myz,zm->ym", S, spec[:, :T + 1])
    want = np.fft.irfft(out, n=x.shape[-1], axis=-1)
    got = np.asarray(truncate(jnp.asarray(x, jnp.float32), g.lats, T))
    rel = float(np.abs(got - want).max() / np.abs(want).max())
    rep.check("sht", "rel_err_vs_numpy_f64", rel, MATMUL_REL_BOUND)


def run_one_card(rep, grid, seed, levels=LEVELS,
                 series_levels=SERIES_LEVELS, accuracy_grid=None):
    from lagrangiancoherence_tpu.testing.flows import jet_wave_winds

    u, v = jet_wave_winds(grid.lats, grid.lons, series_levels, seed=seed)
    flag = rep.phase("flagship", phase_flagship, grid, u[:levels],
                     v[:levels])
    rep.phase("layers", phase_layers, grid, u[:levels], v[:levels])
    rep.phase("api", phase_api, grid, u[:levels], v[:levels])
    rep.phase("series", phase_series, grid, u, v, levels, flag)
    acc_grid = accuracy_grid or grid
    rep.phase("accuracy", phase_accuracy, acc_grid, seed)
    rep.phase("fold", phase_fold)
    rep.phase("prefilter", phase_prefilter, acc_grid, seed)
    rep.phase("sht", phase_sht, seed)


def phase_four(rep, grid, seed, levels=LEVELS, windows=4):
    """ftle_sharded (4-row and 2 x 2 meshes) and ftle_batch against
    single-card ftle_pipeline."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from lagrangiancoherence_tpu.models.pipeline import ftle_pipeline
    from lagrangiancoherence_tpu.parallel.mesh import batch_mesh, parcel_mesh
    from lagrangiancoherence_tpu.parallel.pipeline import (ftle_batch,
                                                           ftle_sharded,
                                                           shard_inputs)
    from lagrangiancoherence_tpu.testing.flows import jet_wave_winds

    u, v = jet_wave_winds(grid.lats, grid.lons, levels + windows - 1,
                          seed=seed)
    kw = dict(settls_order=4, interp_order=3)
    singles = [np.asarray(ftle_pipeline(jnp.asarray(u[s:s + levels]),
                                        jnp.asarray(v[s:s + levels]), DT,
                                        grid, **kw)) for s in range(windows)]
    u0, v0 = u[:levels], v[:levels]

    for label, mesh in (("sharded_y4", parcel_mesh(4)),
                        ("sharded_y2x2", parcel_mesh(4, x_parallel=2))):
        ins = shard_inputs(u0, v0, grid, mesh,
                           x_sharded=mesh.shape.get("x", 1) > 1)
        for name, arr in ins.items():
            rep(label, input=name, shards=_shards(arr))
        t0 = time.perf_counter()
        out = np.asarray(ftle_sharded(u0, v0, DT, grid, mesh, **kw))
        rep(label, shape=out.shape,
            wall_s_with_compile=time.perf_counter() - t0)
        check_ftle(rep, label, out, singles[0], "single-card ftle_pipeline")

    mesh = batch_mesh(4)
    sharding = NamedSharding(mesh, P("t", None, None, None))
    ub = jax.device_put(np.stack([u[s:s + levels] for s in range(windows)]),
                        sharding)
    vb = jax.device_put(np.stack([v[s:s + levels] for s in range(windows)]),
                        sharding)
    rep("batch_t4", input="u", shards=_shards(ub))
    rep("batch_t4", input="v", shards=_shards(vb))
    t0 = time.perf_counter()
    out = ftle_batch(ub, vb, DT, grid, mesh, **kw)
    rep("batch_t4", output_shards=_shards(out))
    out = np.asarray(out)
    rep("batch_t4", shape=out.shape,
        wall_s_with_compile=time.perf_counter() - t0)
    for i in range(windows):
        check_ftle(rep, "batch_t4", out[i], singles[i],
                   f"single-card ftle_pipeline, window {i}")
    for d in jax.devices():
        rep("memory", device=d.id, peak_bytes_in_use=_peak_bytes(d))


def _import_package():
    """The package beside this script, never another installed copy."""
    sys.path.insert(0, HERE)
    try:
        import lagrangiancoherence_tpu as pkg
    except ImportError as e:
        raise SystemExit(f"chip_smoke: the lagrangiancoherence_tpu package "
                         f"is not beside this script ({e})") from None
    where = os.path.dirname(os.path.dirname(os.path.abspath(pkg.__file__)))
    if where != HERE:
        raise SystemExit(f"chip_smoke: lagrangiancoherence_tpu imported from "
                         f"{where}, not from {HERE}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card paths")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the synthetic winds")
    args = ap.parse_args(argv)

    _import_package()
    import jax

    from lagrangiancoherence_tpu.grid import global_quarter_degree_grid
    from lagrangiancoherence_tpu.utils.runtime import (card_info,
                                                       enable_compile_cache,
                                                       require_gpu)

    try:
        devices = require_gpu()
    except RuntimeError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 1
    if args.four and len(devices) < 4:
        print(f"chip_smoke: --four needs 4 GPUs, found {len(devices)}",
              file=sys.stderr)
        return 1
    cards = card_info()
    for line in cards:
        print(line, flush=True)
    rep = Report(cards[0] if len(set(cards)) == 1 else "; ".join(cards))
    try:
        import h5py  # noqa: F401
        h5 = True
    except ImportError:
        h5 = False
    rep("device", platform=devices[0].platform, kind=devices[0].device_kind,
        count=len(devices), h5py=h5, jax=jax.__version__,
        compile_cache=enable_compile_cache())

    grid = global_quarter_degree_grid()
    if args.four:
        rep.phase("four", phase_four, grid, args.seed)
        used = jax.devices()[:4]
    else:
        run_one_card(rep, grid, args.seed)
        used = devices[:1]
    if rep.failures:
        for f in rep.failures:
            print(f"chip_smoke: FAILED {f}", file=sys.stderr)
        return 1
    print(json.dumps(last_line(used)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
