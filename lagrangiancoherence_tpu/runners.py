"""Batch runners: FTLE time series (the animation workload).

The reference's production pattern is one batch job per timestamp, driven by
an HPC scheduler over netCDF files (/root/reference/LCS/LCS.py:236-268,
area_of_influence.py:168-184: a Python loop sliding an 8-step window).  Here
the same workload is a library call:

* ``ftle_series`` slides an integration window over a long wind record and
  computes one FTLE field per window — batched through ``vmap`` (one fused
  program evaluates ``batch`` windows at a time) and optionally sharded over
  a ``"t"`` device mesh axis (parallel/mesh.batch_mesh);
* ``ftle_series_to_files`` **streams**: each window is computed and written
  to its per-timestamp netCDF/HDF5 file before the next chunk starts, and
  windows whose output file already exists are skipped *before* compute —
  the idempotent retry-at-the-driver failure-recovery contract
  (SURVEY.md §5): a crashed run is resumed by re-invoking it and pays only
  for the windows it had not finished.
"""
from __future__ import annotations

import os

import numpy as np

from .field import Field, as_field
from .grid import Grid
from .utils.logging import logger, timed_stage

__all__ = ["ftle_series", "ftle_series_to_files"]


def _windows(nt: int, window: int, stride: int) -> list[int]:
    return list(range(0, nt - window + 1, stride))


def _prep_record(u, v, propdim):
    """Sort/transpose the wind record into (time, lat, lon) numpy arrays."""
    if not (hasattr(u, "dims") or not isinstance(u, np.ndarray)):
        raise TypeError("pass Fields (or xarray DataArrays) with "
                        "time/latitude/longitude dims")
    U, V = as_field(u), as_field(v)
    order = (propdim, "latitude", "longitude")
    U = U.transpose(*order).sortby("latitude").sortby("longitude")
    V = V.transpose(*order).sortby("latitude").sortby("longitude")
    lats, lons = U.coords["latitude"], U.coords["longitude"]
    times = U.coords[propdim]
    return np.asarray(U.data), np.asarray(V.data), lats, lons, times


def _auto_batch(mesh) -> int:
    """Windows per compiled program: 8 vmapped windows by default.  With a
    ``"t"`` mesh the batch must stay shardable (a size-1 batch axis cannot
    be partitioned N ways), so the heuristic returns a multiple of the
    mesh's device count."""
    if mesh is not None:
        n = int(np.prod(list(mesh.shape.values())))
        return n * max(1, 8 // n)
    return 8


def _iter_series_chunks(ud, vd, starts, window, timestep, grid, *,
                        batch, mesh, settls_order, interp_order, sigma,
                        compat):
    """Yield ``(chunk_starts, fields_np)`` per compiled batch.

    ``ud``/``vd`` are the full device-resident wind records — uploaded ONCE
    by the caller; windows are sliced on device, so overlapping windows
    never cross the host link again (274 MB per flagship window).
    """
    import jax
    import jax.numpy as jnp

    from .models.pipeline import ftle_pipeline

    kw = dict(settls_order=settls_order, interp_order=interp_order,
              sigma=sigma, compat=compat)
    # one jitted vmapped executable shared by every multi-window chunk
    # (rebuilding it per chunk re-traced each time)
    vfn = jax.jit(jax.vmap(lambda uu, vv: ftle_pipeline(
        uu, vv, timestep, grid, **kw)))

    if mesh is not None:
        from .parallel.pipeline import ftle_batch
        ndev = int(np.prod(list(mesh.shape.values())))

    for chunk_start in range(0, len(starts), batch):
        chunk = starts[chunk_start:chunk_start + batch]
        if mesh is not None:
            # pad the tail chunk to a multiple of the device count so the
            # "t" batch axis stays shardable; padded replicas are sliced
            # off below
            pad = (-len(chunk)) % ndev
            padded = chunk + [chunk[-1]] * pad
            ub = jnp.stack([ud[s:s + window] for s in padded])
            vb = jnp.stack([vd[s:s + window] for s in padded])
            out = np.asarray(ftle_batch(ub, vb, timestep, grid, mesh,
                                        **kw))[:len(chunk)]
        elif len(chunk) == 1:
            # plain (un-vmapped) single-field program — ftle_pipeline is
            # itself jitted, so repeated calls reuse one executable
            s = chunk[0]
            out = np.asarray(ftle_pipeline(ud[s:s + window],
                                           vd[s:s + window], timestep,
                                           grid, **kw))[None]
        else:
            ub = jnp.stack([ud[s:s + window] for s in chunk])
            vb = jnp.stack([vd[s:s + window] for s in chunk])
            out = np.asarray(vfn(ub, vb))
        yield chunk, out


def _stamp_indices(starts, window, timestep):
    """Per-window timestamp rule: last time of the window forward, first
    backward (/root/reference/LCS/LCS.py:158)."""
    return [(s + window - 1 if timestep > 0 else s) for s in starts]


def ftle_series(u, v, timestep: float, *, window: int, stride: int = 1,
                settls_order: int = 4, interp_order: int = 3, sigma=None,
                compat: bool = True, batch="auto", mesh=None,
                propdim: str = "time", cyclic_x: bool = True):
    """FTLE fields over sliding windows of a long wind record.

    ``u``/``v``: Fields (time, latitude, longitude) or arrays with the same
    layout; ``window``: time levels per integration (e.g. 33 for 8 days of
    6-hourly data); ``stride``: window start spacing.  Returns a Field
    (time, latitude, longitude) stamped per the reference's rule (last time
    of the window forward, first backward — /root/reference/LCS/LCS.py:158).

    ``batch``: windows evaluated per compiled program; ``"auto"`` picks per
    mesh (see ``_auto_batch``).  The record computes in ``api.float_dtype``:
    float64 under JAX's x64 mode, float32 otherwise.

    ``mesh``: optional ``batch_mesh`` to shard window batches across chips.

    ``cyclic_x``: longitude wrap semantics.  ``True`` (global records)
    wraps parcels across the dateline; pass ``False`` for regional records
    (the reference's own research workload is regional —
    /root/reference/LCS/area_of_influence.py:168-184), which clamp at the
    domain edge instead.
    """
    import jax.numpy as jnp

    from .api import float_dtype

    ud, vd, lats, lons, times = _prep_record(u, v, propdim)
    grid = Grid(lats=lats, lons=lons, cyclic_x=cyclic_x)
    starts = _windows(ud.shape[0], window, stride)
    if not starts:
        raise ValueError(f"record of {ud.shape[0]} steps is shorter than "
                         f"window={window}")
    if batch == "auto":
        batch = _auto_batch(mesh)
    batch = max(1, int(batch))

    # upload the whole wind record ONCE; windows are sliced on device
    ud = jnp.asarray(ud, dtype=float_dtype())
    vd = jnp.asarray(vd, dtype=float_dtype())

    fields = []
    with timed_stage(f"FTLE series: {len(starts)} windows"):
        for _chunk, out in _iter_series_chunks(
                ud, vd, starts, window, timestep, grid, batch=batch,
                mesh=mesh, settls_order=settls_order,
                interp_order=interp_order, sigma=sigma, compat=compat):
            fields.append(out)
    data = np.concatenate(fields, axis=0)

    stamps = np.asarray(times)[_stamp_indices(starts, window, timestep)]
    return Field(data, (propdim, "latitude", "longitude"),
                 {propdim: stamps, "latitude": lats, "longitude": lons},
                 name="ftle")


def _stamp_tag(stamp) -> str:
    return np.datetime_as_string(np.datetime64(stamp), unit="h") \
        if np.issubdtype(np.asarray(stamp).dtype, np.datetime64) \
        else str(stamp)


def ftle_series_to_files(u, v, timestep: float, outdir: str, *,
                         window: int, stride: int = 1,
                         overwrite: bool = False, batch="auto", mesh=None,
                         settls_order: int = 4, interp_order: int = 3,
                         sigma=None, compat: bool = True,
                         propdim: str = "time",
                         cyclic_x: bool = True) -> list[str]:
    """Streaming variant: one netCDF/HDF5 file per window timestamp.

    Streams for real: each chunk of windows is written as soon as it is
    computed, so a crash at window N loses at most one chunk of compute and
    host memory stays O(batch) fields, not O(series).  On re-invocation,
    windows whose output file already exists are dropped *before* compute
    (unless ``overwrite``) — resume skips the work, not just the write.
    """
    import jax.numpy as jnp

    from .api import float_dtype
    from .utils.io import save_dataset

    os.makedirs(outdir, exist_ok=True)
    ud, vd, lats, lons, times = _prep_record(u, v, propdim)
    grid = Grid(lats=lats, lons=lons, cyclic_x=cyclic_x)
    starts = _windows(ud.shape[0], window, stride)
    if not starts:
        raise ValueError(f"record of {ud.shape[0]} steps is shorter than "
                         f"window={window}")

    stamps = np.asarray(times)[_stamp_indices(starts, window, timestep)]
    paths = {s: os.path.join(outdir, f"ftle_{_stamp_tag(st)}.nc")
             for s, st in zip(starts, stamps)}
    stamp_of = dict(zip(starts, stamps))
    if overwrite:
        todo = starts
    else:
        todo = [s for s in starts if not os.path.exists(paths[s])]
        for s in starts:
            if s not in todo:
                logger.info("skip existing %s", paths[s])
    if not todo:
        return []

    if batch == "auto":
        batch = _auto_batch(mesh)
    batch = max(1, int(batch))
    ud = jnp.asarray(ud, dtype=float_dtype())
    vd = jnp.asarray(vd, dtype=float_dtype())

    written = []
    with timed_stage(f"FTLE series → files: {len(todo)} windows"):
        for chunk, out in _iter_series_chunks(
                ud, vd, todo, window, timestep, grid, batch=batch,
                mesh=mesh, settls_order=settls_order,
                interp_order=interp_order, sigma=sigma, compat=compat):
            for s, field2d in zip(chunk, out):
                stamp = stamp_of[s]
                fld = Field(field2d[None], (propdim, "latitude", "longitude"),
                            {propdim: np.asarray([stamp]),
                             "latitude": lats, "longitude": lons},
                            name="ftle")
                if save_dataset({"ftle": fld}, paths[s],
                                skip_if_exists=not overwrite):
                    written.append(paths[s])
    return written
