"""Multi-chip FTLE pipeline: spatial DP over the parcel grid via shard_map.

Scale-out design (SURVEY.md §2 'Parallelism strategies'):

* wind fields (T, ny, nx) are **replicated** — each chip holds the full
  domain its parcels can reach, so the SETTLS scan needs **zero
  communication**;
* parcel positions are **sharded by latitude rows** over the mesh axis
  ``"y"``; every interpolation is a local gather;
* the only cross-chip exchange in the whole pipeline is the width-2 halo of
  the departure-point blocks at the flow-map-gradient stage (4th-order lat
  stencil) — two ``ppermute`` neighbour hops (parallel/halo.py);
* the closed-form norm is pointwise-local.

Grids whose row count does not divide the device count are padded with
replica rows at the south-most end of the last shard; the pad integrates
harmlessly (positions clamp) and is sliced off after the gather.  The
stencil's one-sided edge branch keys on *real* global row indices, so padded
rows never contaminate real outputs.

``ftle_batch`` handles the animation workload: a batch of independent wind
fields sharded over a ``"t"`` mesh axis — trivial DP, no communication.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import NamedSharding, PartitionSpec as P

from ..grid import Grid
from ..models.ftle import ftle_norm
from ..models.pipeline import ftle_pipeline
from ..models.settls import conv_x_factor, settls_scan
from ..ops.interp import prefilter
from .halo import (derivative_spherical_blocked, exchange_cols_cyclic,
                   exchange_rows, fourth_order_dim1_blocked,
                   gaussian_filter_blocked)

__all__ = ["ftle_sharded", "ftle_batch", "parcel_propagation_sharded",
           "shard_inputs"]

EARTH_DEG = np.pi / 180.0


def shard_inputs(u, v, grid: Grid, mesh, *, x_sharded: bool = False):
    """Place the latitude-sharded pipelines' inputs on ``mesh``.

    Winds are replicated; initial positions, the conv factor, latitudes and
    home rows are sharded by latitude rows over ``"y"`` (positions also by
    longitude over ``"x"`` when ``x_sharded``).  Returns a dict of device
    arrays: ``u, v, px0, py0, convx, lats, home``.

    Row padding up to a multiple of the ``"y"`` axis uses
    SYMMETRIC-reflected rows (global row k >= ny maps to 2*ny-1-k, edge row
    repeated — scipy 'reflect'): a padded parcel starts exactly where its
    reflected row starts and is integrated with that row's home-row
    metadata, so its trajectory is bit-identical — which makes the Gaussian
    stage's reflect-padding at the south edge exact.
    """
    ny = grid.shape[0]
    nyd = mesh.shape["y"]
    ny_pad = -(-ny // nyd) * nyd
    dtype = jnp.asarray(u).dtype
    home_idx = np.arange(ny_pad)
    home_idx = np.where(home_idx < ny, home_idx, 2 * ny - 1 - home_idx)
    px0, py0 = grid.mesh_xy
    lats_pad = grid.lats[home_idx]

    rep = NamedSharding(mesh, P())
    shard_y = NamedSharding(mesh, P("y", None))
    shard_pos = NamedSharding(mesh, P("y", "x" if x_sharded else None))

    def put(a, sharding, dt=dtype):
        return jax.device_put(jnp.asarray(a, dtype=dt), sharding)

    return dict(u=put(u, rep), v=put(v, rep),
                px0=put(px0[home_idx], shard_pos),
                py0=put(py0[home_idx], shard_pos),
                convx=put(conv_x_factor(lats_pad), shard_y),
                lats=put(lats_pad, NamedSharding(mesh, P("y"))),
                home=put(home_idx[:, None], shard_y, jnp.int32))


def ftle_sharded(u, v, timestep, grid: Grid, mesh, *, settls_order: int = 0,
                 interp_order: int = 3, sigma=None, compat: bool = True):
    """(T, ny, nx) winds → (ny, nx) FTLE norm, sharded over ``mesh`` axis
    ``"y"`` (and optionally ``"x"``).  Numerically identical to
    ``models.pipeline.ftle_pipeline``.
    """
    ny, nx = grid.shape
    nyd = mesh.shape["y"]
    nxd = mesh.shape.get("x", 1)
    x_axes = ("x",) if nxd > 1 else ()
    if nxd > 1:
        if nx % nxd:
            raise ValueError(f"nx={nx} must divide the x mesh axis ({nxd})")
        if sigma is not None:
            raise NotImplementedError(
                "gauss_sigma with an x-sharded mesh is not supported yet; "
                "use a 1-D ('y',) mesh")
    rows = -(-ny // nyd)          # rows per shard (ceil)
    ny_pad = rows * nyd
    pad = ny_pad - ny             # reflected pad rows (see shard_inputs)
    dt = jnp.asarray(timestep, dtype=jnp.asarray(u).dtype)
    dlat = float(grid.lats[1] - grid.lats[0])
    dlon = float(grid.lons[1] - grid.lons[0])
    assert rows >= 2, (
        f"{rows} rows/shard < stencil halo width 2; use fewer devices")

    def block_fn(u_f, v_f, cu_f, cv_f, px0_b, py0_b, convx_b, lats_b,
                 home_b):
        row_start = jax.lax.axis_index("y") * rows
        px, py = settls_scan(u_f, v_f, cu_f, cv_f, px0_b, py0_b, dt,
                             convx_b, grid, settls_order=settls_order,
                             interp_order=interp_order, return_traj=False,
                             home_rows=home_b)
        if sigma is not None:
            if pad == 0:
                # fully local: width-radius halo exchange, zero gather
                px = gaussian_filter_blocked(px, sigma)
                py = gaussian_filter_blocked(py, sigma)
            else:
                # pad rows break the reflect-at-block-edge identity; the
                # smooth runs once per pipeline, so an all_gather of the two
                # (ny, nx) departure fields (a few MB) + replicated
                # full-field smoothing is the simple exact fallback
                def smooth_full(f):
                    full = jax.lax.all_gather(f, "y", axis=0, tiled=True)[:ny]
                    from ..ops.filters import gaussian_filter
                    sm = gaussian_filter(full, sigma)
                    sm = jnp.pad(sm, ((0, ny_pad - ny), (0, 0)))
                    return jax.lax.dynamic_slice_in_dim(sm, row_start, rows,
                                                        axis=0)
                px = smooth_full(px)
                py = smooth_full(py)
        # sphere map (/root/reference/LCS/LCS.py:193-199)
        lon = px * EARTH_DEG
        colat = (py - 90.0) * EARTH_DEG
        X = 6371000.0 * jnp.sin(colat) * jnp.cos(lon)
        Y = 6371000.0 * jnp.sin(colat) * jnp.sin(lon)
        Z = 6371000.0 * jnp.cos(colat)

        def ds(f, dim):
            if dim == 0:
                fp = exchange_rows(f, 2)
                return derivative_spherical_blocked(
                    fp, 2, row_start, lats_b, dlat, dlon, ny, dim=0,
                    out_dtype=f.dtype)
            if nxd > 1:
                # x-sharded: cyclic ring halo + blocked stencil (the
                # gradient stage is always cyclic in lon — LCS.py:200 with
                # tools.py:248 defaults), with the quirk-Q6 f32 cast
                fp = exchange_cols_cyclic(f.astype(jnp.float32), 2)
                deriv = fourth_order_dim1_blocked(fp, 2).astype(f.dtype)
                dx = (np.pi / 180.0) * dlon * 6371000.0 \
                    * jnp.cos(lats_b.astype(f.dtype) * EARTH_DEG)
                return deriv / dx[:, None]
            return derivative_spherical_blocked(
                f, 0, row_start, lats_b, dlat, dlon, ny, dim=1,
                out_dtype=f.dtype)

        zero = jnp.zeros_like(X)
        tensor = jnp.stack([ds(X, 1), ds(X, 0), ds(Y, 1), ds(Y, 0),
                            ds(Z, 1), ds(Z, 0), zero, zero, zero])
        return ftle_norm(tensor, compat=compat)

    @jax.jit
    def run(u, v, px0, py0, convx, lats, home):
        cu = prefilter(u, order=interp_order)
        cv = prefilter(v, order=interp_order)
        xs = x_axes[0] if x_axes else None
        fn = shard_map(block_fn, mesh=mesh, check_vma=False,
                       in_specs=(P(), P(), P(), P(),
                                 P("y", xs), P("y", xs),
                                 P("y", None), P("y"), P("y", None)),
                       out_specs=P("y", xs))
        return fn(u, v, cu, cv, px0, py0, convx, lats, home)

    out = run(**shard_inputs(u, v, grid, mesh, x_sharded=nxd > 1))
    return out[:ny]


def parcel_propagation_sharded(u, v, timestep, grid: Grid, mesh, *,
                               settls_order: int = 0, interp_order: int = 3,
                               return_traj: bool = False):
    """Latitude-sharded SETTLS integration: (T, ny, nx) winds → departure
    points (ny, nx) or trajectories (T, ny, nx), sharded over mesh axis
    ``"y"``.  Zero cross-device communication (winds replicated, positions
    sharded) — the integration itself never couples parcels.
    """
    ny = grid.shape[0]
    dt = jnp.asarray(timestep, dtype=jnp.asarray(u).dtype)

    def block_fn(u_f, v_f, cu_f, cv_f, px0_b, py0_b, convx_b, home_b):
        return settls_scan(u_f, v_f, cu_f, cv_f, px0_b, py0_b, dt,
                           convx_b, grid, settls_order=settls_order,
                           interp_order=interp_order,
                           return_traj=return_traj, home_rows=home_b)

    pos_spec = P(None, "y", None) if return_traj else P("y", None)

    @jax.jit
    def run(u, v, px0, py0, convx, home):
        cu = prefilter(u, order=interp_order)
        cv = prefilter(v, order=interp_order)
        fn = shard_map(block_fn, mesh=mesh, check_vma=False,
                       in_specs=(P(), P(), P(), P(),
                                 P("y", None), P("y", None),
                                 P("y", None), P("y", None)),
                       out_specs=(pos_spec, pos_spec))
        return fn(u, v, cu, cv, px0, py0, convx, home)

    ins = shard_inputs(u, v, grid, mesh)
    del ins["lats"]
    px, py = run(**ins)
    if return_traj:
        return px[:, :ny], py[:, :ny]
    return px[:ny], py[:ny]


def ftle_batch(u_batch, v_batch, timestep, grid: Grid, mesh, *,
               settls_order: int = 0, interp_order: int = 3, sigma=None,
               compat: bool = True):
    """Batched FTLE over independent wind fields (B, T, ny, nx), sharded over
    the ``"t"`` mesh axis — the animation workload's trivial data
    parallelism (SURVEY.md §5 'long integration windows')."""
    fn = jax.vmap(lambda uu, vv: ftle_pipeline(
        uu, vv, timestep, grid, settls_order=settls_order,
        interp_order=interp_order, sigma=sigma, compat=compat))
    sharded = NamedSharding(mesh, P("t", None, None, None))
    u_j = jax.device_put(jnp.asarray(u_batch), sharded)
    v_j = jax.device_put(jnp.asarray(v_batch), sharded)
    return jax.jit(fn)(u_j, v_j)
