"""SETTLS two-time-level semi-Lagrangian parcel advection (Hortal 2002).

Re-design of the reference's integrator
(/root/reference/LCS/trajectory.py:8-144): the Python time loop with per-step
scipy ``map_coordinates`` calls becomes one ``lax.scan`` over the time axis,
with the wind fields cubic-prefiltered **once** up front (two dense matmuls
per slice) and each step evaluating ``1 + SETTLS_order`` multi-field gather
groups (``2 + 4*SETTLS_order`` field interpolations) over the whole parcel
grid.

Reference semantics replicated exactly (SURVEY.md quirks):

* Q2 — winds are indexed positionally **forward** even for backward
  (timestep < 0) integration; only time *labels* are reversed at the API
  layer (/root/reference/LCS/trajectory.py:59-60,82-84,105-108);
* Q3 — each SETTLS iteration *adds* the correction to the already-displaced
  iterate (/root/reference/LCS/trajectory.py:110-112);
* Q5 — cyclic wrap ``x % 180`` below -180 and ``-180 + (x % 180)`` above
  +180; hard clamp of latitude to [y_min, y_max] and, when non-cyclic, of
  longitude to [x_min, x_max] (/root/reference/LCS/trajectory.py:89-97);
* conversion factors ``conv_y = 180/(R*pi)`` and
  ``conv_x = conv_y/|cos(lat_grid)|`` are evaluated on the parcels' *home*
  latitudes, not their current positions
  (/root/reference/LCS/trajectory.py:54-57).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..grid import EARTH_RADIUS, Grid
from ..ops.interp import interp_at_parcels_multi, prefilter

__all__ = ["parcel_propagation_core", "settls_scan", "conv_x_factor"]


def conv_x_factor(lats) -> np.ndarray:
    """(rows, 1) m/s → deg/s longitude factor ``conv_y / |cos(lat)|`` on the
    parcels' home latitudes (the reference's LCS/trajectory.py:54-57),
    evaluated in float64 on the host.  Every program (single-device or
    sharded) casts these same values to its dtype: a factor computed on
    the device, or constant-folded by the compiler, can differ in the last
    bit between programs, and the scan amplifies that into visibly
    different float32 trajectories."""
    conv_y = 180.0 / (EARTH_RADIUS * np.pi)
    lat = np.asarray(lats, dtype=np.float64)
    return (conv_y / np.abs(np.cos(lat * (np.pi / 180.0))))[:, None]


def _progress_step(t, nsteps):
    """Host-side per-step progress line for long scans (the reference
    prints ``Propagating time ...`` every step,
    /root/reference/LCS/trajectory.py:81).  Fired from inside the scan via
    ``jax.debug.callback`` — async, so it never stalls the device."""
    from ..utils.logging import logger
    logger.info("Propagating time index %d/%d", int(t) + 1, int(nsteps))


def _clamp_wrap(px, py, *, y_min, y_max, x_min, x_max, cyclic_x):
    """Boundary handling per /root/reference/LCS/trajectory.py:89-97."""
    py = jnp.where(py > y_min, py, y_min)
    py = jnp.where(py < y_max, py, y_max)
    if cyclic_x:
        px = jnp.where(px > -180.0, px, jnp.mod(px, 180.0))
        px = jnp.where(px < 180.0, px, -180.0 + jnp.mod(px, 180.0))
    else:
        px = jnp.where(px < x_min, x_min, px)
        px = jnp.where(px > x_max, x_max, px)
    return px, py




def settls_scan(u, v, cu, cv, px0, py0, dt, conv_x, grid: Grid, *,
                settls_order: int, interp_order: int, return_traj: bool,
                home_rows=None, progress: bool = False):
    """The SETTLS time loop as one ``lax.scan`` over a position *block*.

    ``u``/``v``: full (T, ny, nx) winds; ``cu``/``cv``: their prefiltered
    coefficients.  ``px0``/``py0``: (rows, nx) initial positions whose home
    rows are grid rows 0.. or, for a shard's block, are given per row by
    ``home_rows`` ((rows, 1) traced int array).
    ``conv_x``: (rows, 1) per-home-latitude m/s→deg/s factor.  Shared by
    the single-device jit and the shard_map per-device block.

    Hot-path structure: all fields needed at one set of positions evaluate
    through a single multi-field gather — one gather group for the Euler
    guess (u_t, v_t) and one per SETTLS iteration (u, v at both time
    levels), sharing the fold/mirror/weight index math across fields.

    Returns the final ``(px, py)`` or, with ``return_traj``, the
    (T, rows, nx) position stacks including the initial positions.
    """
    dtype = u.dtype
    conv_y = jnp.asarray(180.0 / (EARTH_RADIUS * np.pi), dtype=dtype)
    bounds = dict(y_min=grid.y_min, y_max=grid.y_max,
                  x_min=grid.x_min, x_max=grid.x_max, cyclic_x=grid.cyclic_x)
    W = jnp.stack([u, v], axis=1)      # (T, 2, ny, nx)
    CW = jnp.stack([cu, cv], axis=1)

    def interp_multi(fields, coeffs, px, py):
        return interp_at_parcels_multi(
            fields, coeffs, px, py,
            x_min=grid.x_min, x_max=grid.x_max,
            y_min=grid.y_min, y_max=grid.y_max,
            order=interp_order, home_rows=home_rows)

    def slices(t):
        return (jax.lax.dynamic_index_in_dim(W, t, 0, keepdims=False),
                jax.lax.dynamic_index_in_dim(CW, t, 0, keepdims=False))

    def step(carry, t):
        if progress:
            jax.debug.callback(_progress_step, t, u.shape[0] - 1,
                               ordered=False)
        px, py = carry

        # Euler first guess from winds at the current positions
        # (/root/reference/LCS/trajectory.py:82-87)
        A_t, B_t = slices(t)
        ua, va = interp_multi(A_t, B_t, px, py)
        py = py + dt * conv_y * va
        px = px + dt * conv_x * ua
        px, py = _clamp_wrap(px, py, **bounds)

        # SETTLS fixed-point iterations, cumulative form (Q3)
        # (/root/reference/LCS/trajectory.py:100-124)
        if settls_order:
            A_n, B_n = slices(t + 1)
            A_tn = jnp.concatenate([A_t, A_n], axis=0)
            B_tn = jnp.concatenate([B_t, B_n], axis=0)
        for _ in range(settls_order):
            u_t_d, v_t_d, u_n_d, v_n_d = interp_multi(A_tn, B_tn, px, py)
            py = py + 0.5 * dt * conv_y * (va + 2.0 * v_t_d - v_n_d)
            px = px + 0.5 * dt * conv_x * (ua + 2.0 * u_t_d - u_n_d)
            px, py = _clamp_wrap(px, py, **bounds)

        return (px, py), ((px, py) if return_traj else None)

    nsteps = u.shape[0] - 1
    (px, py), traj = jax.lax.scan(step, (px0, py0), jnp.arange(nsteps))
    if return_traj:
        traj_x = jnp.concatenate([px0[None], traj[0]], axis=0)
        traj_y = jnp.concatenate([py0[None], traj[1]], axis=0)
        return traj_x, traj_y
    return px, py


@partial(jax.jit, static_argnames=("grid", "settls_order", "interp_order",
                                   "return_traj", "progress"))
def parcel_propagation_core(u: jax.Array, v: jax.Array, timestep,
                            grid: Grid, *, settls_order: int = 0,
                            interp_order: int = 3,
                            return_traj: bool = False,
                            progress: bool = False):
    """Integrate parcel positions through ``T-1`` SETTLS steps.

    Parameters
    ----------
    u, v : (T, ny, nx) zonal/meridional wind [m/s], lat/lon ascending, time
        in storage order (Q2: forward positional indexing regardless of the
        sign of ``timestep``).
    timestep : seconds (scalar; negative for backward integration).
    grid : static Grid.
    return_traj : if True, returns (T, ny, nx) stacked positions including
        the initial mesh; else the final (ny, nx) positions.
    progress : log one line per step from inside the scan (host callback).

    Returns
    -------
    (positions_x, positions_y)
    """
    dtype = u.dtype
    ny, nx = grid.shape
    assert u.shape[-2:] == (ny, nx), (u.shape, grid.shape)

    # Prefilter every time slice once (order-3 only); raw fields are still
    # needed for the pole rows' order-1/constant path.
    cu = prefilter(u, order=interp_order)
    cv = prefilter(v, order=interp_order)

    dt = jnp.asarray(timestep, dtype=dtype)
    conv_x = jnp.asarray(conv_x_factor(grid.lats), dtype=dtype)

    px0_np, py0_np = grid.mesh_xy
    px0 = jnp.asarray(px0_np, dtype=dtype)
    py0 = jnp.asarray(py0_np, dtype=dtype)

    return settls_scan(u, v, cu, cv, px0, py0, dt, conv_x, grid,
                       settls_order=settls_order, interp_order=interp_order,
                       return_traj=return_traj, progress=progress)
