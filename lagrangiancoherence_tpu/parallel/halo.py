"""Width-h latitude halo exchange + blocked stencils for the sharded pipeline.

SURVEY.md §2: the only cross-chip communication the FTLE workload needs is a
width-2 halo exchange of the departure-point fields at the flow-map-gradient
stage (4th-order stencil) — everything else is communication-free data
parallelism.  This module provides that exchange as explicit
``lax.ppermute`` neighbor shifts (one neighbour hop each way) plus blocked
versions of the stencil / Gaussian ops that consume the padded blocks.

All functions here run *inside* ``shard_map`` over a mesh axis ``"y"`` that
shards latitude rows.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..grid import EARTH_RADIUS

__all__ = ["exchange_rows", "exchange_cols_cyclic",
           "fourth_order_dim0_blocked", "fourth_order_dim1_blocked",
           "derivative_spherical_blocked", "gaussian_filter_blocked"]


def exchange_rows(x: jax.Array, h: int, axis_name: str = "y",
                  reflect_at_edges: bool = False) -> jax.Array:
    """Pad a (rows, nx) block to (rows + 2h, nx) with neighbour rows.

    Device d's top halo is the last ``h`` rows of device d-1; its bottom halo
    the first ``h`` rows of device d+1 — one ``ppermute`` each way.  Global
    edge devices receive zeros, or (``reflect_at_edges=True``) a symmetric
    reflection of their own edge rows — the blocked equivalent of scipy's
    ``mode='reflect'`` padding used by the Gaussian stage.
    """
    n = jax.lax.axis_size(axis_name)
    if n == 1:
        top = jnp.zeros_like(x[:h])
        bot = jnp.zeros_like(x[:h])
    else:
        top = jax.lax.ppermute(x[-h:], axis_name,
                               [(i, i + 1) for i in range(n - 1)])
        bot = jax.lax.ppermute(x[:h], axis_name,
                               [(i, i - 1) for i in range(1, n)])
    if reflect_at_edges:
        idx = jax.lax.axis_index(axis_name)
        top = jnp.where(idx == 0, x[h - 1::-1], top)
        bot = jnp.where(idx == n - 1, x[:x.shape[0] - h - 1:-1], bot)
    return jnp.concatenate([top, x, bot], axis=0)


def exchange_cols_cyclic(x: jax.Array, h: int,
                         axis_name: str = "x") -> jax.Array:
    """Pad a (rows, cols) block to (rows, cols + 2h) with neighbour columns,
    **cyclically**: the global longitude axis wraps, so the ppermute ring
    includes the wraparound hop (device 0 ↔ device n-1)."""
    n = jax.lax.axis_size(axis_name)
    if n == 1:
        left = x[:, -h:]
        right = x[:, :h]
    else:
        left = jax.lax.ppermute(x[:, -h:], axis_name,
                                [(i, (i + 1) % n) for i in range(n)])
        right = jax.lax.ppermute(x[:, :h], axis_name,
                                 [(i, (i - 1) % n) for i in range(n)])
    return jnp.concatenate([left, x, right], axis=1)


def fourth_order_dim1_blocked(padded: jax.Array, h: int) -> jax.Array:
    """Longitude derivative of a cyclically halo-padded block: the
    reference's 4th-order centred stencil with cyclic modulo indexing
    (/root/reference/LCS/tools.py:221-228), column-blocked.

    ``padded``: (rows, cols + 2h) with ``h >= 2``.  Returns (rows, cols).
    """
    cols = padded.shape[1] - 2 * h

    def sl(k):
        return jax.lax.slice_in_dim(padded, h + k, h + k + cols, axis=1)

    return (4.0 / 3.0) * (sl(1) - sl(-1)) / 2.0 \
        - (1.0 / 3.0) * (sl(2) - sl(-2)) / 4.0


def fourth_order_dim0_blocked(padded: jax.Array, h: int, row_start,
                              ny_total: int) -> jax.Array:
    """Latitude derivative of a halo-padded block: the reference's 4th-order
    centred stencil with one-sided differences at the *global* edges
    (/root/reference/LCS/tools.py:200-217), row-blocked.

    ``padded``: (rows + 2h, nx) with ``h >= 2``; ``row_start``: global index
    of the first interior row (traced OK).  Returns (rows, nx).
    """
    rows = padded.shape[0] - 2 * h

    def sl(k):
        return jax.lax.slice_in_dim(padded, h + k, h + k + rows, axis=0)

    out = (4.0 / 3.0) * (sl(1) - sl(-1)) / 2.0 \
        - (1.0 / 3.0) * (sl(2) - sl(-2)) / 4.0
    fwd = (sl(1) - sl(0)) / 2.0
    bwd = (sl(0) - sl(-1)) / 2.0
    grow = jax.lax.broadcasted_iota(jnp.int32, (rows, 1), 0) + row_start
    out = jnp.where(grow < 2, fwd, out)
    out = jnp.where(grow >= ny_total - 2, bwd, out)
    return out


def derivative_spherical_blocked(values_padded: jax.Array, h: int, row_start,
                                 lats_block: jax.Array, dlat: float,
                                 dlon: float, ny_total: int, dim: int,
                                 isglobal: bool = True,
                                 out_dtype=None) -> jax.Array:
    """Blocked ``derivative_spherical_coords`` (quirk Q6 float32 stencil,
    /root/reference/LCS/tools.py:248-267).

    For ``dim=0`` the input must be halo-padded; for ``dim=1`` (longitude,
    fully local on a lat-sharded layout) pass the unpadded block with h=0.
    """
    if out_dtype is None:
        out_dtype = values_padded.dtype
    if dim == 0:
        deriv = fourth_order_dim0_blocked(
            values_padded.astype(jnp.float32), h, row_start, ny_total
        ).astype(out_dtype)
        dy = (np.pi / 180.0) * dlat * EARTH_RADIUS
        return deriv / jnp.asarray(dy, dtype=out_dtype)
    from ..ops.stencil import fourth_order_derivative
    assert h == 0, "longitude derivative is local; pass the unpadded block"
    deriv = fourth_order_derivative(values_padded.astype(jnp.float32), dim=1,
                                    isglobal=isglobal).astype(out_dtype)
    y = lats_block.astype(out_dtype) * (np.pi / 180.0)
    dx = (np.pi / 180.0) * dlon * EARTH_RADIUS * jnp.cos(y)
    return deriv / dx[:, None]


def gaussian_filter_blocked(x: jax.Array, sigma: float, axis_name: str = "y",
                            truncate: float = 4.0) -> jax.Array:
    """Blocked scipy-compatible Gaussian smoothing: halo-exchange ``radius``
    rows (reflected at the global edges), then separable correlation —
    matches the full-field ``ops.filters.gaussian_filter`` on the assembled
    result.  Requires the global row count to be exactly
    ``rows_per_shard * n_shards`` (no pad rows); the sharded pipeline falls
    back to an all_gather + full-field smooth otherwise.
    """
    from ..ops.filters import gaussian_kernel1d
    taps = gaussian_kernel1d(float(sigma), truncate)
    r = (len(taps) - 1) // 2
    k = jnp.asarray(taps, dtype=x.dtype)
    if x.shape[0] < r:
        raise ValueError(f"{x.shape[0]} rows/shard < gaussian radius {r}")
    padded = exchange_rows(x, r, axis_name, reflect_at_edges=True)
    rows = x.shape[0]
    out = jnp.zeros_like(x)
    for i in range(len(taps)):
        out = out + k[i] * jax.lax.slice_in_dim(padded, i, i + rows, axis=0)
    # longitude axis is local: symmetric pad + correlate
    p = jnp.pad(out, [(0, 0), (r, r)], mode="symmetric")
    out2 = jnp.zeros_like(out)
    nx = x.shape[1]
    for i in range(len(taps)):
        out2 = out2 + k[i] * jax.lax.slice_in_dim(p, i, i + nx, axis=1)
    return out2
