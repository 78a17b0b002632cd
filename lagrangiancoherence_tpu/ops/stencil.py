"""Finite-difference stencils on the sphere.

Re-implementation of the reference's numba kernels:

* ``fourth_order_derivative`` (/root/reference/LCS/tools.py:190-245): 4th-order
  centred stencil ``(4/3)(f[+1]-f[-1])/2 - (1/3)(f[+2]-f[-2])/4`` with
  one-sided ``(f[+1]-f)/2`` / ``(f-f[-1])/2`` within two rows of the domain
  edges, and cyclic modulo indexing in longitude when ``isglobal``;
* ``derivative_spherical_coords`` (/root/reference/LCS/tools.py:248-267):
  metric scaling ``dx = (pi/180) dlon R cos(lat)``, ``dy = (pi/180) dlat R``,
  including the reference's float32 cast of the stencil stage (SURVEY.md
  quirk Q6, /root/reference/LCS/tools.py:258).

Instead of numba's scalar loops, everything is expressed as rolls/shifts that
XLA fuses into a single vectorised pass.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..grid import EARTH_RADIUS

__all__ = ["fourth_order_derivative", "derivative_spherical_coords"]


def _centered(arr: jnp.ndarray, axis: int) -> jnp.ndarray:
    """4th-order centred difference with periodic wraparound along ``axis``."""
    p1 = jnp.roll(arr, -1, axis=axis)
    m1 = jnp.roll(arr, 1, axis=axis)
    p2 = jnp.roll(arr, -2, axis=axis)
    m2 = jnp.roll(arr, 2, axis=axis)
    return (4.0 / 3.0) * (p1 - m1) / 2.0 - (1.0 / 3.0) * (p2 - m2) / 4.0


def fourth_order_derivative(arr: jnp.ndarray, dim: int = 0,
                            isglobal: bool = True) -> jnp.ndarray:
    """Semantics of the reference numba stencil on a 2-D [lat, lon] array.

    dim=0 (latitude): centred interior, one-sided within 2 rows of each edge.
    dim=1 (longitude): fully cyclic when ``isglobal``; otherwise one-sided at
    the two columns nearest each boundary.
    """
    arr = jnp.asarray(arr)
    if dim == 0:
        out = _centered(arr, axis=0)
        # one-sided rows: 0,1 forward; -2,-1 backward (tools.py:209-217)
        fwd = (jnp.roll(arr, -1, axis=0) - arr) / 2.0
        bwd = (arr - jnp.roll(arr, 1, axis=0)) / 2.0
        n = arr.shape[0]
        row = jnp.arange(n)[:, None]
        out = jnp.where(row < 2, fwd, out)
        out = jnp.where(row >= n - 2, bwd, out)
        return out
    elif dim == 1:
        out = _centered(arr, axis=1)
        if isglobal:
            return out
        fwd = (jnp.roll(arr, -1, axis=1) - arr) / 2.0
        bwd = (arr - jnp.roll(arr, 1, axis=1)) / 2.0
        n = arr.shape[1]
        col = jnp.arange(n)[None, :]
        out = jnp.where(col < 2, fwd, out)
        out = jnp.where(col >= n - 2, bwd, out)
        return out
    raise ValueError("dim must be 0 or 1")


def derivative_spherical_coords(values: jnp.ndarray, lats: np.ndarray,
                                lons: np.ndarray, dim: int = 0,
                                isglobal: bool = True,
                                out_dtype=None) -> jnp.ndarray:
    """Metric-scaled spherical derivative (/root/reference/LCS/tools.py:248-267).

    The stencil stage runs in float32 (quirk Q6); the metric division promotes
    back to ``out_dtype`` (default: dtype of ``values``), matching the
    reference's numpy float32/float64 mixing.
    """
    values = jnp.asarray(values)
    if out_dtype is None:
        out_dtype = values.dtype
    deriv = fourth_order_derivative(values.astype(jnp.float32), dim=dim,
                                    isglobal=isglobal).astype(out_dtype)
    if dim == 0:
        dy = (np.pi / 180.0) * (lats[1] - lats[0]) * EARTH_RADIUS
        return deriv / jnp.asarray(dy, dtype=out_dtype)
    y = jnp.asarray(lats, dtype=out_dtype) * (np.pi / 180.0)
    dx = (np.pi / 180.0) * (lons[1] - lons[0]) * EARTH_RADIUS * jnp.cos(y)
    return deriv / dx[:, None]
