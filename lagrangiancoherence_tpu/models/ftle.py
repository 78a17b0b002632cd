"""Flow-map deformation gradient and FTLE norm — one fused jitted stage.

Re-designs /root/reference/LCS/LCS.py:142-157,171-225: instead of xarray
merge/stack/dropna plus a per-point LAPACK SVD (``scipy.linalg.norm(ord=2)``),
the deformation tensor and the largest singular value are computed in closed
form, fully vectorised, in one jitted function XLA fuses end-to-end.

Two modes:

* ``compat=True`` (default) reproduces quirk Q1: the reference reshapes its
  9-element derivative stack row-major to [3,3], producing the *scrambled*
  matrix ``[[dXdx,dXdy,dYdx],[dYdy,dZdx,dZdy],[0,0,0]]``
  (/root/reference/LCS/LCS.py:152-154, SURVEY.md Q1).  Its largest singular
  value equals sqrt(lambda_max(A A^T)) for the 2x3 top block A — a 2x2
  symmetric eigenproblem solved by the quadratic formula, no LAPACK.
* ``compat=False`` computes the textbook Cauchy-Green norm from the true
  Jacobian ``F = [[dXdx,dXdy],[dYdx,dYdy],[dZdx,dZdy]]``.

NaN handling replicates the stack/dropna/unstack round-trip
(/root/reference/LCS/LCS.py:145-157): any point with a NaN in its tensor
stays NaN in the output; all other points are unaffected (the norm is
pointwise independent).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..grid import EARTH_RADIUS, Grid
from ..ops.filters import gaussian_filter
from ..ops.stencil import derivative_spherical_coords

__all__ = ["flowmap_gradient", "ftle_norm", "ftle_from_departures"]


def flowmap_gradient(x_dep: jax.Array, y_dep: jax.Array, grid: Grid,
                     sigma=None) -> jax.Array:
    """Departure lon/lat -> 9-component deformation stack
    (/root/reference/LCS/LCS.py:171-225).

    Returns (9, ny, nx) in the reference's element order
    [dXdx, dXdy, dYdx, dYdy, dZdx, dZdy, 0, 0, 0].
    """
    if sigma is not None:
        x_dep = gaussian_filter(x_dep, sigma=sigma)
        y_dep = gaussian_filter(y_dep, sigma=sigma)
    lon = x_dep * (np.pi / 180.0)
    colat = (y_dep - 90.0) * (np.pi / 180.0)  # colatitude (LCS.py:196)
    sin_colat = jnp.sin(colat)
    X = EARTH_RADIUS * sin_colat * jnp.cos(lon)
    Y = EARTH_RADIUS * sin_colat * jnp.sin(lon)
    Z = EARTH_RADIUS * jnp.cos(colat)

    def d(f, dim):
        return derivative_spherical_coords(f, grid.lats, grid.lons, dim=dim)

    zero = jnp.zeros_like(X)
    return jnp.stack([d(X, 1), d(X, 0), d(Y, 1), d(Y, 0), d(Z, 1), d(Z, 0),
                      zero, zero, zero])


def _sigma_max_2xk(rows) -> jax.Array:
    """Largest singular value of a 2xK matrix given its two rows (each a list
    of equal-shaped arrays), via the closed-form 2x2 Gram eigenvalue."""
    r0, r1 = rows
    g11 = sum(a * a for a in r0)
    g22 = sum(a * a for a in r1)
    g12 = sum(a * b for a, b in zip(r0, r1))
    tr = g11 + g22
    disc = jnp.sqrt(jnp.maximum((g11 - g22) ** 2 + 4.0 * g12 * g12, 0.0))
    lam_max = 0.5 * (tr + disc)
    return jnp.sqrt(jnp.maximum(lam_max, 0.0))


def ftle_norm(def_tensor: jax.Array, compat: bool = True) -> jax.Array:
    """Per-point matrix 2-norm of the deformation stack (9, ny, nx).

    compat=True: quirk-Q1 scrambled [3,3] reshape (LCS.py:152-154) — the
    effective matrix rows are (t0,t1,t2) and (t3,t4,t5) with a zero third row.
    compat=False: corrected Jacobian columns (d/dx, d/dy) of (X, Y, Z).
    """
    t = def_tensor
    if compat:
        rows = ([t[0], t[1], t[2]], [t[3], t[4], t[5]])
    else:
        # F^T F with F columns (dX/dx,dY/dx,dZ/dx) and (dX/dy,dY/dy,dZ/dy)
        rows = ([t[0], t[2], t[4]], [t[1], t[3], t[5]])
    out = _sigma_max_2xk(rows)
    bad = jnp.any(jnp.isnan(def_tensor), axis=0)
    return jnp.where(bad, jnp.nan, out)


@partial(jax.jit, static_argnames=("grid", "compat"))
def ftle_from_departures(x_dep: jax.Array, y_dep: jax.Array, grid: Grid,
                         sigma=None, compat: bool = True) -> jax.Array:
    """Fused departure-points -> FTLE-norm field (ny, nx)."""
    tensor = flowmap_gradient(x_dep, y_dep, grid, sigma=sigma)
    return ftle_norm(tensor, compat=compat)
