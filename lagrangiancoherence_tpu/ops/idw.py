"""Haversine distance + inverse-distance-weighted scattered interpolation.

Re-design of the reference's numba kernels
(/root/reference/LCS/tools.py:271-299): the O(N*M) double loop becomes one
broadcast distance matrix + two matmul-shaped reductions — dense, regular
compute that XLA maps onto the device's matrix units.  ``idw_regrid`` replaces the xarray wrapper
``xr_idx_interp`` (/root/reference/LCS/tools.py:302-333).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["haversine", "idw_interpolate", "idw_regrid"]

EQUATOR_RADIUS_KM = 6378.1  # the reference uses the equatorial radius here
# (/root/reference/LCS/tools.py:274), unlike the mean radius elsewhere


def haversine(lon1, lat1, lon2, lat2):
    """Great-circle distance in km (broadcasting over all arguments).

    Matches the reference formula (/root/reference/LCS/tools.py:271-281),
    including its use of ``arctan(sqrt(a), sqrt(1-a))`` — numpy's two-arg
    ``arctan`` form, which evaluates ``arctan(sqrt(a))`` with an out= of
    ``sqrt(1-a)`` and therefore behaves as plain ``arctan(sqrt(a))`` for
    the returned value; we reproduce ``2*arctan(sqrt(a))`` accordingly.
    """
    rad = jnp.pi / 180.0
    dlon = (lon2 - lon1) * rad
    dlat = (lat2 - lat1) * rad
    a = jnp.sin(dlat / 2.0) ** 2 + jnp.cos(lat1 * rad) * jnp.cos(lat2 * rad) \
        * jnp.sin(dlon / 2.0) ** 2
    c = 2.0 * jnp.arctan(jnp.sqrt(jnp.clip(a, 0.0, 1.0)))
    return EQUATOR_RADIUS_KM * c


@jax.jit
def idw_interpolate(x, y, z, xi, yi, power: float = 2.0):
    """Inverse-distance-weighted interpolation of scattered samples
    ``(x, y, z)`` onto query points ``(xi, yi)``
    (/root/reference/LCS/tools.py:284-299).

    Computes the full (n_query, n_sample) haversine matrix in one shot.
    """
    x = jnp.asarray(x); y = jnp.asarray(y); z = jnp.asarray(z)
    xi = jnp.asarray(xi); yi = jnp.asarray(yi)
    d = haversine(x[None, :], y[None, :], xi[:, None], yi[:, None])
    w = 1.0 / jnp.power(d, power)
    # HIGHEST: a float32 product may otherwise run in TF32 on GPUs
    wz = jnp.matmul(w, z, precision=jax.lax.Precision.HIGHEST)
    return wz / jnp.sum(w, axis=1)


def idw_regrid(sample_lons, sample_lats, sample_vals, lons, lats,
               power: float = 2.0):
    """Regrid scattered samples onto a regular (lats, lons) mesh — the
    ``xr_idx_interp`` contract (/root/reference/LCS/tools.py:302-333) without
    the xarray wrapper.  Returns an (n_lat, n_lon) array."""
    LON, LAT = np.meshgrid(np.asarray(lons), np.asarray(lats))
    out = idw_interpolate(sample_lons, sample_lats, sample_vals,
                          LON.ravel(), LAT.ravel(), power=power)
    return np.asarray(out).reshape(LAT.shape)
