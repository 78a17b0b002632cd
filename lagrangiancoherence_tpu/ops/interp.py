"""Spline interpolation of gridded fields at arbitrary parcel positions.

Re-implements the numerical contract of ``scipy.ndimage.map_coordinates`` as used
by the reference's hot inner kernel ``xr_map_coordinates``
(/root/reference/LCS/tools.py:11-48):

* index scaling ``size * (p - min) / (max - min)`` — the reference's N/(N-1)
  stretch, SURVEY.md quirk Q4 (/root/reference/LCS/tools.py:21-22);
* spline order ``interp_order`` with ``mode='wrap'`` for rows away from the poles
  (/root/reference/LCS/tools.py:24-30) — the reference passes the order
  straight to scipy, so the full scipy surface (orders 0-5) is supported
  here (default 3, the reference's LCS/LCS.py:51);
* order-1 ``mode='constant'`` (cval=0) for the ``order`` rows nearest each pole
  (/root/reference/LCS/tools.py:31-39).

scipy semantics were reverse-engineered empirically and are reproduced exactly:

* **coordinate fold** for ``wrap``: periodic with period ``n-1``; negative
  coordinates use ``x + (n-1) * (floor(-x/(n-1)) + 1)``, coordinates above
  ``n-1`` use ``x - (n-1) * floor(x/(n-1))``; in-range coordinates (including
  exactly ``n-1``) are untouched;
* **cubic prefilter** for ``mode='wrap'``: the solve of a plain tridiagonal
  system with boundary rows ``(4*c0 + 2*c1)/6 = x0`` (verified to machine
  precision against ``scipy.ndimage.spline_filter1d``).  The inverse is
  precomputed once per grid size on the host and applied as a dense matmul
  instead of scipy's sequential IIR recursion;
* **evaluation taps** (4 per axis for order 3) are mirror-folded about the edge
  samples: ``idx < 0 -> -idx``, ``idx > n-1 -> 2*(n-1) - idx``.

All evaluation functions are shape-polymorphic in the query arrays and safe to
``jit``/``vmap``/``shard_map``.
"""
from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "spline_filter_matrix",
    "prefilter",
    "eval_spline_wrap",
    "eval_linear_constant",
    "interp_at_parcels",
    "interp_at_parcels_multi",
]


# ---------------------------------------------------------------------------
# Cubic B-spline prefilter as a dense matrix (host-side, cached)
# ---------------------------------------------------------------------------

def _bspline_int_samples(order: int) -> np.ndarray:
    """Centered cardinal B-spline of degree ``order`` sampled at the
    integers ``-(order//2) .. order//2`` (the prefilter system's band):
    order 2 → [1, 6, 1]/8; order 3 → [1, 4, 1]/6; order 4 →
    [1, 76, 230, 76, 1]/384; order 5 → [1, 26, 66, 26, 1]/120."""
    from math import comb, factorial
    half = order // 2
    ks = np.arange(-half, half + 1, dtype=np.float64)
    k1 = order + 1
    tt = ks[:, None] + k1 / 2.0 - np.arange(k1 + 1)[None, :]
    signs = (-1.0) ** np.arange(k1 + 1)
    w = (signs[None, :] * comb_vec(k1) * np.maximum(tt, 0.0) ** order)
    return w.sum(axis=1) / factorial(order)


@lru_cache(maxsize=8)
def comb_vec(k1: int) -> np.ndarray:
    from math import comb
    return np.array([comb(k1, j) for j in range(k1 + 1)], dtype=np.float64)


@lru_cache(maxsize=64)
def spline_filter_matrix(n: int, order: int = 3) -> np.ndarray:
    """Dense inverse of scipy's ``mode='wrap'`` prefilter system.

    ``c = M @ x`` reproduces ``scipy.ndimage.spline_filter1d(x, order,
    mode='wrap')`` to machine precision for orders 2-5 (orders 0/1 need no
    prefilter).  The forward system is banded — row ``i`` sums the
    B-spline's integer samples over taps ``i+k`` with out-of-range taps
    MIRRORED about the edge samples (scipy's wrap prefilter uses mirror
    boundaries; verified empirically, see tests/test_interp.py).  The
    order-3 band is [1, 4, 1]/6 with boundary rows ``(4 c0 + 2 c1)/6``.
    The inverse is precomputed once per grid size on the host and applied
    as a dense matmul instead of scipy's sequential IIR recursion.
    """
    if order in (0, 1):
        return np.eye(n)
    if order not in (2, 3, 4, 5):
        raise NotImplementedError(
            f"spline order {order} not supported (scipy surface is 0-5)")
    if n < 2:
        return np.eye(n)
    w = _bspline_int_samples(order)
    half = order // 2
    T = np.zeros((n, n), dtype=np.float64)
    for i in range(n):
        for k, wk in zip(range(-half, half + 1), w):
            j = i + k
            if j < 0:
                j = -j
            if j > n - 1:
                j = 2 * (n - 1) - j
            T[i, j] += wk
    return np.linalg.inv(T)


def prefilter(field: jax.Array, order: int = 3) -> jax.Array:
    """Separable 2-D spline prefilter over the trailing (lat, lon) axes.

    Equivalent to scipy's per-axis ``spline_filter1d(mode='wrap')`` but
    expressed as two dense matmuls.  Leading axes (e.g. time) are batched.
    ``Precision.HIGHEST`` keeps the products in true float32 on GPUs (the
    default may use TF32, about three decimal digits).  The inverse's
    interior rows are Toeplitz with an exponentially decaying band, so an
    O(n) banded form (a (2K+1)-tap convolution plus dense edge rows) is the
    alternative to measure against these products.
    """
    if order in (0, 1):
        return field
    ny, nx = field.shape[-2], field.shape[-1]
    my = jnp.asarray(spline_filter_matrix(ny, order), dtype=field.dtype)
    mx = jnp.asarray(spline_filter_matrix(nx, order), dtype=field.dtype)
    prec = jax.lax.Precision.HIGHEST
    c = jnp.einsum("ij,...jk->...ik", my, field, precision=prec)
    c = jnp.einsum("...ij,kj->...ik", c, mx, precision=prec)
    return c


# ---------------------------------------------------------------------------
# Coordinate folding and tap mirroring (scipy C semantics)
# ---------------------------------------------------------------------------

def _fold_coord_wrap(x: jax.Array, n: int) -> jax.Array:
    """scipy map_coordinate() for mode='wrap': period ``n-1`` fold."""
    sz = float(n - 1)
    neg = x + sz * (jnp.floor(-x / sz) + 1.0)
    pos = x - sz * jnp.floor(x / sz)
    return jnp.where(x < 0, neg, jnp.where(x > sz, pos, x))


def _mirror_tap(idx: jax.Array, n: int) -> jax.Array:
    """Mirror out-of-range integer tap indices about the edge samples."""
    idx = jnp.where(idx < 0, -idx, idx)
    idx = jnp.where(idx > n - 1, 2 * (n - 1) - idx, idx)
    return idx


def _cubic_weights(t: jax.Array) -> tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """Cubic B-spline weights for taps at offsets (-1, 0, 1, 2) from floor(x)."""
    one_t = 1.0 - t
    w0 = one_t * one_t * one_t / 6.0
    w1 = 2.0 / 3.0 - t * t + 0.5 * t * t * t
    w2 = 2.0 / 3.0 - one_t * one_t + 0.5 * one_t * one_t * one_t
    w3 = t * t * t / 6.0
    return w0, w1, w2, w3


def _bspline_weight(order: int, s: jax.Array) -> jax.Array:
    """Centered cardinal B-spline of degree ``order`` at tap-relative
    coordinate ``s = t - k`` — the truncated-power expansion, branch-free
    under jit (orders 2/4/5; orders 0/1/3 use the dedicated fast paths)."""
    from math import comb, factorial
    k1 = order + 1
    acc = jnp.zeros_like(s)
    for j in range(k1 + 1):
        term = jnp.maximum(s + k1 / 2.0 - j, 0.0) ** order
        acc = acc + ((-1.0) ** j * comb(k1, j)) * term
    return acc / factorial(order)


def _axis_taps(f: jax.Array, n: int, order: int):
    """Per-axis tap indices and weights for ``mode='wrap'``-folded
    fractional indices ``f``.

    scipy tap anchoring (verified empirically, tests/test_interp.py):
    even orders anchor at ``floor(f + 0.5)`` (taps -order/2..order/2),
    odd orders at ``floor(f)`` (taps -(order//2)..order//2+1).  Order 0 is
    a single unit-weight tap at the rounded index.
    """
    if order == 0:
        i0 = jnp.floor(f + 0.5).astype(jnp.int32)
        return [_mirror_tap(i0, n)], [jnp.ones_like(f)]
    if order == 1:
        i0 = jnp.floor(f)
        t = f - i0
        i0 = i0.astype(jnp.int32)
        return ([_mirror_tap(i0, n), _mirror_tap(i0 + 1, n)],
                [1.0 - t, t])
    if order == 3:
        i0 = jnp.floor(f)
        t = f - i0
        i0 = i0.astype(jnp.int32)
        return ([_mirror_tap(i0 + k, n) for k in (-1, 0, 1, 2)],
                list(_cubic_weights(t)))
    if order % 2 == 0:
        i0 = jnp.floor(f + 0.5)
        offs = range(-(order // 2), order // 2 + 1)
    else:
        i0 = jnp.floor(f)
        offs = range(-(order // 2), order // 2 + 2)
    t = f - i0
    i0 = i0.astype(jnp.int32)
    return ([_mirror_tap(i0 + k, n) for k in offs],
            [_bspline_weight(order, t - k) for k in offs])


# ---------------------------------------------------------------------------
# Evaluation kernels
# ---------------------------------------------------------------------------

def eval_spline_wrap(coeffs: jax.Array, ys: jax.Array, xs: jax.Array,
                     order: int = 3) -> jax.Array:
    """Evaluate a (prefiltered, for order 3) field at fractional grid indices
    ``(ys, xs)`` with scipy ``mode='wrap'`` semantics on both axes.

    ``coeffs``: (ny, nx).  ``ys``/``xs``: any broadcast-equal shape.
    """
    ny, nx = coeffs.shape
    yf = _fold_coord_wrap(ys, ny)
    xf = _fold_coord_wrap(xs, nx)
    yi_l, wy_l = _axis_taps(yf, ny, order)
    xi_l, wx_l = _axis_taps(xf, nx, order)
    yi = jnp.stack(yi_l, axis=-1)
    xi = jnp.stack(xi_l, axis=-1)
    wy = jnp.stack(wy_l, axis=-1)
    wx = jnp.stack(wx_l, axis=-1)
    ntaps = len(yi_l)

    # Gather the ntaps x ntaps neighbourhood per query point in one flat gather.
    flat = coeffs.reshape(-1)
    lin = (yi[..., :, None] * nx + xi[..., None, :]).reshape(*ys.shape, ntaps * ntaps)
    vals = jnp.take(flat, lin, axis=0)
    w = (wy[..., :, None] * wx[..., None, :]).reshape(*ys.shape, ntaps * ntaps)
    return jnp.sum(vals * w.astype(vals.dtype), axis=-1)


def eval_linear_constant(field: jax.Array, ys: jax.Array, xs: jax.Array) -> jax.Array:
    """Order-1 interpolation with scipy ``mode='constant'`` (cval=0): any query
    with either coordinate outside ``[0, n-1]`` returns 0
    (/root/reference/LCS/tools.py:35-39 pole handling)."""
    ny, nx = field.shape
    in_range = (ys >= 0) & (ys <= ny - 1) & (xs >= 0) & (xs <= nx - 1)
    y0 = jnp.clip(jnp.floor(ys), 0, ny - 2)
    x0 = jnp.clip(jnp.floor(xs), 0, nx - 2)
    ty = (ys - y0).astype(field.dtype)
    tx = (xs - x0).astype(field.dtype)
    y0i = y0.astype(jnp.int32)
    x0i = x0.astype(jnp.int32)
    flat = field.reshape(-1)
    v00 = jnp.take(flat, y0i * nx + x0i, axis=0)
    v01 = jnp.take(flat, y0i * nx + x0i + 1, axis=0)
    v10 = jnp.take(flat, (y0i + 1) * nx + x0i, axis=0)
    v11 = jnp.take(flat, (y0i + 1) * nx + x0i + 1, axis=0)
    out = (v00 * (1 - ty) * (1 - tx) + v01 * (1 - ty) * tx
           + v10 * ty * (1 - tx) + v11 * ty * tx)
    return jnp.where(in_range, out, jnp.zeros((), dtype=field.dtype))


# ---------------------------------------------------------------------------
# The reference's xr_map_coordinates contract
# ---------------------------------------------------------------------------

def scale_positions(px: jax.Array, py: jax.Array, *, x_min, x_max, y_min, y_max,
                    nx: int, ny: int) -> tuple[jax.Array, jax.Array]:
    """Quirk-Q4 index scaling: ``size * (p - min) / (max - min)``
    (/root/reference/LCS/tools.py:21-22).

    The sub/mul/div chain is fenced with ``optimization_barrier`` so XLA
    compiles the IDENTICAL op sequence in every program that computes it.
    Without the fence, program-specific fusion can move the result by one
    ulp — and a position sitting exactly on a fold/mirror boundary (every
    grid's own last column: ``p == max`` scales to exactly ``n``, which
    wrap-folds to 1.0, the edge of the tap -1 mirror zone,
    /root/reference/LCS/tools.py:21-41) then takes DIFFERENT taps in two
    otherwise-identical programs, a ~1e-2-class value jump.  The scipy
    oracle evaluates the same sub/mul/div order in IEEE double, so the
    fenced chain also pins parity with it."""
    px, py = jax.lax.optimization_barrier((px, py))
    xi = nx * (px - x_min) / (x_max - x_min)
    yi = ny * (py - y_min) / (y_max - y_min)
    return jax.lax.optimization_barrier((xi, yi))


def interp_at_parcels(field: jax.Array, coeffs: jax.Array,
                      px: jax.Array, py: jax.Array, *,
                      x_min, x_max, y_min, y_max, order: int = 3,
                      row_offset=0, home_rows=None) -> jax.Array:
    """Full ``xr_map_coordinates(isglobal=True)`` semantics
    (/root/reference/LCS/tools.py:11-48).

    ``field``: raw (ny, nx) values; ``coeffs``: prefiltered coefficients (equal
    to ``field`` when order == 1).  ``px``/``py`` hold parcels whose *home*
    rows are grid rows ``row_offset .. row_offset + px.shape[0]`` — the
    reference keys the pole special-case on the home row, not the current
    position.  ``row_offset`` (traced OK) supports lat-sharded position
    blocks: each shard passes its global starting row.  ``home_rows``
    ((rows, 1) int array) overrides the iota+offset mapping entirely — used
    by the sharded pipeline's mirror-padded shards.
    """
    ny, nx = field.shape
    xi, yi = scale_positions(px, py, x_min=x_min, x_max=x_max,
                             y_min=y_min, y_max=y_max, nx=nx, ny=ny)
    interior = eval_spline_wrap(coeffs, yi, xi, order=order)
    poles = eval_linear_constant(field, yi, xi)
    if home_rows is None:
        row = jax.lax.broadcasted_iota(jnp.int32, px.shape, 0) + row_offset
    else:
        row = jnp.broadcast_to(home_rows, px.shape)
    is_pole_row = (row < order) | (row >= ny - order)
    return jnp.where(is_pole_row, poles, interior)


# ---------------------------------------------------------------------------
# Multi-field evaluation: the SETTLS hot path
# ---------------------------------------------------------------------------
# Each SETTLS iteration evaluates FOUR fields (u, v at two time levels) at
# the SAME parcel positions (/root/reference/LCS/trajectory.py:105-108).
# Evaluating them together shares the entire index/weight computation (fold,
# mirror, spline weights) and issues one gather per tap over a stacked
# (F, ny*nx) operand — an F-fold reduction in kernel count versus calling
# interp_at_parcels per field, which matters for both compile time and
# device-memory traffic.

def _taps_and_weights(ys, xs, ny: int, nx: int, order: int):
    """Shared tap-index/weight computation for ``mode='wrap'`` evaluation."""
    yf = _fold_coord_wrap(ys, ny)
    xf = _fold_coord_wrap(xs, nx)
    yi, wy = _axis_taps(yf, ny, order)
    xi, wx = _axis_taps(xf, nx, order)
    return yi, xi, wy, wx


def interp_at_parcels_multi(fields: jax.Array, coeffs: jax.Array,
                            px: jax.Array, py: jax.Array, *,
                            x_min, x_max, y_min, y_max, order: int = 3,
                            row_offset=0, home_rows=None) -> jax.Array:
    """``interp_at_parcels`` for F stacked fields at shared positions.

    ``fields``/``coeffs``: (F, ny, nx); returns (F,) + px.shape.  Bitwise
    semantics per field match ``interp_at_parcels`` up to floating-point
    summation order (taps accumulate sequentially here).
    """
    nf, ny, nx = fields.shape
    xi_f, yi_f = scale_positions(px, py, x_min=x_min, x_max=x_max,
                                 y_min=y_min, y_max=y_max, nx=nx, ny=ny)
    flat = coeffs.reshape(nf, ny * nx)
    yi, xi, wy, wx = _taps_and_weights(yi_f, xi_f, ny, nx, order)

    interior = jnp.zeros((nf,) + px.shape, dtype=fields.dtype)
    for j in range(len(yi)):
        row_base = yi[j] * nx
        for k in range(len(xi)):
            lin = row_base + xi[k]
            w = (wy[j] * wx[k]).astype(fields.dtype)
            interior = interior + w[None] * jnp.take(flat, lin, axis=1)

    # pole rows: order-1, mode='constant' on the raw fields
    in_range = (yi_f >= 0) & (yi_f <= ny - 1) & (xi_f >= 0) & (xi_f <= nx - 1)
    y0 = jnp.clip(jnp.floor(yi_f), 0, ny - 2)
    x0 = jnp.clip(jnp.floor(xi_f), 0, nx - 2)
    ty = (yi_f - y0).astype(fields.dtype)
    tx = (xi_f - x0).astype(fields.dtype)
    y0i = y0.astype(jnp.int32)
    x0i = x0.astype(jnp.int32)
    raw = fields.reshape(nf, ny * nx)
    base = y0i * nx + x0i
    poles = (jnp.take(raw, base, axis=1) * ((1 - ty) * (1 - tx))[None]
             + jnp.take(raw, base + 1, axis=1) * ((1 - ty) * tx)[None]
             + jnp.take(raw, base + nx, axis=1) * (ty * (1 - tx))[None]
             + jnp.take(raw, base + nx + 1, axis=1) * (ty * tx)[None])
    poles = jnp.where(in_range[None], poles,
                      jnp.zeros((), dtype=fields.dtype))

    if home_rows is None:
        row = jax.lax.broadcasted_iota(jnp.int32, px.shape, 0) + row_offset
    else:
        row = jnp.broadcast_to(home_rows, px.shape)
    is_pole_row = (row < order) | (row >= ny - order)
    return jnp.where(is_pole_row[None], poles, interior)
