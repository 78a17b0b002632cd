"""Parity tests: ops.interp vs scipy.ndimage.map_coordinates, including the
reference's exact usage pattern (/root/reference/LCS/tools.py:11-48)."""
import numpy as np
import pytest
import jax.numpy as jnp
from scipy.ndimage import map_coordinates, spline_filter1d

from lagrangiancoherence_tpu.ops import interp as I


RNG = np.random.default_rng(42)


@pytest.mark.parametrize("order", [2, 3, 4, 5])
def test_spline_filter_matrix_matches_scipy(order):
    for n in (9, 32, 181):
        M = I.spline_filter_matrix(n, order=order)
        ref = spline_filter1d(np.eye(n), order=order, mode="wrap", axis=0)
        np.testing.assert_allclose(M, ref, atol=1e-11)


def test_prefilter_2d_matches_scipy():
    x = RNG.normal(size=(19, 37))
    c = np.asarray(I.prefilter(jnp.asarray(x), order=3))
    ref = spline_filter1d(x, order=3, mode="wrap", axis=0)
    ref = spline_filter1d(ref, order=3, mode="wrap", axis=1)
    np.testing.assert_allclose(c, ref, atol=1e-10)


def test_prefilter_f32_vs_f64():
    """f32 prefilter (the device serving dtype) stays within f32-roundoff
    class of the f64 product — pins the serving path's coefficient
    accuracy regardless of the implementation behind `prefilter`."""
    x = RNG.normal(size=(3, 128, 256))
    ref64 = np.asarray(I.prefilter(jnp.asarray(x), order=3))
    got = np.asarray(I.prefilter(jnp.asarray(x, np.float32), order=3))
    scale = np.abs(ref64).max()
    assert np.abs(got - ref64).max() / scale < 2e-6


@pytest.mark.parametrize("order", [0, 1, 2, 3, 4, 5])
def test_eval_wrap_matches_scipy(order):
    ny, nx = 23, 41
    f = RNG.normal(size=(ny, nx))
    # queries spanning in-range, negative, beyond-range, exact edges
    ys = np.concatenate([RNG.uniform(-5, ny + 5, 500),
                         [0.0, ny - 1.0, float(ny), -1.0, -(ny - 1.0)]])
    xs = np.concatenate([RNG.uniform(-5, nx + 5, 500),
                         [0.0, nx - 1.0, float(nx), -1.0, -(nx - 1.0)]])
    ref = map_coordinates(f, np.array([ys, xs]), order=order, mode="wrap")
    c = I.prefilter(jnp.asarray(f), order=order)
    got = np.asarray(I.eval_spline_wrap(c, jnp.asarray(ys), jnp.asarray(xs),
                                        order=order))
    np.testing.assert_allclose(got, ref, atol=1e-9)


def test_eval_linear_constant_matches_scipy():
    ny, nx = 17, 29
    f = RNG.normal(size=(ny, nx))
    ys = np.concatenate([RNG.uniform(-3, ny + 3, 400), [0.0, ny - 1.0, -0.0001]])
    xs = np.concatenate([RNG.uniform(-3, nx + 3, 400), [nx - 1.0, 0.0, nx - 0.999]])
    ref = map_coordinates(f, np.array([ys, xs]), order=1, mode="constant")
    got = np.asarray(I.eval_linear_constant(jnp.asarray(f), jnp.asarray(ys),
                                            jnp.asarray(xs)))
    np.testing.assert_allclose(got, ref, atol=1e-12)


def _xr_map_coordinates_oracle(values, lats, lons, px, py, order):
    """Faithful numpy re-implementation of the reference's xr_map_coordinates
    (/root/reference/LCS/tools.py:11-48) for the isglobal=True path."""
    ny, nx = values.shape
    new_x = nx * (px - lons.min()) / (lons.max() - lons.min())
    new_y = ny * (py - lats.min()) / (lats.max() - lats.min())
    out = np.empty_like(values, dtype=float)
    interior = np.arange(order, ny - order)
    out[interior, :] = map_coordinates(
        values, np.array([new_y[interior, :].ravel(), new_x[interior, :].ravel()]),
        order=order, mode="wrap").reshape(len(interior), nx)
    pole_idxs = np.hstack([np.arange(0, order), np.arange(ny - order, ny)])
    out[pole_idxs, :] = map_coordinates(
        values, np.array([new_y[pole_idxs, :].ravel(), new_x[pole_idxs, :].ravel()]),
        order=1, mode="constant").reshape(len(pole_idxs), nx)
    return out


@pytest.mark.parametrize("order", [0, 1, 2, 3])
def test_interp_at_parcels_matches_reference_contract(order):
    ny, nx = 31, 45
    lats = np.linspace(-88, 88, ny)
    lons = np.linspace(-180, 176, nx)
    f = RNG.normal(size=(ny, nx))
    # parcel positions: grid plus random displacement, clamped like trajectory.py
    px0, py0 = np.meshgrid(lons, lats)
    px = px0 + RNG.uniform(-10, 10, size=(ny, nx))
    py = np.clip(py0 + RNG.uniform(-10, 10, size=(ny, nx)), lats.min(), lats.max())
    px = np.where(px <= -180, px % 180, px)
    px = np.where(px >= 180, -180 + (px % 180), px)

    ref = _xr_map_coordinates_oracle(f, lats, lons, px, py, order)
    c = I.prefilter(jnp.asarray(f), order=order)
    got = np.asarray(I.interp_at_parcels(
        jnp.asarray(f), c, jnp.asarray(px), jnp.asarray(py),
        x_min=lons.min(), x_max=lons.max(), y_min=lats.min(), y_max=lats.max(),
        order=order))
    np.testing.assert_allclose(got, ref, atol=1e-9)


@pytest.mark.parametrize("order", [0, 2, 4, 5])
def test_interp_multi_new_orders_match_single(order):
    """interp_at_parcels_multi covers the full scipy order surface 0-5
    (the reference passes interp_order straight to scipy,
    /root/reference/LCS/tools.py:28)."""
    ny, nx = 25, 33
    lats = np.linspace(-88, 88, ny)
    lons = np.linspace(-180, 170, nx)
    f = RNG.normal(size=(3, ny, nx))
    px = np.broadcast_to(lons, (ny, nx)) + RNG.normal(size=(ny, nx)) * 8
    py = np.clip(np.broadcast_to(lats[:, None], (ny, nx))
                 + RNG.normal(size=(ny, nx)) * 5, -88, 88)
    bounds = dict(y_min=lats[0], y_max=lats[-1], x_min=lons[0],
                  x_max=lons[-1])
    c = I.prefilter(jnp.asarray(f), order=order)
    got = np.asarray(I.interp_at_parcels_multi(
        jnp.asarray(f), c, jnp.asarray(px), jnp.asarray(py), order=order,
        **bounds))
    for k in range(3):
        want = np.asarray(I.interp_at_parcels(
            jnp.asarray(f[k]), c[k], jnp.asarray(px), jnp.asarray(py),
            order=order, **bounds))
        np.testing.assert_allclose(got[k], want, atol=1e-11)
        want_oracle = _xr_map_coordinates_oracle(f[k], lats, lons, px, py,
                                                 order)
        np.testing.assert_allclose(got[k], want_oracle, atol=1e-9)
