"""User-facing API with the reference's call signatures.

``LCS`` reproduces the constructor/call contract of the reference class
(/root/reference/LCS/LCS.py:19-168) and ``parcel_propagation`` that of the
reference integrator entry point (/root/reference/LCS/trajectory.py:8-18),
but everything below the argument parsing is the jitted JAX core: labeled
coordinates stop at this file; the pipeline body is jitted JAX over plain
arrays and the static ``Grid`` struct.

Differences from the reference, by design:

* inputs are ``Field`` objects, xarray DataArrays (duck-typed), dicts/Datasets
  of the two, or a path to an HDF5/netCDF4 file — xarray itself is optional;
* the destructive CLI behaviour (input deletion, SURVEY.md Q8) is not
  replicated;
* quirk Q1 (scrambled deformation tensor) is reproduced by default for
  parity; pass ``compat=False`` to the constructor for the corrected
  Cauchy-Green norm.
"""
from __future__ import annotations

import re

import numpy as np

from .field import Field, as_field
from .grid import Grid
from .models.ftle import ftle_from_departures
from .models.settls import parcel_propagation_core
from .ops.regrid import regrid_linear_nearest
from .ops.sht import truncate as sht_truncate
from .utils.logging import configure_verbosity, logger, timed_stage

__all__ = ["LCS", "parcel_propagation", "flowmap_gradient", "latlonsel",
           "create_arrays_list", "float_dtype"]


def float_dtype() -> np.dtype:
    """The float dtype the library computes in: float64 when JAX's x64
    mode is enabled, float32 otherwise (the accelerator serving dtype)."""
    import jax
    return np.dtype(jax.dtypes.canonicalize_dtype(np.float64))


def create_arrays_list(field, groupdim: str = "points"):
    """Group a stacked Field along ``groupdim`` into a list of per-label
    value arrays — parity shim for the reference's (unused) helper
    (/root/reference/LCS/LCS.py:228-233)."""
    field = as_field(field)
    ax = field.axis(groupdim)
    return [np.take(field.data, i, axis=ax)
            for i in range(field.shape[ax])]

COMMON_GRID_LATS = np.linspace(-89.75, 89.75, 180 * 2)
COMMON_GRID_LONS = np.linspace(-180, 179.5, 360 * 2 + 1)


# ---------------------------------------------------------------------------
# Input normalisation helpers
# ---------------------------------------------------------------------------

def _extract_uv(ds, u, v, timedim: str) -> tuple[Field, Field]:
    """ds/u/v → (u, v) Fields; mirrors /root/reference/LCS/LCS.py:81-87."""
    if ds is not None:
        if isinstance(ds, str):
            from .utils.io import open_dataset
            ds = open_dataset(ds)
        if isinstance(ds, dict):
            u, v = ds["u"], ds["v"]
        elif hasattr(ds, "data_vars"):  # xarray Dataset, duck-typed
            u, v = ds["u"], ds["v"]
        else:
            raise TypeError(f"unsupported ds type {type(ds)}")
    if u is None or v is None:
        raise ValueError("provide either ds= or both u= and v=")
    u = as_field(u)
    v = as_field(v)
    for f in (u, v):
        if set(f.dims) != {"latitude", "longitude", timedim}:
            raise AssertionError(
                f"array dims should be latitude, longitude and {timedim}; "
                f"got {f.dims}")
    order = (timedim, "latitude", "longitude")
    return u.transpose(*order), v.transpose(*order)


_FREQ_UNITS = {"D": "D", "h": "h", "H": "h", "min": "m", "T": "m",
               "s": "s", "S": "s", "ms": "ms", "us": "us", "ns": "ns"}


def _parse_freq(freq: str) -> np.timedelta64:
    """Fixed-length pandas frequency string (``"3h"``, ``"1D"``,
    ``"30min"``, ...) → ``timedelta64``."""
    m = re.fullmatch(r"\s*(\d*)\s*([A-Za-z]+)\s*", freq)
    if m is None or m.group(2) not in _FREQ_UNITS:
        raise ValueError(f"unsupported resample frequency {freq!r}; use a "
                         f"fixed-length one such as '3h', '1D' or '30min'")
    return np.timedelta64(int(m.group(1) or 1), _FREQ_UNITS[m.group(2)])


def _resample_labels(times: np.ndarray, freq: str) -> np.ndarray:
    """Bin labels of pandas ``Series.resample(freq).asfreq()``: multiples of
    ``freq`` counted from the start of the first time's day (pandas'
    default ``origin='start_day'``), from the bin holding ``times[0]`` to
    the bin holding ``times[-1]``."""
    times = np.asarray(times, dtype="datetime64[ns]")
    step = _parse_freq(freq).astype("timedelta64[ns]")
    origin = times[0].astype("datetime64[D]").astype("datetime64[ns]")
    first = (times[0] - origin) // step
    last = (times[-1] - origin) // step
    return origin + np.arange(first, last + 1) * step


def _resample_linear(f: Field, freq: str, timedim: str) -> Field:
    """Linear-in-time resample onto a regular frequency
    (xarray ``resample().interpolate('linear')`` semantics,
    /root/reference/LCS/LCS.py:88-91).

    Bin labels follow pandas ``resample`` (origin = start of day, not
    ``times[0]``), so records that do not start on a bin edge align the
    way the reference's xarray resample does; labels outside the record's
    time span interpolate to NaN, matching scipy ``interp1d`` with
    ``bounds_error=False`` underneath xarray."""
    times = np.asarray(f.coords[timedim], dtype="datetime64[ns]")
    new_times = _resample_labels(times, freq)
    t_src = times.view("int64").astype(np.float64)
    t_dst = new_times.view("int64").astype(np.float64)
    ax = f.axis(timedim)
    data = np.moveaxis(f.data, ax, 0)
    flat = data.reshape(data.shape[0], -1)
    # vectorised interpolation over all grid points at once
    idx = np.clip(np.searchsorted(t_src, t_dst, side="left"), 1, t_src.size - 1)
    t0, t1 = t_src[idx - 1], t_src[idx]
    w = ((t_dst - t0) / np.where(t1 > t0, t1 - t0, 1.0))[:, None]
    out = flat[idx - 1] * (1 - w) + flat[idx] * w
    oob = (t_dst < t_src[0]) | (t_dst > t_src[-1])
    if oob.any():
        out[oob] = np.nan
    data = out.reshape((t_dst.size,) + data.shape[1:])
    data = np.moveaxis(data, 0, ax)
    coords = {**f.coords, timedim: new_times}
    return Field(data=data, dims=f.dims, coords=coords, name=f.name)


def latlonsel(field: Field, latitude=None, longitude=None,
              latname: str = "latitude", lonname: str = "longitude") -> Field:
    """Lat/lon box crop with *strict* inequalities — boundary points are
    dropped, matching the reference's mask (/root/reference/LCS/tools.py:158-187).
    Accepts slices or [min, max] lists."""
    field = as_field(field)

    def bounds(sel):
        if isinstance(sel, slice):
            return sel.start, sel.stop
        return sel[0], sel[-1]

    data = field
    if longitude is not None:
        lon1, lon2 = bounds(longitude)
        c = data.coords[lonname]
        data = data.isel({lonname: np.nonzero((c > lon1) & (c < lon2))[0]})
    if latitude is not None:
        lat1, lat2 = bounds(latitude)
        c = data.coords[latname]
        data = data.isel({latname: np.nonzero((c > lat1) & (c < lat2))[0]})
    return data


# ---------------------------------------------------------------------------
# parcel_propagation — reference signature facade over the scan core
# ---------------------------------------------------------------------------

def parcel_propagation(U, V, timestep: float = 1, propdim: str = "time",
                       verbose: bool = True, return_traj: bool = False,
                       SETTLS_order: int = 0, copy: bool = False,
                       interp_order: int = 3, cyclic_xboundary: bool = False):
    """Two-time-level semi-Lagrangian advection, reference contract
    (/root/reference/LCS/trajectory.py:8-144).

    Returns ``(positions_x, positions_y)`` Fields: final departure points
    stamped with the last (possibly reversed, quirk Q2) time label, or the
    full trajectory stack when ``return_traj=True``.
    """
    configure_verbosity(verbose)
    U = as_field(U).sortby("longitude").sortby("latitude")
    V = as_field(V).sortby("longitude").sortby("latitude")
    order = (propdim, "latitude", "longitude")
    U = U.transpose(*order)
    V = V.transpose(*order)

    lats = U.coords["latitude"]
    lons = U.coords["longitude"]
    grid = Grid(lats=lats, lons=lons, cyclic_x=cyclic_xboundary)

    times = list(U.coords[propdim])
    if timestep < 0:
        times = times[::-1]  # labels reverse; storage order does not (Q2)

    with timed_stage("Parcel propagation"):
        dtype = float_dtype()
        px, py = parcel_propagation_core(
            np.asarray(U.data, dtype=dtype),
            np.asarray(V.data, dtype=dtype),
            float(timestep), grid,
            settls_order=int(SETTLS_order),
            interp_order=int(interp_order),
            return_traj=return_traj,
            # per-step progress lines, as the reference's verboseprint
            # (/root/reference/LCS/trajectory.py:81) — async host callback,
            # gated off with verbose=False to keep the scan callback-free
            progress=bool(verbose))
        px = np.asarray(px)
        py = np.asarray(py)

    coords2d = {"latitude": lats, "longitude": lons}
    if return_traj:
        # 360-day-calendar guard (/root/reference/LCS/trajectory.py:129-130):
        # datetime64 cannot represent cftime.Datetime360Day labels, so
        # trajectories cannot carry them (type-name check — cftime is an
        # optional dependency and may not be installed)
        assert type(times[0]).__name__ != "Datetime360Day", (
            "Cannot return trajectories with time coordinates "
            "cftime.Datetime360Day.")
        tcoord = np.asarray(times, dtype="datetime64[ns]")
        dims = (propdim, "latitude", "longitude")
        fx = Field(px, dims, {**coords2d, propdim: tcoord}, name="positions_x")
        fy = Field(py, dims, {**coords2d, propdim: tcoord}, name="positions_y")
        return fx, fy
    fx = Field(px, ("latitude", "longitude"), dict(coords2d), name="positions_x")
    fy = Field(py, ("latitude", "longitude"), dict(coords2d), name="positions_y")
    fx = fx.assign_coords(**{propdim: times[-1]})
    fy = fy.assign_coords(**{propdim: times[-1]})
    return fx, fy


def flowmap_gradient(x_departure, y_departure, sigma=None) -> Field:
    """Deformation-tensor facade (/root/reference/LCS/LCS.py:171-225):
    returns a Field with a leading ``derivatives`` dim of length 9 in the
    reference's element order."""
    from .models.ftle import flowmap_gradient as _core
    x_departure = as_field(x_departure)
    y_departure = as_field(y_departure)
    lats = x_departure.coords["latitude"]
    lons = x_departure.coords["longitude"]
    grid = Grid(lats=lats, lons=lons)
    tensor = np.asarray(_core(np.asarray(x_departure.data, dtype=np.float64),
                              np.asarray(y_departure.data, dtype=np.float64),
                              grid, sigma=sigma))
    return Field(tensor, ("derivatives", "latitude", "longitude"),
                 {"latitude": lats, "longitude": lons,
                  "derivatives": np.arange(9)},
                 name="def_tensor")


# ---------------------------------------------------------------------------
# LCS — the FTLE pipeline
# ---------------------------------------------------------------------------

class LCS:
    """Finite-Time Lyapunov Exponent pipeline for 2-D wind fields.

    Constructor/call parameters mirror /root/reference/LCS/LCS.py:25-51.
    ``compat`` additionally selects the quirk-Q1-compatible matrix norm
    (default True, see models/ftle.py).
    """

    earth_r = 6371000  # metres

    def __init__(self, timestep: float = 1, timedim: str = "time",
                 SETTLS_order: int = 0, subdomain=None,
                 return_dpts: bool = False, gauss_sigma=None,
                 compat: bool = True):
        self.timestep = timestep
        self.SETTLS_order = SETTLS_order
        self.timedim = timedim
        self.subdomain = subdomain
        self.gauss_sigma = gauss_sigma
        self.return_dpts = return_dpts
        self.compat = compat

    def __call__(self, ds=None, u=None, v=None, verbose: bool = True, s=None,
                 resample=None, s_is_error: bool = False,
                 isglobal: bool = False, return_traj: bool = False,
                 interp_to_common_grid: bool = True,
                 traj_interp_order: int = 3, truncation: int = 20):
        configure_verbosity(verbose)
        timestep = self.timestep
        timedim = self.timedim

        u, v = _extract_uv(ds, u, v, timedim)

        if isinstance(resample, str):
            u = _resample_linear(u, resample, timedim)
            v = _resample_linear(v, resample, timedim)
            tvals = np.asarray(u.coords[timedim], dtype="datetime64[ns]")
            timestep = float(np.sign(timestep)) * float(
                (tvals[1] - tvals[0]) / np.timedelta64(1, "s"))

        u = u.sortby("latitude").sortby("longitude")
        v = v.sortby("latitude").sortby("longitude")

        if isglobal:
            if interp_to_common_grid:
                with timed_stage("Regrid to common global grid"):
                    u = self._to_common_grid(u, timedim)
                    v = self._to_common_grid(v, timedim)
            if truncation is not None:
                with timed_stage(f"Spectral truncation T{truncation}"):
                    lats = u.coords["latitude"]
                    u = u.copy(data=np.asarray(
                        sht_truncate(u.data, lats, truncation)))
                    v = v.copy(data=np.asarray(
                        sht_truncate(v.data, lats, truncation)))
            cyclic_xboundary = True
            self.subdomain = None
        else:
            cyclic_xboundary = False

        if s is None:
            # The reference computes-and-prints an unused smoothing factor
            # (/root/reference/LCS/LCS.py:124-126, SURVEY.md Q7); we log it
            # at debug level and nothing consumes it.
            first = u.isel({timedim: 0})
            s = int(10 * first.data.size * first.std())
            logger.debug("legacy smoothing factor s = %s (unused)", s)

        x_departure, y_departure = parcel_propagation(
            u, v, timestep, propdim=timedim, verbose=verbose,
            SETTLS_order=self.SETTLS_order,
            cyclic_xboundary=cyclic_xboundary, return_traj=return_traj,
            interp_order=traj_interp_order, copy=True)

        if return_traj:
            x_trajs, y_trajs = x_departure, y_departure
            x_departure = x_trajs.isel({timedim: -1})
            y_departure = y_trajs.isel({timedim: -1})

        with timed_stage("Deformation tensor + eigenvalues"):
            lats = x_departure.coords["latitude"]
            lons = x_departure.coords["longitude"]
            grid = Grid(lats=lats, lons=lons)
            norm = np.asarray(ftle_from_departures(
                np.asarray(x_departure.data, dtype=np.float64),
                np.asarray(y_departure.data, dtype=np.float64),
                grid, sigma=self.gauss_sigma, compat=self.compat))

        times = u.coords[timedim]
        timestamp = times[-1] if np.sign(timestep) == 1 else times[0]
        eigenvalues = Field(
            norm, ("latitude", "longitude"),
            {"latitude": lats, "longitude": lons}, name="ftle")
        if isinstance(self.subdomain, dict):
            # The reference computes the gradient on the FULL field and crops
            # the tensor afterwards (/root/reference/LCS/LCS.py:142-144), so
            # subdomain-interior points keep centred stencils fed by data
            # outside the crop.  The norm is pointwise, so cropping the norm
            # here is exactly equivalent to cropping the tensor there.
            # Departure points are returned uncropped, as in the reference.
            eigenvalues = latlonsel(eigenvalues, **self.subdomain)
        eigenvalues = eigenvalues.expand_dims(timedim, coord=timestamp)

        if self.return_dpts and return_traj:
            return eigenvalues, x_departure, y_departure, x_trajs, y_trajs
        elif self.return_dpts:
            return eigenvalues, x_departure, y_departure
        elif return_traj:
            return eigenvalues, x_trajs, y_trajs
        return eigenvalues

    @staticmethod
    def _to_common_grid(f: Field, timedim: str) -> Field:
        data = np.asarray(regrid_linear_nearest(
            f.data, f.coords["latitude"], f.coords["longitude"],
            COMMON_GRID_LATS, COMMON_GRID_LONS))
        return Field(data, (timedim, "latitude", "longitude"),
                     {timedim: f.coords[timedim],
                      "latitude": COMMON_GRID_LATS,
                      "longitude": COMMON_GRID_LONS},
                     name=f.name)
