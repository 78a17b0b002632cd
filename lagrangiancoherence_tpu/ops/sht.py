"""Triangular spherical-harmonic truncation as dense linear algebra.

Functional replacement for the reference's use of
``windspharm.xarray.VectorWind.truncate(..., truncation=20)``
(/root/reference/LCS/LCS.py:115-118), which low-pass filters the wind
components to total wavenumber <= T before global FTLE runs.

windspharm delegates to spharm's Fortran grid<->spectral transforms.  This
design instead expresses the whole round-trip as dense linear algebra that
the device's matrix units run:

* longitude -> zonal wavenumbers via ``jnp.fft.rfft`` (XLA-native FFT);
* per zonal wavenumber ``m <= T``, the latitude profile is least-squares
  projected onto the normalised associated Legendre basis
  ``P_n^m(sin(lat))`` for ``n = m..T`` and immediately re-synthesised.  The
  combined project+synthesise operator ``S_m = P_m @ pinv(P_m)`` is a small
  ``(ny, ny)`` matrix precomputed on the host once per (grid, T) and applied
  as one batched matmul over all retained ``m``;
* wavenumbers ``m > T`` are zeroed; inverse rfft returns to grid space.

Least-squares projection is the right analysis operator for the reference's
*regular* (non-Gaussian) 0.5-degree grid, where no exact quadrature exists —
the same choice spharm's regular-grid mode makes internally.

Equivalence to the spharm pipeline (windspharm analyses onto the FULL basis
n = m..nlat-1, zeroes n > T, then synthesises — a different operator
composition): for any field whose latitudinal spectrum is resolved by the
grid, a consistent least-squares analysis recovers the exact coefficients
independent of quadrature weighting, so analysis-then-zero coincides with
the direct span projection used here.  The two can differ only in how
unresolved (near/above-Nyquist) latitudinal content is folded — O(quadrature
residual), machine-zero for modes with n <= ny-1-T under the interpolatory
weights.  Verified cross-implementation in
tests/test_sht.py::TestFullAnalysisOracle against a scipy-built
analysis-zero-synthesis oracle on the reference's common grid (spharm
itself is not installable in this environment; that oracle is the
committed ground-truth artifact).
"""
from __future__ import annotations

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["legendre_basis", "truncation_operators", "truncate"]


def _normalized_legendre(nmax: int, m: int, x: np.ndarray) -> np.ndarray:
    """Orthonormal associated Legendre functions ``\\bar P_n^m(x)`` for
    ``n = m..nmax`` evaluated at ``x = sin(lat)``, via the standard stable
    three-term recursion (fully normalised, geodesy convention)."""
    x = np.asarray(x, dtype=np.float64)
    npts = x.shape[0]
    out = np.zeros((nmax - m + 1, npts))
    # P_m^m seed: \bar P_m^m = sqrt((2m+1)/(4pi) * (2m-1)!!/(2m)!!) (1-x^2)^{m/2}
    # Build the double-factorial ratio in log space for stability.
    log_ratio = 0.0
    for k in range(1, m + 1):
        log_ratio += np.log((2 * k - 1) / (2 * k))
    pmm = np.sqrt((2 * m + 1) / (4 * np.pi) * np.exp(log_ratio)) \
        * (1.0 - x * x) ** (m / 2.0)
    if m % 2 == 1:
        pmm = -pmm  # Condon-Shortley phase
    out[0] = pmm
    if nmax == m:
        return out
    # P_{m+1}^m
    out[1] = x * np.sqrt(2 * m + 3.0) * pmm
    for n in range(m + 2, nmax + 1):
        a = np.sqrt((4.0 * n * n - 1.0) / (n * n - m * m))
        b = np.sqrt(((n - 1.0) ** 2 - m * m) / (4.0 * (n - 1.0) ** 2 - 1.0))
        out[n - m] = a * (x * out[n - m - 1] - b * out[n - m - 2])
    return out


def _interpolatory_weights(x: np.ndarray) -> np.ndarray:
    """Interpolatory quadrature weights on the nodes ``x`` in (-1, 1):
    the unique weights integrating every polynomial of degree <= ny-1
    exactly (solved in the orthonormal Legendre basis for conditioning —
    the nodes x = sin(equispaced lat) follow the Chebyshev density, so the
    Vandermonde is well-conditioned and the weights stay positive).

    Why this instead of plain cos(lat) Riemann weights: products
    ``\\bar P_n^m \\bar P_k^m`` are polynomials of degree n+k, so exact
    polynomial quadrature makes the LSQ projector *annihilate* every
    out-of-span mode with n+k <= ny-1 analytically, where the Riemann sum
    only reaches O(dlat^2) (~1e-4 on the 0.5-degree grid)."""
    ny = x.shape[0]
    V = _normalized_legendre(ny - 1, 0, x)          # (ny modes, ny nodes)
    mu = np.zeros(ny)
    mu[0] = 2.0 * np.sqrt(1.0 / (4.0 * np.pi))      # int of \bar P_0^0 on [-1,1]
    return np.linalg.solve(V, mu)


@lru_cache(maxsize=16)
def legendre_basis(lats_key: bytes, truncation: int) -> np.ndarray:
    """Stacked smoothing operators ``S[m] = P_m (P_m^T W P_m)^{-1} P_m^T W``,
    shape ``(truncation+1, ny, ny)``; cached per (latitude vector, T).

    The projection is least squares under exact interpolatory quadrature
    weights (see :func:`_interpolatory_weights`): modes with n <= T pass
    through unchanged (projection identity on its own span) and modes with
    T < n <= ny-1-T are annihilated to machine precision."""
    lats = np.frombuffer(lats_key, dtype=np.float64)
    x = np.sin(np.deg2rad(lats))
    w = _interpolatory_weights(x)
    ny = lats.shape[0]
    S = np.zeros((truncation + 1, ny, ny))
    for m in range(truncation + 1):
        P = _normalized_legendre(truncation, m, x).T  # (ny, n_modes)
        PtW = P.T * w[None, :]
        S[m] = P @ np.linalg.solve(PtW @ P, PtW)
    return S


def truncation_operators(lats: np.ndarray, truncation: int) -> np.ndarray:
    lats = np.ascontiguousarray(np.asarray(lats, dtype=np.float64))
    return legendre_basis(lats.tobytes(), truncation)


@partial(jax.jit, static_argnames=("truncation",))
def _truncate_jit(field: jax.Array, S: jax.Array, truncation: int) -> jax.Array:
    nx = field.shape[-1]
    spec = jnp.fft.rfft(field, axis=-1)  # (..., ny, nx//2+1)
    keep = spec[..., : truncation + 1]   # zonal wavenumbers m <= T
    # batched matmul over m: out[..., y, m] = S[m] @ keep[..., :, m]
    # HIGHEST: a float32 product may otherwise run in TF32 on GPUs
    smoothed = jnp.einsum("myz,...zm->...ym", S.astype(keep.dtype), keep,
                          precision=jax.lax.Precision.HIGHEST)
    out_spec = jnp.zeros_like(spec)
    out_spec = out_spec.at[..., : truncation + 1].set(smoothed)
    return jnp.fft.irfft(out_spec, n=nx, axis=-1).astype(field.dtype)


def truncate(field: jax.Array, lats: np.ndarray, truncation: int = 20) -> jax.Array:
    """Triangular truncation of ``field`` (..., ny, nx) to total wavenumber
    <= ``truncation`` on a regular lat/lon grid."""
    S = jnp.asarray(truncation_operators(lats, truncation))
    return _truncate_jit(jnp.asarray(field), S, truncation)
