"""Ideal-vortex validation workload — the de-facto acceptance test.

Re-creation of the reference's example driver
(the reference's examples/ideal_vortex.py:211-403) on this library's stack:

* build the Rankine-like moving vortex flow (testing/flows.py);
* advect a dye tracer forward and backward through the flow (the reference's
  trajectory-based mixing visualisation, ideal_vortex.py:262-279);
* compute attracting (backward) and repelling (forward) FTLE via the ``LCS``
  facade with ``isglobal=True``, applying the caller-side ``log(ftle)/2``
  convention (ideal_vortex.py:280-288, SURVEY.md Q9);
* print summary statistics; write PNG figures only when matplotlib is
  importable (plots are optional — stats go to stdout either way).

Run: ``python examples/ideal_vortex.py [--quick]``
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np

sys.path.insert(0, ".")  # allow running from the repo root without install

from lagrangiancoherence_tpu.api import LCS, parcel_propagation
from lagrangiancoherence_tpu.field import Field
from lagrangiancoherence_tpu.testing import flows


def make_fields(cfg):
    u, v, lats, lons, times = flows.ideal_vortex(**cfg)
    dims = ("time", "latitude", "longitude")
    coords = dict(time=times, latitude=lats, longitude=lons)
    return (Field(u, dims, coords, name="u"),
            Field(v, dims, coords, name="v"), lats, lons)


def dye_advection(U, V, timestep):
    """Departure-point dye maps: each parcel carries its origin longitude /
    latitude — the mixing picture of ideal_vortex.py:262-279."""
    x_dep, y_dep = parcel_propagation(U, V, timestep, verbose=False,
                                      SETTLS_order=2, cyclic_xboundary=True)
    return x_dep, y_dep


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--quick", action="store_true",
                   help="fewer time steps for smoke testing")
    p.add_argument("--plot", action="store_true",
                   help="write PNGs (requires matplotlib)")
    args = p.parse_args(argv)

    cfg = dict(flows.VORTEX_CONFIG_SUBTROPICAL)
    if args.quick:
        cfg["nt"] = 5

    U, V, lats, lons = make_fields(cfg)
    timestep = 6 * 3600

    t0 = time.perf_counter()
    x_fwd, y_fwd = dye_advection(U, V, +timestep)
    x_bwd, y_bwd = dye_advection(U, V, -timestep)
    print(f"dye advection: {time.perf_counter() - t0:.2f}s")
    print(f"  forward dye lon spread (std): {np.nanstd(x_fwd.data):8.3f} deg")
    print(f"  backward dye lon spread (std): {np.nanstd(x_bwd.data):8.3f} deg")

    t0 = time.perf_counter()
    lcs = LCS(timestep=-timestep, timedim="time", SETTLS_order=4)
    ftle_attracting = lcs(u=U, v=V, verbose=False, isglobal=True,
                          interp_to_common_grid=True, truncation=20)
    lcs = LCS(timestep=+timestep, timedim="time", SETTLS_order=4)
    ftle_repelling = lcs(u=U, v=V, verbose=False, isglobal=True,
                         interp_to_common_grid=True, truncation=20)
    print(f"FTLE (attracting + repelling): {time.perf_counter() - t0:.2f}s")

    # caller-side Lyapunov convention (Q9): lambda = log(sigma_max) / 2
    lam_a = np.log(ftle_attracting.data[0]) / 2
    lam_r = np.log(ftle_repelling.data[0]) / 2
    for name, lam in (("attracting", lam_a), ("repelling", lam_r)):
        print(f"  {name:10s}: max={np.nanmax(lam):6.3f} "
              f"p99={np.nanpercentile(lam, 99):6.3f} "
              f"median={np.nanmedian(lam):6.3f}")

    # structural sanity: strong attracting ridge near the vortex
    glats = ftle_attracting.coords["latitude"]
    glons = ftle_attracting.coords["longitude"]
    iy = np.argmin(np.abs(glats - cfg["center"][1]))
    ix = np.argmin(np.abs(glons - cfg["center"][0]))
    near = np.nanmax(lam_a[max(0, iy - 20):iy + 20, max(0, ix - 20):ix + 20])
    far = np.nanmedian(lam_a)
    print(f"  vortex-ring max vs global median: {near:.3f} vs {far:.3f}")
    assert near > far, "no coherent structure found near the vortex"

    if args.plot:
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            print("matplotlib unavailable; skipping plots")
            return
        fig, axs = plt.subplots(2, 2, figsize=(14, 7))
        for ax, (title, data) in zip(axs.flat, [
                ("forward dye (origin lon)", x_fwd.data),
                ("backward dye (origin lon)", x_bwd.data),
                ("attracting log-FTLE/2", lam_a),
                ("repelling log-FTLE/2", lam_r)]):
            im = ax.imshow(data, origin="lower", aspect="auto")
            ax.set_title(title)
            fig.colorbar(im, ax=ax, shrink=0.8)
        fig.tight_layout()
        fig.savefig("ideal_vortex_summary.png", dpi=150)
        print("wrote ideal_vortex_summary.png")


if __name__ == "__main__":
    main()
