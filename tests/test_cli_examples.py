"""CLI and example-driver smoke tests (SURVEY.md §2 'CLI entry' and §4
analytic-flow validation scripts)."""
import os

import numpy as np
import pytest

from lagrangiancoherence_tpu.cli import main as cli_main, parse_subdomain
from lagrangiancoherence_tpu.field import Field
from lagrangiancoherence_tpu.testing import flows

h5py = pytest.importorskip("h5py")

from lagrangiancoherence_tpu.utils.io import open_dataset, save_dataset


def write_winds(path, nt=4):
    cfg = dict(flows.SADDLE_CONFIG, nt=nt)
    u, v, lats, lons, times = flows.ideal_saddle(**cfg)
    dims = ("time", "latitude", "longitude")
    coords = dict(time=times, latitude=lats, longitude=lons)
    save_dataset({"u": Field(u, dims, coords, name="u"),
                  "v": Field(v, dims, coords, name="v")}, str(path))
    return lats, lons


class TestCLI:
    def test_basic_run_writes_ftle(self, tmp_path):
        inp = tmp_path / "winds.nc"
        out = tmp_path / "ftle.nc"
        lats, lons = write_winds(inp)
        rc = cli_main([str(inp), str(out), "--timestep", "-21600",
                       "--settls-order", "1", "--quiet"])
        assert rc == 0
        ds = open_dataset(str(out))
        assert ds["ftle"].shape == (1, lats.size, lons.size)
        assert os.path.exists(inp), "input must NEVER be deleted (Q8 fix)"

    def test_idempotent_skip(self, tmp_path):
        inp = tmp_path / "winds.nc"
        out = tmp_path / "ftle.nc"
        write_winds(inp)
        cli_main([str(inp), str(out), "--settls-order", "0", "--quiet"])
        mtime = os.path.getmtime(out)
        rc = cli_main([str(inp), str(out), "--settls-order", "0", "--quiet"])
        assert rc == 0
        assert os.path.getmtime(out) == mtime, "existing output rewritten"

    def test_return_traj_writes_departures(self, tmp_path):
        inp = tmp_path / "winds.nc"
        out = tmp_path / "traj.nc"
        write_winds(inp)
        cli_main([str(inp), str(out), "--settls-order", "0",
                  "--return-traj", "--quiet"])
        assert (tmp_path / "traj_x_departure.nc").exists()
        assert (tmp_path / "traj_y_departure.nc").exists()

    def test_full_scipy_order_surface(self, tmp_path):
        # the CLI accepts every scipy spline order the library supports
        # (0-5, ops/interp.py)
        inp = tmp_path / "winds.nc"
        lats, lons = write_winds(inp)
        for order in (0, 2, 5):
            out = tmp_path / f"ftle_o{order}.nc"
            rc = cli_main([str(inp), str(out), "--settls-order", "1",
                           "--interp-order", str(order), "--quiet"])
            assert rc == 0
            ds = open_dataset(str(out))
            assert ds["ftle"].shape == (1, lats.size, lons.size)

    def test_parse_subdomain(self):
        sub = parse_subdomain("-90/-32/-40/15")
        assert sub["longitude"] == slice(-90.0, -32.0)
        assert sub["latitude"] == slice(-40.0, 15.0)
        assert parse_subdomain(None) is None


class TestExamples:
    def test_ideal_vortex_quick(self, capsys):
        import runpy
        import sys
        argv = sys.argv
        sys.argv = ["ideal_vortex.py", "--quick"]
        try:
            runpy.run_path("examples/ideal_vortex.py", run_name="__main__")
        finally:
            sys.argv = argv
        out = capsys.readouterr().out
        assert "attracting" in out and "repelling" in out

    def test_area_of_influence_quick(self, capsys):
        import runpy
        import sys
        argv = sys.argv
        sys.argv = ["area_of_influence.py", "--quick"]
        try:
            runpy.run_path("examples/area_of_influence.py",
                           run_name="__main__")
        finally:
            sys.argv = argv
        assert "AREA-OF-INFLUENCE PIPELINE OK" in capsys.readouterr().out


class TestCreateArraysList:
    def test_groups_along_dim(self):
        from lagrangiancoherence_tpu.api import create_arrays_list
        f = Field(np.arange(12).reshape(3, 4), ("points", "x"),
                  {"points": np.arange(3), "x": np.arange(4)})
        groups = create_arrays_list(f, "points")
        assert len(groups) == 3
        np.testing.assert_array_equal(groups[1], [4, 5, 6, 7])
