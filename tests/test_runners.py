"""FTLE time-series runner tests (the animation workload, SURVEY.md §5)."""
import os

import jax
import numpy as np
import pytest

from lagrangiancoherence_tpu.field import Field
from lagrangiancoherence_tpu.grid import Grid
from lagrangiancoherence_tpu.models.pipeline import ftle_pipeline
from lagrangiancoherence_tpu.runners import ftle_series, ftle_series_to_files
from lagrangiancoherence_tpu.testing import flows


def wind_fields(nt=12):
    cfg = dict(flows.VORTEX_CONFIG_SUBTROPICAL, nt=nt)
    u, v, lats, lons, times = flows.ideal_vortex(**cfg)
    dims = ("time", "latitude", "longitude")
    coords = dict(time=times, latitude=lats, longitude=lons)
    return (Field(u, dims, coords, name="u"),
            Field(v, dims, coords, name="v"), u, v, lats, lons, times)


class TestFtleSeries:
    def test_windows_match_single_runs(self):
        U, V, u, v, lats, lons, times = wind_fields()
        import jax.numpy as jnp
        grid = Grid(lats=lats, lons=lons, cyclic_x=True)
        series = ftle_series(U, V, -6 * 3600.0, window=5, stride=3,
                             settls_order=1, batch=2)
        starts = [0, 3, 6]
        assert series.shape[0] == len(starts)
        for i, s in enumerate(starts):
            ref = np.asarray(ftle_pipeline(
                jnp.asarray(u[s:s + 5]), jnp.asarray(v[s:s + 5]),
                -6 * 3600.0, grid, settls_order=1))
            np.testing.assert_allclose(series.data[i], ref, atol=1e-10)
            # backward run stamps the window's first time (LCS.py:158)
            assert series.coords["time"][i] == times[s]

    def test_forward_stamps_last(self):
        U, V, *_, times = wind_fields()
        series = ftle_series(U, V, 6 * 3600.0, window=5, stride=5,
                             settls_order=0)
        assert series.coords["time"][0] == times[4]

    def test_sharded_batch(self):
        if len(jax.devices()) < 4:
            pytest.skip("needs 4 devices")
        from lagrangiancoherence_tpu.parallel.mesh import batch_mesh
        U, V, *_ = wind_fields()
        a = ftle_series(U, V, -6 * 3600.0, window=5, stride=2,
                        settls_order=1, batch=4, mesh=batch_mesh(4))
        b = ftle_series(U, V, -6 * 3600.0, window=5, stride=2,
                        settls_order=1, batch=4)
        np.testing.assert_allclose(a.data, b.data, atol=1e-10)

    def test_too_short_record_raises(self):
        U, V, *_ = wind_fields(nt=4)
        with pytest.raises(ValueError):
            ftle_series(U, V, -6 * 3600.0, window=10)


class TestStreaming:
    def test_idempotent_files(self, tmp_path):
        pytest.importorskip("h5py")
        U, V, *_ = wind_fields()
        out = str(tmp_path / "anim")
        w1 = ftle_series_to_files(U, V, -6 * 3600.0, out, window=5,
                                  stride=5, settls_order=0)
        assert len(w1) == 2
        assert all(os.path.exists(p) for p in w1)
        # second run skips everything (crash-recovery contract)
        w2 = ftle_series_to_files(U, V, -6 * 3600.0, out, window=5,
                                  stride=5, settls_order=0)
        assert w2 == []

    def test_resume_recomputes_only_missing(self, tmp_path, monkeypatch):
        """Resume after a partial run skips COMPUTE, not just writes, and
        completed windows survive a mid-series crash (streamed writes)."""
        pytest.importorskip("h5py")
        import lagrangiancoherence_tpu.models.pipeline as mp

        calls = []
        real = mp.ftle_pipeline

        def counting(*a, **k):
            calls.append(1)
            return real(*a, **k)

        monkeypatch.setattr(mp, "ftle_pipeline", counting)
        U, V, *_ = wind_fields()
        out = str(tmp_path / "anim")
        # batch=1 → one ftle_pipeline call per window (run_single path)
        w1 = ftle_series_to_files(U, V, -6 * 3600.0, out, window=5,
                                  stride=5, settls_order=0, batch=1)
        assert len(w1) == 2 and len(calls) == 2
        # simulate a crash that lost the second window
        os.remove(w1[1])
        calls.clear()
        w2 = ftle_series_to_files(U, V, -6 * 3600.0, out, window=5,
                                  stride=5, settls_order=0, batch=1)
        assert w2 == [w1[1]]
        assert len(calls) == 1          # only the missing window recomputed

    def test_streams_per_chunk(self, tmp_path, monkeypatch):
        """Each chunk's files exist on disk BEFORE the next chunk's compute
        starts — a crash loses at most one chunk of work."""
        pytest.importorskip("h5py")
        import lagrangiancoherence_tpu.models.pipeline as mp

        seen_on_disk = []
        real = mp.ftle_pipeline
        outdir = str(tmp_path / "anim")

        def spying(*a, **k):
            import glob
            seen_on_disk.append(len(glob.glob(os.path.join(outdir, "*.nc"))))
            return real(*a, **k)

        monkeypatch.setattr(mp, "ftle_pipeline", spying)
        U, V, *_ = wind_fields()
        w = ftle_series_to_files(U, V, -6 * 3600.0, outdir, window=5,
                                 stride=5, settls_order=0, batch=1)
        assert len(w) == 2
        # second window's compute saw the first window already written
        assert seen_on_disk == [0, 1]


class TestSeriesOptions:
    def test_regional_cyclic_x_false(self):
        """Regional records (reference's research workload,
        area_of_influence.py:168-184) must not get dateline wrap."""
        import jax.numpy as jnp
        U, V, u, v, lats, lons, times = wind_fields()
        grid = Grid(lats=lats, lons=lons, cyclic_x=False)
        series = ftle_series(U, V, -6 * 3600.0, window=5, stride=5,
                             settls_order=1, batch=1, cyclic_x=False)
        ref = np.asarray(ftle_pipeline(
            jnp.asarray(u[:5]), jnp.asarray(v[:5]), -6 * 3600.0, grid,
            settls_order=1))
        np.testing.assert_allclose(series.data[0], ref, atol=1e-10)

    def test_mesh_tail_chunk_padded(self):
        """A tail chunk smaller than the mesh device count is padded to stay
        shardable, and auto-batch stays a device-count multiple."""
        if len(jax.devices()) < 2:
            pytest.skip("needs 2 devices")
        from lagrangiancoherence_tpu.parallel.mesh import batch_mesh
        U, V, *_ = wind_fields()
        # stride=2 → 4 windows; batch=3 on a 2-device mesh → chunks of
        # 3 (padded to 4) and 1 (padded to 2)
        a = ftle_series(U, V, -6 * 3600.0, window=5, stride=2,
                        settls_order=1, batch=3, mesh=batch_mesh(2))
        b = ftle_series(U, V, -6 * 3600.0, window=5, stride=2,
                        settls_order=1, batch=4)
        np.testing.assert_allclose(a.data, b.data, atol=1e-10)
