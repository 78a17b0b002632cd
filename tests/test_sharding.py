"""Multi-device parity tests on the virtual 8-device CPU mesh — the
'single-host multi-device parity' strategy SURVEY.md §4 prescribes: 1-chip
and N-way-sharded runs must produce identical outputs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lagrangiancoherence_tpu.grid import Grid
from lagrangiancoherence_tpu.models.pipeline import ftle_pipeline
from lagrangiancoherence_tpu.parallel.mesh import batch_mesh, parcel_mesh
from lagrangiancoherence_tpu.parallel.pipeline import ftle_batch, ftle_sharded
from lagrangiancoherence_tpu.testing import flows

needs_8_devices = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices")


def vortex_case():
    u, v, lats, lons, _ = flows.ideal_vortex(**flows.VORTEX_CONFIG_SUBTROPICAL)
    return u, v, Grid(lats=lats, lons=lons, cyclic_x=True)


def vortex_case_divisible():
    """96 latitude rows — divides the 8-device mesh, exercising the
    zero-pad fast paths (blocked gaussian included)."""
    cfg = dict(flows.VORTEX_CONFIG_SUBTROPICAL)
    u, v, lats, lons, _ = flows.ideal_vortex(**cfg)
    lats96 = np.linspace(lats[0], lats[0] + 2.0 * 95, 96)
    LON, LAT = np.meshgrid(lons, lats96)
    # regenerate on the 96-row grid by reusing the same vortex config
    cfg2 = dict(cfg, lat_min=float(lats96[0]), lat_max=float(lats96[-1]) + 1)
    u2, v2, lats2, lons2, _ = flows.ideal_vortex(**cfg2)
    assert lats2.size == 96, lats2.size
    return u2, v2, Grid(lats=lats2, lons=lons2, cyclic_x=True)


@needs_8_devices
class TestShardedParity:
    @pytest.mark.parametrize("n_dev", [2, 8])
    def test_parity_no_sigma(self, n_dev):
        u, v, grid = vortex_case()
        ref = np.asarray(ftle_pipeline(jnp.asarray(u), jnp.asarray(v),
                                       -6 * 3600.0, grid, settls_order=2))
        out = np.asarray(ftle_sharded(u, v, -6 * 3600.0, grid,
                                      parcel_mesh(n_dev), settls_order=2))
        assert out.shape == ref.shape
        np.testing.assert_allclose(out, ref, atol=1e-10)

    def test_parity_gaussian_nondivisible(self):
        # 89 rows over 8 devices → 7 pad rows → all_gather smoothing path
        u, v, grid = vortex_case()
        ref = np.asarray(ftle_pipeline(jnp.asarray(u), jnp.asarray(v),
                                       -6 * 3600.0, grid, settls_order=1,
                                       sigma=1.5))
        out = np.asarray(ftle_sharded(u, v, -6 * 3600.0, grid,
                                      parcel_mesh(8), settls_order=1,
                                      sigma=1.5))
        np.testing.assert_allclose(out, ref, atol=1e-10)

    def test_parity_gaussian_divisible(self):
        # 96 rows over 8 devices → pad 0 → halo-exchange blocked gaussian
        u, v, grid = vortex_case_divisible()
        ref = np.asarray(ftle_pipeline(jnp.asarray(u), jnp.asarray(v),
                                       -6 * 3600.0, grid, settls_order=1,
                                       sigma=2.0))
        out = np.asarray(ftle_sharded(u, v, -6 * 3600.0, grid,
                                      parcel_mesh(8), settls_order=1,
                                      sigma=2.0))
        np.testing.assert_allclose(out, ref, atol=1e-10)

    def test_forward_integration(self):
        u, v, grid = vortex_case()
        ref = np.asarray(ftle_pipeline(jnp.asarray(u), jnp.asarray(v),
                                       6 * 3600.0, grid, settls_order=1))
        out = np.asarray(ftle_sharded(u, v, 6 * 3600.0, grid,
                                      parcel_mesh(8), settls_order=1))
        np.testing.assert_allclose(out, ref, atol=1e-10)


@needs_8_devices
class TestBatchParity:
    def test_batched_fields_match_single(self):
        u, v, grid = vortex_case()
        ref = np.asarray(ftle_pipeline(jnp.asarray(u), jnp.asarray(v),
                                       -6 * 3600.0, grid, settls_order=1))
        ub = np.stack([u] * 4)
        vb = np.stack([v] * 4)
        out = np.asarray(ftle_batch(ub, vb, -6 * 3600.0, grid,
                                    batch_mesh(4), settls_order=1))
        assert out.shape == (4,) + ref.shape
        np.testing.assert_allclose(out, np.broadcast_to(ref, out.shape),
                                   atol=1e-12)


class TestMeshConstruction:
    def test_parcel_mesh_axes(self):
        m = parcel_mesh(1)
        assert m.axis_names == ("y",)

    def test_parcel_mesh_2d(self):
        if len(jax.devices()) < 8:
            pytest.skip("needs 8 devices")
        m = parcel_mesh(8, x_parallel=2)
        assert m.axis_names == ("y", "x")
        assert m.shape["y"] == 4 and m.shape["x"] == 2

    def test_bad_split_raises(self):
        if len(jax.devices()) < 8:
            pytest.skip("needs 8 devices")
        with pytest.raises(ValueError):
            parcel_mesh(8, x_parallel=3)


@needs_8_devices
class TestShardedPropagation:
    def test_departure_parity(self):
        from lagrangiancoherence_tpu.models.settls import \
            parcel_propagation_core
        from lagrangiancoherence_tpu.parallel.pipeline import \
            parcel_propagation_sharded
        u, v, grid = vortex_case()
        ref_x, ref_y = parcel_propagation_core(
            jnp.asarray(u), jnp.asarray(v), -6 * 3600.0, grid,
            settls_order=2)
        out_x, out_y = parcel_propagation_sharded(
            u, v, -6 * 3600.0, grid, parcel_mesh(8), settls_order=2)
        np.testing.assert_allclose(np.asarray(out_x), np.asarray(ref_x),
                                   atol=1e-10)
        np.testing.assert_allclose(np.asarray(out_y), np.asarray(ref_y),
                                   atol=1e-10)

    def test_trajectory_parity(self):
        from lagrangiancoherence_tpu.models.settls import \
            parcel_propagation_core
        from lagrangiancoherence_tpu.parallel.pipeline import \
            parcel_propagation_sharded
        u, v, grid = vortex_case()
        ref_x, ref_y = parcel_propagation_core(
            jnp.asarray(u), jnp.asarray(v), -6 * 3600.0, grid,
            settls_order=1, return_traj=True)
        out_x, out_y = parcel_propagation_sharded(
            u, v, -6 * 3600.0, grid, parcel_mesh(8), settls_order=1,
            return_traj=True)
        assert out_x.shape == ref_x.shape
        np.testing.assert_allclose(np.asarray(out_x), np.asarray(ref_x),
                                   atol=1e-10)


@needs_8_devices
class TestTwoDMesh:
    @pytest.mark.parametrize("x_parallel", [2, 4])
    def test_yx_mesh_parity(self, x_parallel):
        u, v, grid = vortex_case()  # nx=180 divides 2 and 4
        ref = np.asarray(ftle_pipeline(jnp.asarray(u), jnp.asarray(v),
                                       -6 * 3600.0, grid, settls_order=2))
        mesh = parcel_mesh(8, x_parallel=x_parallel)
        out = np.asarray(ftle_sharded(u, v, -6 * 3600.0, grid, mesh,
                                      settls_order=2))
        np.testing.assert_allclose(out, ref, atol=1e-10)

    def test_indivisible_nx_rejected(self):
        u, v, grid = vortex_case()
        mesh = parcel_mesh(8, x_parallel=8)  # 180 % 8 != 0
        with pytest.raises(ValueError):
            ftle_sharded(u, v, -6 * 3600.0, grid, mesh, settls_order=0)

    def test_sigma_with_x_sharding_rejected(self):
        u, v, grid = vortex_case()
        mesh = parcel_mesh(8, x_parallel=2)
        with pytest.raises(NotImplementedError):
            ftle_sharded(u, v, -6 * 3600.0, grid, mesh, settls_order=0,
                         sigma=1.0)
