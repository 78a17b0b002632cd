"""The GPU entry points' host-side contract, checked on the CPU.

``chip_smoke.py`` and ``bench.py`` run only on a GPU; what they decide on
the host — refusing a CPU backend, the last line they print, where the
compile cache goes — is tested here.  So are the choices the GPU bring-up
made in the library: the float dtype rule, datetime handling without
pandas, float32 matmuls pinned to HIGHEST precision (not TF32), and no
TPU kernel module anywhere in the import graph.
"""
import json
import os
import subprocess
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import bench
import chip_smoke
from lagrangiancoherence_tpu.utils import runtime

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_chip_smoke_refuses_cpu_backend(capsys):
    assert chip_smoke.main([]) == 1
    out = capsys.readouterr()
    assert out.out == ""                      # no result, no "ok" line
    assert "no GPU" in out.err


def test_bench_refuses_cpu_backend(capsys):
    assert bench.main([]) == 1
    out = capsys.readouterr()
    assert out.out == ""                      # no record, no timing
    assert "no GPU" in out.err


def test_last_line_has_exactly_the_contract_keys():
    dev = SimpleNamespace(platform="gpu", device_kind="NVIDIA H100 80GB HBM3")
    line = json.loads(json.dumps(chip_smoke.last_line([dev] * 4)))
    assert line == {"ok": True, "device": {"platform": "gpu",
                                           "kind": "NVIDIA H100 80GB HBM3",
                                           "count": 4}}


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv(runtime.CACHE_ENV, str(tmp_path))
    assert runtime.compile_cache_dir() == str(tmp_path)
    assert runtime.enable_compile_cache() == str(tmp_path)
    # JAX reads the variable itself; the helper sets nothing else
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_default_is_fixed_in_checkout(monkeypatch):
    monkeypatch.delenv(runtime.CACHE_ENV, raising=False)
    first = runtime.compile_cache_dir()
    assert first == runtime.compile_cache_dir()
    assert first == os.path.join(ROOT, ".jax_cache")
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


@pytest.mark.parametrize("x64", [True, False])
def test_series_dtype_follows_x64(x64):
    from lagrangiancoherence_tpu.api import float_dtype
    from lagrangiancoherence_tpu.field import Field
    from lagrangiancoherence_tpu.runners import ftle_series

    lats = np.linspace(-80.0, 80.0, 9)
    lons = np.linspace(-180.0, 150.0, 12)
    times = np.datetime64("2000-01-01T00", "ns") \
        + np.arange(3) * np.timedelta64(6, "h")
    u = np.full((3, 9, 12), 10.0)
    dims = ("time", "latitude", "longitude")
    coords = dict(time=times, latitude=lats, longitude=lons)
    with jax.enable_x64(x64):
        want = np.float64 if x64 else np.float32
        assert float_dtype() == want
        out = ftle_series(Field(u, dims, coords), Field(0.5 * u, dims, coords),
                          -6 * 3600.0, window=3, settls_order=1)
    assert out.data.dtype == want


@pytest.mark.parametrize("freq", ["3h", "6h", "1D", "30min"])
def test_resample_labels_match_pandas(freq):
    pd = pytest.importorskip("pandas")
    from lagrangiancoherence_tpu.api import _resample_labels

    for start in ("2000-01-01 01:00", "2000-02-28 23:30"):
        for step in ("7h", "45min"):
            times = pd.date_range(start, periods=9, freq=step)
            want = pd.Series(0.0, index=times).resample(freq).asfreq().index
            got = _resample_labels(times.values, freq)
            assert got.shape == want.shape
            assert (got == want.values).all()


def _dot_precisions(closed):
    """``precision`` of every dot_general in a jaxpr, sub-jaxprs included."""
    out = []

    def walk(jaxpr):
        for eqn in jaxpr.eqns:
            if eqn.primitive.name == "dot_general":
                out.append(eqn.params["precision"])
            for v in eqn.params.values():
                for sub in v if isinstance(v, (list, tuple)) else [v]:
                    if hasattr(sub, "jaxpr") and hasattr(sub, "consts"):
                        walk(sub.jaxpr)
                    elif hasattr(sub, "eqns"):
                        walk(sub)

    walk(closed.jaxpr)
    return out


def _sht(x):
    from lagrangiancoherence_tpu.ops.sht import truncate
    return truncate(x, np.linspace(-80.0, 80.0, 12), 3)


def _idw(z):
    from lagrangiancoherence_tpu.ops.idw import idw_interpolate
    pts = jnp.linspace(-40.0, 40.0, z.shape[0])
    return idw_interpolate(pts, pts, z, pts[:3] + 1.0, pts[:3] + 1.0)


def _prefilter(x):
    from lagrangiancoherence_tpu.ops.interp import prefilter
    return prefilter(x, order=3)


@pytest.mark.parametrize("fn, shape", [(_sht, (12, 16)), (_idw, (5,)),
                                       (_prefilter, (12, 16))],
                         ids=["sht", "idw", "prefilter"])
def test_float32_matmuls_run_at_highest_precision(fn, shape):
    with jax.enable_x64(False):
        closed = jax.make_jaxpr(fn)(jnp.ones(shape, jnp.float32))
    precs = _dot_precisions(closed)
    assert precs, "no matmul found"
    hi = jax.lax.Precision.HIGHEST
    assert all(p == (hi, hi) for p in precs), precs


def test_no_tpu_kernel_module_in_import_graph():
    """Importing every package module and both GPU entry points loads no
    TPU kernel-language module (``jax.experimental.*.tpu``,
    ``jax._src.*.mosaic``)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import lagrangiancoherence_tpu as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import bench, chip_smoke\n"
        "bad = [k for k in sys.modules\n"
        "       if (k.startswith('jax.experimental.') and 'tpu' in k.split('.'))\n"
        "       or (k.startswith('jax._src.') and 'mosaic' in k.split('.'))]\n"
        "print(len(bad), bad)\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("0 "), res.stdout
