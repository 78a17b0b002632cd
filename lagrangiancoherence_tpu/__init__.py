"""lagrangiancoherence_tpu — Lagrangian Coherent Structures in JAX.

From-scratch JAX re-design of the capability surface of
gabrielmpp/LagrangianCoherence (see /root/reference and SURVEY.md): SETTLS
semi-Lagrangian parcel advection, FTLE via the flow-map deformation
gradient, ridge extraction, area-of-influence attribution — with a
lax.scan/shard_map compute core, closed-form eigensolves, and spatial data
parallelism over device meshes.

Public API (lazy-imported to keep ``import lagrangiancoherence_tpu`` light):

- ``LCS``, ``parcel_propagation``, ``flowmap_gradient``, ``latlonsel`` (api)
- ``Field`` (field) and ``Grid`` (grid)
- ``find_ridges_spherical_hessian`` (models.ridges), ``find_area``
  (models.area), ``filter_ridges`` (models.ridge_filter)
- ``ftle_pipeline`` (models.pipeline), ``ftle_sharded``/``ftle_batch``
  (parallel.pipeline)
"""
from __future__ import annotations

__version__ = "0.1.0"

_EXPORTS = {
    "LCS": "lagrangiancoherence_tpu.api",
    "parcel_propagation": "lagrangiancoherence_tpu.api",
    "flowmap_gradient": "lagrangiancoherence_tpu.api",
    "latlonsel": "lagrangiancoherence_tpu.api",
    "Field": "lagrangiancoherence_tpu.field",
    "as_field": "lagrangiancoherence_tpu.field",
    "Grid": "lagrangiancoherence_tpu.grid",
    "find_ridges_spherical_hessian": "lagrangiancoherence_tpu.models.ridges",
    "find_area": "lagrangiancoherence_tpu.models.area",
    "filter_ridges": "lagrangiancoherence_tpu.models.ridge_filter",
    "ftle_pipeline": "lagrangiancoherence_tpu.models.pipeline",
    "ftle_sharded": "lagrangiancoherence_tpu.parallel.pipeline",
    "ftle_batch": "lagrangiancoherence_tpu.parallel.pipeline",
    "parcel_propagation_sharded": "lagrangiancoherence_tpu.parallel.pipeline",
    "ftle_series": "lagrangiancoherence_tpu.runners",
    "ftle_series_to_files": "lagrangiancoherence_tpu.runners",
}

__all__ = sorted(_EXPORTS) + ["__version__"]


def __getattr__(name: str):
    if name in _EXPORTS:
        import importlib
        mod = importlib.import_module(_EXPORTS[name])
        return getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return __all__
