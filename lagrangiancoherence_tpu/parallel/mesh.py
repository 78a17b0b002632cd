"""Device-mesh construction for the parcel-grid data parallelism.

The reference has no distributed runtime at all (SURVEY.md §2: scale-out was
one netCDF per batch job).  The scale-out strategy here is spatial data
parallelism over the parcel grid: a 1-D (or 2-D) ``jax.sharding.Mesh`` whose
``"y"`` axis shards latitude rows (and optionally ``"x"`` longitude columns),
plus a ``"t"`` axis for batch/time parallelism in animation workloads.
Collectives are XLA's (NCCL on GPUs); no custom transport.  GPUs of one
host are joined all to all, so the mesh follows the algorithm, not a
topology.
"""
from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["parcel_mesh", "batch_mesh", "P", "NamedSharding"]


def parcel_mesh(n_devices: int | None = None, devices=None,
                x_parallel: int = 1) -> Mesh:
    """1-D (or 2-D) mesh over the parcel grid: ``("y",)`` or ``("y", "x")``.

    ``x_parallel > 1`` splits the device count between latitude and longitude
    shards; the default shards latitude only (the stencil halo is in lat and
    lon is cyclic, so y-sharding keeps the halo exchange to one axis).
    """
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            devices = devices[:n_devices]
    devices = np.asarray(devices)
    n = devices.size
    if x_parallel > 1:
        if n % x_parallel:
            raise ValueError(f"{n} devices do not split into x_parallel="
                             f"{x_parallel}")
        return Mesh(devices.reshape(n // x_parallel, x_parallel), ("y", "x"))
    return Mesh(devices.reshape(n), ("y",))


def batch_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """1-D mesh over a batch/time axis — the animation-workload layout
    (SURVEY.md §2: 'Batch/time DP')."""
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            devices = devices[:n_devices]
    return Mesh(np.asarray(devices), ("t",))
