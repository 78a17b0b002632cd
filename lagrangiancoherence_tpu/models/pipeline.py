"""End-to-end fused FTLE pipeline: winds in, FTLE-norm field out, one jit.

The reference pipeline crosses Python/host at every stage
(/root/reference/LCS/LCS.py:129-157: propagation loop → xarray merge →
stack/dropna → LAPACK norm).  Here SETTLS scan, flow-map gradient and the
closed-form norm compile into a single XLA program — no host sync between
stages, which is what the sharded multi-chip path and the benchmark drive.
"""
from __future__ import annotations

from functools import partial

import jax

from ..grid import Grid
from .ftle import flowmap_gradient, ftle_norm
from .settls import parcel_propagation_core

__all__ = ["ftle_pipeline"]


@partial(jax.jit, static_argnames=("grid", "settls_order", "interp_order",
                                   "sigma", "compat"))
def ftle_pipeline(u: jax.Array, v: jax.Array, timestep, grid: Grid, *,
                  settls_order: int = 0, interp_order: int = 3,
                  sigma=None, compat: bool = True):
    """(T, ny, nx) winds → (ny, nx) FTLE norm, fully fused.

    Semantics identical to ``LCS.__call__``'s core path (quirks Q1-Q6
    included); see models/settls.py and models/ftle.py for the stage
    contracts.
    """
    px, py = parcel_propagation_core(u, v, timestep, grid,
                                     settls_order=settls_order,
                                     interp_order=interp_order,
                                     return_traj=False)
    tensor = flowmap_gradient(px, py, grid, sigma=sigma)
    return ftle_norm(tensor, compat=compat)
