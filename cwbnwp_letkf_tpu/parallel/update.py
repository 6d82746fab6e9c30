"""Sharded per-variable LETKF update over a device mesh.

``shard_map`` splits the point batch across the ``"grid"`` mesh axis; every
device runs the identical single-device update (ops/update.py) on its slice
with the obs arrays replicated.  This replaces the reference's
scatter -> serial loop -> gather pipeline (letkf_scatter_grid /
letkf_gather_grid, module_mpi_util.f90:190-358): state is born sharded, so
the alltoallv transposes vanish.

Each entry point jits its ``shard_map``: called eagerly, ``shard_map``
dispatches the body primitive by primitive, one SPMD launch each, which
made the four-device cycle several times slower than one device.
"""
from __future__ import annotations

from typing import Sequence

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..ops.update import DevicePlatform, update_points
from .mesh import GRID_AXIS


def sharded_update_points(
    mesh: Mesh,
    xb,
    points_xyz,
    platforms: Sequence[DevicePlatform],
    ivar: int,
    *,
    inflat: float,
    weight_function: int,
    use_rtpp: bool = False,
    rtpp_alpha: float = 0.85,
    use_rtps: bool = False,
    rtps_alpha: float = 0.85,
    solver_dtype=jnp.float32,
    chunk: int = 4096,
    method: str = "auto",
    max_blocks=None,
    point_order: str = "auto",
    return_diagnostics: bool = False,
):
    """Run :func:`~cwbnwp_letkf_tpu.ops.update.update_points` SPMD.

    ``xb [B, k]`` and ``points_xyz [B, 3]`` are sharded along ``B``; platform
    obs data is replicated.  The batch is padded to a multiple of the mesh
    size with copies of the LAST REAL POINT (zeroed xb; output rows dropped
    before returning) — a sentinel coordinate like 1e18 would enter the
    padded shard's Hilbert-key bounding box and collapse every real point to
    one cell, degrading its chunks to raw grid order and defeating the
    bucketed block culling.  Result is identical to the single-device path
    (tests/test_sharding.py).

    ``return_diagnostics=True`` also returns the psum-reduced diagnostics
    dict of the local updates (``bucket_overflow`` summed, ``ns_residual``
    maxed over shards) — the SPMD path's only signal that a bucketed block
    budget was undersized for some shard's local chunking (plan with
    ``plan_max_blocks(..., n_shards=mesh.devices.size)`` to make that
    impossible by construction).
    """
    xb = jnp.asarray(xb)
    q = jnp.asarray(points_xyz)
    b, k = xb.shape
    n_dev = mesh.devices.size

    b_pad = -(-b // n_dev) * n_dev
    if b_pad != b:
        xb = jnp.concatenate([xb, jnp.zeros((b_pad - b, k), xb.dtype)])
        q = jnp.concatenate([q, jnp.broadcast_to(q[-1:], (b_pad - b, 3))])

    statics = [dp.static for dp in platforms]
    arrays = [(dp.xyz, dp.stats) for dp in platforms]

    def local(xb_l, q_l, arrays_l):
        plats = [
            DevicePlatform(static=st, xyz=xyz, stats=stats)
            for st, (xyz, stats) in zip(statics, arrays_l)
        ]
        xa_l, diag = update_points(
            xb_l, q_l, plats, ivar,
            inflat=inflat, weight_function=weight_function,
            use_rtpp=use_rtpp, rtpp_alpha=rtpp_alpha,
            use_rtps=use_rtps, rtps_alpha=rtps_alpha,
            solver_dtype=solver_dtype, chunk=chunk, method=method,
            max_blocks=max_blocks, point_order=point_order,
            return_diagnostics=True)
        return xa_l, _psum_diag(diag)

    f = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(GRID_AXIS), P(GRID_AXIS), P()),
        out_specs=(P(GRID_AXIS), P()),
    )
    xa, diag = jax.jit(f)(xb, q, arrays)
    if return_diagnostics:
        return xa[:b], diag
    return xa[:b]


def sharded_update_points_cycle(
    mesh: Mesh,
    xb,
    points_xyz,
    platforms: Sequence[DevicePlatform],
    groups,
    *,
    weight_function: int,
    solver_dtype=jnp.float32,
    chunk: int = 4096,
    subchunk: int = 512,
    method: str = "auto",
    max_blocks=None,
    point_order: str = "auto",
    return_diagnostics: bool = False,
):
    """SPMD variant of :func:`~cwbnwp_letkf_tpu.ops.cycle.update_points_cycle`.

    ``xb [B, V_total, k]`` / ``points_xyz [B, 3]`` sharded along ``B``; obs
    replicated; each device runs the full fused cycle on its point shard.
    Same padding (last-real-point copies) / diagnostics contract as
    :func:`sharded_update_points`; budgets from
    ``plan_cycle_budgets(..., n_shards=mesh.devices.size)`` make bucketed
    overflow impossible by construction.
    """
    from ..ops.cycle import update_points_cycle

    xb = jnp.asarray(xb)
    q = jnp.asarray(points_xyz)
    b, v_tot, k = xb.shape
    n_dev = mesh.devices.size

    b_pad = -(-b // n_dev) * n_dev
    if b_pad != b:
        xb = jnp.concatenate(
            [xb, jnp.zeros((b_pad - b, v_tot, k), xb.dtype)])
        q = jnp.concatenate([q, jnp.broadcast_to(q[-1:], (b_pad - b, 3))])

    statics = [dp.static for dp in platforms]
    arrays = [(dp.xyz, dp.stats) for dp in platforms]

    def local(xb_l, q_l, arrays_l):
        plats = [
            DevicePlatform(static=st, xyz=xyz, stats=stats)
            for st, (xyz, stats) in zip(statics, arrays_l)
        ]
        xa_l, diag = update_points_cycle(
            xb_l, q_l, plats, groups,
            weight_function=weight_function, solver_dtype=solver_dtype,
            chunk=chunk, subchunk=subchunk, method=method,
            max_blocks=max_blocks, point_order=point_order,
            return_diagnostics=True)
        return xa_l, _psum_diag(diag)

    f = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(GRID_AXIS), P(GRID_AXIS), P()),
        out_specs=(P(GRID_AXIS), P()),
    )
    xa, diag = jax.jit(f)(xb, q, arrays)
    if return_diagnostics:
        return xa[:b], diag
    return xa[:b]


def _psum_diag(diag):
    """Reduce per-shard diagnostics across the grid axis (replicated out)."""
    return {
        "bucket_overflow": jax.lax.psum(diag["bucket_overflow"], GRID_AXIS),
        "ns_residual": jax.lax.pmax(diag["ns_residual"], GRID_AXIS),
    }


def sharded_update_points_group(
    mesh: Mesh,
    xb,
    points_xyz,
    platforms: Sequence[DevicePlatform],
    ivars,
    *,
    inflats,
    weight_function: int,
    rtpp_alpha,
    rtps_alpha,
    solver_dtype=jnp.float32,
    chunk: int = 4096,
    method: str = "auto",
    max_blocks=None,
    point_order: str = "auto",
    return_diagnostics: bool = False,
):
    """SPMD variant of :func:`~cwbnwp_letkf_tpu.ops.update.update_points_group`.

    ``xb [B, V, k]`` / ``points_xyz [B, 3]`` sharded along ``B``; obs
    replicated.  Same padding (last-real-point copies) / masking /
    diagnostics contract as :func:`sharded_update_points`.
    """
    from ..ops.update import update_points_group

    xb = jnp.asarray(xb)
    q = jnp.asarray(points_xyz)
    b, n_vars, k = xb.shape
    n_dev = mesh.devices.size

    b_pad = -(-b // n_dev) * n_dev
    if b_pad != b:
        xb = jnp.concatenate([xb, jnp.zeros((b_pad - b, n_vars, k), xb.dtype)])
        q = jnp.concatenate([q, jnp.broadcast_to(q[-1:], (b_pad - b, 3))])

    statics = [dp.static for dp in platforms]
    arrays = [(dp.xyz, dp.stats) for dp in platforms]

    def local(xb_l, q_l, arrays_l):
        plats = [
            DevicePlatform(static=st, xyz=xyz, stats=stats)
            for st, (xyz, stats) in zip(statics, arrays_l)
        ]
        xa_l, diag = update_points_group(
            xb_l, q_l, plats, ivars,
            inflats=inflats, weight_function=weight_function,
            rtpp_alpha=rtpp_alpha, rtps_alpha=rtps_alpha,
            solver_dtype=solver_dtype, chunk=chunk, method=method,
            max_blocks=max_blocks, point_order=point_order,
            return_diagnostics=True)
        return xa_l, _psum_diag(diag)

    f = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(GRID_AXIS), P(GRID_AXIS), P()),
        out_specs=(P(GRID_AXIS), P()),
    )
    xa, diag = jax.jit(f)(xb, q, arrays)
    if return_diagnostics:
        return xa[:b], diag
    return xa[:b]
