"""Multi-host orchestration: sharded ingest + replicated obs over DCN.

The reference binds one MPI rank per member for I/O (rank r reads member
r+1's wrfinput, cwb_letkf.f90:39-52) then redistributes member-layout fields
to domain layout with mpi_alltoallv (module_mpi_util.f90:190-267).  Across
several processes (one per host, or one per card) the equivalent is: each *host process* reads a disjoint
member subset from shared storage and assembles global device arrays with
``jax.make_array_from_process_local_data`` — state is born in its analysis
sharding, so the alltoallv transpose never exists.  Obs arrays are small and
replicated (the reference's ibcast/iallgatherv merge, gts_omboma.f90:508-611)
— GSPMD broadcasts them once per cycle, overlapped with the first
eigh batches by XLA's async dispatch.

Single-process fallback: with one process this degenerates to plain
device_put, so the same code path serves tests, one host, and pods.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np


def my_member_slice(k: int, process_index: Optional[int] = None,
                    process_count: Optional[int] = None) -> slice:
    """Members owned by this host: contiguous balanced split of 0..k-1.

    (The reference's static rank->member binding, cwb_letkf.f90:39-52,
    without the nproc >= nmember restriction.)
    """
    import jax

    pi = jax.process_index() if process_index is None else process_index
    pc = jax.process_count() if process_count is None else process_count
    base, extra = divmod(k, pc)
    lo = pi * base + min(pi, extra)
    hi = lo + base + (1 if pi < extra else 0)
    return slice(lo, hi)


def make_point_sharded(mesh, arr: np.ndarray, axis: int = 0):
    """Assemble a global array sharded along the point-batch axis.

    ``arr`` must be the full global array on every process (single-host) or
    the process-local shard (multi-host, when
    ``jax.process_count() > 1`` — callers pass the rows this host computed).
    """
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from .mesh import GRID_AXIS

    spec = [None] * arr.ndim
    spec[axis] = GRID_AXIS
    sharding = NamedSharding(mesh, P(*spec))
    if jax.process_count() == 1:
        return jax.device_put(arr, sharding)
    return jax.make_array_from_process_local_data(sharding, arr)


def replicate_obs(mesh, tree):
    """Replicate obs arrays on every device of the (possibly multi-host)
    mesh.  Small payloads; one DCN broadcast per cycle."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    sharding = NamedSharding(mesh, P())
    return jax.tree.map(lambda a: jax.device_put(a, sharding), tree)


def make_member_sharded(mesh, local_cols: np.ndarray):
    """Assemble a global ``[B, k]`` array member-sharded over the mesh.

    ``local_cols``: this process's member columns ``[B, k_local]`` (the
    members of :func:`my_member_slice`), the product of member-parallel
    ingest — the reference's rank-per-member read, cwb_letkf.f90:39-52.
    Single-process callers pass the full ``[B, k]``.
    """
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from .mesh import GRID_AXIS

    sharding = NamedSharding(mesh, P(None, GRID_AXIS))
    if jax.process_count() == 1:
        return jax.device_put(local_cols, sharding)
    return jax.make_array_from_process_local_data(sharding, local_cols)


def members_to_points(mesh, arr):
    """Reshard ``[B, k]`` from member-sharded to point-sharded layout.

    THE alltoallv of the reference (letkf_scatter_grid,
    module_mpi_util.f90:190-267), reduced to a jit identity with an output
    sharding: GSPMD emits one all-to-all over ICI/DCN.  Ingest lands
    member-sharded (each host wrote only its members); the update wants
    points sharded with all k members per point — this is the single
    transpose between those layouts per cycle.
    """
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from .mesh import GRID_AXIS

    out = NamedSharding(mesh, P(GRID_AXIS, None))
    return jax.jit(lambda x: x, out_shardings=out)(arr)


def member_block(k: int, mesh) -> slice:
    """Members this process owns under the member-sharded device layout.

    The ``[B, V, k]`` group arrays are sharded on the member axis over ALL
    mesh devices (padded to a device-count multiple), so a process's
    members are exactly the columns its devices hold:
    ``[pid * kpp, (pid+1) * kpp) ∩ [0, k)`` with
    ``kpp = pad(k, n_dev) / n_proc``.  This supersedes
    :func:`my_member_slice` (balanced split) for the distributed CLI —
    ownership must FOLLOW the sharding, or
    ``jax.make_array_from_process_local_data`` would reshuffle columns.
    Mirrors the reference's static rank->member binding
    (cwb_letkf.f90:39-52) without the ``nproc >= nmember`` restriction.
    """
    import jax

    n_dev = mesh.devices.size
    kpp = (-(-k // n_dev) * n_dev) // jax.process_count()
    lo = jax.process_index() * kpp
    return slice(min(lo, k), min(lo + kpp, k))


def member_group_to_points(mesh, local: np.ndarray, k: int):
    """Assemble this host's ``[B, V, k_local]`` group columns into the
    global point-sharded ``[B, V, k]`` update input.

    The member->point transpose is the reference's ``letkf_scatter_grid``
    alltoallv (module_mpi_util.f90:190-267), emitted by GSPMD from the
    output sharding of a jit identity.  ``local`` holds the columns of
    :func:`member_block` (zero-padded processes pass zero columns).
    """
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from .mesh import GRID_AXIS

    n_dev = mesh.devices.size
    k_pad = -(-k // n_dev) * n_dev
    kpp = k_pad // jax.process_count()
    if local.shape[2] != kpp:
        buf = np.zeros(local.shape[:2] + (kpp,), local.dtype)
        buf[..., :local.shape[2]] = local
        local = buf
    sharding = NamedSharding(mesh, P(None, None, GRID_AXIS))
    if jax.process_count() == 1:
        arr = jax.device_put(local, sharding)
    else:
        arr = jax.make_array_from_process_local_data(sharding, local)
    out = NamedSharding(mesh, P(GRID_AXIS, None, None))
    arr = jax.jit(lambda x: x, out_shardings=out)(arr)
    return arr[:, :, :k] if k_pad != k else arr


def points_to_member_columns(mesh, xa, k: int) -> np.ndarray:
    """Inverse transpose + local fetch: this host's member columns of the
    full-domain analysis.

    The reference's ``letkf_gather_grid`` (module_mpi_util.f90:269-358):
    point-sharded ``[B, V, k]`` -> member-sharded -> the columns of this
    process's devices, assembled host-side for the member file writes.
    """
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from .mesh import GRID_AXIS

    n_dev = mesh.devices.size
    k_pad = -(-k // n_dev) * n_dev
    if k_pad != k:
        xa = jnp.concatenate(
            [xa, jnp.zeros(xa.shape[:2] + (k_pad - k,), xa.dtype)], axis=2)
    out = NamedSharding(mesh, P(None, None, GRID_AXIS))
    xa_m = jax.jit(lambda x: x, out_shardings=out)(xa)
    shards = sorted(xa_m.addressable_shards,
                    key=lambda s: s.index[2].start or 0)
    local = np.concatenate([np.asarray(s.data) for s in shards], axis=2)
    blk = member_block(k, mesh)
    return local[:, :, :max(0, blk.stop - blk.start)]


def read_members_sharded(paths: Sequence[str], cfg, reader=None):
    """Member-parallel ingest: this process reads ONLY its member slice.

    Returns ``(ens_local, sl)``: the ensemble object holding the members of
    ``sl = my_member_slice(len(paths))`` (``ens_local.k == sl length``) and
    the slice itself.  Per-variable global arrays are then assembled with
    :func:`make_member_sharded` (columns ``ens_local.field(name)``) and
    resharded to the update layout with :func:`members_to_points` — the
    reference's rank-per-member read + alltoallv
    (cwb_letkf.f90:39-52, module_mpi_util.f90:190-267).
    """
    if reader is None:
        from ..models.state import read_ensemble

        def reader(ps, c):
            return read_ensemble(ps, c, allow_subset=True)

    sl = my_member_slice(len(paths))
    local_paths = list(paths[sl])
    if not local_paths:
        raise ValueError(
            f"process owns no members ({len(paths)} members over "
            "more processes); use fewer processes or replicate")
    return reader(local_paths, cfg), sl
