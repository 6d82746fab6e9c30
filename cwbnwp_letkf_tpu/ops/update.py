"""Per-variable LETKF update over a batch of analysis points.

This is the batched replacement for the reference's hot serial triple loop
(module_letkf_core.f90:209-240): instead of one gridpoint at a
time per MPI rank, all points are processed as chunked device batches —
neighbor search (ops/neighbors.py), whitened normal-term accumulation
(ops/whiten.py) and the batched ensemble-space solve (ops/solver.py) each run
over thousands of points at once, so the k-by-k solves run as batched
matmuls and the gathers vectorize.

The caller supplies points as flat arrays; the grid/stagger bookkeeping lives
in models/ (mirroring letkf_driver's dispatch, letkf_core.f90:74-206).
"""
from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..obs.base import PlatformObs, PlatformStatic
from .bucketed import (auto_block_size, bucket_platform,
                       bucketed_platform_terms, default_max_blocks, hilbert3,
                       required_max_blocks)
from .dense import dense_platform_terms, platform_dense_tables
from .neighbors import normalize_coords, radius_neighbors
from .solver import letkf_solve_from_normal, letkf_solve_group_from_normal
from .whiten import ObsStats, accumulate_platform_terms, platform_obs_stats

#: normal-term accumulation backends:
#: "dense"    — one matmul against per-record outer-product tables
#:              (ops/dense.py; the fast path at small-to-mid R);
#: "bucketed" — Hilbert-blocked dense with per-chunk spatial block culling
#:              (ops/bucketed.py; the scalable path for radar-volume R);
#: "gather"   — top-k neighbor search + obs gather (ops/neighbors.py +
#:              ops/whiten.py; mirrors the reference's kd-tree structure);
#: "auto"     — per platform: bucketed when R >= BUCKET_MIN_RECORDS, else
#:              dense.
#: Identical results whenever the obs cap is not hit (and, for bucketed, no
#: candidate-block overflow); at the cap all keep the nearest subset,
#: differing only at distance ties (see ops/dense.py).
ACCUMULATE_METHODS = ("dense", "gather", "bucketed", "auto")

#: record count above which "auto" switches a platform from the all-records
#: dense matmul to the block-culled path.  The dense path's per-chunk cost
#: grows linearly in R, bucketed's with local obs density only; the
#: crossover is not yet measured on the H100.
BUCKET_MIN_RECORDS = 8192


class BucketBudget(NamedTuple):
    """A planned bucketed-culling budget: valid ONLY for its block size.

    ``plan_max_blocks`` sizes blocks adaptively from the eager obs density
    (ops/bucketed.auto_block_size); a traced rebuild (inside jit/shard_map,
    where the density is unknowable) would otherwise pick the fixed
    fallback size, silently changing the blocking the budget was computed
    for — the budget therefore carries its block size and the rebuild uses
    it verbatim.
    """

    block_size: int
    max_blocks: int


class DevicePlatform(NamedTuple):
    """One platform's device-ready obs data + precomputed per-obs stats.

    ``cache`` memoizes derived per-(assim-mask, radii, dtype) products —
    dense tables and bucketed blockings — across variable groups and cycles.
    Legitimate because they depend only on the immutable stats and the
    static config (unlike the reference's kd-trees, which embed radii and
    must be rebuilt per variable, localization.f90:35-167; our distance
    normalization happens at query time).
    """

    static: PlatformStatic
    xyz: jax.Array          # [R, 3] meters
    stats: ObsStats
    cache: dict | None = None    # None = caching off (e.g. traced copies)


def prepare_platform(
    static: PlatformStatic,
    obs: PlatformObs,
    *,
    norain_value: float = -5.0,
) -> DevicePlatform:
    """Precompute the gridpoint-independent obs statistics once per platform.

    (The reference recomputes these per gridpoint per variable inside
    letkf_yoyb — hoisting them is pure win and bitwise-neutral.)
    """
    stats = platform_obs_stats(
        obs.obs,
        obs.hdxb,
        obs.error,
        obs.qc,
        static.err_muti,
        static.err_rej,
        is_dbz=static.is_dbz,
        norain_value=norain_value,
    )
    return DevicePlatform(static=static, xyz=jnp.asarray(obs.xyz),
                          stats=stats, cache={})


def _resolve_kind(method: str, dp: "DevicePlatform") -> str:
    if method == "auto":
        return ("bucketed" if dp.xyz.shape[0] >= BUCKET_MIN_RECORDS
                else "dense")
    return method


def _platform_accumulators(active, kinds, iv, max_blocks, solver_dtype,
                           q_chunks=None):
    """Resolve each active platform to its accumulation backend + payload.

    ``q_chunks``: the ``[n_chunks, chunk, 3]`` Hilbert-ordered points the
    update will run over.  When concrete (not under an enclosing jit trace),
    the bucketed block budget comes from the exact prepass
    (ops/bucketed.required_max_blocks) — overflow-free by construction;
    under a trace it falls back to the heuristic (watch the diagnostics).
    """
    concrete = q_chunks is not None and not isinstance(q_chunks,
                                                       jax.core.Tracer)
    accs = []
    for (dp, on), kind in zip(active, kinds):
        st = dp.static
        if kind == "gather":
            accs.append((dp, on, "gather", None))
            continue
        # The cache may be READ inside a jit trace (its values are concrete
        # arrays captured as constants — e.g. populated by an earlier eager
        # call or plan_max_blocks); it must only be WRITTEN with concrete
        # values, so stores are skipped when `on` is a tracer.
        cache = dp.cache
        storable = cache is not None and not isinstance(on, jax.core.Tracer)
        mask = st.assim_mask(iv)
        dkey = ("dense", mask, jnp.dtype(solver_dtype).name)
        tab = cache.get(dkey) if cache is not None else None
        if tab is None:
            tab = platform_dense_tables(dp.stats, mask,
                                        solver_dtype=solver_dtype)
            if storable:
                cache[dkey] = tab
        if kind == "bucketed":
            mb_req = (max_blocks.get(st.name)
                      if isinstance(max_blocks, dict) else max_blocks)
            # resolve the block size BEFORE the cache key so the eager plan
            # and a later budget-following jitted rebuild share one entry
            # (auto_block_size returns the same adaptive size eagerly that
            # the plan baked into the budget; under a trace the budget
            # supplies it)
            if isinstance(mb_req, BucketBudget):
                bs = mb_req.block_size
            else:
                bs = auto_block_size(on)
            bkey = ("bucketed", mask, jnp.dtype(solver_dtype).name,
                    st.hclr[iv], st.vclr[iv], bs)
            bp = cache.get(bkey) if cache is not None else None
            if bp is None:
                bp = bucket_platform(on, tab, block_size=bs)
                if storable:
                    cache[bkey] = bp
            if isinstance(mb_req, BucketBudget):
                # planned for exactly this blocking (block_size matches by
                # construction above); n_blocks caps it for tiny platforms
                mb = min(mb_req.max_blocks, bp.n_blocks)
            elif mb_req:
                mb = mb_req
            elif concrete:
                flat = q_chunks.reshape(-1, 3)
                qn = normalize_coords(flat, st.hclr[iv], st.vclr[iv])
                needed = int(required_max_blocks(
                    qn.reshape(q_chunks.shape), bp.centers, bp.radii))
                # quantize up to multiples of 16 to bound recompiles
                mb = min(bp.n_blocks, max(16, -(-needed // 16) * 16))
            else:
                mb = default_max_blocks(bp.n_blocks)
            accs.append((dp, on, "bucketed", (bp, mb)))
        else:
            accs.append((dp, on, "dense", tab))
    return [_materialize_acc(a) for a in accs]


def _materialize_acc(acc):
    """Pin each platform's tables/blocking OUTSIDE the chunk loop.

    When the tables are built in-program from jit-argument obs arrays,
    XLA otherwise fuses the table einsum into every chunk's candidate
    gathers, recomputing table rows per chunk (measured 6.1x on the
    cycle's dbz leg; ops/cycle._materialize_plan is the same fix).  The
    barrier has no effect when the payload came concrete from the cache.
    """
    dp, on, kind, payload = acc
    b = jax.lax.optimization_barrier
    if kind == "bucketed":
        bp, mb = payload
        payload = (jax.tree_util.tree_map(b, bp), mb)
    elif kind == "dense" and payload is not None:
        payload = jax.tree_util.tree_map(b, payload)
    return (dp, on, kind, payload)


def _accumulate_chunk(qc, accs, iv, weight_function, solver_dtype, chunk, k):
    """Sum all platforms' normal terms for one chunk of points."""
    a_obs = jnp.zeros((qc.shape[0], k, k), solver_dtype)
    g = jnp.zeros((qc.shape[0], k), solver_dtype)
    cnt = jnp.zeros((qc.shape[0],), jnp.int32)
    ovf = jnp.zeros((), jnp.int32)
    for dp, on, kind, payload in accs:
        st = dp.static
        qn = normalize_coords(qc, st.hclr[iv], st.vclr[iv])
        if kind == "bucketed":
            bp, mb = payload
            a_p, g_p, c_p, o_p = bucketed_platform_terms(
                qn, bp, n_max=st.max_lz_pts,
                weight_function=weight_function, max_blocks=mb,
                solver_dtype=solver_dtype)
            ovf = ovf + o_p
        elif kind == "dense":
            a_p, g_p, c_p = dense_platform_terms(
                qn, on, payload, n_max=st.max_lz_pts,
                weight_function=weight_function,
                solver_dtype=solver_dtype)
        else:
            nb = radius_neighbors(qn, on, n_max=st.max_lz_pts, chunk=chunk)
            a_p, g_p, c_p = accumulate_platform_terms(
                nb, dp.stats, st.assim_mask(iv), weight_function,
                solver_dtype=solver_dtype)
        a_obs = a_obs + a_p
        g = g + g_p
        cnt = cnt + c_p
    return a_obs, g, cnt, ovf


def _maybe_morton_perm(q, point_order, active, kinds, iv):
    """Hilbert-order the analysis points so chunks are spatially compact.

    Block culling only pays off when a chunk's points are close together
    *in localization distance*; raw WRF flattening gives long thin stripes.
    Keys are computed in the normalized coordinates of the largest bucketed
    platform (the one whose culling matters most).  Returns (perm, inv) or
    (None, None) when ordering is off.
    """
    bucketed = [dp for (dp, _), kind in zip(active, kinds)
                if kind == "bucketed"]
    use = (point_order == "morton"
           or (point_order == "auto" and bool(bucketed)))
    if not use:
        return None, None
    if bucketed:
        dp = max(bucketed, key=lambda d: d.xyz.shape[0])
        st = dp.static
        keys = hilbert3(normalize_coords(q, st.hclr[iv], st.vclr[iv]))
    else:
        keys = hilbert3(q)
    perm = jnp.argsort(keys)
    return perm, jnp.argsort(perm)


def plan_max_blocks(
    points_xyz,
    platforms: Sequence[DevicePlatform],
    ivar: int,
    *,
    chunk: int = 4096,
    method: str = "auto",
    point_order: str = "auto",
    solver_dtype=jnp.float32,
    n_shards: int = 1,
) -> dict:
    """Precompute per-platform bucketed block budgets for a jitted update.

    The exact prepass needs concrete points, so it cannot run inside an
    enclosing ``jax.jit``.  Call this once eagerly with the same
    ``points_xyz``/``chunk``/``method`` the update will use, then pass the
    returned ``{platform_name: max_blocks}`` dict as ``max_blocks`` — the
    whole update then traces into ONE program (the eager path dispatches
    dozens of small ops per call, which costs real wall time on remote
    backends).

    ``n_shards``: plan for the SPMD path — ``parallel.update`` splits the
    (padded) batch contiguously over the mesh and each device Hilbert-orders
    and chunks its LOCAL shard independently, producing a different chunking
    than the global order; budgets planned on the global chunking can
    silently undersize a local chunk (dropping obs with only the overflow
    counter to show for it).  Pass the mesh size to replicate the per-shard
    chunking exactly and take the max over shards.
    """
    q = jnp.asarray(points_xyz)
    b = q.shape[0]
    if n_shards > 1:
        b_pad = -(-b // n_shards) * n_shards
        # same padding parallel.update applies: copies of the last real
        # point (spatially inert — inside the last shard's bbox)
        q_all = jnp.broadcast_to(q[-1:], (b_pad, 3)).at[:b].set(q)
        local = q_all.reshape(n_shards, b_pad // n_shards, 3)
        merged: dict = {}
        for si in range(n_shards):
            one = plan_max_blocks(
                local[si], platforms, ivar, chunk=chunk, method=method,
                point_order=point_order, solver_dtype=solver_dtype)
            for name, bb in one.items():
                prev = merged.get(name)
                # block_size is identical across shards (obs replicated);
                # the merged budget is the worst shard's need
                merged[name] = bb if prev is None else BucketBudget(
                    bb.block_size, max(prev.max_blocks, bb.max_blocks))
        return merged
    active = [(dp, normalize_coords(dp.xyz, dp.static.hclr[ivar],
                                    dp.static.vclr[ivar]))
              for dp in platforms
              if dp.static.active(ivar) and dp.xyz.shape[0] > 0]
    kinds = [_resolve_kind(method, dp) for dp, _ in active]
    perm, _ = _maybe_morton_perm(q, point_order, active, kinds, ivar)
    if perm is not None:
        q = q[perm]
    chunk = min(chunk, max(b, 1))
    n_chunks = -(-b // chunk)
    b_pad = n_chunks * chunk
    q_p = jnp.broadcast_to(q[-1:], (b_pad, 3)).at[:b].set(q)
    accs = _platform_accumulators(
        active, kinds, ivar, None, solver_dtype,
        q_chunks=q_p.reshape(n_chunks, chunk, 3))
    # the budget is only meaningful for the blocking it was computed on, so
    # it carries the (eagerly, density-adaptively chosen) block size; a
    # traced rebuild inside jit/shard_map re-buckets with exactly that size
    return {dp.static.name: BucketBudget(payload[0].block_size, payload[1])
            for dp, _, kind, payload in accs if kind == "bucketed"}


def update_points(
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
    max_blocks: int | dict | None = None,
    point_order: str = "auto",
    return_diagnostics: bool = False,
):
    """LETKF-update analysis variable ``ivar`` at ``B`` points.

    Args:
      xb:         ``[B, k]`` background ensemble values.
      points_xyz: ``[B, 3]`` Lambert x, y (m) + altitude (m)
                  (letkf_core.f90:211-214).
      platforms:  prepared obs platforms (see :func:`prepare_platform`).
      ivar:       position of this variable in ``var_update`` — indexes every
                  per-variable config table (the reference convention).
      inflat:     ``(k-1)/multi_infl(ivar)`` (letkf_core.f90:68).
      chunk:      points per device batch (bounds peak memory).
      method:     normal-term accumulation backend (ACCUMULATE_METHODS).
      max_blocks: bucketed path's candidate-block budget (None = heuristic).
      point_order: "morton" / "linear" / "auto" (morton iff any platform is
                  bucketed) — chunk spatial compactness for block culling.
      return_diagnostics: also return ``{"bucket_overflow": int32}`` —
                  candidate blocks dropped by the ``max_blocks`` budget
                  (0 == bucketed result exactly matches dense).

    Returns ``xa`` ``[B, k]``; points with no accepted local obs keep their
    background (letkf_core.f90:220-234).
    """
    xb = jnp.asarray(xb)
    q = jnp.asarray(points_xyz)
    b, k = xb.shape
    if q.shape != (b, 3):
        raise ValueError(
            f"points_xyz must be [{b}, 3] to match xb {xb.shape}, "
            f"got {q.shape}")
    if method not in ACCUMULATE_METHODS:
        raise ValueError(f"method must be one of {ACCUMULATE_METHODS}")

    active: List[Tuple[DevicePlatform, jax.Array]] = []
    for dp in platforms:
        if dp.static.active(ivar) and dp.xyz.shape[0] > 0:
            on = normalize_coords(
                dp.xyz, dp.static.hclr[ivar], dp.static.vclr[ivar])
            active.append((dp, on))
    if not active:
        return (xb, {"bucket_overflow": jnp.zeros((), jnp.int32),
                     "ns_residual": jnp.zeros((), jnp.float32)}) \
            if return_diagnostics else xb
        # build_tree fails for every platform -> variable skipped
        # (letkf_core.f90:63-66)

    kinds = [_resolve_kind(method, dp) for dp, _ in active]
    perm, inv = _maybe_morton_perm(q, point_order, active, kinds, ivar)
    if perm is not None:
        q = q[perm]
        xb = xb[perm]

    chunk = min(chunk, max(b, 1))
    n_chunks = -(-b // chunk)
    b_pad = n_chunks * chunk
    # pad with the last real point (not zeros): padded points must stay
    # spatially inside the chunk for the block-cull prepass/dmin
    q_p = jnp.broadcast_to(q[-1:], (b_pad, 3)).at[:b].set(q)
    xb_p = jnp.zeros((b_pad, k), xb.dtype).at[:b].set(xb)

    accs = _platform_accumulators(
        active, kinds, ivar, max_blocks, solver_dtype,
        q_chunks=q_p.reshape(n_chunks, chunk, 3))

    def body(args):
        qc, xbc = args
        a_obs, g, cnt, ovf = _accumulate_chunk(
            qc, accs, ivar, weight_function, solver_dtype, chunk, k)
        xa, sdiag = letkf_solve_from_normal(
            a_obs, g, xbc, inflat, cnt > 0,
            use_rtpp=use_rtpp, rtpp_alpha=rtpp_alpha,
            use_rtps=use_rtps, rtps_alpha=rtps_alpha,
            solver_dtype=solver_dtype, return_diagnostics=True)
        return xa, ovf, sdiag["ns_residual"]

    xa, ovf, resid = jax.lax.map(
        body,
        (q_p.reshape(n_chunks, chunk, 3), xb_p.reshape(n_chunks, chunk, k)),
    )
    xa = xa.reshape(b_pad, k)[:b]
    if perm is not None:
        xa = xa[inv]
    if return_diagnostics:
        return xa, {"bucket_overflow": jnp.sum(ovf),
                    "ns_residual": jnp.max(resid)}
    return xa


def update_points_group(
    xb,
    points_xyz,
    platforms: Sequence[DevicePlatform],
    ivars: Sequence[int],
    *,
    inflats: Sequence[float],
    weight_function: int,
    rtpp_alpha: Sequence[float],
    rtps_alpha: Sequence[float],
    solver_dtype=jnp.float32,
    chunk: int = 4096,
    method: str = "auto",
    max_blocks: int | dict | None = None,
    point_order: str = "auto",
    return_diagnostics: bool = False,
):
    """Fused LETKF update of a *group* of analysis variables at ``B`` points.

    All variables in the group must share their analysis points (same
    stagger) and their localization signature — per-platform
    ``(hclr, vclr, assim_mask)`` identical for every ``ivar`` in ``ivars``
    (the caller groups by exactly that key; see driver.py).  Under that
    condition the local obs set, the whitened normal terms and hence the
    eigendecomposition are variable-independent: neighbor search, gather and
    eigh run ONCE and only the O(k^2) weight application repeats per
    variable.  The reference redoes the entire pipeline per variable
    (letkf_core.f90:59-297); this fusion is its headline algorithmic cost
    reduction.

    Args:
      xb:         ``[B, V, k]`` background for the V grouped variables.
      points_xyz: ``[B, 3]`` Lambert x, y (m) + altitude (m).
      ivars:      positions in ``var_update`` (ivars[0] supplies the shared
                  localization config).
      inflats:    ``[V]`` per-variable ``(k-1)/multi_infl``.
      rtpp_alpha / rtps_alpha: ``[V]`` relaxation strengths, 0 = disabled.

    Returns ``xa`` ``[B, V, k]``.
    """
    xb = jnp.asarray(xb)
    q = jnp.asarray(points_xyz)
    b, n_vars, k = xb.shape
    if q.shape != (b, 3):
        raise ValueError(
            f"points_xyz must be [{b}, 3] to match xb {xb.shape}, "
            f"got {q.shape}")
    if not (len(ivars) == len(inflats) == len(rtpp_alpha)
            == len(rtps_alpha) == n_vars):
        raise ValueError("per-variable arg lengths must match xb's V axis")
    if method not in ACCUMULATE_METHODS:
        raise ValueError(f"method must be one of {ACCUMULATE_METHODS}")
    iv0 = ivars[0]

    active: List[Tuple[DevicePlatform, jax.Array]] = []
    for dp in platforms:
        if dp.static.active(iv0) and dp.xyz.shape[0] > 0:
            on = normalize_coords(
                dp.xyz, dp.static.hclr[iv0], dp.static.vclr[iv0])
            active.append((dp, on))
    if not active:
        return (xb, {"bucket_overflow": jnp.zeros((), jnp.int32),
                     "ns_residual": jnp.zeros((), jnp.float32)}) \
            if return_diagnostics else xb

    kinds = [_resolve_kind(method, dp) for dp, _ in active]
    perm, inv = _maybe_morton_perm(q, point_order, active, kinds, iv0)
    if perm is not None:
        q = q[perm]
        xb = xb[perm]

    inflats = tuple(float(x) for x in inflats)
    rtpp_alpha = tuple(float(x) for x in rtpp_alpha)
    rtps_alpha = tuple(float(x) for x in rtps_alpha)

    chunk = min(chunk, max(b, 1))
    n_chunks = -(-b // chunk)
    b_pad = n_chunks * chunk
    # pad with the last real point (not zeros): padded points must stay
    # spatially inside the chunk for the block-cull prepass/dmin
    q_p = jnp.broadcast_to(q[-1:], (b_pad, 3)).at[:b].set(q)
    xb_p = jnp.zeros((b_pad, n_vars, k), xb.dtype).at[:b].set(xb)

    accs = _platform_accumulators(
        active, kinds, iv0, max_blocks, solver_dtype,
        q_chunks=q_p.reshape(n_chunks, chunk, 3))

    def body(args):
        qc, xbc = args
        a_obs, g, cnt, ovf = _accumulate_chunk(
            qc, accs, iv0, weight_function, solver_dtype, chunk, k)
        xa, sdiag = letkf_solve_group_from_normal(
            a_obs, g, xbc, inflats, cnt > 0,
            rtpp_alpha=rtpp_alpha, rtps_alpha=rtps_alpha,
            solver_dtype=solver_dtype, return_diagnostics=True)
        return xa, ovf, sdiag["ns_residual"]

    xa, ovf, resid = jax.lax.map(
        body,
        (q_p.reshape(n_chunks, chunk, 3),
         xb_p.reshape(n_chunks, chunk, n_vars, k)),
    )
    xa = xa.reshape(b_pad, n_vars, k)[:b]
    if perm is not None:
        xa = xa[inv]
    if return_diagnostics:
        return xa, {"bucket_overflow": jnp.sum(ovf),
                    "ns_residual": jnp.max(resid)}
    return xa
