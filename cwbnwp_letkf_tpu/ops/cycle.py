"""Fused multi-group LETKF cycle: shared obs geometry across variable groups.

The production namelist's variable groups (U/V at hclr=36 km, W at 12, T/Qv
at 24, MU/P/PH at 24 2-D, hydrometeors at dbz 8) differ ONLY in localization
radii and assimilation masks — they cull, gather and accumulate against the
SAME obs tables.  Round 3 ran one full accumulation pipeline per group
(ops/update.update_points_group), so the synop+vr tables were re-culled and
re-gathered four times per cycle; the reference redoes even more — its
entire per-variable pipeline, kd-tree build included
(module_letkf_core.f90:59-297, module_localization.f90:35).

This module runs ONE traced program for all groups that share analysis
points, sharing per platform:

  * the Hilbert point ordering and chunking (computed in the platform's
    WIDEST client metric),
  * the candidate-block culling and the block gathers: a block candidate in
    the widest metric is a superset of every client group's candidates —
    with ``r2_g = dh2/hclr_g^2 + dv2/vclr_g^2``, the widest radii give the
    SMALLEST normalized distances, so ``r2_wide <= r2_g`` pointwise and any
    in-ball (point, obs) pair of any group is in the wide ball,
  * the per-mask dense tables (groups sharing an assimilation mask share
    the table object).

Only the genuinely group-specific work repeats per group: the 3-wide
distance matmul (cheap), the cap threshold, the localization weights, and
the ``[C, R] @ [R, k*(k+1)]`` accumulation matmul (irreducible — each group
has its own weight matrix).

The accumulation runs on SUB-chunks (default 512 points): candidate sets
shrink superlinearly with chunk spatial extent (a Hilbert subchunk's
bounding box plus the localization ball covers far fewer blocks than a
4096-point chunk's), cutting the per-point matmul width several-fold at
production radar volumes.  The k-by-k solves then run per OUTER chunk
(default 4096) where the batched Newton-Schulz iteration is efficient.
Subchunk sizing is a trade, not a monotone win: narrow subchunks cull
tighter, but at the k=96 production radar volume the per-subchunk
candidate-table GATHER grows and wide subchunks amortize it, so the
production-width leg runs subchunk=chunk=2048.  The widths 512 and 2048
are not yet measured on the H100.

Equivalence: same math as update_points_group per group; results agree to
float32 accumulation-order tolerance (the candidate sets differ only by
provably-zero-weight rows; tests/test_cycle.py checks allclose and the
zero-overflow exactness argument of ops/bucketed.py applies unchanged).
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Sequence, Tuple

import jax
import jax.numpy as jnp

from ..constants import GC1999_SQ
from .bucketed import hilbert3
from .dense import fused_platform_table, terms_from_r2
from .neighbors import normalize_coords
from .solver import letkf_solve_cycle_from_normal
from .update import BUCKET_MIN_RECORDS, BucketBudget, DevicePlatform

_HI = jax.lax.Precision.HIGHEST


class CycleGroup(NamedTuple):
    """One fused variable group inside a cycle call (all share points)."""

    ivars: Tuple[int, ...]
    inflats: Tuple[float, ...]
    rtpp_alpha: Tuple[float, ...]
    rtps_alpha: Tuple[float, ...]


class CycleBlocking(NamedTuple):
    """Wide-metric Hilbert blocking of one platform's records.

    Like ops/bucketed.BucketedPlatform but metric-agnostic: coordinates are
    kept RAW (meters) so every client group can normalize with its own
    radii; only the culling geometry (centers, radii) lives in the wide
    metric.  ``fused_by_mask`` / ``nvalid_by_mask`` hold one reordered
    table (and its accepted-obs counts — masks gate acceptance, so counts
    are per-mask too) per distinct client assimilation mask; both are
    empty on a geometry-only blocking (budget planning needs only the
    culling geometry, never the tables — at production radar volume with
    k=96 the table is ~7.5 GB, see ops/dense.fused_platform_table).

    Shapes (NB = blocks, S = block size, F = k*(k+1)):
      xyz_raw:        [NB*S, 3]  raw coords, Hilbert(wide) order
      fused_by_mask:  tuple of [NB, S, F]
      nvalid_by_mask: tuple of [NB, S]
      rec_mask:       [NB, S]
      centers_w:      [NB, 3]   wide-normalized block centers
      radii_w:        [NB]      wide-normalized covering radii
    """

    xyz_raw: jax.Array
    fused_by_mask: Tuple[jax.Array, ...]
    nvalid_by_mask: Tuple[jax.Array, ...]
    rec_mask: jax.Array
    centers_w: jax.Array
    radii_w: jax.Array

    @property
    def n_blocks(self) -> int:
        return self.rec_mask.shape[0]

    @property
    def block_size(self) -> int:
        return self.rec_mask.shape[1]


class PlatformPlan(NamedTuple):
    """One platform's resolved role in a cycle call."""

    dp: DevicePlatform
    kind: str                        # 'dense' | 'bucketed'
    clients: Tuple[int, ...]         # group indices this platform feeds
    wide_h: float                    # widest client hclr (km)
    wide_v: float                    # widest client vclr (km; -1 = 2-D)
    mask_idx: Tuple[int, ...]        # per client: index into tables/fused
    tables: Tuple[Tuple[jax.Array, jax.Array], ...]
                                     # per distinct mask: (fused [R, F],
                                     # nvalid [R]) — dense path only
    centers: Tuple[jax.Array, ...]   # per client: [1, 3] group-normalized
                                     # record centroid (dense.py centering)
    blocking: CycleBlocking | None   # bucketed path only
    budget: int | None               # candidate-block budget (bucketed)


def _wide_metric(st, groups, clients) -> Tuple[float, float]:
    """Widest (hclr, vclr) over the client groups; vclr<=0 wins (2-D)."""
    hs = [st.hclr[groups[g].ivars[0]] for g in clients]
    vs = [st.vclr[groups[g].ivars[0]] for g in clients]
    wide_v = -1.0 if any(v <= 0 for v in vs) else max(vs)
    return max(hs), wide_v


def _cycle_blocking(dp, masks, wide_h, wide_v, block_size,
                    presorted: bool = False,
                    solver_dtype=jnp.float32,
                    geometry_only: bool = False) -> CycleBlocking:
    """Hilbert-block the records in the wide metric, raw coords retained.

    ``presorted=True`` asserts the caller already ordered the records by
    ``hilbert3(normalize_coords(xyz, wide_h, wide_v))`` and skips the
    device-side reorder (any fixed order is VALID — blocks are built from
    the given order — merely slower to cull if not Hilbert; sortedness is
    a performance contract, not a correctness one).  Reorder and padding
    are applied to the small per-record STATS before the table einsum
    (ops/dense.fused_platform_table), so peak memory is one table — the
    k=96 production radar volume fits where a table-level gather/pad
    (transiently 2x ~7.5 GB) did not.  ``geometry_only`` skips the tables
    entirely (budget planning touches only centers/radii).
    """
    obs_raw = jnp.asarray(dp.xyz)
    obs_w = normalize_coords(obs_raw, wide_h, wide_v)
    r = obs_raw.shape[0]
    order = None
    if presorted:
        obs_raw_s = obs_raw
        obs_w_s = obs_w
    else:
        order = jnp.argsort(hilbert3(obs_w))
        obs_raw_s = obs_raw[order]
        obs_w_s = obs_w[order]

    s = block_size
    nb = -(-r // s)
    pad = nb * s - r
    rec_mask = jnp.arange(nb * s) < r
    if pad:
        obs_raw_s = jnp.concatenate(
            [obs_raw_s, jnp.broadcast_to(obs_raw_s[-1:], (pad, 3))], axis=0)
        obs_w_s = jnp.concatenate(
            [obs_w_s, jnp.broadcast_to(obs_w_s[-1:], (pad, 3))], axis=0)

    fused_by_mask: Tuple[jax.Array, ...] = ()
    nvalid_by_mask: Tuple[jax.Array, ...] = ()
    if not geometry_only:
        pairs = [fused_platform_table(dp.stats, m, solver_dtype=solver_dtype,
                                      order=order, pad_to=nb * s)
                 for m in masks]
        fused_by_mask = tuple(f.reshape(nb, s, -1) for f, _ in pairs)
        nvalid_by_mask = tuple(nv.reshape(nb, s) for _, nv in pairs)

    obs_wb = obs_w_s.reshape(nb, s, 3)
    mask_b = rec_mask.reshape(nb, s)
    n_real = jnp.maximum(jnp.sum(mask_b, axis=1, keepdims=True), 1)
    centers = (jnp.sum(jnp.where(mask_b[..., None], obs_wb, 0.0), axis=1)
               / n_real)
    d2 = jnp.sum((obs_wb - centers[:, None, :]) ** 2, axis=-1)
    radii = jnp.sqrt(jnp.max(jnp.where(mask_b, d2, 0.0), axis=1))
    return CycleBlocking(
        xyz_raw=obs_raw_s,
        fused_by_mask=fused_by_mask,
        nvalid_by_mask=nvalid_by_mask,
        rec_mask=mask_b,
        centers_w=centers,
        radii_w=radii,
    )


def _resolve_plans(
    platforms: Sequence[DevicePlatform],
    groups: Sequence[CycleGroup],
    *,
    method: str,
    solver_dtype,
    max_blocks,
    obs_presorted: bool = False,
    geometry_only: bool = False,
) -> List[PlatformPlan]:
    """Build every active platform's cycle plan (cached where concrete).

    ``geometry_only`` (budget planning) skips every fused table: dense
    platforms get empty ``tables`` and bucketed blockings carry only the
    culling geometry — planning at production radar volume must not pay
    (or even fit) the ~7.5 GB k=96 table.
    """
    from .bucketed import auto_block_size, default_max_blocks

    plans: List[PlatformPlan] = []
    for dp in platforms:
        st = dp.static
        clients = tuple(
            gi for gi, grp in enumerate(groups) if st.active(grp.ivars[0]))
        if not clients or dp.xyz.shape[0] == 0:
            continue
        kind = method
        if method == "auto":
            kind = ("bucketed" if dp.xyz.shape[0] >= BUCKET_MIN_RECORDS
                    else "dense")
        # distinct assimilation masks -> shared tables
        masks: List[tuple] = []
        mask_idx = []
        for gi in clients:
            m = st.assim_mask(groups[gi].ivars[0])
            if m not in masks:
                masks.append(m)
            mask_idx.append(masks.index(m))
        cache = dp.cache
        storable = cache is not None and not isinstance(
            dp.xyz, jax.core.Tracer)
        dname = jnp.dtype(solver_dtype).name
        tables = []
        if kind == "dense" and not geometry_only:
            for m in masks:
                key = ("fused", m, dname)
                t = cache.get(key) if cache is not None else None
                if t is None:
                    t = fused_platform_table(dp.stats, m,
                                             solver_dtype=solver_dtype)
                    if storable:
                        cache[key] = t
                tables.append(t)
        wide_h, wide_v = _wide_metric(st, groups, clients)
        centers = []
        for gi in clients:
            iv = groups[gi].ivars[0]
            on = normalize_coords(dp.xyz, st.hclr[iv], st.vclr[iv])
            centers.append(jnp.mean(on, axis=0, keepdims=True))
        blocking = None
        budget = None
        if kind == "bucketed":
            mb_req = (max_blocks.get(st.name)
                      if isinstance(max_blocks, dict) else max_blocks)
            if isinstance(mb_req, BucketBudget):
                bs = mb_req.block_size
            else:
                bs = auto_block_size(
                    normalize_coords(dp.xyz, wide_h, wide_v))
            bkey = ("cycle", tuple(masks), dname, wide_h, wide_v, bs,
                    obs_presorted, geometry_only)
            blocking = cache.get(bkey) if cache is not None else None
            if blocking is None and geometry_only and cache is not None:
                # a full blocking is a superset of the geometry-only one
                full = cache.get(bkey[:-1] + (False,))
                if full is not None:
                    blocking = full
            if blocking is None:
                blocking = _cycle_blocking(dp, masks, wide_h, wide_v, bs,
                                           presorted=obs_presorted,
                                           solver_dtype=solver_dtype,
                                           geometry_only=geometry_only)
                if storable:
                    cache[bkey] = blocking
            if isinstance(mb_req, BucketBudget):
                budget = min(mb_req.max_blocks, blocking.n_blocks)
            elif mb_req:
                budget = int(mb_req)
            else:
                budget = default_max_blocks(blocking.n_blocks)
        plans.append(PlatformPlan(
            dp=dp, kind=kind, clients=clients, wide_h=wide_h, wide_v=wide_v,
            mask_idx=tuple(mask_idx), tables=tuple(tables),
            centers=tuple(centers), blocking=blocking, budget=budget))
    return plans


def _materialize_plan(plan: PlatformPlan) -> PlatformPlan:
    """Force the plan's tables/blocking to materialize BEFORE the chunk loop.

    When the fused tables are built in-program (obs arrays as jit
    arguments — the production pattern, so multi-GB tables are never
    baked into the program as constants), XLA's fusion otherwise inlines
    the table einsum into every subchunk's candidate-block gather,
    recomputing table rows inside the loop.  ``optimization_barrier`` pins
    the producer outside ``lax.map`` without forcing a host sync.
    """
    b = jax.lax.optimization_barrier
    return plan._replace(
        tables=tuple((b(f), b(nv)) for f, nv in plan.tables),
        centers=tuple(b(c) for c in plan.centers),
        blocking=(None if plan.blocking is None
                  else jax.tree_util.tree_map(b, plan.blocking)),
    )


def _group_r2(q_raw, obs_raw, st, ivar, center):
    """Squared normalized distances exactly as the per-group dense path.

    Normalizes raw coords with this group's radii, centers on the
    platform-wide group-normalized record centroid, and expands the
    distance via one 3-wide matmul (ops/dense.dense_platform_terms).
    """
    qn = normalize_coords(q_raw, st.hclr[ivar], st.vclr[ivar]) - center
    on = normalize_coords(obs_raw, st.hclr[ivar], st.vclr[ivar]) - center
    dots = jnp.dot(qn, on.T, precision=_HI, preferred_element_type=qn.dtype)
    return jnp.maximum(
        jnp.sum(qn * qn, axis=-1, keepdims=True)
        + jnp.sum(on * on, axis=-1)[None, :] - 2.0 * dots, 0.0)


def _bucketed_cycle_terms(q_raw, plan, groups, weight_function, solver_dtype):
    """Shared cull + gather, per-client terms, for one subchunk.

    Returns ``(per-client list of (a, g, cnt), overflow)``.
    """
    cb = plan.blocking
    st = plan.dp.static
    nb, s = cb.n_blocks, cb.block_size
    m = min(plan.budget, nb)

    qw = normalize_coords(q_raw, plan.wide_h, plan.wide_v)
    d2 = jnp.sum((qw[:, None, :] - cb.centers_w[None, :, :]) ** 2, axis=-1)
    dmin = jnp.sqrt(jnp.min(d2, axis=0))                            # [NB]
    reach = jnp.sqrt(jnp.asarray(GC1999_SQ, dmin.dtype)) + cb.radii_w
    cand = dmin <= reach
    score = jnp.where(cand, dmin - cb.radii_w, jnp.inf)
    _, idx = jax.lax.top_k(-score, m)
    keep = cand[idx]
    overflow = (jnp.sum(cand.astype(jnp.int32))
                - jnp.sum(keep.astype(jnp.int32)))

    obs_c = cb.xyz_raw.reshape(nb, s, 3)[idx].reshape(m * s, 3)
    row_mask = (keep[:, None] & cb.rec_mask[idx]).reshape(m * s)
    fused_c = {mi: cb.fused_by_mask[mi][idx].reshape(m * s, -1)
               for mi in set(plan.mask_idx)}
    nvalid_c = {mi: cb.nvalid_by_mask[mi][idx].reshape(m * s)
                for mi in set(plan.mask_idx)}

    outs = []
    for ci, gi in enumerate(plan.clients):
        iv = groups[gi].ivars[0]
        r2 = _group_r2(q_raw, obs_c, st, iv, plan.centers[ci])
        outs.append(terms_from_r2(
            r2, fused_c[plan.mask_idx[ci]], nvalid_c[plan.mask_idx[ci]],
            n_max=st.max_lz_pts, weight_function=weight_function,
            solver_dtype=solver_dtype, row_mask=row_mask))
    return outs, overflow


def _dense_cycle_terms(q_raw, plan, groups, weight_function, solver_dtype):
    """All-records accumulation per client group (small platforms)."""
    st = plan.dp.static
    outs = []
    for ci, gi in enumerate(plan.clients):
        iv = groups[gi].ivars[0]
        r2 = _group_r2(q_raw, plan.dp.xyz, st, iv, plan.centers[ci])
        fused, nvalid = plan.tables[plan.mask_idx[ci]]
        outs.append(terms_from_r2(
            r2, fused, nvalid, n_max=st.max_lz_pts,
            weight_function=weight_function, solver_dtype=solver_dtype))
    return outs


def plan_cycle_budgets(
    points_xyz,
    platforms: Sequence[DevicePlatform],
    groups: Sequence[CycleGroup],
    *,
    chunk: int = 4096,
    subchunk: int = 512,
    method: str = "auto",
    point_order: str = "auto",
    solver_dtype=jnp.float32,
    n_shards: int = 1,
    obs_presorted: bool = False,
) -> Dict[str, BucketBudget]:
    """Exact per-platform candidate budgets for the cycle's SUBCHUNKS.

    The cycle culls in each platform's wide client metric at subchunk
    granularity, so budgets from ops/update.plan_max_blocks (per-group
    metric, outer-chunk granularity) do not transfer.  Same contract
    otherwise: run eagerly with the same points/chunking the cycle will
    use; ``n_shards`` replicates the SPMD per-shard chunking and takes the
    worst shard (see ops/update.plan_max_blocks).
    """
    from .bucketed import required_max_blocks

    q = jnp.asarray(points_xyz)
    b = q.shape[0]
    if n_shards > 1:
        b_pad = -(-b // n_shards) * n_shards
        q_all = jnp.broadcast_to(q[-1:], (b_pad, 3)).at[:b].set(q)
        local = q_all.reshape(n_shards, b_pad // n_shards, 3)
        merged: Dict[str, BucketBudget] = {}
        for si in range(n_shards):
            one = plan_cycle_budgets(
                local[si], platforms, groups, chunk=chunk,
                subchunk=subchunk, method=method, point_order=point_order,
                solver_dtype=solver_dtype, obs_presorted=obs_presorted)
            for name, bb in one.items():
                prev = merged.get(name)
                merged[name] = bb if prev is None else BucketBudget(
                    bb.block_size, max(prev.max_blocks, bb.max_blocks))
        return merged

    plans = _resolve_plans(platforms, groups, method=method,
                           solver_dtype=solver_dtype, max_blocks=None,
                           obs_presorted=obs_presorted, geometry_only=True)
    perm = _cycle_point_perm(q, plans, point_order)
    if perm is not None:
        q = q[perm]
    sub = min(subchunk, max(b, 1))
    n_sub = -(-b // sub)
    q_p = jnp.broadcast_to(q[-1:], (n_sub * sub, 3)).at[:b].set(q)
    q_chunks = q_p.reshape(n_sub, sub, 3)
    out: Dict[str, BucketBudget] = {}
    for plan in plans:
        if plan.kind != "bucketed":
            continue
        cb = plan.blocking
        qn = normalize_coords(q_chunks.reshape(-1, 3),
                              plan.wide_h, plan.wide_v)
        needed = int(required_max_blocks(
            qn.reshape(n_sub, sub, 3), cb.centers_w, cb.radii_w))
        mb = min(cb.n_blocks, max(16, -(-needed // 16) * 16))
        out[plan.dp.static.name] = BucketBudget(cb.block_size, mb)
    return out


def _cycle_point_perm(q, plans, point_order):
    """Hilbert point ordering in the largest bucketed platform's wide metric."""
    bucketed = [p for p in plans if p.kind == "bucketed"]
    use = (point_order == "morton"
           or (point_order == "auto" and bool(bucketed)))
    if not use:
        return None
    if bucketed:
        p = max(bucketed, key=lambda p: p.dp.xyz.shape[0])
        keys = hilbert3(normalize_coords(q, p.wide_h, p.wide_v))
    else:
        keys = hilbert3(q)
    return jnp.argsort(keys)


def update_points_cycle(
    xb,
    points_xyz,
    platforms: Sequence[DevicePlatform],
    groups: Sequence[CycleGroup],
    *,
    weight_function: int,
    solver_dtype=jnp.float32,
    chunk: int = 4096,
    subchunk: int = 512,
    method: str = "auto",
    max_blocks: Dict[str, BucketBudget] | int | None = None,
    point_order: str = "auto",
    obs_presorted: bool = False,
    return_diagnostics: bool = False,
):
    """Fused LETKF update of SEVERAL variable groups at shared points.

    Args:
      xb:     ``[B, V_total, k]`` background; the V axis concatenates the
              groups' variables in ``groups`` order.
      points_xyz: ``[B, 3]`` shared analysis points (same stagger for all
              groups — the driver splits staggers into separate calls).
      groups: per-group ivars/inflats/relaxations; ``ivars[0]`` supplies the
              group's localization signature as in update_points_group.
      max_blocks: per-platform budgets from :func:`plan_cycle_budgets`
              (None = heuristic; watch the overflow diagnostic).
      chunk / subchunk: solve batch size / accumulation cull granularity.

    Returns ``xa [B, V_total, k]`` (+ diagnostics dict like
    update_points_group).  Semantics per group are exactly
    update_points_group's; see module docstring for the equivalence
    argument.
    """
    xb = jnp.asarray(xb)
    q = jnp.asarray(points_xyz)
    b, v_tot, k = xb.shape
    if q.shape != (b, 3):
        raise ValueError(f"points_xyz must be [{b}, 3], got {q.shape}")
    sizes = [len(g.ivars) for g in groups]
    if sum(sizes) != v_tot:
        raise ValueError(
            f"xb V axis {v_tot} != sum of group sizes {sizes}")
    col0 = [0]
    for s_ in sizes:
        col0.append(col0[-1] + s_)

    plans = _resolve_plans(platforms, groups, method=method,
                           solver_dtype=solver_dtype, max_blocks=max_blocks,
                           obs_presorted=obs_presorted)
    plans = [_materialize_plan(p) for p in plans]
    n_groups = len(groups)

    perm = _cycle_point_perm(q, plans, point_order)
    if perm is not None:
        inv = jnp.argsort(perm)
        q = q[perm]
        xb = xb[perm]

    chunk = min(chunk, max(b, 1))
    sub = min(subchunk, chunk)
    chunk = -(-chunk // sub) * sub        # outer chunk | subchunk
    n_chunks = -(-b // chunk)
    b_pad = n_chunks * chunk
    q_p = jnp.broadcast_to(q[-1:], (b_pad, 3)).at[:b].set(q)
    xb_p = jnp.zeros((b_pad, v_tot, k), xb.dtype).at[:b].set(xb)

    def inner(qs):
        """Accumulate every group's normal terms for one subchunk."""
        c = qs.shape[0]
        a_all = jnp.zeros((n_groups, c, k, k), solver_dtype)
        g_all = jnp.zeros((n_groups, c, k), solver_dtype)
        cnt_all = jnp.zeros((n_groups, c), jnp.int32)
        ovf = jnp.zeros((), jnp.int32)
        for plan in plans:
            if plan.kind == "bucketed":
                outs, o = _bucketed_cycle_terms(
                    qs, plan, groups, weight_function, solver_dtype)
                ovf = ovf + o
            else:
                outs = _dense_cycle_terms(
                    qs, plan, groups, weight_function, solver_dtype)
            for ci, gi in enumerate(plan.clients):
                a_p, g_p, c_p = outs[ci]
                a_all = a_all.at[gi].add(a_p)
                g_all = g_all.at[gi].add(g_p)
                cnt_all = cnt_all.at[gi].add(c_p)
        return a_all, g_all, cnt_all, ovf

    def body(args):
        qc, xbc = args
        n_sub = qc.shape[0] // sub
        a, g, cnt, ovf = jax.lax.map(
            inner, qc.reshape(n_sub, sub, 3))
        # [n_sub, G, sub, ...] -> [G, chunk, ...]
        a = jnp.swapaxes(a, 0, 1).reshape(n_groups, qc.shape[0], k, k)
        g = jnp.swapaxes(g, 0, 1).reshape(n_groups, qc.shape[0], k)
        cnt = jnp.swapaxes(cnt, 0, 1).reshape(n_groups, qc.shape[0])
        # solves for ALL groups, NS launches stacked by inflation value
        # (two launches per chunk under the production namelist instead of
        # six; see solver.letkf_solve_cycle_from_normal)
        xa_cols, sdiag = letkf_solve_cycle_from_normal(
            [a[gi] for gi in range(n_groups)],
            [g[gi] for gi in range(n_groups)],
            [xbc[:, col0[gi]:col0[gi + 1], :] for gi in range(n_groups)],
            [grp.inflats for grp in groups],
            [cnt[gi] > 0 for gi in range(n_groups)],
            rtpp_alpha_groups=[grp.rtpp_alpha for grp in groups],
            rtps_alpha_groups=[grp.rtps_alpha for grp in groups],
            solver_dtype=solver_dtype, return_diagnostics=True)
        return (jnp.concatenate(xa_cols, axis=1), jnp.sum(ovf),
                sdiag["ns_residual"])

    xa, ovf, resid = jax.lax.map(
        body,
        (q_p.reshape(n_chunks, chunk, 3),
         xb_p.reshape(n_chunks, chunk, v_tot, k)),
    )
    xa = xa.reshape(b_pad, v_tot, k)[:b]
    if perm is not None:
        xa = xa[inv]
    if return_diagnostics:
        return xa, {"bucket_overflow": jnp.sum(ovf),
                    "ns_residual": jnp.max(resid)}
    return xa
