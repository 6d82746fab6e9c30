"""Dense localization-weighted normal-term accumulation (matmul path).

The gather path (ops/neighbors.py + ops/whiten.py) mirrors the reference's
kd-tree-then-assemble structure (module_localization.f90:188-331,
module_letkf_core.f90:300-595): per-gridpoint top-k neighbor selection followed
by a gather of the selected obs columns.  Both primitives are slow next to a
matmul: ``lax.top_k`` over a 20k-obs platform and a per-point row gather
move far more bytes per useful flop than one dense contraction.

This module removes both, exploiting that the whitened normal terms are
*separable* in (gridpoint, obs).  With ``einv = w(r) * valid / err``
(module_letkf_core.f90:439-450: Gaussian ``w^2 = exp(-r2/2)``, Gaspari-Cohn
``w^2 = GC(r)``), the per-point solve inputs are

    a_obs[b] = sum_{v,o} einv^2 * bg_vo bg_vo^T = sum_o G(r2_bo) * BGBG[o]
    g[b]     = sum_{v,o} einv^2 * omm_vo bg_vo  = sum_o G(r2_bo) * OMBG[o]

where ``BGBG[o] = sum_v E_vo bg_vo bg_vo^T``, ``OMBG[o] = sum_v E_vo omm_vo
bg_vo`` and ``E = (valid & assim) / err^2`` fold every gridpoint-independent
factor — QC, rejection, assimilation mask, error scaling, even the observed-
variable axis — into tables built once per (platform, variable group).  The
per-chunk work is then ONE ``[C, R] @ [R, k*(k+1)]`` matmul instead of top-k +
gather.

The ``max_lz_pts`` cap (config.f90:9,30) becomes a per-row localization-radius
threshold: the largest ``t <= gc1999^2`` with ``#{o : r2_bo <= t} <= n_max``,
found by vectorized multisection on the distance matrix (a few cheap masked-
count passes).  Documented divergence (shared with ops/neighbors.py): where
kdtree2 keeps an *arbitrary* ``max_lz_pts``-subset of in-radius obs
(module_kdtree2.f90:1696-1706), this path keeps the nearest-by-radius subset;
obs tied within the multisection resolution (~cap * 16^-6) of the final
threshold may be excluded, so the kept count is <= n_max, matching the gather
path except at such ties.  Results are identical whenever the cap is not hit.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ..constants import GC1999_SQ
from ..localization import WEIGHT_GC1999, gaspari_cohn_1999
from .whiten import ObsStats

_HI = jax.lax.Precision.HIGHEST

#: float32 accumulation-matmul precision (the [C, R] @ [R, k*(k+1)] normal-
#: term contraction).  HIGH is the default: on an H100 (80GB HBM3, 700 W
#: power limit) it lowers to a TF32 cuBLAS gemm, as DEFAULT does, and runs
#: this matmul 2.7-3x faster than HIGHEST, at 1.2e-4 relative error
#: against float64 where HIGHEST has 2e-7.  The k=40 and k=96 cycles stay
#: within 2e-6 x max|xa| of the float64 oracle either way, far inside the
#: suite's 5e-4 (chip_smoke.py, precision phase).  Parity-sensitive runs
#: restore HIGHEST (config.accum_precision / :func:`set_accum_precision`).
DEFAULT_ACCUM_PRECISION = "high"
_ACC_PRECISIONS = {"high": jax.lax.Precision.HIGH,
                   "highest": jax.lax.Precision.HIGHEST}
_ACC_PREC_F32 = _ACC_PRECISIONS[DEFAULT_ACCUM_PRECISION]


def set_accum_precision(name: str) -> None:
    """Select the f32 normal-term accumulation precision.

    ``"high"`` (default; TF32 on the GPU) or ``"highest"`` (full f32).  float64
    solver runs always use HIGHEST regardless.  Clears jit caches so traced
    updates pick up the switch.
    """
    global _ACC_PREC_F32
    if name not in _ACC_PRECISIONS:
        raise ValueError(f"accum_precision must be one of "
                         f"{sorted(_ACC_PRECISIONS)}, got {name!r}")
    _ACC_PREC_F32 = _ACC_PRECISIONS[name]
    jax.clear_caches()


class DenseTables(NamedTuple):
    """Per-obs-record tables for one (platform, variable group).

    Shapes (R = records, k = members):
      bgbg:   [R, k*k]  ``sum_v E_vr * bg_vr bg_vr^T`` (row-major flattened)
      ombg:   [R, k]    ``sum_v E_vr * omm_vr bg_vr``
      nvalid: [R]       number of accepted (valid & assimilated) obs per
                        record — the reference's per-obs contribution to
                        ``total`` (letkf_core.f90:455)
    """

    bgbg: jax.Array
    ombg: jax.Array
    nvalid: jax.Array


def fuse_tables(tables: DenseTables) -> jax.Array:
    """Interleave (bgbg | ombg) into the canonical fused ``[R, k*(k+1)]``.

    Record r's row is the ``k x (k+1)`` matrix ``[BGBG_r | ombg_r]``
    flattened row-major (column ``k`` of each k-row holds the ombg
    element).  :func:`terms_from_r2` splits along the same layout, and
    :func:`fused_platform_table` emits it directly — keeping ONE layout
    everywhere lets the memory-critical paths skip this copy entirely.
    """
    r, kk = tables.bgbg.shape
    k = tables.ombg.shape[-1]
    assert kk == k * k, (tables.bgbg.shape, tables.ombg.shape)
    return jnp.concatenate(
        [tables.bgbg.reshape(r, k, k), tables.ombg[:, :, None]],
        axis=-1).reshape(r, k * (k + 1))


#: record count above which the fused-table einsum runs in row slices.
#: Building the table in one shot can keep the einsum's ``[R, k, k+1]``
#: output and the flat ``[R, k*(k+1)]`` consumer layout live at once when
#: the reshape is not a bitcast, which doubles the largest array of the
#: cycle (the table is ~7.5 GB at the production 200k-record k=96 radar
#: volume).  Slicing bounds that transient to one slice.  The slice size
#: is not yet measured on the H100.
_TABLE_ROW_SLICE = 16384


def fused_platform_table(
    stats: ObsStats,
    assim_v: Tuple[bool, ...],
    *,
    solver_dtype=jnp.float32,
    order=None,
    pad_to: int | None = None,
):
    """Build the canonical fused table directly from per-record stats.

    Returns ``(fused [P, k*(k+1)], nvalid [P])`` with ``P = pad_to or R``,
    in :func:`fuse_tables`' interleaved layout.  ``order`` (optional
    ``[R]`` int) reorders records and ``pad_to`` zero-pads — both applied
    to the SMALL ``[V, R, k]`` stats *before* the table einsum, and the
    einsum itself runs in row slices of ``_TABLE_ROW_SLICE`` (see there),
    so the only ``O(R * k^2)`` array ever materialized is the returned
    table itself.  At production radar volume with k=96 the table is
    ~7.5 GB; both the table-level gather/concat route and the one-shot
    einsum transiently double that.
    """
    active = jnp.asarray(assim_v, bool)
    if stats.omm.shape[0] != active.shape[0]:
        raise ValueError(
            f"assim mask has {active.shape[0]} vars, stats have "
            f"{stats.omm.shape[0]}")
    valid = stats.valid & active[:, None]                      # [V, R]
    err = stats.err.astype(solver_dtype)
    e = jnp.where(valid, 1.0 / (err * err), 0.0)               # [V, R]
    bg = stats.bg.astype(solver_dtype)                         # [V, R, K]
    omm = stats.omm.astype(solver_dtype)                       # [V, R]
    nvalid = jnp.sum(valid, axis=0, dtype=jnp.int32)           # [R]
    if order is not None:
        e = e[:, order]
        bg = bg[:, order]
        omm = omm[:, order]
        nvalid = nvalid[order]
    if pad_to is not None:
        pad = pad_to - e.shape[1]
        if pad:
            v = e.shape[0]
            k = bg.shape[-1]
            e = jnp.concatenate(
                [e, jnp.zeros((v, pad), e.dtype)], axis=1)
            bg = jnp.concatenate(
                [bg, jnp.zeros((v, pad, k), bg.dtype)], axis=1)
            omm = jnp.concatenate(
                [omm, jnp.zeros((v, pad), omm.dtype)], axis=1)
            nvalid = jnp.concatenate(
                [nvalid, jnp.zeros((pad,), nvalid.dtype)], axis=0)
    ebg = e[..., None] * bg
    bg_ext = jnp.concatenate([bg, omm[..., None]], axis=-1)    # [V, P, k+1]
    k = bg.shape[-1]
    p = ebg.shape[1]
    # smallest slice count with rows | P and rows % 8 == 0: aligned rows
    # keep both the [n_slices, rows, F] -> [P, F] flatten and the caller's
    # block reshape bitcasts under tiled layouts, instead of a table-sized
    # relayout copy.  No aligned divisor (small/odd P) -> one-shot einsum.
    n_slices = 1
    if p > _TABLE_ROW_SLICE:
        for n in range(-(-p // _TABLE_ROW_SLICE), min(p, 1024) + 1):
            if p % n == 0 and (p // n) % 8 == 0:
                n_slices = n
                break
    if n_slices > 1:
        rows = p // n_slices

        def one_slice(args):
            eb, bx = args                                # [V, rows, k(+1)]
            f = jnp.einsum("vrk,vrl->rkl", eb, bx, precision=_HI,
                           preferred_element_type=solver_dtype)
            return f.reshape(rows, k * (k + 1))

        fused = jax.lax.map(one_slice, (
            jnp.moveaxis(ebg.reshape(-1, n_slices, rows, k), 0, 1),
            jnp.moveaxis(bg_ext.reshape(-1, n_slices, rows, k + 1), 0, 1)))
        return fused.reshape(p, k * (k + 1)), nvalid
    fused = jnp.einsum("vrk,vrl->rkl", ebg, bg_ext,
                       precision=_HI, preferred_element_type=solver_dtype)
    return fused.reshape(-1, k * (k + 1)), nvalid


def platform_dense_tables(
    stats: ObsStats,
    assim_v: Tuple[bool, ...],
    *,
    solver_dtype=jnp.float32,
) -> DenseTables:
    """Fold QC/assimilation/error scaling into per-record outer products.

    ``E_vr = (valid & assim_v) / err^2`` absorbs everything the whitening
    applies except the distance weight (module_letkf_core.f90:429-450); the
    observed-variable axis V is contracted away entirely, so platforms with
    several observed variables (e.g. surface u,v,t,p,q) cost the same per
    chunk as single-variable ones.
    """
    active = jnp.asarray(assim_v, bool)
    if stats.omm.shape[0] != active.shape[0]:
        raise ValueError(
            f"assim mask has {active.shape[0]} vars, stats have "
            f"{stats.omm.shape[0]}")
    valid = stats.valid & active[:, None]                      # [V, R]
    err = stats.err.astype(solver_dtype)
    e = jnp.where(valid, 1.0 / (err * err), 0.0)               # [V, R]
    bg = stats.bg.astype(solver_dtype)                         # [V, R, K]
    omm = stats.omm.astype(solver_dtype)                       # [V, R]

    ebg = e[..., None] * bg
    bgbg = jnp.einsum("vrk,vrl->rkl", ebg, bg,
                      precision=_HI, preferred_element_type=solver_dtype)
    ombg = jnp.einsum("vr,vrk->rk", omm, ebg,
                      precision=_HI, preferred_element_type=solver_dtype)
    k = bg.shape[-1]
    return DenseTables(
        bgbg=bgbg.reshape(-1, k * k),
        ombg=ombg,
        nvalid=jnp.sum(valid, axis=0, dtype=jnp.int32),
    )


def _cap_threshold(r2, n_max: int, r2_cap: float, *, splits: int = 16,
                   rounds: int = 6):
    """Largest per-row threshold ``t <= r2_cap`` with ``#(r2 <= t) <= n_max``.

    Vectorized multisection: each round counts ``splits`` candidate
    thresholds in one masked-sum pass over ``r2`` (memory-bound, so counting
    several candidates per pass is ~free) and narrows the bracket by
    ``splits``x.  Resolution after ``rounds``: ``r2_cap * splits**-rounds``
    (~6e-8 relative at the defaults; ties within it fall under the
    documented cap-tie divergence, module docstring).  The invariant
    ``count(lo) <= n_max`` holds throughout (lo starts below every
    distance), so the returned threshold never overshoots the cap.

    The search is bound by the per-round full re-read of ``r2``, so fewer,
    wider rounds at the same resolution read less while the extra
    per-pass candidates ride the same read (16x5 demoted one borderline
    record per ~20 query points against the gather oracle — below the
    resolution, caught by
    tests/test_dense.py::test_dense_matches_gather_over_cap).
    """
    dtype = r2.dtype
    # derive from r2 so the carry stays device-varying under shard_map
    lo = jnp.full_like(r2[:, 0], -1.0)
    hi = jnp.full_like(r2[:, 0], r2_cap)

    over = jnp.sum(r2 <= r2_cap, axis=-1) > n_max              # [B]

    def round_fn(_, lohi):
        lo, hi = lohi
        # candidate thresholds: lo + j/splits * (hi - lo), j = 1..splits-1
        frac = (jnp.arange(1, splits, dtype=dtype) / splits)   # [S-1]
        cand = lo[:, None] + frac[None, :] * (hi - lo)[:, None]   # [B, S-1]
        counts = jnp.sum(
            r2[:, None, :] <= cand[:, :, None], axis=-1)       # [B, S-1]
        ok = counts <= n_max                                    # monotone
        n_ok = jnp.sum(ok, axis=-1)                             # [B]
        all_c = jnp.concatenate([lo[:, None], cand], axis=1)    # [B, S]
        new_lo = jnp.take_along_axis(all_c, n_ok[:, None], axis=1)[:, 0]
        hi_c = jnp.concatenate([cand, hi[:, None]], axis=1)     # [B, S]
        new_hi = jnp.take_along_axis(hi_c, n_ok[:, None], axis=1)[:, 0]
        return new_lo, new_hi

    lo, hi = jax.lax.fori_loop(0, rounds, round_fn, (lo, hi))
    return jnp.where(over, lo, jnp.asarray(r2_cap, dtype))


def terms_from_r2(
    r2,
    fused,
    nvalid,
    *,
    n_max: int,
    weight_function: int,
    r2_cap: float = GC1999_SQ,
    solver_dtype=jnp.float32,
    row_mask=None,
):
    """Capped, localization-weighted normal terms from a distance matrix.

    The shared core of the dense and bucketed paths: apply the per-row cap
    threshold (multisection), the distance weight (letkf_core.f90:443-450)
    and the single ``[C, R] @ [R, k*(k+1)]`` accumulation matmul.

    Args:
      r2:     ``[C, R]`` squared normalized distances.
      fused:  ``[R, k*(k+1)]`` interleaved (bgbg | ombg) rows
              (:func:`fuse_tables` / :func:`fused_platform_table` layout).
      nvalid: ``[R]`` accepted-obs count per record.
      row_mask: optional ``[R]`` bool — False rows can never contribute
        (the bucketed path uses it to kill padded/non-candidate blocks).

    Returns ``(a_obs [C, k, k], g [C, k], count [C])``.
    """
    c = r2.shape[0]
    kk_k = fused.shape[-1]
    # kk + k = k*(k+1) => k = largest root
    k = int((-1 + (1 + 4 * kk_k) ** 0.5) / 2)
    assert k * (k + 1) == kk_k, fused.shape

    if row_mask is not None:
        r2 = jnp.where(row_mask[None, :], r2, jnp.asarray(jnp.inf, r2.dtype))

    if r2.shape[1] > n_max:
        t = _cap_threshold(r2, n_max, r2_cap)[:, None]
    else:
        t = jnp.asarray(r2_cap, r2.dtype)
    sel = r2 <= t                                                  # [C, R]

    if weight_function == WEIGHT_GC1999:
        w2 = gaspari_cohn_1999(jnp.sqrt(jnp.where(sel, r2, 0.0)))
    else:
        w2 = jnp.exp(-0.5 * jnp.where(sel, r2, 0.0))
        # (exp(0.25*r2))^-2, letkf_core.f90:444
    gm = jnp.where(sel, w2, 0.0).astype(solver_dtype)              # [C, R]

    # f32 runs accumulate at _ACC_PREC_F32 (see there for its error on the
    # GPU); float64 parity runs keep full precision.  The count matmul
    # below stays HIGHEST — its result is truncated to int, so even
    # 1-ulp-low sums would be wrong.
    acc_prec = (_ACC_PREC_F32
                if jnp.dtype(solver_dtype) == jnp.float32 else _HI)
    out = jnp.dot(gm, fused.astype(solver_dtype),
                  precision=acc_prec, preferred_element_type=solver_dtype)
    out3 = out.reshape(c, k, k + 1)
    a_obs = out3[:, :, :k]
    g = out3[:, :, k]
    count = jnp.dot(sel.astype(jnp.float32),
                    nvalid.astype(jnp.float32),
                    precision=_HI,
                    preferred_element_type=jnp.float32).astype(jnp.int32)
    return a_obs, g, count


@jax.named_scope("dense_localize")
def dense_platform_terms(
    q_norm,
    obs_norm,
    tables: DenseTables,
    *,
    n_max: int,
    weight_function: int,
    r2_cap: float = GC1999_SQ,
    solver_dtype=jnp.float32,
):
    """Accumulate one platform's normal terms for a chunk of gridpoints.

    Args:
      q_norm:   ``[C, 3]`` localization-normalized query coordinates.
      obs_norm: ``[R, 3]`` localization-normalized obs coordinates
                (same per-variable scaling; ops/neighbors.normalize_coords).
      tables:   output of :func:`platform_dense_tables` for this variable
                group's assimilation mask.
      n_max:    the platform's ``max_lz_pts`` cap.
      weight_function: Gaussian (!=1) or Gaspari-Cohn (1)
                (module_letkf_core.f90:443).

    Returns ``(a_obs [C, k, k], g [C, k], count [C])`` — exactly the
    quantities ops/whiten.accumulate_platform_terms produces, with identical
    semantics (see module docstring for the cap-tie divergence).
    """
    q = jnp.asarray(q_norm)
    obs = jnp.asarray(obs_norm, q.dtype)
    r = obs.shape[0]

    # centered squared distances via one matmul (see ops/neighbors.py)
    center = (jnp.mean(obs, axis=0, keepdims=True) if r
              else jnp.zeros((1, 3), q.dtype))
    qc = q - center
    oc = obs - center
    dots = jnp.dot(qc, oc.T, precision=_HI, preferred_element_type=q.dtype)
    r2 = jnp.maximum(
        jnp.sum(qc * qc, axis=-1, keepdims=True)
        + jnp.sum(oc * oc, axis=-1)[None, :] - 2.0 * dots, 0.0)   # [C, R]

    fused = fuse_tables(tables)                                    # [R, kk+k]
    return terms_from_r2(
        r2, fused, tables.nvalid, n_max=n_max,
        weight_function=weight_function, r2_cap=r2_cap,
        solver_dtype=solver_dtype)
