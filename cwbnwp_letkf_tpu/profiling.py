"""Profiling & device-time breakdown: the tracing layer the reference lacks.

The reference's only instrumentation is root-rank wall-clock stage prints
(timer(), module_mpi_util.f90:66-71, used at
cwb_letkf.f90:25-80) — no per-kernel view at all.  Here:

* :func:`maybe_trace` captures a ``jax.profiler`` trace (viewable in
  XProf/TensorBoard) around any region when a directory is given;
* the hot ops are wrapped in ``jax.named_scope`` (ops/neighbors.py,
  ops/whiten.py, ops/solver.py) so the trace attributes device time to
  ``dense_localize`` / ``eigh`` / ``weight_apply``
  instead of anonymous fusions;
* :func:`device_breakdown` measures that same split without any profiler
  infrastructure by re-running each pipeline stage on a sample batch with a
  completion barrier — a quick answer to "where does the cycle's device time
  go" that works on any backend.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional, Sequence


@contextlib.contextmanager
def maybe_trace(profile_dir: Optional[str]):
    """``jax.profiler.trace(profile_dir)`` when a directory is given, else a
    no-op.  The captured trace carries the named scopes below."""
    if not profile_dir:
        yield
        return
    import jax

    with jax.profiler.trace(profile_dir):
        yield


def _best_of(fn, reps: int = 3) -> float:
    import jax

    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        best = min(best, time.perf_counter() - t0)
    return best


def device_breakdown(
    xb,
    points_xyz,
    platforms: Sequence,
    ivar: int = 0,
    *,
    weight_function: int = 0,
    inflat: Optional[float] = None,
    sample: int = 4096,
    reps: int = 3,
) -> Dict[str, float]:
    """Per-stage device time on a ``sample``-point batch (seconds, best-of).

    Stages mirror the update pipeline (ops/update.py): ``neighbor_search``
    (the dense path, ops/dense.py: distance matmul + cap threshold +
    weighted table matmul), ``eigh`` (the batched k-by-k
    eigendecomposition), ``weight_apply`` (weight transform +
    relaxation).  Each stage is timed with its inputs already device-resident
    and a completion barrier, so the numbers are additive estimates of the
    fused pipeline's cost attribution (XLA fusion across stages makes the
    true fused total slightly cheaper than the sum).
    """
    import jax
    import jax.numpy as jnp

    from .ops.dense import dense_platform_terms, platform_dense_tables
    from .ops.neighbors import normalize_coords
    from .ops.solver import (apply_weight_factors,
                             letkf_weight_factors_from_normal)

    xb = jnp.asarray(xb)[:sample]
    q = jnp.asarray(points_xyz)[:sample]
    b, k = xb.shape
    if inflat is None:
        inflat = float(k - 1)

    active = [dp for dp in platforms
              if dp.static.active(ivar) and dp.xyz.shape[0] > 0]
    if not active:
        raise ValueError("no active platform for this variable")

    out: Dict[str, float] = {}

    # -- localize_accumulate (dense path: distance matmul + cap threshold +
    #    weighted table matmul, ops/dense.py) -------------------------------
    obs_norm = [
        jax.block_until_ready(
            normalize_coords(dp.xyz, dp.static.hclr[ivar],
                             dp.static.vclr[ivar]))
        for dp in active
    ]
    q_norm = [
        jax.block_until_ready(
            normalize_coords(q, dp.static.hclr[ivar], dp.static.vclr[ivar]))
        for dp in active
    ]
    tables = [
        jax.block_until_ready(jax.jit(platform_dense_tables)(
            dp.stats, dp.static.assim_mask(ivar)))
        for dp in active
    ]

    @jax.jit
    def run_accumulate(q_norm):
        a = jnp.zeros((b, k, k), jnp.float32)
        g = jnp.zeros((b, k), jnp.float32)
        for dp, qn, on, tab in zip(active, q_norm, obs_norm, tables):
            a_p, g_p, _ = dense_platform_terms(
                qn, on, tab, n_max=dp.static.max_lz_pts,
                weight_function=weight_function)
            a, g = a + a_p, g + g_p
        return a, g

    a_obs, g = jax.block_until_ready(run_accumulate(q_norm))
    out["localize_accumulate_s"] = _best_of(
        lambda: run_accumulate(q_norm), reps)

    # -- eigh ----------------------------------------------------------------
    def run_eigh():
        return letkf_weight_factors_from_normal(a_obs, g, inflat)

    lam, v, g2 = jax.block_until_ready(run_eigh())
    out["eigh_s"] = _best_of(run_eigh, reps)

    # -- weight_apply --------------------------------------------------------
    def run_apply():
        return apply_weight_factors(lam, v, g2, xb)

    jax.block_until_ready(run_apply())
    out["weight_apply_s"] = _best_of(run_apply, reps)

    total = sum(out.values())
    out["total_s"] = total
    out["points"] = b
    for name in ("localize_accumulate", "eigh", "weight_apply"):
        out[f"{name}_frac"] = (out[f"{name}_s"] / total) if total else 0.0
    return out
