"""Local-obs assembly: QC gates, outlier rejection, R-localized whitening.

Batched re-design of ``letkf_yoyb`` (module_letkf_core.f90:300-595).  The reference walks a linked list per gridpoint, re-deriving every
observation's ensemble statistics (mean, perturbations, spread) and rejection
decision at *every* gridpoint that sees it.  Those quantities only depend on
the observation itself, so here they are computed **once per platform** in one
vectorized pass (:func:`platform_obs_stats`); the per-gridpoint work reduces
to a gather + distance-weight multiply + matmul accumulation
(:func:`accumulate_platform_terms`).

Whitening invariant: an obs slot that is masked (outside radius, padded, QC-
rejected, or not assimilated for this analysis variable) contributes an exact
zero column to ``Yb Yb^T`` and ``Yb yo`` — equivalent to absence (tested in
test_solver.py::test_padded_zero_obs_columns_are_noops).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp

from ..localization import obs_error_inv_weight
from .neighbors import NeighborSet

#: full-f32 multiplies (an f32 matmul on the GPU may otherwise run in TF32)
_HI = jax.lax.Precision.HIGHEST


class ObsStats(NamedTuple):
    """Per-observation (gridpoint-independent) preprocessed quantities.

    Shapes (V = observed vars per record, R = records, K = members):
      omm:   [V, R]    obs minus ensemble-mean H(xb)   (letkf_core.f90:433)
      bg:    [V, R, K] H(xb) perturbations             (letkf_core.f90:430-432)
      err:   [V, R]    effective obs error (file error * err_muti; radar:
                       the namelist error — letkf_core.f90:435,502)
      valid: [V, R]    QC gate & outlier rejection passed
    """

    omm: jax.Array
    bg: jax.Array
    err: jax.Array
    valid: jax.Array


def platform_obs_stats(
    obs,
    hdxb,
    error,
    qc,
    err_muti: Tuple[float, ...],
    err_rej: Tuple[float, ...],
    *,
    is_dbz: bool = False,
    norain_value: float = -5.0,
) -> ObsStats:
    """Vectorized per-obs statistics + QC (letkf_core.f90:429-437,497-510).

    Args:
      obs/hdxb/error/qc: ``[V, R]`` / ``[V, R, K]`` / ``[V, R]`` / ``[V, R, K]``.
      err_muti/err_rej: per-observed-variable scalars (config.f90:17-18).
      is_dbz: apply the reflectivity no-rain special cases
        (letkf_core.f90:504-510): the outlier rejection is skipped when
        ``obs == norain_value``, and the obs is dropped entirely when both
        obs and ensemble-mean equal ``norain_value``.
    """
    obs = jnp.asarray(obs)
    hdxb = jnp.asarray(hdxb)
    k = hdxb.shape[-1]
    dtype = hdxb.dtype

    # mean = sum(bg) * nmember_inv (letkf_core.f90:431 with param.f90:130)
    mean = jnp.mean(hdxb, axis=-1)
    bg = hdxb - mean[..., None]
    omm = obs - mean
    # std = sqrt(bg.bg / (k-1)) (letkf_core.f90:434)
    std = jnp.sqrt(jnp.sum(bg * bg, axis=-1) / (k - 1.0))
    err = jnp.asarray(error) * jnp.asarray(err_muti, dtype)[:, None]
    rej = jnp.asarray(err_rej, dtype)[:, None]

    # QC gate: any member qc >= 0 (letkf_core.f90:429); radar has qc == 0.
    qc_ok = jnp.any(jnp.asarray(qc) >= 0, axis=-1)
    outlier = jnp.abs(omm) > jnp.sqrt(std * std + err * err) * rej
    if is_dbz:
        norain = jnp.asarray(norain_value, dtype)
        rejected = (outlier & (obs != norain)) | ((obs == norain) & (mean == norain))
    else:
        rejected = outlier
    return ObsStats(omm=omm, bg=bg, err=err, valid=qc_ok & ~rejected)


@jax.named_scope("gather_whiten")
def accumulate_platform_terms(
    nb: NeighborSet,
    stats: ObsStats,
    assim_v: Tuple[bool, ...],
    weight_function: int,
    *,
    solver_dtype=jnp.float32,
):
    """Gather one platform's local obs and accumulate its normal terms.

    For a batch of ``B`` gridpoints with neighbor lists ``nb`` over this
    platform's records, returns::

      a_obs [B, k, k] = Yb'_p Yb'_p^T    g [B, k] = Yb'_p yo'_p    count [B]

    where the whitened slots are ``yo' = (obs - mean) * error_inv`` and
    ``yb' = bg * error_inv`` (letkf_core.f90:439-453) and ``error_inv``
    carries the distance localization (localization.py).  ``count`` is the
    number of accepted obs (the reference's ``total``, letkf_core.f90:455) —
    zero-weight but accepted obs still count, matching the reference's
    skip-vs-solve decision (letkf_core.f90:542).

    ``assim_v[v]`` statically disables observed variables not assimilated
    into the current analysis variable (letkf_core.f90:355-363,429).
    """
    idx = nb.idx  # [B, n_max]
    active_vars = [v for v, a in enumerate(assim_v) if a]
    if not active_vars:
        raise ValueError("accumulate_platform_terms called with no active vars")

    v_act = len(active_vars)
    r = stats.omm.shape[-1]
    k = stats.bg.shape[-1]
    b, n = idx.shape

    # Fuse the observed-variable axis into the slot axis: gather all active
    # variables' tables with one flattened index (v * R + idx), then run one
    # [B, v*n, k] einsum pair instead of v separate small ones.
    av = jnp.asarray(active_vars, jnp.int32)
    idx_f = (av[:, None, None] * r
             + idx[None, :, :].astype(jnp.int32))            # [V, B, n]
    idx_f = jnp.transpose(idx_f, (1, 0, 2)).reshape(b, v_act * n)

    # mode="clip": sentinel-padded neighbor slots carry indices past R; they
    # are masked below, but the default fill mode would inject NaNs that
    # survive multiplication by zero.
    omm = jnp.take(stats.omm.reshape(-1), idx_f, mode="clip")       # [B, Vn]
    err = jnp.take(stats.err.reshape(-1), idx_f, mode="clip")
    val = jnp.take(stats.valid.reshape(-1), idx_f, mode="clip")
    val = val & jnp.tile(nb.mask, (1, v_act))
    bg = jnp.take(stats.bg.reshape(-1, k), idx_f, axis=0,
                  mode="clip")                                       # [B, Vn, k]

    r2 = jnp.tile(nb.r2, (1, v_act))
    einv = obs_error_inv_weight(r2, err, weight_function)
    einv = jnp.where(val, einv, 0.0).astype(solver_dtype)

    yo = omm.astype(solver_dtype) * einv                             # [B, Vn]
    yb = bg.astype(solver_dtype) * einv[..., None]                   # [B, Vn, k]

    a_obs = jnp.einsum("bnk,bnl->bkl", yb, yb,
                       precision=_HI, preferred_element_type=solver_dtype)
    g = jnp.einsum("bnk,bn->bk", yb, yo,
                   precision=_HI, preferred_element_type=solver_dtype)
    count = jnp.sum(val, axis=-1, dtype=jnp.int32)
    return a_obs, g, count
