"""On-device fixed-radius neighbor search: the batched kd-tree replacement.

The reference builds one kdtree2 per (obs platform, analysis variable) in
localization-normalized coordinates and does a serial fixed-radius query per
gridpoint (module_localization.f90:35-167,188-331 over
module_kdtree2.f90:1118-1179).  Pointer-chasing tree walks are hostile to
wide batched execution, so here the search is a *batched distance
computation + capped top-k*:

    r2[b, o] = |q_b - x_o|^2           (one [B,3]x[3,N] matmul per chunk)
    keep the <= gc1999^2 hits,         (module_localization.f90:202)
    capped at the n_max nearest        (max_lz_pts, config.f90:9,30)

All coordinates are pre-normalized by the per-variable localization radii
(1/(hclr*1e3) horizontally, 1/(vclr*1e3) vertically, or a 2-D search when
vclr < 0 — module_localization.f90:148-157), so the search radius is the
constant ``gc1999^2`` for every platform.

Documented divergence from the reference: when more than ``max_lz_pts`` obs
fall inside the ball, kdtree2 keeps the first ``max_lz_pts`` encountered in
tree-traversal order — an arbitrary subset (module_kdtree2.f90:1696-1706,
the library itself warns the result "is NOT the smallest ball").  Here the
``n_max`` *nearest* are kept instead, which is deterministic and
scientifically preferable; results are identical whenever the cap is not hit.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import GC1999_SQ


class NeighborSet(NamedTuple):
    """Padded fixed-k neighbor lists for a batch of query points.

    idx:  ``[B, n_max]`` int32 obs indices (arbitrary where ``~mask``).
    r2:   ``[B, n_max]`` squared normalized distances (``inf`` where ``~mask``).
    mask: ``[B, n_max]`` bool — True for real in-radius neighbors.
    """

    idx: jax.Array
    r2: jax.Array
    mask: jax.Array


def normalize_coords(xyz, hclr_km: float, vclr_km: float):
    """Scale (x, y, z) meters by the localization radii, km -> m.

    Mirrors module_localization.f90:76-82,148-157: horizontal coords divided
    by ``hclr*1e3``; vertical divided by ``vclr*1e3`` when ``vclr > 0``, else
    dropped (2-D localization) — implemented by scaling z to exactly 0 so it
    never contributes to distances.
    """
    xyz = jnp.asarray(xyz)
    h_inv = 1.0 / (hclr_km * 1e3)
    v_inv = 1.0 / (vclr_km * 1e3) if vclr_km > 0.0 else 0.0
    scale = jnp.asarray([h_inv, h_inv, v_inv], dtype=xyz.dtype)
    return xyz * scale


@jax.named_scope("neighbor_search")
def _chunk_neighbors(q, obs_t, obs_sq, n_max, r2_cap):
    """One chunk: q [C,3] against obs_t [3,N] -> capped top-k in-radius."""
    dtype = q.dtype
    # |q-o|^2 = |q|^2 + |o|^2 - 2 q.o ; coords are pre-centered (see
    # radius_neighbors) so the f32 cancellation stays benign.
    qsq = jnp.sum(q * q, axis=-1, keepdims=True)
    # HIGHEST: the GPU would otherwise run the f32 multiply in TF32,
    # mis-ranking neighbors near the radius and shifting exp(r^2)-based weights by ~1%.
    dots = jnp.dot(q, obs_t, precision=jax.lax.Precision.HIGHEST,
                   preferred_element_type=dtype)
    r2 = jnp.maximum(qsq + obs_sq[None, :] - 2.0 * dots, 0.0)
    neg = jnp.where(r2 <= r2_cap, -r2, -jnp.inf)
    vals, idx = jax.lax.top_k(neg, n_max)
    mask = vals > -jnp.inf
    return NeighborSet(
        idx=idx.astype(jnp.int32),
        r2=jnp.where(mask, -vals, jnp.inf),
        mask=mask,
    )


@functools.partial(jax.jit, static_argnames=("n_max", "chunk"))
def radius_neighbors(
    query_xyz,
    obs_xyz,
    *,
    n_max: int,
    r2_cap: float = GC1999_SQ,
    obs_valid: Optional[jax.Array] = None,
    chunk: int = 4096,
) -> NeighborSet:
    """Find up to ``n_max`` nearest obs within ``sqrt(r2_cap)`` per query.

    Args:
      query_xyz: ``[B, 3]`` normalized gridpoint coordinates.
      obs_xyz:   ``[N, 3]`` normalized obs coordinates (same scaling).
      n_max:     cap per query (the platform's ``max_lz_pts``).
      r2_cap:    squared search radius (default ``gc1999^2``,
                 module_localization.f90:202).
      obs_valid: optional ``[N]`` bool — pre-QC'd obs only.
      chunk:     queries per on-device tile (bounds the [chunk, N] buffer).

    The obs axis is padded to a lane multiple with far-away sentinels, and the
    query batch to a ``chunk`` multiple; both paddings are masked exactly.
    """
    q = jnp.asarray(query_xyz)
    obs = jnp.asarray(obs_xyz, dtype=q.dtype)
    b, n = q.shape[0], obs.shape[0]

    # Center both point sets on the obs centroid: distances are translation
    # invariant, and small magnitudes keep the matmul expansion accurate.
    center = jnp.mean(obs, axis=0, keepdims=True) if n else jnp.zeros((1, 3), q.dtype)
    q = q - center
    obs = obs - center

    # Sentinel for padded/invalid obs: far enough that r2 >> r2_cap for any
    # realistic normalized query (O(1e2)), small enough that its square (1e30)
    # and cross terms stay finite in float32.
    n_pad = max(int(np.ceil(max(n, n_max, 1) / 128)) * 128, n_max)
    big = jnp.asarray(1e15, q.dtype)
    obs_p = jnp.full((n_pad, 3), big, dtype=q.dtype).at[:n].set(obs)
    if obs_valid is not None:
        obs_p = jnp.where(
            jnp.pad(obs_valid, (0, n_pad - n), constant_values=False)[:, None],
            obs_p,
            big,
        )
    obs_t = obs_p.T
    obs_sq = jnp.sum(obs_p * obs_p, axis=-1)

    b_pad = int(np.ceil(max(b, 1) / chunk)) * chunk
    q_p = jnp.zeros((b_pad, 3), dtype=q.dtype).at[:b].set(q)

    result = jax.lax.map(
        lambda qc: _chunk_neighbors(qc, obs_t, obs_sq, n_max, r2_cap),
        q_p.reshape(b_pad // chunk, chunk, 3),
    )
    return NeighborSet(
        idx=result.idx.reshape(b_pad, n_max)[:b],
        r2=result.r2.reshape(b_pad, n_max)[:b],
        mask=result.mask.reshape(b_pad, n_max)[:b],
    )
