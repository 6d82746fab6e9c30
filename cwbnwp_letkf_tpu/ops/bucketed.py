"""Spatially-bucketed dense localization for large obs sets.

The plain dense path (ops/dense.py) materializes the full ``[C, R]``
distance matrix and runs the ``[C, R] @ [R, k*(k+1)]`` accumulation over
*all* records — perfect up to R ~ tens of thousands, but a production radar
volume is 10^5-10^6 obs, where nearly all of that work multiplies zeros
(everything outside the ~gc1999 localization ball contributes nothing;
the reference's kd-tree search, module_kdtree2.f90:1118-1179, is O(log R)
per point for the same reason).

Batched, block-granular culling instead of a tree:

  build (once per platform x variable group; :func:`bucket_platform`):
    - Hilbert-sort the records on their localization-normalized coordinates
      so consecutive records are spatial neighbors,
    - cut the sorted order into fixed blocks of ``block_size`` records,
    - precompute per-block centers and covering radii, and the reordered
      dense tables (ops/dense.platform_dense_tables rows).

  query (per chunk; :func:`bucketed_platform_terms`):
    - one tiny ``[C, NB]`` distance matrix to the block centers,
    - a block is a candidate iff some chunk point can be within the
      localization radius of some record in it:
      ``min_c d(q_c, center_b) <= sqrt(r2_cap) + radius_b``,
    - gather the ``max_blocks`` best-scoring candidate blocks (block-granular
      gathers are contiguous row ranges — cheap, unlike per-record gathers),
    - run the shared capped accumulation (ops/dense.terms_from_r2) on the
      ``[C, max_blocks * block_size]`` candidate set only.

Exactness: identical to the dense path whenever no candidate block is
dropped (``overflow == 0``) — culled blocks are provably outside every
point's localization ball, and the cap/weight math is literally shared
code.  If more than ``max_blocks`` blocks are candidates, the farthest
(by center distance minus covering radius) are dropped and ``overflow``
counts them; callers size ``max_blocks``/``chunk`` so overflow stays 0
(chunks of Hilbert-ordered gridpoints are spatially compact, so the
candidate count is set by local obs density, not R).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import GC1999_SQ
from .dense import DenseTables, fuse_tables, terms_from_r2

_HI = jax.lax.Precision.HIGHEST


def _part1by2(x):
    """Spread the low 10 bits of x so there are 2 zero bits between each."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x30000FF
    x = (x | (x << 8)) & 0x300F00F
    x = (x | (x << 4)) & 0x30C30C3
    x = (x | (x << 2)) & 0x9249249
    return x


def morton3(xyz, *, bbox_min=None, bbox_max=None, bits: int = 10):
    """30-bit Morton (Z-order) key per 3-D point; higher = later in Z curve.

    Uses CUBICAL cells: one common cell size = (largest axis extent) /
    ``2**bits`` for all three axes, so chunks of consecutive keys are
    compact in the metric of the input coordinates.  (Per-axis
    quantization would stretch the curve along short axes — e.g. a WRF
    domain's shallow z — making "consecutive" points spatially distant
    there.)  Feed localization-NORMALIZED coordinates to get chunks compact
    in localization distance.  Degenerate axes quantize to cell 0.
    """
    xyz = jnp.asarray(xyz)
    if bbox_min is None:
        bbox_min = jnp.min(xyz, axis=0)
    if bbox_max is None:
        bbox_max = jnp.max(xyz, axis=0)
    n = (1 << bits) - 1
    cell_size = jnp.maximum(jnp.max(bbox_max - bbox_min), 1e-30) / (n + 1)
    cell = jnp.clip((xyz - bbox_min) / cell_size, 0, n).astype(jnp.uint32)
    return (_part1by2(cell[:, 0])
            | (_part1by2(cell[:, 1]) << 1)
            | (_part1by2(cell[:, 2]) << 2))


def hilbert3(xyz, *, bbox_min=None, bbox_max=None, bits: int = 10):
    """30-bit Hilbert-curve key per 3-D point (cubical cells, like morton3).

    Unlike the Z-order curve, the Hilbert curve is CONTINUOUS: consecutive
    keys are always adjacent cells, so equal-size segments of the sorted
    order have compact bounding boxes with no octant-boundary jumps — the
    worst-chunk candidate-block count (what the prepass budget pays for)
    drops accordingly.  Axes -> transposed-Hilbert via Skilling's algorithm
    (J. Skilling, "Programming the Hilbert curve", AIP Conf. Proc. 707,
    2004), fully vectorized: the bit-level loops are static Python over
    ``bits`` levels, elementwise jnp ops over points.
    """
    xyz = jnp.asarray(xyz)
    if bbox_min is None:
        bbox_min = jnp.min(xyz, axis=0)
    if bbox_max is None:
        bbox_max = jnp.max(xyz, axis=0)
    n = (1 << bits) - 1
    cell_size = jnp.maximum(jnp.max(bbox_max - bbox_min), 1e-30) / (n + 1)
    cell = jnp.clip((xyz - bbox_min) / cell_size, 0, n).astype(jnp.uint32)
    x = [cell[:, 0], cell[:, 1], cell[:, 2]]

    # inverse-undo excess work (Skilling: AxestoTranspose)
    q = 1 << (bits - 1)
    while q > 1:
        p = jnp.uint32(q - 1)
        for i in range(3):
            hit = (x[i] & q).astype(bool)
            t = (x[0] ^ x[i]) & p
            x[0] = jnp.where(hit, x[0] ^ p, x[0] ^ t)
            x[i] = jnp.where(hit, x[i], x[i] ^ t)
        q >>= 1
    # Gray encode
    for i in range(1, 3):
        x[i] = x[i] ^ x[i - 1]
    t = jnp.zeros_like(x[0])
    q = 1 << (bits - 1)
    while q > 1:
        t = jnp.where((x[2] & q).astype(bool), t ^ jnp.uint32(q - 1), t)
        q >>= 1
    x = [xi ^ t for xi in x]
    # interleave the transposed-form bits: X[0] holds the MOST significant
    # bit of each 3-bit level
    return (_part1by2(x[0]) << 2) | (_part1by2(x[1]) << 1) | _part1by2(x[2])


class BucketedPlatform(NamedTuple):
    """Block-sorted obs records for one (platform, variable group).

    Shapes (NB = blocks, S = block_size, F = k*(k+1)):
      obs_norm: [NB*S, 3]  normalized coords, Hilbert order; padding repeats
                           the last real record's coords (masked out by
                           rec_mask, so pads can never occupy cap slots)
      fused:    [NB, S, F] reordered (bgbg | ombg) rows
      nvalid:   [NB, S]    accepted-obs count per record (0 on pads)
      rec_mask: [NB, S]    True on real records, False on padding
      centers:  [NB, 3]    per-block coordinate mean (real records only)
      radii:    [NB]       covering radius: max distance center -> record
      center:   [1, 3]     global mean of the REAL records — the same
                           centering point ops/dense.py uses, so per-pair
                           r2 values (hence cap thresholds) are identical
                           between the two paths
    """

    obs_norm: jax.Array
    fused: jax.Array
    nvalid: jax.Array
    rec_mask: jax.Array
    centers: jax.Array
    radii: jax.Array
    center: jax.Array

    @property
    def n_blocks(self) -> int:
        return self.fused.shape[0]

    @property
    def block_size(self) -> int:
        return self.fused.shape[1]


def auto_block_size(obs_norm, *, target_radius: float = 1.25,
                    lo: int = 64, hi: int = 1024) -> int:
    """Density-adaptive block size: covering radius ~ ``target_radius``.

    A block's covering radius adds to every candidacy test's reach
    (``sqrt(r2_cap) + radius_b``), so blocks must stay small relative to
    the localization ball (radius ~3.65 normalized units) REGARDLESS of obs
    density — sparse obs over a large domain need far fewer records per
    block than a dense radar volume.  Targets a block cube of side
    ``2 * target_radius / sqrt(d)`` at the observed density (d = number of
    non-degenerate axes), clamped to [lo, hi] and rounded to 64s.
    """
    if isinstance(obs_norm, jax.core.Tracer):
        # under an enclosing jit the density is unknowable at trace time;
        # callers wanting the adaptive size build (or plan) eagerly first
        return 256
    obs = np.asarray(obs_norm)
    ext = obs.max(0) - obs.min(0)
    live = ext[ext > 1e-9]
    if live.size == 0:
        return lo
    side = 2.0 * target_radius / np.sqrt(live.size)
    density = obs.shape[0] / np.prod(live)
    s = int(density * side ** live.size)
    return int(np.clip(-(-s // 64) * 64, lo, hi))


def bucket_platform(
    obs_norm,
    tables: DenseTables,
    *,
    block_size: int | None = None,
) -> BucketedPlatform:
    """Hilbert-sort records and cut them into fixed spatial blocks.

    ``block_size=None`` picks a density-adaptive size
    (:func:`auto_block_size`).
    """
    obs = jnp.asarray(obs_norm)
    r = obs.shape[0]
    if r == 0:
        raise ValueError("cannot bucket an empty platform")
    if block_size is None:
        block_size = auto_block_size(obs)
    center = jnp.mean(obs, axis=0, keepdims=True)   # == dense.py's center
    order = jnp.argsort(hilbert3(obs))
    obs_s = obs[order]
    fused = fuse_tables(tables)[order]
    nvalid = tables.nvalid[order]

    s = block_size
    nb = -(-r // s)
    pad = nb * s - r
    rec_mask = jnp.arange(nb * s) < r
    if pad:
        obs_s = jnp.concatenate(
            [obs_s, jnp.broadcast_to(obs_s[-1:], (pad, 3))], axis=0)
        fused = jnp.concatenate(
            [fused, jnp.zeros((pad, fused.shape[-1]), fused.dtype)], axis=0)
        nvalid = jnp.concatenate(
            [nvalid, jnp.zeros((pad,), nvalid.dtype)], axis=0)

    obs_b = obs_s.reshape(nb, s, 3)
    mask_b = rec_mask.reshape(nb, s)
    n_real = jnp.maximum(jnp.sum(mask_b, axis=1, keepdims=True), 1)
    centers = (jnp.sum(jnp.where(mask_b[..., None], obs_b, 0.0), axis=1)
               / n_real)                                           # [NB, 3]
    d2 = jnp.sum((obs_b - centers[:, None, :]) ** 2, axis=-1)
    radii = jnp.sqrt(jnp.max(jnp.where(mask_b, d2, 0.0), axis=1))
    return BucketedPlatform(
        obs_norm=obs_s,
        fused=fused.reshape(nb, s, -1),
        nvalid=nvalid.reshape(nb, s),
        rec_mask=mask_b,
        centers=centers,
        radii=radii,
        center=center,
    )


@jax.named_scope("bucketed_localize")
def bucketed_platform_terms(
    q_norm,
    bp: BucketedPlatform,
    *,
    n_max: int,
    weight_function: int,
    max_blocks: int,
    r2_cap: float = GC1999_SQ,
    solver_dtype=jnp.float32,
):
    """Accumulate one platform's normal terms from candidate blocks only.

    Returns ``(a_obs [C, k, k], g [C, k], count [C], overflow [])`` —
    the first three exactly as ops/dense.dense_platform_terms whenever
    ``overflow == 0``; overflow counts candidate blocks that did not fit
    in ``max_blocks`` (their obs are silently dropped — monitor it).
    """
    q = jnp.asarray(q_norm)
    nb, s = bp.n_blocks, bp.block_size
    m = min(max_blocks, nb)

    # [C, NB] chunk-to-center distances (NB is small; direct form)
    d2 = jnp.sum((q[:, None, :] - bp.centers[None, :, :]) ** 2, axis=-1)
    dmin = jnp.sqrt(jnp.min(d2, axis=0))                           # [NB]
    reach = jnp.sqrt(jnp.asarray(r2_cap, dmin.dtype)) + bp.radii
    cand = dmin <= reach                                           # [NB]
    # best candidates first: distance beyond the block's covering ball
    score = jnp.where(cand, dmin - bp.radii, jnp.inf)
    _, idx = jax.lax.top_k(-score, m)                              # [M]
    keep = cand[idx]                                               # [M]
    overflow = jnp.sum(cand.astype(jnp.int32)) - jnp.sum(
        keep.astype(jnp.int32))

    obs_c = bp.obs_norm.reshape(nb, s, 3)[idx].reshape(m * s, 3)
    fused_c = bp.fused[idx].reshape(m * s, -1)
    nvalid_c = bp.nvalid[idx].reshape(m * s)
    row_mask = (keep[:, None] & bp.rec_mask[idx]).reshape(m * s)

    # centered squared distances via one matmul — same centering point as
    # ops/dense.py so each (point, record) r2 is computed identically and
    # the cap thresholds coincide
    center = bp.center
    qc = q - center
    oc = obs_c - center
    dots = jnp.dot(qc, oc.T, precision=_HI, preferred_element_type=q.dtype)
    r2 = jnp.maximum(
        jnp.sum(qc * qc, axis=-1, keepdims=True)
        + jnp.sum(oc * oc, axis=-1)[None, :] - 2.0 * dots, 0.0)    # [C, M*S]

    a_obs, g, count = terms_from_r2(
        r2, fused_c, nvalid_c, n_max=n_max,
        weight_function=weight_function, r2_cap=r2_cap,
        solver_dtype=solver_dtype, row_mask=row_mask)
    return a_obs, g, count, overflow


@jax.jit
def required_max_blocks(q_norm_chunks, centers, radii,
                        r2_cap: float = GC1999_SQ):
    """Exact candidate-block budget: max over chunks of #candidate blocks.

    ``q_norm_chunks``: ``[n_chunks, chunk, 3]`` Hilbert-ordered normalized
    query points (the same chunking the update will use).  Cheap prepass —
    one ``[chunk, NB]`` distance matrix per chunk, no obs tables touched.
    Callers run it OUTSIDE jit, fetch the scalar, and trace the update with
    a static ``max_blocks`` >= it, making overflow impossible by
    construction (static shapes for a compiled program instead of a
    data-dependent candidate count).
    """
    reach = jnp.sqrt(jnp.asarray(r2_cap, radii.dtype)) + radii

    def one(qc):
        d2 = jnp.sum((qc[:, None, :] - centers[None, :, :]) ** 2, axis=-1)
        dmin = jnp.sqrt(jnp.min(d2, axis=0))
        return jnp.sum((dmin <= reach).astype(jnp.int32))

    return jnp.max(jax.lax.map(one, q_norm_chunks))


def default_max_blocks(n_blocks: int) -> int:
    """Heuristic candidate-block budget.

    Covers ~1/4 of all blocks (compact Morton chunks over dense obs touch
    far fewer), with a floor so small platforms barely cull.  Callers with
    known obs density should size this themselves and watch the overflow
    counter — overflow > 0 means obs were dropped.
    """
    return max(32, -(-n_blocks // 4))
