"""Error-free-transformation float64 matmul from bf16 passes (Ozaki scheme).

The reference runs its ensemble-space solve in float64 (``-DREAL64``,
Makefile:9, module_eigen.f90:6-12) on hardware with native f64 BLAS.
SURVEY hard part (d) calls for "doubled-word tricks" to get parity-grade
precision from fast low-precision matmuls — this module is that trick,
built on bf16 x bf16 -> f32 matmuls.  The GPU also has native f64, so
whether this path beats a plain float64 solve there is an open
measurement (ns_invsqrt_refined).

Method (Ozaki et al., "Error-free transformations of matrix
multiplication by using fast routines of matrix multiplication and its
applications", Numer. Algorithms 59(1), 2012 — the same scheme behind
int8/bf16-tensor-core DGEMM emulation):

1. Scale each row of A (column of B) by a power of two so entries lie in
   [-1, 1] — exact in binary floating point.
2. Split every scaled entry into ``s`` fixed-point slices of 8 bits:
   ``u = sum_i n_i * 2^-8(i+1)`` with integer ``n_i``, ``|n_i| <= 256``.
   Each slice is EXACTLY representable in bf16 (8-bit significand).
3. Multiply slice pairs as bf16 operands with f32 accumulation: products are <= 16-bit integers, and a K-length f32
   accumulation of those is exact while ``K * 2^16 < 2^24`` (K <= 255 —
   ensemble sizes are <= ~100).  Every matmul pass is therefore
   ERROR-FREE; only slice truncation and the final recombination round.
4. Recombine the ``s*(s+1)/2`` partial products (pairs with
   ``i + j < s``; deeper pairs are below the slicing resolution) by
   significance level in f32, then across levels in f64, and undo the
   row/column scaling.

Accuracy: entries are sliced to ``8*s`` bits relative to their row/column
maximum, so the result matches true f64 GEMM to ``~K * 2^-8s`` relative
to the row-max * col-max scale — at the default ``s = 6``: ~1e-13, i.e.
f64-grade for any conceivable LETKF use (f64 itself carries 2^-53).

Cost: ``s*(s+1)/2 = 21`` bf16 matmuls plus O(s * M * K) elementwise
slicing in f64.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

#: fixed-point bits per slice; 8 keeps every slice bf16-exact and every
#: slice-pair product an exact <=16-bit integer
_BITS = 8


def _pow2_scale(m):
    """Smallest power of two >= m (elementwise, exact); 1.0 where m == 0.

    frexp on a float64 operand lowers to an s64 bitcast-convert, which
    some XLA backends' X64-rewriting passes cannot legalize.  Instead the
    exponent comes from an f32
    frexp (s32 bitcasts are supported) and two EXACT f64 comparison steps
    absorb both the f32 rounding of ``m`` and frexp's mant=0.5 convention
    at exact powers of two (which would otherwise return ``2m`` and
    silently spend one bit of slicing resolution).
    """
    m32 = jnp.clip(m, jnp.finfo(jnp.float32).tiny,
                   jnp.finfo(jnp.float32).max).astype(jnp.float32)
    _, e = jnp.frexp(m32)          # m32 = mant * 2^e, mant in [0.5, 1)
    s = jnp.ldexp(jnp.ones_like(m32), e).astype(m.dtype)
    # exact corrections: halve if the next power down still covers m
    # (m an exact power of two), double if f32 rounding under-shot
    s = jnp.where(0.5 * s >= m, 0.5 * s, s)
    s = jnp.where(s < m, 2.0 * s, s)
    return jnp.where(m > 0, s, jnp.ones_like(m))


def _slices(u, s: int):
    """Fixed-point 8-bit slices of ``u`` in [-1, 1]: exact bf16 integers."""
    out = []
    r = u
    for i in range(s):
        sc = float(2.0 ** (_BITS * (i + 1)))
        n = jnp.round(r * sc)
        out.append(n.astype(jnp.bfloat16))
        r = r - n / sc             # exact: n/sc has <= 9 significant bits
    return out


def ozaki_matmul(a, b, *, slices: int = 6):
    """Batched f64-grade matmul from exact bf16 matmul passes.

    ``a [..., M, K] @ b [..., K, N]`` in float64, computed as ``slices``
    fixed-point slices per operand and ``slices*(slices+1)/2`` single-pass
    bf16 matmuls (see module docstring).  Requires ``jax_enable_x64`` (the
    float64-parity paths already run under it) and ``K <= 255`` (ensemble
    dimension; asserted).

    Returns float64 ``[..., M, N]``.
    """
    a = jnp.asarray(a, jnp.float64)
    b = jnp.asarray(b, jnp.float64)
    if a.ndim != b.ndim:
        # the dot_general batch dims below assume equal rank; catch it here
        # with a readable message instead of an opaque dimension_numbers
        # trace error (broadcast b yourself if you want [B,M,K] @ [K,N])
        raise ValueError(
            f"operands must have equal rank, got {a.shape} @ {b.shape}")
    k = a.shape[-1]
    if b.shape[-2] != k:
        raise ValueError(f"contraction mismatch: {a.shape} @ {b.shape}")
    if k > (1 << (24 - 2 * _BITS)) - 1:
        raise ValueError(
            f"K={k} breaks the exact-f32-accumulation bound (<= 255)")

    sa = _pow2_scale(jnp.max(jnp.abs(a), axis=-1, keepdims=True))
    sb = _pow2_scale(jnp.max(jnp.abs(b), axis=-2, keepdims=True))
    ua = _slices(a / sa, slices)
    ub = _slices(b / sb, slices)

    # level l = i + j: all pairs at one significance; accumulate the pair
    # sums in f32 (level 0 is a single exact product; levels >= 1 round at
    # 2^-24 relative to their own 2^-8l-scaled magnitude — negligible)
    levels = []
    for l in range(slices):
        acc = None
        for i in range(l + 1):
            j = l - i
            p = jax.lax.dot_general(
                ua[i], ub[j],
                dimension_numbers=(((a.ndim - 1,), (b.ndim - 2,)),
                                   (tuple(range(a.ndim - 2)),
                                    tuple(range(b.ndim - 2)))),
                precision=jax.lax.Precision.DEFAULT,
                preferred_element_type=jnp.float32)
            acc = p if acc is None else acc + p
        levels.append(acc)

    out = jnp.zeros_like(levels[0], dtype=jnp.float64)
    for l in reversed(range(slices)):   # smallest contributions first
        out = out + levels[l].astype(jnp.float64) * float(
            2.0 ** (-_BITS * (l + 2)))
    return out * (sa * sb)


def ozaki_matvec(a, x, *, slices: int = 6):
    """``a [..., M, K] @ x [..., K]`` via :func:`ozaki_matmul`."""
    return ozaki_matmul(a, x[..., None], slices=slices)[..., 0]
