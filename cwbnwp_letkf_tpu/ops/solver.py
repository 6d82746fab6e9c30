"""Batched ensemble-space LETKF solve.

Batched re-design of the reference's per-gridpoint serial solve
(``letkf_solve``, module_letkf_core.f90:598-700, with the
eigendecomposition helpers of module_eigen.f90:37-108).

The reference solves, at every gridpoint, with k = ensemble size and
pre-whitened local innovations ``yo``/perturbations ``yb`` (R-localization
already folded into the obs-error scaling — see ops/whiten.py):

    A    = inflat*I + Yb' Yb'^T            (dsyrk,  letkf_core.f90:649)
    Pa   = A^-1                            (dsyevd, eigen.f90:37-76)
    wm   = Pa (Yb' yo')                    (dgemv+dsymv, letkf_core.f90:651-652)
    W    = sqrt(A^-1)                      (cached eigenpairs, eigen.f90:78-108)
    Wtot = wm 1^T + sqrt(k-1) W            (spread+daxpy, letkf_core.f90:662-668)
    xa   = mean(xb) + Wtot^T (xb - mean)   (dgemv, letkf_core.f90:671-679)

followed by optional RTPP / RTPS relaxation (letkf_core.f90:684-698).

Here the whole thing is one batched computation over ``B`` gridpoints:
``A`` assembly and the weight application are batched matmuls; the
factorization is a batched Newton-Schulz inverse square root
(:func:`ns_invsqrt`) or a batched ``eigh``.  ``Pa`` and ``sqrt(A^-1)`` are never
materialized — both reduce to diagonal rescalings in the eigenbasis, which is
algebraically identical to the reference's eigenpair-cache trick
(eigen.f90:49-56,89-93) and saves two k*k matmuls per gridpoint:

    s = wm . xb'  = (V^T g / lam) . (V^T xb')        (scalar per point)
    t = W xb'     = V ((V^T xb') / sqrt(lam))
    xa = mean(xb) + s + sqrt(k-1) * t

Gridpoints whose local obs vector is empty are left untouched (the reference
``cycle``s them, letkf_core.f90:220-234): padded zero obs columns make
``A = inflat*I`` which would *wrongly* inflate the point, so a ``has_obs``
mask restores the background there.
"""
from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp

#: Full-precision multiplies: on the GPU an f32 matmul with no precision
#: asked for may run in TF32 (a 10-bit mantissa), which would silently
#: degrade the whitened normal terms, the eigenbasis projections and the
#: distance rankings.  The solve is O(k^2) next to the O(k^3) factorization
#: and the neighbor search, so full f32 costs little here.
_HI = jax.lax.Precision.HIGHEST

_EIGH_BACKEND = "auto"


def set_eigh_backend(name: str):
    """Select the ensemble-space factorization backend.

    - ``"auto"`` (default): the Newton-Schulz inverse-sqrt path for float32
      batches on an accelerator, ``jnp.linalg.eigh`` elsewhere (the CPU
      backend and float64 solves).
    - ``"ns"``: force Newton-Schulz (:func:`ns_invsqrt`) — the solve never
      eigendecomposes at all; it builds ``Z = A^(-1/2)`` from batched
      matmuls (float32, 3-D batches only).
    - ``"xla"``: ``jnp.linalg.eigh`` (cuSOLVER on the GPU, LAPACK on CPU).

    Clears jit caches so already-traced solve paths pick up the switch.
    """
    global _EIGH_BACKEND
    if name not in ("auto", "xla", "ns"):
        raise ValueError(f"unknown eigh backend {name!r}")
    _EIGH_BACKEND = name
    jax.clear_caches()


def uses_newton_schulz(dtype) -> bool:
    """Whether a batched ``[B, k, k]`` solve in ``dtype`` takes the
    Newton-Schulz path (else ``jnp.linalg.eigh``)."""
    if jnp.dtype(dtype) != jnp.float32:
        return False
    if _EIGH_BACKEND == "ns":
        return True
    return _EIGH_BACKEND == "auto" and jax.default_backend() != "cpu"


def _use_ns(a_obs) -> bool:
    """Whether the Newton-Schulz inverse-sqrt path handles this solve."""
    return a_obs.ndim == 3 and uses_newton_schulz(a_obs.dtype)


def _ns_z(a_obs, inflat):
    """``(Z, residual)`` for ``Z = (a_obs + inflat*I)^(-1/2)``."""
    z, _, resid = ns_invsqrt(a_obs, inflat, return_info=True)
    return z, resid


@jax.named_scope("ns_invsqrt")
def ns_invsqrt(a_obs, inflat, *, tol: float = 1e-4, max_iters: int = 24,
               return_info: bool = False):
    """Batched ``Z ~= (a_obs + inflat*I)^(-1/2)`` by coupled Newton-Schulz.

    The LETKF solve never needs eigenpairs — only ``A^(-1) g`` and
    ``A^(-1/2) xb'`` (letkf_core.f90:651-679), and both come from the
    symmetric ``Z = A^(-1/2)``: ``A^(-1) g = Z (Z g)``.  The reference
    eigendecomposes with LAPACK; here the coupled Newton-Schulz square-root
    iteration (Higham, Functions of Matrices, alg 6.21)

        Y_0 = A/c,  Z_0 = I
        T   = (3 I - Z Y) / 2
        Y  <- Y T,   Z <- T Z          (-> Y = sqrt(A/c), Z = (A/c)^(-1/2))

    is three batched ``[B, k, k]`` matmuls per step, converging
    quadratically once ``||I - ZY|| < 1``, which the per-matrix Gershgorin
    row-sum scale ``c >= lam_max`` guarantees from step 0 since
    ``A ⪰ inflat*I > 0``.  Because ``a_obs = Yb'Yb'^T ⪰ 0``, the condition
    number is bounded by ``c/inflat``, known at trace time up to the obs
    term.

    Runs a ``lax.while_loop`` on ``max|ZY - I|`` (the residual is a free
    byproduct of T) with full-f32 matmul precision: a lower-precision
    iteration (bf16 passes) diverges at kappa ~ 1e3, because its rounding
    breaks the ``Y = A_c Z`` commuting invariant faster than the iteration
    contracts and the spectrum of ``ZY`` escapes (0, 3).

    On scaling: the real cycle's normal matrices are far worse conditioned
    than synthetic ones (dense localized obs put kappa at 10^2-10^3, where
    the iteration runs ~9 steps, vs ~4 at kappa ~ 3), so interval-tracked
    balanced scaling (mu^2 = 3/(lo+hi) from the provable bounds
    lo = inflat/c, hi = 1.9) was tried.  It is structurally unsafe for this
    map: the balanced choice folds the top of the spectrum through the
    cubic's root at 3/mu^2, and with a pessimistic lo (the only provable
    one — a_obs is exactly singular at obs-sparse points but
    well-conditioned at dense ones) true top eigenvalues land on the root,
    where f32 rounding flips their sign and the iteration diverges
    (observed NaN at kappa ~ 4).  A fold-free margin (mu^2 <= 2/hi) caps
    the bottom-growth gain at ~1.26x/step vs the unscaled 1.5x.  The (0, 3)
    contraction region is the binding constraint; the iteration count at
    real conditioning is a property of the problem.

    Returns ``z`` ``[B, k, k]`` symmetric; with ``return_info=True`` returns
    ``(z, iters, residual)`` — the executed iteration count and the final
    ``max|ZY - I|``.  The residual is the convergence certificate: if the
    ``max_iters`` budget ran out before ``tol`` (condition numbers beyond
    what 24 steps cover), it stays large and callers can warn or fall back
    instead of silently using an inaccurate ``A^(-1/2)``.
    """
    k = a_obs.shape[-1]
    dt = a_obs.dtype
    eye = jnp.eye(k, dtype=dt)
    a = a_obs + jnp.asarray(inflat, dt) * eye
    # Gershgorin upper bound on lam_max, then 1.9x looser: stability only
    # needs spectrum(A/c) in (0, 2) (contraction region of the map is
    # (0, 3)), and lam_max / (G/1.9) <= 1.9 since G >= lam_max.  The looser
    # scale grows lam_min 1.9x faster — one iteration saved at every
    # conditioning tried, with equal-or-better residuals.
    c = jnp.max(jnp.sum(jnp.abs(a), axis=-1), axis=-1) / 1.9    # [B]
    c = jnp.maximum(c, jnp.finfo(dt).tiny)
    y = a / c[:, None, None]
    # z/err must DERIVE from the input (zeros_like, not a broadcast
    # constant): under shard_map the while_loop outputs are varying over
    # the mesh axis, and an unvarying initial carry fails the
    # varying-manual-axes check at trace time — which would crash every
    # sharded NS solve on a real mesh (CPU tests take the eigh path unless
    # they force the "ns" backend).
    z = jnp.zeros_like(a) + eye

    def mm(p, q):
        return jnp.einsum("bij,bjk->bik", p, q, precision=_HI,
                          preferred_element_type=dt)

    def step(state):
        y, z, _, i = state
        w = mm(z, y)
        t = 0.5 * (3.0 * eye - w)
        err = jnp.max(jnp.abs(w - eye))
        return mm(y, t), mm(t, z), err, i + 1

    def cond(s):
        return jnp.logical_and(s[2] > tol, s[3] < max_iters)

    err0 = jnp.asarray(jnp.inf, dt) + 0.0 * jnp.max(c)  # varying like c
    y, z, err, iters = jax.lax.while_loop(
        cond, step, (y, z, err0, jnp.asarray(0)))
    z = z / jnp.sqrt(c)[:, None, None]
    if return_info:
        # err is max|Z_{i-1}Y_{i-1} - I| from the last executed step (the
        # loop's stopping quantity); quadratic convergence means the actual
        # final residual is smaller still — a conservative certificate.
        return z, iters, err
    return z


@jax.named_scope("ns_refine64")
def ns_invsqrt_refined(a_obs, inflat, *, refine_steps: int = 1):
    """f32 Newton-Schulz solve + float64 Newton refinement of ``Z``.

    A middle point of the float64-parity axis (SURVEY hard part d): the
    reference solves in float64 (`Makefile:9` -DREAL64, eigen.f90:6-12).
    Here the whole iteration runs in f32 and ONLY a final Newton step runs
    in double-word precision:

        X_0 = Z_f32 (cast),   X' = 1.5 X - 0.5 X (A X^2)      [3 df64 gemms]

    One step squares the residual: with ``||I - A Z_f32^2|| ~ sqrt(eps32)``
    scale errors, the refined ``X`` lands at ~eps32^2 ~ 1e-12 relative —
    f64-grade — for 3 double-word matmuls instead of an entire f64
    eigensolve.  (The uncoupled Newton-Schulz form is unstable over MANY
    steps; a single step from an already-converged iterate is in its
    stable regime, Higham, Functions of Matrices ch. 6.)

    The f64 matmuls run through the Ozaki error-free-transformation scheme
    (ops/df64.py), built from exact bf16 matmul passes.  On hardware with
    native f64 this path competes with the plain float64 eigh solve
    (``solver_dtype=float64``); which one to keep is an open measurement.

    Returns ``(z64, resid)`` with resid the f32 stage's certificate.
    """
    from .df64 import ozaki_matmul

    a32 = jnp.asarray(a_obs).astype(jnp.float32)
    z32, resid = _ns_z(a32, float(inflat))
    k = a32.shape[-1]
    a64 = (jnp.asarray(a_obs).astype(jnp.float64)
           + jnp.asarray(inflat, jnp.float64)
           * jnp.eye(k, dtype=jnp.float64))
    x = z32.astype(jnp.float64)

    def mm(p, q):
        return ozaki_matmul(p, q)

    for _ in range(refine_steps):
        x2 = mm(x, x)
        ax2 = mm(a64, x2)
        x = 1.5 * x - 0.5 * mm(x, ax2)
    # re-symmetrize: the refinement's product form drifts O(eps64)
    # asymmetric; Z must be symmetric for the s = (Zg).(Zx') identity
    x = 0.5 * (x + jnp.swapaxes(x, -1, -2))
    return x, resid


def letkf_solve_group_refined(
    a_obs,
    g,
    xb,
    inflats,
    has_obs,
    *,
    rtpp_alpha,
    rtps_alpha,
    refine_steps: int = 1,
    return_diagnostics: bool = False,
):
    """Fused group solve at f64-refined precision (see ns_invsqrt_refined).

    Same contract as :func:`letkf_solve_group_from_normal` with
    ``solver_dtype=float64``, but the eigensolve-equivalent runs as
    f32-NS + one f64 Newton step; weight application and RTPP/RTPS run in
    f64 (the matmuls through the Ozaki double-word scheme, ops/df64.py —
    exact bf16 matmul passes).  Accepts f32 or f64 normal terms (f64
    terms preserve a compensated/accurate accumulation upstream).
    """
    from .df64 import ozaki_matmul, ozaki_matvec

    out_dtype = xb.dtype
    f64 = jnp.float64
    xb = jnp.asarray(xb).astype(f64)
    g = jnp.asarray(g).astype(f64)
    k = xb.shape[-1]
    sqkm1 = jnp.sqrt(jnp.asarray(k - 1, f64))
    xb_mean = jnp.mean(xb, axis=-1, keepdims=True)
    xb_prime = xb - xb_mean

    by_val = {}
    for vi, val in enumerate(inflats):
        by_val.setdefault(float(val), []).append(vi)
    xa_cols = [None] * len(inflats)
    resid = jnp.zeros((), jnp.float32)
    for val, vis in by_val.items():
        z, r_val = ns_invsqrt_refined(a_obs, val,
                                      refine_steps=refine_steps)
        resid = jnp.maximum(resid, r_val.astype(jnp.float32))
        zg = ozaki_matvec(z, g)
        xp = xb_prime[:, jnp.asarray(vis), :]
        # u[b,v,i] = sum_j z[b,i,j] xp[b,v,j]  (Z symmetric after refine)
        u = jnp.swapaxes(
            ozaki_matmul(z, jnp.swapaxes(xp, -1, -2)), -1, -2)
        s = jnp.sum(zg[:, None, :] * u, axis=-1, keepdims=True)
        xa_sub = xb_mean[:, jnp.asarray(vis), :] + s + sqkm1 * u
        for j, vi in enumerate(vis):
            xa_cols[vi] = xa_sub[:, j, :]
    xa = jnp.stack(xa_cols, axis=1)

    rtpp = jnp.asarray(rtpp_alpha, f64)[None, :, None]
    rtps = jnp.asarray(rtps_alpha, f64)[None, :, None]
    xa_mean = jnp.mean(xa, axis=-1, keepdims=True)
    xa_prime = xa - xa_mean
    xa_prime = (1.0 - rtpp) * xa_prime + rtpp * xb_prime
    xb_std = jnp.sum(xb_prime * xb_prime, axis=-1, keepdims=True)
    xa_std = jnp.sum(xa_prime * xa_prime, axis=-1, keepdims=True)
    xa_std = jnp.maximum(xa_std, jnp.finfo(f64).tiny)
    factor = rtps * jnp.sqrt(xb_std / xa_std) - rtps + 1.0
    xa = xa_mean + xa_prime * factor

    xa = xa.astype(out_dtype)
    xa = jnp.where(has_obs[:, None, None], xa, xb.astype(out_dtype))
    if return_diagnostics:
        return xa, {"ns_residual": resid}
    return xa


@jax.named_scope("eigh")
def _eigh_batch(a):
    """Batched symmetric eigendecomposition (cuSOLVER on the GPU)."""
    return jnp.linalg.eigh(a)


def letkf_weight_factors_from_normal(a_obs, g, inflat, *, solver_dtype=jnp.float32):
    """Eigen-factor the weight transform from pre-accumulated normal terms.

    ``a_obs = sum_p Yb_p Yb_p^T`` and ``g = sum_p Yb_p yo_p`` can be
    accumulated platform-by-platform (ops/whiten.py) without ever
    materializing the concatenated local obs vector — the k-by-k normal
    matrix is all the solve needs (letkf_core.f90:649-652 builds exactly
    these two quantities via dsyrk/dgemv).
    """
    k = a_obs.shape[-1]
    a = a_obs.astype(solver_dtype) + inflat * jnp.eye(k, dtype=solver_dtype)
    lam, v = _eigh_batch(a)
    return lam, v, g.astype(solver_dtype)


def letkf_weight_factors(yo, yb, inflat, *, solver_dtype=jnp.float32):
    """Compute the eigen-factored LETKF weight transform per gridpoint.

    Args:
      yo: ``[B, n]`` whitened innovations (zero-padded obs slots are exact
        zeros: a zero column contributes nothing to ``Yb Yb^T`` or ``Yb yo``,
        which is equivalent to the obs being absent).
      yb: ``[B, k, n]`` whitened background perturbations in obs space.
      inflat: scalar ``(k-1)/rho`` — multiplicative-inflation-scaled prior
        weight (letkf_core.f90:68).
      solver_dtype: dtype of the ensemble-space math.  The reference uses
        float64 here while state stays float32 (Makefile:9 -DREAL64,
        letkf_core.f90:609-654); float32 is the fast path and float64
        is available for parity testing.

    Returns:
      ``(lam, v, g)``: eigenvalues ``[B, k]``, eigenvectors ``[B, k, k]`` of
      ``A = inflat*I + Yb Yb^T``, and ``g = Yb yo`` ``[B, k]``.
    """
    yb = yb.astype(solver_dtype)
    yo = yo.astype(solver_dtype)
    a_obs = jnp.einsum("bkn,bln->bkl", yb, yb, precision=_HI, preferred_element_type=solver_dtype)
    g = jnp.einsum("bkn,bn->bk", yb, yo, precision=_HI, preferred_element_type=solver_dtype)
    return letkf_weight_factors_from_normal(a_obs, g, inflat,
                                            solver_dtype=solver_dtype)


@jax.named_scope("weight_apply")
def apply_weight_factors(lam, v, g, xb, *, solver_dtype=jnp.float32):
    """Apply the factored weight transform to one analysis field.

    ``xb`` is ``[B, k]``; returns the analysis ``xa`` ``[B, k]`` in
    ``solver_dtype`` (caller casts/masks).  Mirrors letkf_core.f90:662-679.
    """
    xb = xb.astype(solver_dtype)
    k = xb.shape[-1]
    xb_mean = jnp.mean(xb, axis=-1, keepdims=True)
    xb_prime = xb - xb_mean

    vt_g = jnp.einsum("bik,bi->bk", v, g, precision=_HI, preferred_element_type=solver_dtype)
    vt_x = jnp.einsum("bik,bi->bk", v, xb_prime, precision=_HI, preferred_element_type=solver_dtype)
    # s = wm . xb' with wm = Pa g = V diag(1/lam) V^T g
    s = jnp.sum((vt_g / lam) * vt_x, axis=-1, keepdims=True)
    # t = sqrt(A^-1) xb' = V diag(1/sqrt(lam)) V^T xb'
    t = jnp.einsum(
        "bik,bk->bi", v, vt_x / jnp.sqrt(lam), precision=_HI, preferred_element_type=solver_dtype
    )
    return xb_mean + s + jnp.sqrt(jnp.asarray(k - 1, solver_dtype)) * t


@jax.named_scope("weight_apply_z")
def _apply_z(z, g, xb, *, solver_dtype=jnp.float32):
    """Apply the inverse-sqrt factor to one analysis field.

    With ``Z = A^(-1/2)``:  ``t = Z xb'``,  ``s = (Z g) . (Z xb')`` (equals
    ``g^T A^(-1) xb'`` since Z is symmetric), so the whole weight application
    is one batched matvec pair — mirrors letkf_core.f90:662-679 with the
    eigenbasis replaced by Z.
    """
    xb = xb.astype(solver_dtype)
    k = xb.shape[-1]
    xb_mean = jnp.mean(xb, axis=-1, keepdims=True)
    xb_prime = xb - xb_mean
    zg = jnp.einsum("bij,bj->bi", z, g.astype(solver_dtype),
                    precision=_HI, preferred_element_type=solver_dtype)
    u = jnp.einsum("bij,bj->bi", z, xb_prime,
                   precision=_HI, preferred_element_type=solver_dtype)
    s = jnp.sum(zg * u, axis=-1, keepdims=True)
    return xb_mean + s + jnp.sqrt(jnp.asarray(k - 1, solver_dtype)) * u


def _relax(xa, xb_prime, use_rtpp, rtpp_alpha, use_rtps, rtps_alpha):
    """RTPP / RTPS posterior spread relaxation (letkf_core.f90:684-698)."""
    xa_mean = jnp.mean(xa, axis=-1, keepdims=True)
    xa_prime = xa - xa_mean
    if use_rtpp:
        xa_prime = (1.0 - rtpp_alpha) * xa_prime + rtpp_alpha * xb_prime
    if use_rtps:
        xb_std = jnp.sum(xb_prime * xb_prime, axis=-1, keepdims=True)
        xa_std = jnp.sum(xa_prime * xa_prime, axis=-1, keepdims=True)
        xa_std = jnp.maximum(xa_std, jnp.finfo(xa.dtype).tiny)
        factor = rtps_alpha * jnp.sqrt(xb_std / xa_std) - rtps_alpha + 1.0
        xa_prime = xa_prime * factor
    return xa_mean + xa_prime


@functools.partial(
    jax.jit,
    static_argnames=("use_rtpp", "use_rtps", "solver_dtype"),
)
def letkf_solve_batch(
    xb,
    yo,
    yb,
    inflat,
    has_obs,
    *,
    use_rtpp: bool = False,
    rtpp_alpha: float = 0.85,
    use_rtps: bool = False,
    rtps_alpha: float = 0.85,
    solver_dtype=jnp.float32,
):
    """Batched LETKF analysis update over ``B`` gridpoints.

    Args:
      xb: ``[B, k]`` background ensemble values at each gridpoint.
      yo: ``[B, n]`` whitened innovations (zero-padded).
      yb: ``[B, k, n]`` whitened obs-space perturbations (zero-padded).
      inflat: scalar ``(k-1)/multi_infl`` for this variable.
      has_obs: ``[B]`` bool — True where at least one real (unpadded,
        accepted) obs exists.  Points with none keep their background
        unchanged, matching the reference's skip (letkf_core.f90:220-234).
      use_rtpp / use_rtps: static flags; alphas are the per-variable namelist
        values (config.f90:63-68).

    Returns:
      ``xa`` ``[B, k]`` in the dtype of ``xb``.
    """
    yb_s = yb.astype(solver_dtype)
    yo_s = yo.astype(solver_dtype)
    a_obs = jnp.einsum("bkn,bln->bkl", yb_s, yb_s, precision=_HI,
                       preferred_element_type=solver_dtype)
    g = jnp.einsum("bkn,bn->bk", yb_s, yo_s, precision=_HI,
                   preferred_element_type=solver_dtype)
    return letkf_solve_from_normal(
        a_obs, g, xb, inflat, has_obs,
        use_rtpp=use_rtpp, rtpp_alpha=rtpp_alpha,
        use_rtps=use_rtps, rtps_alpha=rtps_alpha,
        solver_dtype=solver_dtype)


def letkf_solve_from_normal(
    a_obs,
    g,
    xb,
    inflat,
    has_obs,
    *,
    use_rtpp: bool = False,
    rtpp_alpha: float = 0.85,
    use_rtps: bool = False,
    rtps_alpha: float = 0.85,
    solver_dtype=jnp.float32,
    return_diagnostics: bool = False,
):
    """Like :func:`letkf_solve_batch` but from accumulated normal terms.

    ``return_diagnostics=True`` also returns ``{"ns_residual": f32 scalar}``
    — the Newton-Schulz convergence certificate (max ``|ZY - I|`` at loop
    exit; 0.0 on the eigh paths, which have no data-dependent accuracy
    cliff).  A residual above ``ns_invsqrt``'s tol means the iteration
    budget ran out for some matrix in the batch: warn or rerun with the
    float64 eigh backend instead of silently using an inaccurate solve.
    """
    out_dtype = xb.dtype
    resid = jnp.zeros((), jnp.float32)
    if _use_ns(jnp.asarray(a_obs).astype(solver_dtype)):
        z, resid = _ns_z(a_obs.astype(solver_dtype), inflat)
        xa = _apply_z(z, g, xb, solver_dtype=solver_dtype)
    else:
        lam, v, g = letkf_weight_factors_from_normal(
            a_obs, g, inflat, solver_dtype=solver_dtype)
        xa = apply_weight_factors(lam, v, g, xb, solver_dtype=solver_dtype)
    if use_rtpp or use_rtps:
        xbp = xb.astype(solver_dtype)
        xbp = xbp - jnp.mean(xbp, axis=-1, keepdims=True)
        xa = _relax(xa, xbp, use_rtpp, rtpp_alpha, use_rtps, rtps_alpha)
    xa = xa.astype(out_dtype)
    xa = jnp.where(has_obs[:, None], xa, xb)
    if return_diagnostics:
        return xa, {"ns_residual": resid.astype(jnp.float32)}
    return xa


def letkf_solve_group_from_normal(
    a_obs,
    g,
    xb,
    inflats,
    has_obs,
    *,
    rtpp_alpha,
    rtps_alpha,
    solver_dtype=jnp.float32,
    return_diagnostics: bool = False,
):
    """Fused multi-variable solve from one set of normal terms.

    The reference recomputes the full k-by-k eigensolve for *every* analysis
    variable at every gridpoint (letkf_core.f90:59-297 re-enters letkf_solve
    per variable), even though variables sharing localization radii and
    assimilation masks see the identical ``Yb' Yb'^T`` / ``Yb' yo'``.  Since
    ``A_v = a_obs + inflat_v * I`` differs between such variables only by a
    multiple of the identity, every ``A_v`` shares the eigenvectors of
    ``a_obs`` — eigenvalues just shift by ``inflat_v``.  One batched eigh
    therefore serves the whole variable group; per-variable cost collapses to
    the O(k^2) weight application.

    Args:
      a_obs:   ``[B, k, k]`` accumulated ``Yb' Yb'^T``.
      g:       ``[B, k]`` accumulated ``Yb' yo'``.
      xb:      ``[B, V, k]`` background for the V grouped variables.
      inflats: ``[V]`` per-variable ``(k-1)/multi_infl`` (letkf_core.f90:68).
      has_obs: ``[B]`` bool — background kept where False.
      rtpp_alpha / rtps_alpha: ``[V]`` relaxation strengths; 0 disables
        (alpha=0 makes both RTPP and RTPS exact identities, so disabled
        variables need no separate code path).

    Returns ``xa`` ``[B, V, k]`` in ``xb``'s dtype; with
    ``return_diagnostics=True`` also ``{"ns_residual": f32 scalar}`` (see
    :func:`letkf_solve_from_normal`).
    """
    out_dtype = xb.dtype
    resid = jnp.zeros((), jnp.float32)
    xb = xb.astype(solver_dtype)
    k = xb.shape[-1]
    a = a_obs.astype(solver_dtype)
    g = g.astype(solver_dtype)
    sqkm1 = jnp.sqrt(jnp.asarray(k - 1, solver_dtype))

    xb_mean = jnp.mean(xb, axis=-1, keepdims=True)
    xb_prime = xb - xb_mean                       # [B, V, k]

    if _use_ns(a):
        # One Newton-Schulz inverse-sqrt per DISTINCT inflation value (the
        # eigh path shares eigenvectors across shifted-identity A's; the NS
        # path shares Z across variables with the same inflat — in the
        # production namelist a fused group shares one multi_infl, so this
        # is one iteration per group).  inflats is a static tuple.
        by_val = {}
        for vi, val in enumerate(inflats):
            by_val.setdefault(float(val), []).append(vi)
        xa_cols = [None] * len(inflats)
        for val, vis in by_val.items():
            z, r_val = _ns_z(a, val)                            # [B, k, k]
            resid = jnp.maximum(resid, r_val.astype(jnp.float32))
            zg = jnp.einsum("bij,bj->bi", z, g, precision=_HI,
                            preferred_element_type=solver_dtype)
            xp = xb_prime[:, jnp.asarray(vis), :]            # [B, Vs, k]
            u = jnp.einsum("bij,bvj->bvi", z, xp, precision=_HI,
                           preferred_element_type=solver_dtype)
            s = jnp.sum(zg[:, None, :] * u, axis=-1, keepdims=True)
            xa_sub = xb_mean[:, jnp.asarray(vis), :] + s + sqkm1 * u
            for j, vi in enumerate(vis):
                xa_cols[vi] = xa_sub[:, j, :]
        xa = jnp.stack(xa_cols, axis=1)                      # [B, V, k]
    else:
        lam0, v = _eigh_batch(a)                  # [B, k], [B, k, k]
        inflats_a = jnp.asarray(inflats, solver_dtype)  # [V]
        vt_g = jnp.einsum("bik,bi->bk", v, g, precision=_HI,
                          preferred_element_type=solver_dtype)
        vt_x = jnp.einsum("bik,bvi->bvk", v, xb_prime,
                          precision=_HI, preferred_element_type=solver_dtype)
        lam = lam0[:, None, :] + inflats_a[None, :, None]   # [B, V, k]
        s = jnp.sum((vt_g[:, None, :] / lam) * vt_x, axis=-1, keepdims=True)
        t = jnp.einsum("bik,bvk->bvi", v, vt_x / jnp.sqrt(lam),
                       precision=_HI, preferred_element_type=solver_dtype)
        xa = xb_mean + s + sqkm1 * t

    # RTPP / RTPS (letkf_core.f90:684-698), vectorized over the group.
    rtpp = jnp.asarray(rtpp_alpha, solver_dtype)[None, :, None]
    rtps = jnp.asarray(rtps_alpha, solver_dtype)[None, :, None]
    xa_mean = jnp.mean(xa, axis=-1, keepdims=True)
    xa_prime = xa - xa_mean
    xa_prime = (1.0 - rtpp) * xa_prime + rtpp * xb_prime
    xb_std = jnp.sum(xb_prime * xb_prime, axis=-1, keepdims=True)
    xa_std = jnp.sum(xa_prime * xa_prime, axis=-1, keepdims=True)
    xa_std = jnp.maximum(xa_std, jnp.finfo(xa.dtype).tiny)
    factor = rtps * jnp.sqrt(xb_std / xa_std) - rtps + 1.0
    xa = xa_mean + xa_prime * factor

    xa = xa.astype(out_dtype)
    xa = jnp.where(has_obs[:, None, None], xa, xb.astype(out_dtype))
    if return_diagnostics:
        return xa, {"ns_residual": resid}
    return xa


def letkf_solve_cycle_from_normal(
    a_groups,
    g_groups,
    xb_groups,
    inflats_groups,
    has_obs_groups,
    *,
    rtpp_alpha_groups,
    rtps_alpha_groups,
    solver_dtype=jnp.float32,
    return_diagnostics: bool = False,
):
    """Several groups' solves with the NS iterations STACKED by inflation.

    The fused cycle (ops/cycle.py) solves G variable groups per point
    chunk; called per group, that is one ``_ns_z`` launch per (group,
    distinct inflat) pair — six per chunk under the production namelist.
    Each launch is a ``while_loop`` of small batched matmuls, so batching
    all groups that share an inflation value into ONE iteration (``A``
    differs per group, but NS treats the batch axis uniformly) cuts the
    launches to one per DISTINCT value — two under the production
    namelist (1.6 dynamics / 1.1 moisture, input.nml:160-170) — at
    2.5-3x the per-launch batch.

    Args: per-group lists, each entry exactly the corresponding argument
    of :func:`letkf_solve_group_from_normal`.  Non-NS backends (float64,
    eigh) fall back to per-group solves unchanged.

    Stacking couples the NS while_loop's stopping criterion: the residual
    is the batch-global max ``|ZY - I|``, so every stacked group iterates
    until the worst-conditioned group's matrices converge.  Correctness is
    unaffected (the coupled iteration is stable past convergence) and
    results match the per-group path to accumulation-order tolerance
    (tests/test_cycle.py::test_cycle_stacked_ns_matches_pergroup), but the
    reported ``ns_residual`` is per-STACK, not per-group — if per-group
    residual attribution ever matters, return per-launch residuals keyed
    by inflation value.

    (Rejected alternative: deriving a mixed group's smaller-shift factor
    by SHIFT-REUSE — ``Z_d1 = Z_d2 M^(-1/2)`` with
    ``M = I - (d2-d1) Z_d2^2``, whose conditioning is bounded by the shift
    ratio (1.45 under the production namelist) so ``M^(-1/2)`` converges
    in ~3 iterations — is exact algebra, but chaining Z2 -> Z2^2 ->
    M-solve -> compose serializes what the independent per-value stacked
    launches otherwise overlap; it was slower end to end.)

    Returns a list of per-group ``xa`` (+ shared diagnostics dict).
    """
    n_groups = len(a_groups)
    if not _use_ns(jnp.asarray(a_groups[0]).astype(solver_dtype)):
        outs = []
        resid = jnp.zeros((), jnp.float32)
        for gi in range(n_groups):
            xa, d = letkf_solve_group_from_normal(
                a_groups[gi], g_groups[gi], xb_groups[gi],
                inflats_groups[gi], has_obs_groups[gi],
                rtpp_alpha=rtpp_alpha_groups[gi],
                rtps_alpha=rtps_alpha_groups[gi],
                solver_dtype=solver_dtype, return_diagnostics=True)
            resid = jnp.maximum(resid, d["ns_residual"])
            outs.append(xa)
        if return_diagnostics:
            return outs, {"ns_residual": resid}
        return outs

    k = xb_groups[0].shape[-1]
    sqkm1 = jnp.sqrt(jnp.asarray(k - 1, solver_dtype))
    a_gs = [jnp.asarray(a).astype(solver_dtype) for a in a_groups]
    g_gs = [jnp.asarray(g).astype(solver_dtype) for g in g_groups]
    xb_gs = [jnp.asarray(x).astype(solver_dtype) for x in xb_groups]
    means = [jnp.mean(x, axis=-1, keepdims=True) for x in xb_gs]
    primes = [x - m for x, m in zip(xb_gs, means)]

    # (group, distinct-inflat) pairs, keyed by the static float value
    by_val = {}
    for gi, inflats in enumerate(inflats_groups):
        seen = {}
        for vi, val in enumerate(inflats):
            seen.setdefault(float(val), []).append(vi)
        for val, vis in seen.items():
            by_val.setdefault(val, []).append((gi, vis))

    resid = jnp.zeros((), jnp.float32)
    xa_cols = [[None] * len(inflats_groups[gi]) for gi in range(n_groups)]
    for val, members in by_val.items():
        astack = (a_gs[members[0][0]] if len(members) == 1
                  else jnp.concatenate([a_gs[gi] for gi, _ in members], 0))
        z_all, r_val = _ns_z(astack, val)
        resid = jnp.maximum(resid, r_val.astype(jnp.float32))
        off = 0
        for gi, vis in members:
            b = a_gs[gi].shape[0]
            z = jax.lax.slice_in_dim(z_all, off, off + b, axis=0)
            off += b
            zg = jnp.einsum("bij,bj->bi", z, g_gs[gi], precision=_HI,
                            preferred_element_type=solver_dtype)
            xp = primes[gi][:, jnp.asarray(vis), :]
            u = jnp.einsum("bij,bvj->bvi", z, xp, precision=_HI,
                           preferred_element_type=solver_dtype)
            s = jnp.sum(zg[:, None, :] * u, axis=-1, keepdims=True)
            xa_sub = means[gi][:, jnp.asarray(vis), :] + s + sqkm1 * u
            for j, vi in enumerate(vis):
                xa_cols[gi][vi] = xa_sub[:, j, :]

    outs = []
    for gi in range(n_groups):
        xa = jnp.stack(xa_cols[gi], axis=1)
        xb = xb_gs[gi]
        out_dtype = xb_groups[gi].dtype
        rtpp = jnp.asarray(rtpp_alpha_groups[gi], solver_dtype)[None, :, None]
        rtps = jnp.asarray(rtps_alpha_groups[gi], solver_dtype)[None, :, None]
        xa_mean = jnp.mean(xa, axis=-1, keepdims=True)
        xa_prime = xa - xa_mean
        xa_prime = (1.0 - rtpp) * xa_prime + rtpp * primes[gi]
        xb_std = jnp.sum(primes[gi] * primes[gi], axis=-1, keepdims=True)
        xa_std = jnp.sum(xa_prime * xa_prime, axis=-1, keepdims=True)
        xa_std = jnp.maximum(xa_std, jnp.finfo(xa.dtype).tiny)
        factor = rtps * jnp.sqrt(xb_std / xa_std) - rtps + 1.0
        xa = xa_mean + xa_prime * factor
        xa = xa.astype(out_dtype)
        xa = jnp.where(has_obs_groups[gi][:, None, None], xa,
                       xb.astype(out_dtype))
        outs.append(xa)
    if return_diagnostics:
        return outs, {"ns_residual": resid}
    return outs


@jax.jit
def tune_q(q):
    """Moisture positivity fix (letkf_tune_q, letkf_core.f90:702-733).

    Zeroes negative members and rescales the positive ones so the member sum
    (hence the ensemble mean) is preserved.  Member axis is the last axis.

    Divergence from the reference: when *no* member is positive the reference
    divides by a zero masked sum (producing Inf/NaN ratios); here such points
    are set to zero, which is the physically sensible limit.
    """
    pos = q > 0.0
    sum_all = jnp.sum(q, axis=-1, keepdims=True)
    sum_pos = jnp.sum(jnp.where(pos, q, 0.0), axis=-1, keepdims=True)
    any_pos = sum_pos > 0.0
    ratio = jnp.where(any_pos, sum_all / jnp.where(any_pos, sum_pos, 1.0), 0.0)
    return jnp.where(pos, ratio * q, 0.0).astype(q.dtype)
