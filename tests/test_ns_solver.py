"""Newton-Schulz inverse-sqrt solve path vs the eigh path and the oracle.

The NS backend (ops/solver.py ns_invsqrt/_apply_z) replaces the per-point
eigendecomposition with batched matrix iterations — algebraically the
same analysis (letkf_core.f90:598-700), so it must match the eigh path to
float32 roundoff and the float64 reference transcription to solver tolerance.
"""
import sys

import jax.numpy as jnp
import numpy as np
import pytest

from chip_smoke import production_matrices
from cwbnwp_letkf_tpu.ops import solver

from . import reference_impl as ref


@pytest.fixture(autouse=True)
def _restore_backend():
    yield
    solver.set_eigh_backend("auto")


def _normal_case(rng, b, k, n, scale=0.5):
    y = rng.standard_normal((b, k, n)).astype(np.float32) * scale
    a_obs = y @ np.transpose(y, (0, 2, 1))
    g = rng.standard_normal((b, k)).astype(np.float32)
    return jnp.asarray(a_obs), jnp.asarray(g)


@pytest.mark.parametrize("k,rho", [(8, 1.1), (40, 1.6), (21, 1.1)])
def test_ns_invsqrt_residual(k, rho):
    rng = np.random.default_rng(0)
    a_obs, _ = _normal_case(rng, 64, k, 3 * k)
    inflat = (k - 1) / rho
    z = np.asarray(solver.ns_invsqrt(a_obs, inflat), np.float64)
    a = np.asarray(a_obs, np.float64) + inflat * np.eye(k)
    res = np.einsum("bij,bjk,bkl->bil", z, a, z) - np.eye(k)
    assert np.abs(res).max() < 5e-5


def test_ns_matches_eigh_single():
    rng = np.random.default_rng(1)
    b, k = 256, 24
    a_obs, g = _normal_case(rng, b, k, 50)
    xb = jnp.asarray(rng.standard_normal((b, k)).astype(np.float32))
    has = jnp.ones((b,), bool)
    kw = dict(use_rtpp=True, rtpp_alpha=0.7, use_rtps=True, rtps_alpha=0.9)
    inflat = (k - 1) / 1.1

    solver.set_eigh_backend("xla")
    xa_e = np.asarray(solver.letkf_solve_from_normal(
        a_obs, g, xb, inflat, has, **kw))
    solver.set_eigh_backend("ns")
    xa_n = np.asarray(solver.letkf_solve_from_normal(
        a_obs, g, xb, inflat, has, **kw))
    np.testing.assert_allclose(xa_n, xa_e, rtol=0, atol=2e-5 * np.abs(xa_e).max())


def test_ns_matches_eigh_group_mixed_inflats():
    """Distinct inflation values inside one group each get their own Z."""
    rng = np.random.default_rng(2)
    b, k, v = 128, 20, 5
    a_obs, g = _normal_case(rng, b, k, 80)
    xb = jnp.asarray(rng.standard_normal((b, v, k)).astype(np.float32))
    has = jnp.asarray(rng.random(b) > 0.3)
    inflats = ((k - 1) / 1.1, (k - 1) / 1.6, (k - 1) / 1.1,
               (k - 1) / 1.3, (k - 1) / 1.6)
    kw = dict(rtpp_alpha=(0.95, 0.0, 0.5, 0.0, 0.95),
              rtps_alpha=(0.0, 0.95, 0.5, 0.0, 0.95))

    solver.set_eigh_backend("xla")
    xa_e = np.asarray(solver.letkf_solve_group_from_normal(
        a_obs, g, xb, inflats, has, **kw))
    solver.set_eigh_backend("ns")
    xa_n = np.asarray(solver.letkf_solve_group_from_normal(
        a_obs, g, xb, inflats, has, **kw))
    np.testing.assert_allclose(xa_n, xa_e, rtol=0, atol=2e-5 * np.abs(xa_e).max())


def test_ns_solve_matches_reference_oracle():
    """Whole solve through the NS backend vs the float64 transcription."""
    rng = np.random.default_rng(3)
    b, k, n = 33, 16, 25
    xb = rng.normal(5.0, 2.0, size=(b, k)).astype(np.float32)
    yo = rng.normal(0.0, 1.0, size=(b, n)).astype(np.float32)
    yb = rng.normal(0.0, 1.0, size=(b, k, n)).astype(np.float32)
    inflat = (k - 1) / 1.2

    solver.set_eigh_backend("ns")
    xa = solver.letkf_solve_batch(
        jnp.asarray(xb), jnp.asarray(yo), jnp.asarray(yb), inflat,
        jnp.ones(b, bool), solver_dtype=jnp.float32)
    expected = np.stack([ref.letkf_solve(xb[i], yo[i], yb[i], inflat)
                         for i in range(b)])
    np.testing.assert_allclose(np.asarray(xa), expected, rtol=2e-3, atol=2e-3)


def test_ns_ill_conditioned_dense_obs():
    """300 strong obs (production radar cap) -> kappa ~ 100: still converges."""
    rng = np.random.default_rng(4)
    b, k, n = 64, 40, 300
    # Nearly-rank-1 obs perturbations (all obs see the same ensemble mode):
    # lam_max ~ 25*n while lam_min stays ~inflat -> kappa in the hundreds.
    u = rng.standard_normal((b, k, 1)).astype(np.float32)
    w = rng.standard_normal((b, 1, n)).astype(np.float32)
    y = 5.0 * u * w + 0.1 * rng.standard_normal((b, k, n)).astype(np.float32)
    a_obs = jnp.asarray(y @ np.transpose(y, (0, 2, 1)))
    inflat = (k - 1) / 1.1
    z = np.asarray(solver.ns_invsqrt(a_obs, inflat), np.float64)
    a = np.asarray(a_obs, np.float64) + inflat * np.eye(k)
    res = np.einsum("bij,bjk,bkl->bil", z, a, z) - np.eye(k)
    kappa = np.linalg.cond(a).max()
    assert kappa > 20, f"case not ill-conditioned enough ({kappa:.1f})"
    # float32 accuracy floor of the iteration is O(kappa * eps_f32)
    assert np.abs(res).max() < max(5e-4, 20 * kappa * 1.2e-7)


def test_refined_f64_beats_f32_accuracy():
    """f32 NS + one f64 Newton step lands at f64-grade Z accuracy.

    The cheap middle point of the f64-parity axis (SURVEY hard part d):
    three emulated-f64 gemms instead of a full f64 eigensolve, ~2 orders
    closer to the f64 oracle than the plain f32 solve.
    """
    k = 24
    rng = np.random.default_rng(4)
    y = rng.standard_normal((32, k, 120)).astype(np.float32) * 0.4
    a = jnp.asarray(y @ np.transpose(y, (0, 2, 1)))
    inflat = (k - 1) / 1.1
    z64, resid = solver.ns_invsqrt_refined(a, inflat)
    assert z64.dtype == jnp.float64
    z32 = solver.ns_invsqrt(a, inflat)
    af = np.asarray(a, np.float64) + inflat * np.eye(k)
    lam, v = np.linalg.eigh(af)
    zo = (v / np.sqrt(lam)[:, None, :]) @ np.transpose(v, (0, 2, 1))
    err32 = np.abs(np.asarray(z32, np.float64) - zo).max() / np.abs(zo).max()
    err64 = np.abs(np.asarray(z64) - zo).max() / np.abs(zo).max()
    assert err64 < err32 / 20, (err64, err32)
    assert err64 < 1e-7
    np.testing.assert_array_equal(np.asarray(z64),
                                  np.swapaxes(np.asarray(z64), 1, 2))


def test_refined_group_solve_matches_f64_solve():
    k = 16
    rng = np.random.default_rng(5)
    nb = 64
    y = rng.standard_normal((nb, k, 60)).astype(np.float32) * 0.4
    a = jnp.asarray((y @ np.transpose(y, (0, 2, 1))).astype(np.float64))
    g = jnp.asarray(rng.standard_normal((nb, k)))
    xb = jnp.asarray(rng.standard_normal((nb, 2, k)))
    kw = dict(inflats=((k - 1) / 1.1, (k - 1) / 1.6),
              rtpp_alpha=(0.9, 0.0), rtps_alpha=(0.0, 0.9))
    xa_r = solver.letkf_solve_group_refined(
        a, g, xb, has_obs=jnp.ones(nb, bool), **kw)
    xa_o = solver.letkf_solve_group_from_normal(
        a, g, xb, kw["inflats"], jnp.ones(nb, bool),
        rtpp_alpha=kw["rtpp_alpha"], rtps_alpha=kw["rtps_alpha"],
        solver_dtype=jnp.float64)
    sc = float(np.abs(np.asarray(xa_o)).max())
    np.testing.assert_allclose(np.asarray(xa_r), np.asarray(xa_o),
                               rtol=0, atol=1e-6 * sc)


def test_cycle_stacked_ns_matches_pergroup():
    """The stacked-NS branch of letkf_solve_cycle_from_normal per group.

    CPU CI otherwise never exercises it (_use_ns is False on the cpu
    backend, so test_cycle.py only covers the per-group eigh fallback);
    forcing the backend guards stacked-vs-per-group equivalence against
    regression: mixed inflation values within and across groups,
    RTPP/RTPS on, and has_obs=False rows.
    """
    rng = np.random.default_rng(7)
    k = 16
    solver.set_eigh_backend("ns")
    a_gs, g_gs, xb_gs, has_gs = [], [], [], []
    inflats_gs = (((k - 1) / 1.6, (k - 1) / 1.6),
                  ((k - 1) / 1.1,),
                  ((k - 1) / 1.1, (k - 1) / 1.6, (k - 1) / 1.3))
    rtpp_gs = ((0.95, 0.0), (0.9,), (0.0, 0.95, 0.5))
    rtps_gs = ((0.0, 0.95), (0.95,), (0.95, 0.0, 0.5))
    for gi, inflats in enumerate(inflats_gs):
        b = 40 + 16 * gi
        a, g = _normal_case(rng, b, k, 30 + 10 * gi)
        a_gs.append(a)
        g_gs.append(g)
        xb_gs.append(jnp.asarray(
            rng.standard_normal((b, len(inflats), k)).astype(np.float32)))
        has_gs.append(jnp.asarray(rng.random(b) > 0.25))

    outs, diag = solver.letkf_solve_cycle_from_normal(
        a_gs, g_gs, xb_gs, inflats_gs, has_gs,
        rtpp_alpha_groups=rtpp_gs, rtps_alpha_groups=rtps_gs,
        return_diagnostics=True)
    assert float(diag["ns_residual"]) < 5e-4
    for gi in range(len(inflats_gs)):
        expect = np.asarray(solver.letkf_solve_group_from_normal(
            a_gs[gi], g_gs[gi], xb_gs[gi], inflats_gs[gi], has_gs[gi],
            rtpp_alpha=rtpp_gs[gi], rtps_alpha=rtps_gs[gi]))
        np.testing.assert_allclose(
            np.asarray(outs[gi]), expect, rtol=0,
            atol=5e-5 * max(np.abs(expect).max(), 1.0),
            err_msg=f"group {gi}")


@pytest.mark.parametrize("p", [200000, 526592, 64 * 3127, 131072])
def test_fused_table_slice_rows_sublane_aligned(p):
    """Slice rows must divide P and be 8-aligned (bitcast reshapes).

    Misaligned rows can make XLA insert a table-sized relayout copy, which
    at the k=96 production radar volume is another ~7.5 GB of device
    memory.
    """
    from cwbnwp_letkf_tpu.ops import dense

    n = 1
    if p > dense._TABLE_ROW_SLICE:
        for cand in range(-(-p // dense._TABLE_ROW_SLICE),
                          min(p, 1024) + 1):
            if p % cand == 0 and (p // cand) % 8 == 0:
                n = cand
                break
    assert p % n == 0
    rows = p // n
    if n > 1:
        assert rows % 8 == 0
        assert rows <= 4 * dense._TABLE_ROW_SLICE


@pytest.mark.parametrize("k", [8, 16, 24, 32, 40, 48, 64, 96])
def test_ns_invsqrt_matches_f64_oracle_at_production_conditioning(k):
    """XLA Newton-Schulz vs a float64 ``A^(-1/2)`` at kappa 1e2-1e3.

    The real cycle's normal matrices have kappa 10^2-10^3, where the
    iteration needs ~9-13 steps.  float32 bounds the accuracy at
    ~kappa * eps32 ~ 1e-4 relative, so 1e-3 leaves a margin of ten.
    """
    rng = np.random.default_rng(k)
    inflat = (k - 1) / 1.1
    a32 = production_matrices(rng, 16, k, inflat)
    a64 = a32.astype(np.float64) + inflat * np.eye(k)
    lam, v = np.linalg.eigh(a64)
    assert (lam[:, -1] / lam[:, 0]).min() > 90
    z_ref = (v / np.sqrt(lam)[:, None, :]) @ np.swapaxes(v, 1, 2)
    z, iters, resid = solver.ns_invsqrt(jnp.asarray(a32), inflat,
                                        return_info=True)
    assert float(resid) <= 1e-4
    assert int(iters) < 24
    err = np.abs(np.asarray(z, np.float64) - z_ref).max() / np.abs(z_ref).max()
    assert err < 1e-3, err


@pytest.mark.parametrize("dtype,path", [(jnp.float32, "ns"),
                                        (jnp.float64, "eigh")])
def test_gpu_dispatch_takes_xla_paths(monkeypatch, dtype, path):
    """On a GPU backend f32 solves take XLA Newton-Schulz and f64 solves
    take eigh; no Pallas module is ever imported."""
    calls = []
    ns, eigh = solver.ns_invsqrt, solver._eigh_batch
    monkeypatch.setattr(solver.jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(solver, "ns_invsqrt", lambda *a, **kw: (
        calls.append("ns"), ns(*a, **kw))[1])
    monkeypatch.setattr(solver, "_eigh_batch", lambda a: (
        calls.append("eigh"), eigh(a))[1])
    rng = np.random.default_rng(9)
    b, k = 32, 12
    a_obs, g = _normal_case(rng, b, k, 30)
    xb = jnp.asarray(rng.standard_normal((b, 2, k)))
    assert solver.uses_newton_schulz(dtype) == (path == "ns")
    xa = solver.letkf_solve_group_from_normal(
        a_obs, g, xb.astype(dtype), ((k - 1) / 1.1, (k - 1) / 1.6),
        jnp.ones(b, bool), rtpp_alpha=(0.9, 0.0), rtps_alpha=(0.0, 0.9),
        solver_dtype=dtype)
    assert np.isfinite(np.asarray(xa)).all()
    assert calls and set(calls) == {path}, calls
    assert not [m for m in sys.modules if "pallas" in m]


def test_set_eigh_backend_validates():
    for name in ("magma", "jacobi"):
        with pytest.raises(ValueError):
            solver.set_eigh_backend(name)
