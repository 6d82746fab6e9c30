"""Dense (one matmul) vs gather (top-k) normal-term accumulation.

The two backends (ops/dense.py vs ops/neighbors.py + ops/whiten.py) must
produce identical LETKF updates whenever the per-platform obs cap
``max_lz_pts`` is not hit, and nearest-subset-equivalent results when it is
(both keep the nearest in-radius obs; dense resolves the cap by radius
threshold — see the divergence note in ops/dense.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cwbnwp_letkf_tpu.config import MAX_VARS
from cwbnwp_letkf_tpu.constants import GC1999_SQ
from cwbnwp_letkf_tpu.obs.base import PlatformStatic, make_platform_obs
from cwbnwp_letkf_tpu.ops.dense import (DEFAULT_ACCUM_PRECISION,
                                        dense_platform_terms,
                                        platform_dense_tables)
from cwbnwp_letkf_tpu.ops.neighbors import normalize_coords, radius_neighbors
from cwbnwp_letkf_tpu.ops.update import prepare_platform, update_points
from cwbnwp_letkf_tpu.ops.whiten import accumulate_platform_terms

K = 8


def _platform(rng, nrec, nvar, max_lz_pts, hclr=60.0, vclr=3.0):
    xyz = np.stack([
        rng.uniform(-2e5, 2e5, nrec),
        rng.uniform(-2e5, 2e5, nrec),
        rng.uniform(0.0, 1.5e4, nrec),
    ], axis=1)
    obs = rng.normal(0.0, 2.0, (nvar, nrec))
    hdxb = obs[:, :, None] + rng.normal(0.0, 1.0, (nvar, nrec, K))
    error = rng.uniform(0.5, 2.0, (nvar, nrec))
    qc = np.zeros((nvar, nrec, K))
    qc[:, ::7, :] = -1.0
    po = make_platform_obs(xyz, obs, hdxb, error, qc, dtype=np.float64)
    st = PlatformStatic(
        name="synop", kind="gts", nvar=nvar, max_lz_pts=max_lz_pts,
        hclr=tuple([hclr] * MAX_VARS), vclr=tuple([vclr] * MAX_VARS),
        err_muti=tuple(0.9 + 0.05 * v for v in range(nvar)),
        err_rej=tuple([5.0] * nvar),
        is_assim=tuple(tuple([v != 1] * MAX_VARS) for v in range(nvar)),
    )
    return st, po


def _points(rng, b):
    return np.stack([
        rng.uniform(-2e5, 2e5, b),
        rng.uniform(-2e5, 2e5, b),
        rng.uniform(0.0, 1.5e4, b),
    ], axis=1)


@pytest.mark.parametrize("wf", [0, 1])
def test_dense_matches_gather_under_cap(wf):
    """Cap never hit -> both backends see identical obs sets."""
    rng = np.random.default_rng(3)
    st, po = _platform(rng, nrec=120, nvar=3, max_lz_pts=200)
    dp = prepare_platform(st, po)
    ivar = 1
    q = jnp.asarray(_points(rng, 50))
    qn = normalize_coords(q, st.hclr[ivar], st.vclr[ivar])
    on = normalize_coords(dp.xyz, st.hclr[ivar], st.vclr[ivar])

    tab = platform_dense_tables(dp.stats, st.assim_mask(ivar),
                                solver_dtype=jnp.float64)
    a_d, g_d, c_d = dense_platform_terms(
        qn, on, tab, n_max=st.max_lz_pts, weight_function=wf,
        solver_dtype=jnp.float64)

    nb = radius_neighbors(qn, on, n_max=st.max_lz_pts, chunk=64)
    a_g, g_g, c_g = accumulate_platform_terms(
        nb, dp.stats, st.assim_mask(ivar), wf, solver_dtype=jnp.float64)

    np.testing.assert_array_equal(np.asarray(c_d), np.asarray(c_g))
    np.testing.assert_allclose(np.asarray(a_d), np.asarray(a_g),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(np.asarray(g_d), np.asarray(g_g),
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("wf", [0, 1])
def test_dense_matches_gather_over_cap(wf):
    """Cap binding: both keep the nearest subset (no distance ties in
    generic random data within the multisection resolution)."""
    rng = np.random.default_rng(4)
    # tight cap: ~everything is in radius (hclr huge), cap selects nearest 12
    st, po = _platform(rng, nrec=300, nvar=2, max_lz_pts=12,
                       hclr=500.0, vclr=50.0)
    dp = prepare_platform(st, po)
    ivar = 0
    q = jnp.asarray(_points(rng, 40))
    qn = normalize_coords(q, st.hclr[ivar], st.vclr[ivar])
    on = normalize_coords(dp.xyz, st.hclr[ivar], st.vclr[ivar])

    tab = platform_dense_tables(dp.stats, st.assim_mask(ivar),
                                solver_dtype=jnp.float64)
    a_d, g_d, c_d = dense_platform_terms(
        qn, on, tab, n_max=st.max_lz_pts, weight_function=wf,
        solver_dtype=jnp.float64)

    nb = radius_neighbors(qn, on, n_max=st.max_lz_pts, chunk=64)
    a_g, g_g, c_g = accumulate_platform_terms(
        nb, dp.stats, st.assim_mask(ivar), wf, solver_dtype=jnp.float64)

    # selection counts: dense keeps <= n_max records; every query has >=
    # n_max candidates here so the threshold resolves to exactly n_max
    # nearest records (both observed vars valid or not per record).
    np.testing.assert_array_equal(np.asarray(c_d), np.asarray(c_g))
    np.testing.assert_allclose(np.asarray(a_d), np.asarray(a_g),
                               rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(np.asarray(g_d), np.asarray(g_g),
                               rtol=1e-10, atol=1e-10)


def test_dense_cap_never_exceeded():
    rng = np.random.default_rng(5)
    st, po = _platform(rng, nrec=400, nvar=1, max_lz_pts=7,
                       hclr=900.0, vclr=-1.0)
    dp = prepare_platform(st, po)
    q = jnp.asarray(_points(rng, 64))
    qn = normalize_coords(q, st.hclr[0], st.vclr[0])
    on = normalize_coords(dp.xyz, st.hclr[0], st.vclr[0])
    tab = platform_dense_tables(dp.stats, st.assim_mask(0))
    _, _, cnt = dense_platform_terms(qn, on, tab, n_max=st.max_lz_pts,
                                     weight_function=0)
    # nvalid per record is 0 or 1 here (single observed var), so count equals
    # the number of selected valid records and must respect the cap
    assert int(jnp.max(cnt)) <= st.max_lz_pts


@pytest.mark.parametrize("wf", [0, 1])
def test_update_points_dense_vs_gather_end_to_end(wf):
    rng = np.random.default_rng(6)
    plats = [_platform(rng, 150, 3, 200),
             _platform(rng, 90, 1, 80, hclr=40.0)]
    dev = [prepare_platform(st, po) for st, po in plats]
    b = 70
    pts = jnp.asarray(_points(rng, b))
    xb = jnp.asarray(rng.normal(5.0, 2.0, (b, K)))
    kw = dict(inflat=(K - 1) / 1.2, weight_function=wf,
              use_rtps=True, rtps_alpha=0.9,
              solver_dtype=jnp.float64, chunk=32)
    xa_d = update_points(xb, pts, dev, 0, method="dense", **kw)
    xa_g = update_points(xb, pts, dev, 0, method="gather", **kw)
    np.testing.assert_allclose(np.asarray(xa_d), np.asarray(xa_g),
                               rtol=1e-10, atol=1e-12)


def test_accum_precision_knob():
    """set_accum_precision("highest") restores full-f32 accumulation: the
    result must land no further from a float64 oracle than "high"
    (parity-sensitive runs need the opt-out without paying for f64)."""
    from cwbnwp_letkf_tpu.ops.dense import set_accum_precision

    rng = np.random.default_rng(11)
    st, po = _platform(rng, 600, 2, 128)
    dp = prepare_platform(st, po)
    q = jnp.asarray(_points(rng, 64), jnp.float32)
    on = normalize_coords(dp.xyz, st.hclr[0], st.vclr[0])
    qn = normalize_coords(q, st.hclr[0], st.vclr[0])
    tab32 = platform_dense_tables(dp.stats, st.assim_mask(0),
                                  solver_dtype=jnp.float32)
    # float64 oracle (always HIGHEST)
    tab64 = platform_dense_tables(dp.stats, st.assim_mask(0),
                                  solver_dtype=jnp.float64)
    a64, g64, _ = dense_platform_terms(
        qn.astype(jnp.float64), on.astype(jnp.float64), tab64,
        n_max=st.max_lz_pts, weight_function=0, solver_dtype=jnp.float64)

    def err(prec):
        set_accum_precision(prec)
        try:
            a, g, _ = dense_platform_terms(
                qn, on, tab32, n_max=st.max_lz_pts, weight_function=0,
                solver_dtype=jnp.float32)
        finally:
            set_accum_precision(DEFAULT_ACCUM_PRECISION)
        scale = float(jnp.max(jnp.abs(a64)))
        return float(jnp.max(jnp.abs(a.astype(jnp.float64) - a64))) / scale

    e_hi = err("highest")
    # CPU lowers both precisions to the same f32 matmul, so only assert the
    # ordering weakly: highest must never be WORSE than the default
    assert e_hi <= err("high") + 1e-9
    assert e_hi < 1e-5


def test_fused_table_sliced_build_matches_oneshot(monkeypatch):
    """Row-sliced table einsum == one-shot, bit-exact.

    The sliced path bounds the [R, k, k+1] einsum transient at the k=96
    production radar volume; each slice computes the identical einsum on a
    row subset, so the result must match the one-shot table exactly.
    """
    from cwbnwp_letkf_tpu.ops import dense
    from cwbnwp_letkf_tpu.ops.whiten import platform_obs_stats

    rng = np.random.default_rng(5)
    v, r, k = 2, 200, 10
    stats = platform_obs_stats(
        rng.normal(0, 1, (v, r)).astype(np.float32),
        rng.normal(0, 1, (v, r, k)).astype(np.float32),
        np.full((v, r), 0.7, np.float32),
        np.zeros((v, r, k), np.int32), (1.0, 1.0), (5.0, 5.0))
    mask = (True, True)
    order = np.argsort(rng.random(r))
    one, nv1 = dense.fused_platform_table(
        stats, mask, order=jnp.asarray(order), pad_to=256)
    monkeypatch.setattr(dense, "_TABLE_ROW_SLICE", 64)   # 256 -> 4 slices
    sliced, nv2 = dense.fused_platform_table(
        stats, mask, order=jnp.asarray(order), pad_to=256)
    np.testing.assert_array_equal(np.asarray(one), np.asarray(sliced))
    np.testing.assert_array_equal(np.asarray(nv1), np.asarray(nv2))


@pytest.mark.parametrize("wf", [0, 1])
def test_default_accum_precision_against_float64(wf):
    """The f32 accumulation at the default precision vs float64 terms.

    On the CPU every f32 precision is a true f32 matmul, so the error is
    f32 accumulation roundoff (~1e-7 relative, 1e-5 bounds it); the GPU's
    lowering of the default is measured against the same oracle by
    chip_smoke.py's precision phase.
    """
    rng = np.random.default_rng(12 + wf)
    st, po = _platform(rng, 600, 2, 128)
    dp = prepare_platform(st, po)
    q = jnp.asarray(_points(rng, 64), jnp.float32)
    on = normalize_coords(dp.xyz, st.hclr[0], st.vclr[0])
    qn = normalize_coords(q, st.hclr[0], st.vclr[0])
    terms = {}
    for dt in (jnp.float32, jnp.float64):
        tab = platform_dense_tables(dp.stats, st.assim_mask(0),
                                    solver_dtype=dt)
        terms[dt] = dense_platform_terms(
            qn.astype(dt), on.astype(dt), tab, n_max=st.max_lz_pts,
            weight_function=wf, solver_dtype=dt)
    for x32, x64 in zip(terms[jnp.float32][:2], terms[jnp.float64][:2]):
        x64 = np.asarray(x64)
        err = np.abs(np.asarray(x32, np.float64) - x64).max()
        assert err < 1e-5 * np.abs(x64).max(), err
    np.testing.assert_array_equal(np.asarray(terms[jnp.float32][2]),
                                  np.asarray(terms[jnp.float64][2]))
