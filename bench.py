"""Benchmark: production-shaped LETKF cycle throughput on one GPU.

Prints ONE JSON line:

  {"metric": "analysis_var_gridpoint_updates_per_s", "value": N,
   "unit": "var-point updates/s (production-grouped 16-var cycle)",
   "vs_baseline": R, "device": {...}, "detail": {...}}

Primary number: the PRODUCTION-GROUPED cycle — the 16 analysis variables of
the reference's input.nml:7 with its per-variable localization radii
(input.nml:38-55): the 8 hydrometeors fuse into ONE weight computation
(identical localization signature, dbz hclr=8/vclr=2), the rest group by
radii signature ([U,V] 36/3, [W] 12/3, [T,QVAPOR] 24/3, [MU,P,PH] 24/2-D) —
5 group solves per cycle instead of the reference's 16 full pipelines.

``detail`` carries batched k x k factorization rates (Newton-Schulz
inverse-sqrt, XLA eigh), the Newton-Schulz rate against a large f32 matmul
probe on the same card, a float64 solve measurement (SURVEY hard part d),
and the production-envelope leg.

``vs_baseline`` compares against a socket-equivalent CPU baseline measured
in-process: a per-gridpoint NumPy/LAPACK transcription of the reference's
serial solve (dsyevd + gemv per point, module_letkf_core.f90:598-700) on a
sampled subset, scaled to 48 cores (one A64FX socket, the reference's target
node, Makefile:8).  The reference itself publishes no numbers
(BASELINE.md), so this stand-in anchors the ratio.

Case: k=40 members, 128x128x20 idealized grid (327,680 points; one point set
for all variables — the synthetic grid is unstaggered), synop 2,000 recs x 5
obsvars (cap 100) + vr 20,000 recs (cap 300) + dbz 20,000 recs (cap 300).

    python bench.py     # one process, one GPU
"""
import json
import os
import sys
import time

os.environ.setdefault("OMP_NUM_THREADS", "1")
os.environ.setdefault("OPENBLAS_NUM_THREADS", "1")

import numpy as np  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

K = 40
SOCKET_CORES = 48  # A64FX socket (FX1000 node)
N_VARS = 16        # production cycle updates 16 variables (input.nml:7)

#: var_update positions (input.nml:7):
#: 0:U 1:V 2:W 3:T 4:QVAPOR 5-12:hydrometeors 13:MU 14:P 15:PH
HYDRO = tuple(range(5, 13))

#: production variable groups by localization signature (input.nml:38-55);
#: each entry: (name, ivars, per-platform radii {plat: (hclr, vclr)})
PROD_GROUPS = (
    ("UV",    (0, 1),   {"synop": (50.0, 3.0), "vr": (36.0, 3.0)}),
    ("W",     (2,),     {"synop": (50.0, 3.0), "vr": (12.0, 3.0)}),
    ("TQv",   (3, 4),   {"synop": (50.0, 3.0), "vr": (24.0, 3.0)}),
    ("hydro", HYDRO,    {"dbz": (8.0, 2.0)}),
    ("MuPPh", (13, 14, 15), {"synop": (50.0, -1.0), "vr": (24.0, -1.0)}),
)

#: multiplicative inflation (input.nml:160-170): 1.6 dynamics, 1.1 moisture
MULTI_INFL = tuple(1.1 if i >= 4 else 1.6 for i in range(N_VARS))
RTPP = 0.95
RTPS = 0.95


def build_case(k=K, nx=128, nz=20, n_obs=(2000, 20000, 20000), seed=0):
    """The headline case: ``(pts [B, 3], xb [B, k], [(static, obs)] * 3)``.

    The defaults are the benchmark's; smaller arguments give the same
    shape of case for tests.  ``n_obs`` is the (synop, vr, dbz) record
    count.
    """
    from cwbnwp_letkf_tpu.config import MAX_VARS
    from cwbnwp_letkf_tpu.obs.base import PlatformStatic
    from cwbnwp_letkf_tpu.obs.synthetic import (
        correlated_ensemble, idealized_grid, synthetic_gts_platform)

    rng = np.random.default_rng(seed)
    # dx=10 km x 128 -> 1280 km domain: the production domain EXTENT
    # (450x450 @ 3 km ~ 1350 km, the scale the namelist radii were tuned
    # for) at a benchable point count; radius-to-domain ratios match
    # production, so spatial culling behaves as it would there.
    pts = idealized_grid(nx, nx, nz, dx_m=1280e3 / nx)
    truth, xb = correlated_ensemble(rng, pts, k, n_bumps=8, length_m=1.5e5)

    def radii(plat, default=-1.0):
        h = [default] * MAX_VARS
        v = [default] * MAX_VARS
        for _, ivars, rmap in PROD_GROUPS:
            if plat in rmap:
                for iv in ivars:
                    h[iv], v[iv] = rmap[plat]
        return tuple(h), tuple(v)

    plats = []
    for (name, nvar, cap, err), nobs in zip(
            (("synop", 5, 100, 0.5), ("vr", 1, 300, 1.0),
             ("dbz", 1, 300, 2.5)), n_obs):
        # obs across the FULL domain (production networks/radar mosaics
        # cover the grid; extent_frac=0.5 would pack all obs into the
        # central quarter, defeating spatial culling for the large-radius
        # groups)
        st0, po = synthetic_gts_platform(
            rng, pts, truth, xb, name=name, nobs=nobs, nvar=nvar,
            obs_err=err, max_lz_pts=cap, extent_frac=1.0)
        h, v = radii(name)
        st = PlatformStatic(
            name=name, kind=st0.kind, nvar=nvar, max_lz_pts=cap,
            hclr=h, vclr=v, err_muti=st0.err_muti, err_rej=st0.err_rej,
            is_assim=st0.is_assim)
        plats.append((st, po))
    return pts, xb, plats


def _best_of(run, n=1):
    """Best steady wall time of ``n`` passes."""
    best = float("inf")
    for _ in range(n):
        t0 = time.time()
        run()
        best = min(best, time.time() - t0)
    return best


def _fetch(x):
    """Completion barrier: wait for ``x`` and check a digest is finite."""
    import jax

    jax.block_until_ready(x)
    h = np.asarray(x.reshape(-1)[:1024])
    assert np.isfinite(h).all()
    return h


def _prod_cycle_groups(k=K):
    from cwbnwp_letkf_tpu.ops.cycle import CycleGroup

    out = []
    for name, ivars, _ in PROD_GROUPS:
        nv = len(ivars)
        out.append(CycleGroup(
            ivars=ivars,
            inflats=tuple((k - 1) / MULTI_INFL[iv] for iv in ivars),
            rtpp_alpha=(RTPP,) * nv,
            rtps_alpha=(RTPS,) * nv))
    return tuple(out)


def bench_production(pts, xb, plats):
    """FUSED production cycle: all 5 variable groups in one traced program.

    ops/cycle.py shares the culling geometry across groups; the per-group
    path is kept as the ``pergroup`` leg for the fusion comparison.
    """
    import jax
    import jax.numpy as jnp
    from cwbnwp_letkf_tpu.ops.cycle import (plan_cycle_budgets,
                                            update_points_cycle)
    from cwbnwp_letkf_tpu.ops.solver import uses_newton_schulz
    from cwbnwp_letkf_tpu.ops.update import DevicePlatform, prepare_platform

    dev = [prepare_platform(st, po) for st, po in plats]
    statics = [dp.static for dp in dev]
    arrays = [(dp.xyz, dp.stats) for dp in dev]
    xb_d = jnp.asarray(xb)
    pts_d = jnp.asarray(pts)
    b = pts.shape[0]
    groups = _prod_cycle_groups()
    v_tot = sum(len(g.ivars) for g in groups)

    _log("planning cycle budgets")
    budgets = plan_cycle_budgets(pts_d, dev, groups, chunk=4096,
                                 subchunk=512)
    _log(f"budgets: {budgets}")

    @jax.jit
    def cycle_fn(xb_a, pts_a, arrays_a):
        plats_a = [DevicePlatform(static=st, xyz=xyz, stats=stats)
                   for st, (xyz, stats) in zip(statics, arrays_a)]
        xb_v = jnp.broadcast_to(xb_a[:, None, :], (b, v_tot, K))
        return update_points_cycle(
            xb_v, pts_a, plats_a, groups, weight_function=0,
            chunk=4096, subchunk=512, max_blocks=budgets,
            return_diagnostics=True)

    _log("warming fused cycle")
    xa, diag = cycle_fn(xb_d, pts_d, arrays)
    _fetch(xa)
    _log("fused cycle compiled")
    t0 = time.time()
    xa, diag = cycle_fn(xb_d, pts_d, arrays)
    _fetch(xa)
    cycle_wall = time.time() - t0
    cycle_wall = min(cycle_wall, _best_of(
        lambda: _fetch(cycle_fn(xb_d, pts_d, arrays)[0])))

    vpps = N_VARS * b / cycle_wall
    return vpps, {
        "grouping": "production-fused-cycle",
        "points": b, "k": K, "n_vars": N_VARS,
        "cycle_wall_s": round(cycle_wall, 2),
        "bucket_overflow": int(diag["bucket_overflow"]),
        "ns_residual": float(diag["ns_residual"]),
        "cycle_budgets": {n: list(bb) for n, bb in (budgets or {}).items()},
        "solver": ("xla-newton-schulz" if uses_newton_schulz(jnp.float32)
                   else "xla-eigh"),
    }


def bench_pergroup(pts, xb, plats):
    """One program per variable group: the fusion comparison baseline."""
    import jax
    import jax.numpy as jnp
    from cwbnwp_letkf_tpu.ops.update import (DevicePlatform, plan_max_blocks,
                                             prepare_platform,
                                             update_points_group)

    dev = [prepare_platform(st, po) for st, po in plats]
    statics = [dp.static for dp in dev]
    arrays = [(dp.xyz, dp.stats) for dp in dev]
    xb_d = jnp.asarray(xb)
    pts_d = jnp.asarray(pts)
    b = pts.shape[0]

    runs = []
    for name, ivars, _ in PROD_GROUPS:
        nv = len(ivars)
        kw = dict(
            ivars=ivars,
            inflats=tuple((K - 1) / MULTI_INFL[iv] for iv in ivars),
            weight_function=0,
            rtpp_alpha=(RTPP,) * nv,
            rtps_alpha=(RTPS,) * nv,
            chunk=2048)
        # plan eagerly, obs arrays as jit ARGUMENTS (see bench_production)
        budgets = plan_max_blocks(pts_d, dev, ivars[0], chunk=2048)

        @jax.jit
        def group_fn(xb_a, pts_a, arrays_a, kw=kw, budgets=budgets, nv=nv):
            plats_a = [DevicePlatform(static=st, xyz=xyz, stats=stats)
                       for st, (xyz, stats) in zip(statics, arrays_a)]
            xb_v = jnp.broadcast_to(xb_a[:, None, :], (b, nv, K))
            return update_points_group(xb_v, pts_a, plats_a,
                                       max_blocks=budgets, **kw)

        def dispatch(fn=group_fn):
            return fn(xb_d, pts_d, arrays)

        runs.append((name, nv, dispatch))

    for name, _, dispatch in runs:
        _fetch(dispatch())
        _log(f"pergroup {name} compiled")
    t0 = time.time()
    outs = [dispatch() for _, _, dispatch in runs]
    for xa in outs:
        _fetch(xa)
    wall = time.time() - t0
    per_group = {}
    for name, _, dispatch in runs:
        per_group[name] = round(_best_of(lambda: _fetch(dispatch())), 2)
    return {
        "pergroup_wall_s": round(wall, 2),
        "pergroup_var_points_per_s": round(N_VARS * b / wall, 1),
        "pergroup_group_wall_s": per_group,
    }


def bench_peak_fused(pts, xb, plats):
    """Best case: 16 copies of one variable, 100% fused."""
    import jax
    import jax.numpy as jnp
    from cwbnwp_letkf_tpu.ops.update import (DevicePlatform,
                                             prepare_platform,
                                             update_points_group)

    dev = [prepare_platform(st, po) for st, po in plats[:2]]  # synop + vr
    statics = [dp.static for dp in dev]
    arrays = [(dp.xyz, dp.stats) for dp in dev]
    xb_d = jnp.asarray(xb)
    b = pts.shape[0]
    pts_d = jnp.asarray(pts)
    kw = dict(
        ivars=(0,) * N_VARS,
        inflats=tuple((K - 1) / 1.1 for _ in range(N_VARS)),
        weight_function=0,
        rtpp_alpha=(0.0,) * N_VARS,
        rtps_alpha=(0.9,) * N_VARS,
        chunk=2048)
    xb_v = jnp.broadcast_to(xb_d[:, None, :], (b, N_VARS, K))

    @jax.jit
    def fused_fn(xb_a, pts_a, arrays_a):
        plats_a = [DevicePlatform(static=st, xyz=xyz, stats=stats)
                   for st, (xyz, stats) in zip(statics, arrays_a)]
        return update_points_group(xb_a, pts_a, plats_a, **kw)

    def run():
        return _fetch(fused_fn(xb_v, pts_d, arrays))

    run()
    dt = _best_of(run)
    return N_VARS * b / dt, dt


def bench_solver_rates():
    """Batched k x k factorization rates, and NS against a matmul probe."""
    import jax
    import jax.numpy as jnp
    from cwbnwp_letkf_tpu.ops.solver import (letkf_solve_group_from_normal,
                                             letkf_solve_group_refined,
                                             ns_invsqrt)

    rng = np.random.default_rng(0)
    bsz = 4096
    y = rng.standard_normal((bsz, K, 300)).astype(np.float32) * 0.3
    a_obs = jnp.asarray(y @ np.transpose(y, (0, 2, 1)))
    a_full = a_obs + (K - 1) / 1.1 * jnp.eye(K, dtype=jnp.float32)
    out = {}

    def rate(f, *args, n=10):
        _fetch(f(*args))
        t0 = time.time()
        for _ in range(n):
            r = f(*args)
        _fetch(r)
        return bsz * n / (time.time() - t0)

    out["ns_invsqrt_per_s"] = round(rate(jax.jit(
        lambda a: ns_invsqrt(a, (K - 1) / 1.1)), a_obs), 0)

    # k=96 — the PRODUCTION ensemble size (input.nml:6)
    k96 = 96
    y96 = rng.standard_normal((1024, k96, 300)).astype(np.float32) * 0.3
    a96 = jnp.asarray(y96 @ np.transpose(y96, (0, 2, 1)))

    def rate96(f, n=6):
        _fetch(f(a96))
        t0 = time.time()
        for _ in range(n):
            r = f(a96)
        _fetch(r)
        return round(1024 * n / (time.time() - t0), 0)

    out["ns96_invsqrt_per_s"] = rate96(jax.jit(
        lambda a: ns_invsqrt(a, (k96 - 1) / 1.1)))
    out["xla_eigh_per_s"] = round(rate(
        jax.jit(lambda a: jnp.linalg.eigh(a)[1]), a_full, n=3), 0)

    # NS against a probe on the same card: (a) the executed iteration
    # count from the while_loop carry; (b) what a large f32 matmul at the
    # precision the NS iteration uses (HIGHEST) reaches here.  The share
    # is NS's achieved flop rate over the probe's.
    _, iters, resid = jax.jit(
        lambda a: ns_invsqrt(a, (K - 1) / 1.1, return_info=True))(a_obs)
    iters = int(iters)
    out["ns_iters"] = iters
    out["ns_residual"] = float(resid)
    n = 4096
    x = jnp.asarray(rng.standard_normal((n, n)).astype(np.float32))
    mm = jax.jit(lambda a, b: jnp.dot(
        a, b, precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32))
    _fetch(mm(x, x))
    reps = 8
    t0 = time.time()
    r = x
    for _ in range(reps):
        r = mm(r, x)
    _fetch(r)
    probe = reps * 2 * n**3 / (time.time() - t0)
    out["f32_highest_matmul_probe_tflops"] = round(probe / 1e12, 2)
    achieved = out["ns_invsqrt_per_s"] * iters * 3 * 2 * K**3
    out["ns_achieved_tflops"] = round(achieved / 1e12, 3)
    out["ns_share_of_matmul_probe"] = round(achieved / probe, 3)

    # float64 parity-mode solve (eigh path) vs the same-shape float32 NS
    # solve — quantifies SURVEY hard part (d)
    nb = bsz
    g = jnp.asarray(rng.standard_normal((nb, K)).astype(np.float64))
    xbv = jnp.asarray(rng.standard_normal((nb, 2, K)).astype(np.float64))
    a64 = jnp.asarray(np.asarray(a_obs, np.float64))

    def solve(a, g, x, dt):
        return letkf_solve_group_from_normal(
            a, g, x, ((K - 1) / 1.1, (K - 1) / 1.6), jnp.ones(nb, bool),
            rtpp_alpha=(0.95, 0.95), rtps_alpha=(0.95, 0.95),
            solver_dtype=dt)

    f32 = jax.jit(lambda a, g, x: solve(a, g, x, jnp.float32))
    f32v = round(rate(f32, a_obs, g.astype(jnp.float32),
                      xbv.astype(jnp.float32), n=5), 0)
    f64 = jax.jit(lambda a, g, x: solve(a, g, x, jnp.float64))
    f64v = round(rate(f64, a64, g, xbv, n=2), 0)
    out["f32_solve_points_per_s"] = f32v
    out["f64_solve_points_per_s"] = f64v
    out["f64_vs_f32_slowdown"] = round(f32v / f64v, 1)

    # f32 NS + ONE double-word Newton refinement of Z; accuracy measured
    # against the full-f64 eigh solve on the same inputs
    fr = jax.jit(lambda a, gg, x: letkf_solve_group_refined(
        a, gg, x, ((K - 1) / 1.1, (K - 1) / 1.6), jnp.ones(nb, bool),
        rtpp_alpha=(0.95, 0.95), rtps_alpha=(0.95, 0.95)))
    v = round(rate(fr, a64, g, xbv, n=3), 0)
    out["f64_refined_solve_points_per_s"] = v
    xa_r = np.asarray(fr(a64, g, xbv))
    xa_o = np.asarray(f64(a64, g, xbv))
    xa_f = np.asarray(f32(a_obs, g.astype(jnp.float32),
                          xbv.astype(jnp.float32)), np.float64)
    sc = np.abs(xa_o).max()
    out["f64_refined_max_err_vs_f64"] = float(np.abs(xa_r - xa_o).max() / sc)
    out["f32_max_err_vs_f64"] = float(np.abs(xa_f - xa_o).max() / sc)
    out["f64_refined_vs_f32_slowdown"] = round(f32v / v, 1)
    return out


def bench_radar_scale():
    """Bucketed culling at PRODUCTION radar volume: R = 200k records.

    The main case caps radar at 20k records, near the dense crossover;
    this leg reports var-point updates/s through a single-variable
    update against one 200k-record dbz volume with exact planned budgets,
    plus the realized budget, to show per-obs cost stays set by local obs
    density rather than R (ops/bucketed.py's design claim).
    """
    import jax
    import jax.numpy as jnp
    from cwbnwp_letkf_tpu.config import MAX_VARS
    from cwbnwp_letkf_tpu.obs.base import PlatformStatic
    from cwbnwp_letkf_tpu.obs.synthetic import (
        correlated_ensemble, idealized_grid, synthetic_gts_platform)
    from cwbnwp_letkf_tpu.ops.update import (plan_max_blocks,
                                             prepare_platform, update_points)

    rng = np.random.default_rng(7)
    pts = idealized_grid(96, 96, 20, dx_m=10e3)          # 184,320 points
    truth, xb = correlated_ensemble(rng, pts, K, n_bumps=8, length_m=1.5e5)
    r_big = 200_000
    st0, po = synthetic_gts_platform(
        rng, pts, truth, xb, name="dbz", nobs=r_big, obs_err=2.5,
        max_lz_pts=300, extent_frac=1.0)
    h = [8.0] * MAX_VARS
    v = [2.0] * MAX_VARS
    st = PlatformStatic(
        name="dbz", kind=st0.kind, nvar=1, max_lz_pts=300,
        hclr=tuple(h), vclr=tuple(v), err_muti=st0.err_muti,
        err_rej=st0.err_rej, is_assim=st0.is_assim)
    from cwbnwp_letkf_tpu.ops.update import DevicePlatform

    dev = prepare_platform(st, po)
    pts_d = jnp.asarray(pts)
    xb_d = jnp.asarray(xb)
    b = pts.shape[0]

    budgets = plan_max_blocks(pts_d, [dev], 0, chunk=2048, method="bucketed")

    # obs arrays go in as jit ARGUMENTS (the sharded production path's
    # pattern, parallel/update.py): a closure would bake the ~1.3 GB of
    # 200k-record tables into the program as constants
    def fn_(x, q, xyz, stats):
        plat = DevicePlatform(static=st, xyz=xyz, stats=stats)
        return update_points(
            x, q, [plat], 0, inflat=(K - 1) / 1.1, weight_function=0,
            chunk=2048, method="bucketed", max_blocks=budgets,
            return_diagnostics=True)

    fn = jax.jit(fn_)
    xa, diag = fn(xb_d, pts_d, dev.xyz, dev.stats)
    _fetch(xa)
    t0 = time.time()
    xa, diag = fn(xb_d, pts_d, dev.xyz, dev.stats)
    _fetch(xa)
    dt = time.time() - t0
    return {
        "radar200k_records": r_big,
        "radar200k_points_per_s": round(b / dt, 0),
        "radar200k_wall_s": round(dt, 2),
        "radar200k_max_blocks": budgets.get("dbz"),
        "radar200k_overflow": int(diag["bucket_overflow"]),
    }


#: the reference's production envelope (input.nml:6): 450x450x52 points at
#: 3 km / 400 m, 96 members, a 200k-record radar volume
PROD_GRID = (450, 450, 52)
PROD_K = 96
PROD_RADAR = 200_000
#: slabs the envelope is cut into, each one program call (the k=96 radar
#: table alone is ~7.5 GB).  Sized for a 16 GB device and not yet re-sized
#: for the H100's 80 GB.
PROD_SLABS = 20


def prod_shape_case(grid=PROD_GRID, k=PROD_K, r_obs=PROD_RADAR, seed=9):
    """The production-envelope case: ``(pts [B, 3], truth [B], plat, groups)``
    with ``plat`` one ``(PlatformStatic, PlatformObs)`` pair.

    One radar platform (vr, hclr 24 km / vclr 3 km, cap 300) feeding one
    variable group.  Records are presorted in Hilbert order in the
    blocking's metric, so the blocking skips the 2x-table reorder
    transient (ops/cycle._cycle_blocking presorted contract).  The
    background of any slab comes from :func:`prod_shape_background`.
    """
    import jax.numpy as jnp
    from cwbnwp_letkf_tpu.config import MAX_VARS
    from cwbnwp_letkf_tpu.obs.base import PlatformStatic, make_platform_obs
    from cwbnwp_letkf_tpu.obs.synthetic import idealized_grid
    from cwbnwp_letkf_tpu.ops.bucketed import hilbert3
    from cwbnwp_letkf_tpu.ops.cycle import CycleGroup
    from cwbnwp_letkf_tpu.ops.neighbors import normalize_coords

    rng = np.random.default_rng(seed)
    pts = idealized_grid(*grid, dx_m=3e3, dz_m=400.0)
    b = pts.shape[0]
    truth = (290.0 + 5.0 * np.exp(-(pts[:, 0] ** 2 + pts[:, 1] ** 2)
                                  / (4e5 ** 2))).astype(np.float32)
    gi = rng.integers(0, b, r_obs)
    oxyz = pts[gi] + rng.normal(0, 500.0, (r_obs, 3)).astype(np.float32)
    obs = truth[gi] + rng.normal(0, 1.0, r_obs).astype(np.float32)
    # speed-only case: member spread need not be spatially correlated
    hdxb = (truth[gi, None] - 2.0
            + rng.standard_normal((r_obs, k)).astype(np.float32))
    hclr, vclr = 24.0, 3.0
    keys = np.asarray(hilbert3(normalize_coords(
        jnp.asarray(oxyz), hclr, vclr)))
    order = np.argsort(keys)
    po = make_platform_obs(oxyz[order], obs[order], hdxb[order],
                           error=np.ones((1, r_obs), np.float32))
    st = PlatformStatic(
        name="vr", kind="radar", nvar=1, max_lz_pts=300,
        hclr=tuple([hclr] * MAX_VARS), vclr=tuple([vclr] * MAX_VARS),
        err_muti=(1.0,), err_rej=(5.0,),
        is_assim=(tuple([True] * MAX_VARS),))
    groups = (CycleGroup(ivars=(0,), inflats=((k - 1) / 1.1,),
                         rtpp_alpha=(RTPP,), rtps_alpha=(RTPS,)),)
    return pts, truth, (st, po), groups


def prod_shape_background(truth, lo, hi, k=PROD_K, seed=9):
    """Background ``[hi - lo, k]`` of points ``lo:hi`` (made per slab)."""
    rng = np.random.default_rng([seed, lo])
    return (truth[lo:hi, None] - 2.0
            + rng.standard_normal((hi - lo, k)).astype(np.float32))


def bench_prod_shape():
    """PRODUCTION shape: 10.53M points, k=96, 200k radar records.

    The namelist's real case (450x450x52 domain at 3 km, 96 members,
    input.nml:6), processed in ``PROD_SLABS`` slabs (the streaming CLI
    does the same per variable group).  Reports var-point updates/s for
    one variable group, the k=96 NS iteration count/residual, the device
    memory high-water, and overflow (must be 0).
    """
    import jax
    import jax.numpy as jnp
    from cwbnwp_letkf_tpu.ops.cycle import (plan_cycle_budgets,
                                            update_points_cycle)
    from cwbnwp_letkf_tpu.ops.solver import ns_invsqrt
    from cwbnwp_letkf_tpu.ops.update import DevicePlatform, prepare_platform

    k96 = PROD_K
    pts, truth, (st, po), groups = prod_shape_case()
    dev = prepare_platform(st, po)
    b = pts.shape[0]
    n_slabs = PROD_SLABS
    slab = -(-b // n_slabs)
    bounds = [(si * slab, min(b, (si + 1) * slab)) for si in range(n_slabs)]

    _log("prod_shape: planning budgets over slabs")
    merged = None
    for lo, hi in bounds:
        one = plan_cycle_budgets(
            jnp.asarray(pts[lo:hi]), [dev], groups,
            chunk=2048, subchunk=2048, obs_presorted=True)
        for name, bb in one.items():
            if merged is None or bb.max_blocks > merged.max_blocks:
                merged = bb
    budgets = {"vr": merged}
    dev.cache.clear()   # drop the eagerly-built 7.5 GB table before runs
    _log(f"prod_shape budgets: {budgets}")

    @jax.jit
    def slab_fn(xb_s, pts_s, xyz, stats):
        plat = DevicePlatform(static=st, xyz=xyz, stats=stats)
        return update_points_cycle(
            xb_s[:, None, :], pts_s, [plat], groups, weight_function=0,
            chunk=2048, subchunk=2048, max_blocks=budgets,
            obs_presorted=True, return_diagnostics=True)

    def upload(xb_host, lo, hi):
        args = (jax.device_put(xb_host), jax.device_put(pts[lo:hi]))
        jax.block_until_ready(args)
        return args

    def run_slab(args):
        xa, diag = slab_fn(*args, dev.xyz, dev.stats)
        _fetch(xa)
        return diag

    _log("prod_shape: warming")
    lo, hi = bounds[0]
    args0 = upload(prod_shape_background(truth, lo, hi, k96), lo, hi)
    ma = slab_fn.lower(*args0, dev.xyz, dev.stats).compile() \
        .memory_analysis()
    footprint_gb = round((ma.temp_size_in_bytes + ma.argument_size_in_bytes
                          + ma.output_size_in_bytes) / 2**30, 2)
    _log(f"prod_shape: compiled footprint {footprint_gb} GB")
    run_slab(args0)
    del args0
    _log("prod_shape: compiled; measuring all slabs")
    # h2d is timed separately from compute: each slab's upload finishes
    # before its compute starts
    ovf = 0
    resid = 0.0
    h2d_s = 0.0
    comp_s = 0.0
    for si, (lo, hi) in enumerate(bounds):
        xb_host = prod_shape_background(truth, lo, hi, k96)
        t1 = time.time()
        args = upload(xb_host, lo, hi)
        h2d_s += time.time() - t1
        t1 = time.time()
        d = run_slab(args)
        comp_s += time.time() - t1
        del args
        ovf += int(d["bucket_overflow"])
        resid = max(resid, float(d["ns_residual"]))
        if si % 5 == 0:
            _log(f"prod_shape: slab {si + 1}/{n_slabs} "
                 f"(h2d {h2d_s:.0f} s, compute {comp_s:.0f} s)")
    wall = h2d_s + comp_s

    mem = jax.local_devices()[0].memory_stats() or {}
    # k=96 NS characterization on one batch
    rng = np.random.default_rng(9)
    _, it96, r96 = jax.jit(lambda a: ns_invsqrt(
        a, (k96 - 1) / 1.1, return_info=True))(
            jnp.asarray(np.einsum(
                "bkn,bln->bkl",
                *(2 * [rng.standard_normal((512, k96, 300)).astype(
                    np.float32) * 0.2]))))
    peak = mem.get("peak_bytes_in_use", 0)
    return {
        "prod_shape_points": b,
        "prod_shape_k": k96,
        "prod_shape_radar_records": PROD_RADAR,
        "prod_shape_wall_s": round(wall, 2),
        "prod_shape_h2d_s": round(h2d_s, 2),
        "prod_shape_compute_s": round(comp_s, 2),
        "prod_shape_var_points_per_s": round(b / comp_s, 0),
        "prod_shape_var_points_per_s_incl_h2d": round(b / wall, 0),
        "prod_shape_overflow": ovf,
        "prod_shape_ns_residual": resid,
        "prod_shape_budget": list(budgets["vr"]),
        "prod_shape_ns96_iters": int(it96),
        "prod_shape_ns96_residual": float(r96),
        "prod_shape_device_peak_gb": (
            round(peak / 2**30, 2) if peak else None),
        "prod_shape_compiled_footprint_gb": footprint_gb,
    }


def bench_cpu_baseline(pts, xb, plats, n_sample=150):
    """Per-point NumPy/LAPACK stand-in for the reference's serial solve."""
    from cwbnwp_letkf_tpu.constants import GC1999_SQ

    rng = np.random.default_rng(1)
    sample = rng.choice(pts.shape[0], n_sample, replace=False)
    prepared = []
    for st, po in plats[:2]:
        iv = 0 if st.hclr[0] > 0 else 5
        hinv = 1.0 / (st.hclr[iv] * 1e3)
        vinv = 1.0 / (st.vclr[iv] * 1e3) if st.vclr[iv] > 0 else 0.0
        scale = np.array([hinv, hinv, vinv])
        mean = po.hdxb.mean(-1)
        bg = po.hdxb - mean[..., None]
        omm = po.obs - mean
        err = po.error * np.array(st.err_muti)[:, None]
        prepared.append((po.xyz * scale, scale, omm, bg, err))

    best = float("inf")
    for _rep in range(2):
        t0 = time.time()
        for i in sample:
            yo_all, yb_all = [], []
            for (oxyz, scale, omm, bg, err) in prepared:
                d = oxyz - pts[i] * scale
                r2 = (d ** 2).sum(1)
                hit = np.nonzero(r2 <= GC1999_SQ)[0]
                if hit.size == 0:
                    continue
                w = 1.0 / (err[:, hit] * np.exp(0.25 * r2[hit]))
                yo_all.append((omm[:, hit] * w).ravel())
                yb_all.append((bg[:, hit, :] * w[..., None]).reshape(-1, K))
            if not yo_all:
                continue
            yo = np.concatenate(yo_all)
            yb = np.concatenate(yb_all, 0).T  # [K, n]
            a = ((K - 1) / 1.1) * np.eye(K) + yb @ yb.T
            lam, vec = np.linalg.eigh(a)
            pa = (vec / lam) @ vec.T
            w_sqrt = (vec / np.sqrt(lam)) @ vec.T
            wm = pa @ (yb @ yo)
            xm = xb[i].mean()
            xp = xb[i] - xm
            _ = xm + wm @ xp + np.sqrt(K - 1.0) * (w_sqrt @ xp)
        best = min(best, time.time() - t0)
    return n_sample / best


def _log(msg):
    print(f"[bench {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr,
          flush=True)


def device_stamp():
    """Platform, device kind and count as JAX reports them, plus the card's
    name and power limit from ``nvidia-smi`` (where there is one)."""
    import shutil
    import subprocess

    import jax

    devs = jax.devices()
    out = {"platform": devs[0].platform, "kind": devs[0].device_kind,
           "count": len(devs)}
    if shutil.which("nvidia-smi"):
        out["nvidia_smi"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip()
    return out


def main():
    import jax

    from cwbnwp_letkf_tpu.cli import use_compile_cache

    use_compile_cache()
    # without x64, "float64" silently downcasts to f32 and the f64 parity
    # measurement would be fiction; all production-path dtypes are explicit
    # f32, so enabling it changes nothing else.
    jax.config.update("jax_enable_x64", True)

    pts, xb, plats = build_case()
    _log("case built")
    cpu_core_pps = bench_cpu_baseline(pts, xb, plats)
    _log(f"cpu baseline: {cpu_core_pps:.1f}")

    vpps, detail = bench_production(pts, xb, plats)
    _log(f"production cycle: {vpps:.0f} var-pts/s")
    detail["cpu_core_var_points_per_s"] = round(cpu_core_pps, 1)
    detail["socket_cores"] = SOCKET_CORES
    detail["baseline_method"] = (
        "in-process NumPy/LAPACK transcription of the reference's serial "
        "per-point solve (letkf_core.f90:598-700), tables pre-normalized "
        "once, 150-point sample, best-of-2 passes, x48 cores (one A64FX "
        "socket)")
    peak_vpps, peak_wall = bench_peak_fused(pts, xb, plats)
    detail.update(bench_pergroup(pts, xb, plats))
    detail["fused16_var_points_per_s"] = round(peak_vpps, 1)
    detail["fused16_wall_s"] = round(peak_wall, 2)
    detail.update(bench_solver_rates())
    detail.update(bench_radar_scale())
    detail.update(bench_prod_shape())
    print(json.dumps({
        "metric": "analysis_var_gridpoint_updates_per_s",
        "value": round(vpps, 1),
        "unit": "var-point updates/s (production-grouped 16-var cycle)",
        "vs_baseline": round(vpps / (cpu_core_pps * SOCKET_CORES), 2),
        "device": device_stamp(),
        "detail": detail,
    }))


if __name__ == "__main__":
    main()
