"""Bring-up check: the whole LETKF cycle on NVIDIA GPUs, end to end.

    python chip_smoke.py                # one card: phases 1-6
    python chip_smoke.py --four-cards   # the four-card path only

One process drives one card through the normal entry points, at the
production widths, and checks every result against the float64 oracle
(tests/reference_impl.py):

1. device     platform, device kind and count, JAX version, compile cache,
              and the card's name and power limit from ``nvidia-smi``;
2. solver     Newton-Schulz ``A^(-1/2)`` at [4096, 40, 40] and
              [4096, 96, 96] on production-conditioned matrices (kappa
              1e2-1e3) against a host float64 inverse square root; the
              float64 group solve (cuSOLVER eigh) and the double-word
              refined solve;
3. precision  the normal-term accumulation matmul at each f32 precision
              against float64, and the k=40 / k=96 cycle at each against
              the oracle;
4. cycle      the production-grouped fused cycle at k=40 over 327,680
              points (bench.build_case);
5. prod       one slab (~526k points) of the reference's 450x450x52 k=96
              envelope with the 200k-record radar volume
              (bench.prod_shape_case);
6. cli        ``python -m cwbnwp_letkf_tpu.cli`` on a seed-generated NetCDF
              case for the production namelist (examples/input.nml) at
              k=40 on 128x128x20, eager and ``--stream``.

Any failure raises and exits non-zero.  The script refuses to run when JAX
finds no GPU.  The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}``.

``--four-cards`` runs the CLI case of phase 6 across four cards, and what
it is compared with, from a parent that stays off the cards: (a) one child
whose mesh spans all four cards against a one-card child; (b) four
``--distributed`` children, one card each, against (a).
"""
import argparse
import json
import os
import re
import shutil
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

FIXTURE = os.path.join(HERE, "examples", "input.nml")
#: the cycle tolerance of the test suite (tests/test_cycle.py)
CYCLE_TOL = 5e-4
#: the multi-process tolerance of the test suite (tests/test_multiprocess.py)
MESH_TOL = 3e-5
#: Newton-Schulz stopping tolerance (ops/solver.ns_invsqrt)
NS_TOL = 1e-4
#: the phase-6 CLI case
CLI_CASE = dict(k=40, nx=128, ny=128, nz=20, n_synop=2000, n_radar=20000)


def _log(msg):
    print(f"[smoke] {msg}", flush=True)


def _check(ok, msg):
    if not ok:
        raise RuntimeError(f"check failed: {msg}")


def _import_package():
    """Import the package that sits beside this script, and no other."""
    import cwbnwp_letkf_tpu

    where = os.path.dirname(os.path.abspath(cwbnwp_letkf_tpu.__file__))
    _check(os.path.dirname(where) == HERE,
           f"cwbnwp_letkf_tpu imported from {where}, not from {HERE}")


def nvidia_smi() -> str:
    """``name, power.limit`` of every card, read without JAX."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def _timed(fn, *args, reps=3):
    """(result, best warm wall seconds) of ``fn(*args)``; the first call
    compiles and is not timed."""
    import jax

    out = jax.block_until_ready(fn(*args))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return out, best


def _memory_line(label, compiled):
    import jax

    ma = compiled.memory_analysis()
    peak = (jax.local_devices()[0].memory_stats() or {}).get(
        "peak_bytes_in_use")
    _log(f"{label}: device peak_bytes_in_use "
         f"{'not reported' if peak is None else f'{peak / 2**30:.3f} GiB'}; "
         f"compiled args {ma.argument_size_in_bytes / 2**30:.3f} GiB, "
         f"temps {ma.temp_size_in_bytes / 2**30:.3f} GiB, "
         f"outputs {ma.output_size_in_bytes / 2**30:.3f} GiB")


# ---------------------------------------------------------------------------
# the float64 oracle
# ---------------------------------------------------------------------------
def _whiten_table(st, po, weight_function, norain_value):
    """Per (var, record): accepted, ``omm/err`` and ``bg/err``, from the
    reference's own whitening at zero distance (its accept decision does not
    depend on distance; the distance only scales both by one weight)."""
    from tests import reference_impl as ref

    nvar, nrec = po.obs.shape
    k = po.hdxb.shape[-1]
    ok = np.zeros((nvar, nrec), bool)
    yo0 = np.zeros((nvar, nrec))
    yb0 = np.zeros((nvar, nrec, k))
    for v in range(nvar):
        for r in range(nrec):
            if not (po.qc[v, r] >= 0).any():
                continue
            err = float(po.error[v, r]) * st.err_muti[v]
            a, y, b = ref.whiten_obs(
                float(po.obs[v, r]), po.hdxb[v, r], err, 0.0, st.err_rej[v],
                weight_function,
                norain_value=norain_value if st.is_dbz else None)
            ok[v, r] = a
            yo0[v, r] = y
            yb0[v, r] = b
    return st, np.asarray(po.xyz, np.float64), ok, yo0, yb0


def oracle_group(xb, pts, tables, ivars, inflats, rtpp, rtps,
                 weight_function):
    """float64 analysis ``[n, V, k]`` of one variable group at ``pts``.

    ``tables`` come from :func:`_whiten_table`; ``ivars[0]`` gives the
    group's localization (radii, assimilation mask).  Each platform keeps
    its ``max_lz_pts`` nearest records inside the ``gc1999`` ball, then the
    accepted, assimilated obs go through ``reference_impl.letkf_solve``.
    """
    from cwbnwp_letkf_tpu.constants import GC1999_SQ
    from tests import reference_impl as ref

    iv = ivars[0]
    xa = np.array(xb, np.float64, copy=True)
    for i, p in enumerate(np.asarray(pts, np.float64)):
        yo, yb = [], []
        for st, xyz, ok, yo0, yb0 in tables:
            if not st.active(iv):
                continue
            mask = st.assim_mask(iv)
            hinv = 1.0 / (st.hclr[iv] * 1e3)
            vinv = 1.0 / (st.vclr[iv] * 1e3) if st.vclr[iv] > 0 else 0.0
            r2 = (((xyz - p) * np.array([hinv, hinv, vinv])) ** 2).sum(1)
            near = np.nonzero(r2 <= GC1999_SQ)[0]
            near = near[np.argsort(r2[near], kind="stable")][:st.max_lz_pts]
            for v in range(st.nvar):
                if not mask[v]:
                    continue
                sel = near[ok[v, near]]
                w = np.array([ref.error_inv(float(d), 1.0, weight_function)
                              for d in r2[sel]])
                yo.append(yo0[v, sel] * w)
                yb.append(yb0[v, sel] * w[:, None])
        if not yo or not sum(len(y) for y in yo):
            continue
        yo_i = np.concatenate(yo)
        yb_i = np.concatenate(yb, axis=0).T
        for j in range(len(ivars)):
            xa[i, j] = ref.letkf_solve(
                xb[i, j], yo_i, yb_i, inflats[j],
                use_rtpp=rtpp[j] > 0, rtpp_alpha=rtpp[j],
                use_rtps=rtps[j] > 0, rtps_alpha=rtps[j])
    return xa


def oracle_cycle(xb, pts, plats, groups, weight_function,
                 norain_value=-5.0):
    """float64 analysis ``[n, V_total, k]`` of a whole cycle at ``pts``."""
    tables = [_whiten_table(st, po, weight_function, norain_value)
              for st, po in plats]
    out, col = [], 0
    for grp in groups:
        nv = len(grp.ivars)
        out.append(oracle_group(xb[:, col:col + nv], pts, tables, grp.ivars,
                                grp.inflats, grp.rtpp_alpha, grp.rtps_alpha,
                                weight_function))
        col += nv
    return np.concatenate(out, axis=1)


def compare_oracle(label, xa, xa_ref, xb):
    """Max error of ``xa`` against the oracle, over ``max|xa|``; fails above
    the suite's cycle tolerance.  Returns the relative error."""
    xa = np.asarray(xa, np.float64)
    err = float(np.abs(xa - xa_ref).max())
    scale = float(np.abs(xa_ref).max())
    incr = float(np.abs(xa_ref - np.asarray(xb, np.float64)).max())
    _log(f"{label}: max|xa - oracle| = {err:.3e} = {err / scale:.3e} of "
         f"max|xa| ({scale:.4g}), {err / max(incr, 1e-300):.3e} of the "
         f"largest increment ({incr:.4g}); tolerance "
         f"{CYCLE_TOL} of max|xa|")
    return err / scale


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------
def phase_device(smi):
    import jax

    devs = jax.devices()
    cache = (os.environ.get("JAX_COMPILATION_CACHE_DIR")
             or jax.config.jax_compilation_cache_dir)
    _log(f"device: platform {devs[0].platform}, kind {devs[0].device_kind}, "
         f"count {len(devs)}, jax {jax.__version__}, compile cache {cache}")
    _log(f"device: nvidia-smi name, power.limit: {smi}")


def production_matrices(rng, b, k, inflat):
    """``a_obs [b, k, k]`` whose ``A = a_obs + inflat*I`` has a condition
    number log-uniform in [1e2, 1e3], the range of the real cycle's normal
    matrices; the spectrum of ``a_obs`` decays to zero as a rank-poor obs
    term does."""
    kappa = 10.0 ** rng.uniform(2.0, 3.0, b)
    lam = inflat * (kappa - 1.0)[:, None] * rng.uniform(size=(b, k)) ** 4
    lam[:, 0] = inflat * (kappa - 1.0)
    lam[:, -1] = 0.0
    q, _ = np.linalg.qr(rng.standard_normal((b, k, k)))
    a = (q * lam[:, None, :]) @ np.swapaxes(q, 1, 2)
    return (0.5 * (a + np.swapaxes(a, 1, 2))).astype(np.float32)


def phase_solver(batch=4096, ks=(40, 96), f64_batch=1024, reps=3):
    import jax
    import jax.numpy as jnp

    from cwbnwp_letkf_tpu.ops.solver import (letkf_solve_group_from_normal,
                                             letkf_solve_group_refined,
                                             ns_invsqrt)

    rng = np.random.default_rng(1)
    for k in ks:
        inflat = (k - 1) / 1.1
        a32 = production_matrices(rng, batch, k, inflat)
        a64 = a32.astype(np.float64) + inflat * np.eye(k)
        lam, v = np.linalg.eigh(a64)
        z_ref = (v / np.sqrt(lam)[:, None, :]) @ np.swapaxes(v, 1, 2)
        kappa = lam[:, -1] / lam[:, 0]
        fn = jax.jit(lambda a: ns_invsqrt(a, inflat, return_info=True))
        (z, iters, resid), dt = _timed(fn, jnp.asarray(a32), reps=reps)
        z = np.asarray(z, np.float64)
        err = float(np.abs(z - z_ref).max() / np.abs(z_ref).max())
        _log(f"solver: XLA Newton-Schulz [{batch},{k},{k}] kappa "
             f"{kappa.min():.0f}-{kappa.max():.0f}: {int(iters)} iterations, "
             f"residual {float(resid):.2e}, max rel err vs float64 "
             f"{err:.2e}, {dt * 1e3:.3f} ms warm = {batch / dt:,.0f} "
             "solves/s")
        _check(float(resid) <= NS_TOL, f"NS residual {float(resid)} at k={k}")
        _check(err < 1e-3, f"NS error {err} at k={k}")

    # the float64 group solve (eigh) and the double-word refined solve
    prev_x64 = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        for k in ks:
            b = f64_batch
            inflats = ((k - 1) / 1.1, (k - 1) / 1.6)
            a = jnp.asarray(production_matrices(rng, b, k, inflats[0])
                            .astype(np.float64))
            g = jnp.asarray(rng.standard_normal((b, k)))
            xb = jnp.asarray(290.0 + rng.standard_normal((b, 2, k)))
            kw = dict(inflats=inflats, has_obs=jnp.ones(b, bool),
                      rtpp_alpha=(0.95, 0.95), rtps_alpha=(0.95, 0.95))
            f64 = jax.jit(lambda a, g, x: letkf_solve_group_from_normal(
                a, g, x, solver_dtype=jnp.float64, **kw))
            ref_fn = jax.jit(lambda a, g, x: letkf_solve_group_refined(
                a, g, x, **kw))
            f32 = jax.jit(lambda a, g, x: letkf_solve_group_from_normal(
                a, g, x, **kw))
            xa64, t64 = _timed(f64, a, g, xb, reps=reps)
            xar, tr = _timed(ref_fn, a, g, xb, reps=reps)
            a32, g32, x32 = (jnp.asarray(t, jnp.float32) for t in (a, g, xb))
            xa32, t32 = _timed(f32, a32, g32, x32, reps=reps)
            x64 = np.asarray(xa64)
            sc = np.abs(x64).max()
            e_r = float(np.abs(np.asarray(xar) - x64).max() / sc)
            e_32 = float(np.abs(np.asarray(xa32, np.float64) - x64).max()
                         / sc)
            _log(f"solver: group solve k={k} batch {b}: float64 eigh "
                 f"{t64 * 1e3:.3f} ms ({b / t64:,.0f} pts/s); refined "
                 f"{tr * 1e3:.3f} ms ({b / tr:,.0f} pts/s), max rel err vs "
                 f"float64 {e_r:.2e}; float32 NS {t32 * 1e3:.3f} ms "
                 f"({b / t32:,.0f} pts/s), max rel err vs float64 {e_32:.2e}")
            _check(np.isfinite(x64).all(), f"float64 solve at k={k}")
            _check(e_r < 1e-8, f"refined solve error {e_r} at k={k}")
    finally:
        jax.config.update("jax_enable_x64", prev_x64)


def _cycle_run(k, pts, xb, plats, groups, *, chunk, subchunk, obs_presorted,
               label=None):
    """Plan budgets, compile and run the fused cycle with the obs arrays as
    jit arguments (the production pattern).  Returns
    ``(xa, diag, warm seconds, compiled)``."""
    import jax
    import jax.numpy as jnp

    from cwbnwp_letkf_tpu.ops.cycle import (plan_cycle_budgets,
                                            update_points_cycle)
    from cwbnwp_letkf_tpu.ops.update import DevicePlatform

    statics = [dp.static for dp in plats]
    arrays = [(dp.xyz, dp.stats) for dp in plats]
    pts_d = jnp.asarray(pts)
    budgets = plan_cycle_budgets(pts_d, plats, groups, chunk=chunk,
                                 subchunk=subchunk, obs_presorted=obs_presorted)
    for dp in plats:
        dp.cache.clear()
    v_tot = sum(len(g.ivars) for g in groups)
    xb_d = jnp.asarray(xb)

    def cycle_fn(xb_a, pts_a, arrays_a):
        plats_a = [DevicePlatform(static=st, xyz=xyz, stats=stats)
                   for st, (xyz, stats) in zip(statics, arrays_a)]
        xb_v = jnp.broadcast_to(xb_a[:, None, :], (xb_a.shape[0], v_tot, k))
        return update_points_cycle(
            xb_v, pts_a, plats_a, groups, weight_function=0, chunk=chunk,
            subchunk=subchunk, max_blocks=budgets,
            obs_presorted=obs_presorted, return_diagnostics=True)

    t0 = time.perf_counter()
    compiled = jax.jit(cycle_fn).lower(xb_d, pts_d, arrays).compile()
    if label:
        _log(f"{label}: compiled in {time.perf_counter() - t0:.1f} s")
    (xa, diag), dt = _timed(compiled, xb_d, pts_d, arrays, reps=1)
    return np.asarray(xa), diag, dt, compiled


def _case_oracle(k, pts, xb, plats_raw, groups, idx):
    """Oracle ``[n, V, k]`` at points ``idx`` of a bench-shaped case."""
    v_tot = sum(len(g.ivars) for g in groups)
    xb_v = np.broadcast_to(xb[idx, None, :], (len(idx), v_tot, k))
    return xb_v, oracle_cycle(xb_v, pts[idx], plats_raw, groups, 0)


def phase_precision(ks=(40, 96), nx=64, nz=10,
                    n_obs=(2000, 20000, 20000), n_sample=512,
                    c=512, r=4096, reps=10):
    import jax
    import jax.numpy as jnp

    import bench
    from cwbnwp_letkf_tpu.ops import dense
    from cwbnwp_letkf_tpu.ops.update import prepare_platform

    precisions = {"default": jax.lax.Precision.DEFAULT,
                  "high": jax.lax.Precision.HIGH,
                  "highest": jax.lax.Precision.HIGHEST}
    rng = np.random.default_rng(2)
    for k in ks:
        # (i) the [C, R] @ [R, k*(k+1)] accumulation matmul alone
        r2 = rng.uniform(0.0, 13.3, (c, r))
        gm = np.where(rng.uniform(size=(c, r)) < 0.1,
                      np.exp(-0.5 * r2), 0.0).astype(np.float32)
        bg = rng.standard_normal((r, k)).astype(np.float32)
        tab = (bg[:, :, None] * np.concatenate(
            [bg, rng.standard_normal((r, 1)).astype(np.float32)],
            axis=1)[:, None, :]).reshape(r, k * (k + 1))
        ref = gm.astype(np.float64) @ tab.astype(np.float64)
        for name, prec in precisions.items():
            fn = jax.jit(lambda a, b, p=prec: jnp.dot(
                a, b, precision=p, preferred_element_type=jnp.float32))
            out, dt = _timed(fn, jnp.asarray(gm), jnp.asarray(tab),
                             reps=reps)
            err = float(np.abs(np.asarray(out, np.float64) - ref).max()
                        / np.abs(ref).max())
            _log(f"precision: accumulation matmul [{c},{r}]@[{r},"
                 f"{k * (k + 1)}] {name}: max rel err vs float64 "
                 f"{err:.2e}, {dt * 1e3:.3f} ms warm")
            if name == "high":
                hlo = fn.lower(jnp.asarray(gm), jnp.asarray(tab)) \
                    .compile().as_text()
                for line in hlo.splitlines():
                    if "custom-call" in line or " dot(" in line:
                        keep = re.findall(
                            r'custom_call_target="[^"]*"|"precision_config"'
                            r':\{[^}]*\}|"algorithm":"?[A-Z0-9_]*"?|'
                            r'operand_precision=\{[^}]*\}', line)
                        _log(f"precision: compiled high dot: {keep}")
                        break

        # (ii) the cycle at each f32 accumulation precision vs the oracle
        pts, xb, plats_raw = bench.build_case(k=k, nx=nx, nz=nz,
                                              n_obs=n_obs, seed=3)
        groups = bench._prod_cycle_groups(k)
        idx = np.sort(rng.choice(pts.shape[0], min(n_sample, pts.shape[0]),
                                 replace=False))
        xb_v, xa_ref = _case_oracle(k, pts, xb, plats_raw, groups, idx)
        try:
            for name in ("high", "highest"):
                dense.set_accum_precision(name)
                plats = [prepare_platform(st, po) for st, po in plats_raw]
                xa, diag, dt, _ = _cycle_run(
                    k, pts, xb, plats, groups, chunk=4096, subchunk=512,
                    obs_presorted=False)
                rel = compare_oracle(
                    f"precision: cycle k={k} ({pts.shape[0]} points, "
                    f"accumulation {name})", xa[idx], xa_ref, xb_v)
                _log(f"precision: cycle k={k} accumulation {name}: "
                     f"{'within' if rel <= CYCLE_TOL else 'OUTSIDE'} "
                     f"tolerance, overflow {int(diag['bucket_overflow'])}, "
                     f"NS residual {float(diag['ns_residual']):.2e}, "
                     f"{dt:.3f} s warm")
                if name == dense.DEFAULT_ACCUM_PRECISION:
                    _check(rel <= CYCLE_TOL,
                           f"default accumulation precision {name}: cycle "
                           f"error {rel} of max|xa| at k={k}")
        finally:
            dense.set_accum_precision(dense.DEFAULT_ACCUM_PRECISION)


def phase_cycle(k=40, nx=128, nz=20, n_obs=(2000, 20000, 20000),
                n_sample=1024):
    import bench
    from cwbnwp_letkf_tpu.ops.solver import uses_newton_schulz
    from cwbnwp_letkf_tpu.ops.update import prepare_platform

    t0 = time.perf_counter()
    pts, xb, plats_raw = bench.build_case(k=k, nx=nx, nz=nz, n_obs=n_obs)
    groups = bench._prod_cycle_groups(k)
    plats = [prepare_platform(st, po) for st, po in plats_raw]
    _log(f"cycle: case built in {time.perf_counter() - t0:.1f} s: "
         f"{pts.shape[0]} points, k={k}, {len(groups)} groups, records "
         f"{[po.nrec for _, po in plats_raw]}")
    xa, diag, dt, compiled = _cycle_run(
        k, pts, xb, plats, groups, chunk=4096, subchunk=512,
        obs_presorted=False, label="cycle")
    ovf = int(diag["bucket_overflow"])
    resid = float(diag["ns_residual"])
    n_vars = sum(len(g.ivars) for g in groups)
    _log(f"cycle: k={k} {pts.shape[0]} points x {n_vars} variables: "
         f"{dt:.3f} s warm = {n_vars * pts.shape[0] / dt:,.0f} var-point "
         f"updates/s, overflow {ovf}, NS residual {resid:.2e}, solver "
         f"{'newton-schulz' if uses_newton_schulz(np.float32) else 'eigh'}")
    _memory_line("cycle", compiled)
    _check(ovf == 0, f"cycle overflow {ovf}")
    _check(resid <= NS_TOL, f"cycle NS residual {resid}")
    _check(np.isfinite(xa).all(), "cycle output not finite")
    rng = np.random.default_rng(4)
    idx = np.sort(rng.choice(pts.shape[0], min(n_sample, pts.shape[0]),
                             replace=False))
    xb_v, xa_ref = _case_oracle(k, pts, xb, plats_raw, groups, idx)
    rel = compare_oracle(f"cycle: {len(idx)} sampled points", xa[idx],
                         xa_ref, xb_v)
    _check(rel <= CYCLE_TOL, f"cycle error {rel} of max|xa|")


def phase_production(grid=None, k=96, r_obs=200_000, n_slabs=20,
                     n_sample=1024, chunk=2048):
    import bench
    from cwbnwp_letkf_tpu.ops.update import prepare_platform

    grid = grid or bench.PROD_GRID
    t0 = time.perf_counter()
    pts_all, truth, plat, groups = bench.prod_shape_case(grid=grid, k=k,
                                                         r_obs=r_obs)
    dev = prepare_platform(*plat)
    b = pts_all.shape[0]
    slab = -(-b // n_slabs)
    lo = (n_slabs // 2) * slab
    hi = min(b, lo + slab)
    pts = pts_all[lo:hi]
    xb = bench.prod_shape_background(truth, lo, hi, k)
    _log(f"prod: case built in {time.perf_counter() - t0:.1f} s: slab "
         f"{n_slabs // 2 + 1}/{n_slabs} of {grid} = {hi - lo} points, "
         f"k={k}, {r_obs} radar records")
    xa, diag, dt, compiled = _cycle_run(
        k, pts, xb, [dev], groups, chunk=chunk, subchunk=chunk,
        obs_presorted=True, label="prod")
    ovf = int(diag["bucket_overflow"])
    resid = float(diag["ns_residual"])
    _log(f"prod: {hi - lo} points: {dt:.3f} s warm = "
         f"{(hi - lo) / dt:,.0f} var-point updates/s, overflow {ovf}, NS "
         f"residual {resid:.2e}")
    _memory_line("prod", compiled)
    _check(ovf == 0, f"prod overflow {ovf}")
    _check(resid <= NS_TOL, f"prod NS residual {resid}")
    _check(np.isfinite(xa).all(), "prod output not finite")
    rng = np.random.default_rng(5)
    idx = np.sort(rng.choice(hi - lo, min(n_sample, hi - lo), replace=False))
    xb_v = xb[idx, None, :]
    xa_ref = oracle_cycle(xb_v, pts[idx], [plat], groups, 0)
    rel = compare_oracle(f"prod: {len(idx)} sampled points", xa[idx],
                         xa_ref, xb_v)
    _check(rel <= CYCLE_TOL, f"prod error {rel} of max|xa|")


def _read_fields(path):
    from cwbnwp_letkf_tpu.io.netcdf import NetcdfReader

    with NetcdfReader(path) as nc:
        return {n: nc.get_variable(n) for n in nc.variable_names()
                if n != "Times"}


def _compare_dirs(label, dir_a, dir_b, k, tol=None):
    """Every member file and the mean of two output directories.

    With ``tol`` None: the streaming test's tolerances (stream == eager,
    tests/test_streaming.py).  Else ``|a - b| <= tol * max|a|`` per
    variable, the multi-process test's rule, plus the streaming test's
    allowance for the f32 rounding of P/PH/MU's large base states (the
    files hold perturbations; the cycle updates full fields).
    """
    base_atol = {"MU": 0.05, "P": 0.05, "PH": 0.05}
    worst = 0.0
    for name in [f"wrfout_nc_{m + 1:03d}" for m in range(k)] + [
            "wrfout_nc_mean"]:
        fa = _read_fields(os.path.join(dir_a, name))
        fb = _read_fields(os.path.join(dir_b, name))
        _check(set(fa) == set(fb), f"{label}: {name} variables differ")
        for var, a in fa.items():
            a = np.asarray(a, np.float64)
            d = float(np.abs(np.asarray(fb[var], np.float64) - a).max())
            if tol is None:
                rtol = 1e-5 if name.endswith("mean") else 1e-6
                atol = base_atol.get(var, rtol)
                bound = atol + rtol * np.abs(a)
                ok = bool((np.abs(fb[var] - a) <= bound).all())
            else:
                ok = d <= tol * float(np.abs(a).max()) + base_atol.get(
                    var, 0.0)
            _check(ok, f"{label}: {name} {var} differs by {d:.3e}")
            sc = float(np.abs(a).max())
            if sc:
                worst = max(worst, d / sc)
    _log(f"{label}: {k} members + mean equal, largest difference "
         f"{worst:.3e} of max|field|")


def _cli_oracle(case_dir, out_dir, n_sample, seed=6):
    """Sampled T analyses of ``out_dir`` against the oracle."""
    from cwbnwp_letkf_tpu.config import LetkfConfig
    from cwbnwp_letkf_tpu.models.state import read_ensemble
    from cwbnwp_letkf_tpu.models.vcoord import (analysis_points,
                                                mean_geopotential_height)
    from cwbnwp_letkf_tpu.obs.base import platform_statics_from_config
    from cwbnwp_letkf_tpu.obs.gts import read_gts_ensemble
    from cwbnwp_letkf_tpu.obs.radar import PREFIX_TO_NAME, read_radar_ensemble
    from cwbnwp_letkf_tpu.projection import LambertProjection

    cfg = LetkfConfig.from_namelist(os.path.join(case_dir, "input.nml"))
    k = cfg.nmember
    proj = LambertProjection.from_config(cfg.projection)
    member = lambda stem, m: os.path.join(case_dir, f"{stem}_{m + 1:03d}")
    ens = read_ensemble([member("wrfinput_nc", m) for m in range(k)], cfg)
    obs = dict(read_gts_ensemble([member("gts_letkf", m) for m in range(k)],
                                 proj, None))
    for prefix in ("VR", "MR"):
        obs[PREFIX_TO_NAME[prefix]] = read_radar_ensemble(
            [member(f"{prefix}_letkf", m) for m in range(k)], proj)
    plats = [(st, obs[st.name]) for st in platform_statics_from_config(cfg)
             if st.name in obs and obs[st.name].nrec]
    iv = cfg.var_update.index("T")
    pts, dims = analysis_points(ens, proj, 0, 0,
                                mean_geopotential_height(ens),
                                quirk=cfg.replicate_stagger_quirk)
    rng = np.random.default_rng(seed)
    idx = np.sort(rng.choice(pts.shape[0], n_sample, replace=False))
    xb = ens.fields["t"].reshape(-1, k)[idx][:, None, :]
    infl = cfg.inflation
    tables = [_whiten_table(st, po, cfg.weight_function, cfg.norain_value)
              for st, po in plats]
    xa_ref = oracle_group(
        xb, pts[idx], tables, (iv,), ((k - 1) / infl.multi_infl[iv],),
        (infl.rtpp_alpha[iv] if infl.use_rtpp[iv] else 0.0,),
        (infl.rtps_alpha[iv] if infl.use_rtps[iv] else 0.0,),
        cfg.weight_function)
    xa = np.stack([_read_fields(os.path.join(out_dir,
                                             f"wrfout_nc_{m + 1:03d}"))["T"]
                   .reshape(-1) for m in range(k)], axis=-1)[idx][:, None, :]
    return compare_oracle(f"cli: T at {n_sample} sampled points", xa,
                          xa_ref, xb)


def _write_case(case_dir, case):
    from cwbnwp_letkf_tpu.synthetic_case import generate_production_case

    t0 = time.perf_counter()
    with open(FIXTURE) as fh:
        generate_production_case(case_dir, fh.read(), seed=7, **case)
    _log(f"case written in {time.perf_counter() - t0:.1f} s: {case}")


def phase_cli(workdir, case=None, n_sample=1024, expect_platform="gpu"):
    import jax

    from cwbnwp_letkf_tpu.cli import main as cli_main

    case = case or CLI_CASE
    k = case["k"]
    case_dir = os.path.join(workdir, "case")
    _write_case(case_dir, case)
    for mode in ("eager", "stream"):
        out = os.path.join(workdir, mode)
        mpath = os.path.join(workdir, f"metrics_{mode}.json")
        argv = ["--input", case_dir, "--output", out, "--quiet",
                "--metrics-json", mpath] + (["--stream"]
                                            if mode == "stream" else [])
        t0 = time.perf_counter()
        rc = cli_main(argv)
        wall = time.perf_counter() - t0
        _check(rc == 0, f"cli {mode} exit code {rc}")
        for name in [f"wrfout_nc_{m + 1:03d}" for m in range(k)] + [
                "wrfout_nc_mean"]:
            _check(os.path.exists(os.path.join(out, name)),
                   f"cli {mode}: {name} missing")
        with open(mpath) as fh:
            metrics = json.load(fh)
        dev = metrics["devices"]
        _check(dev["platform"] == expect_platform
               and dev["kind"] == jax.devices()[0].device_kind,
               f"cli {mode}: metrics name {dev}")
        ovf = sum(g["bucket_overflow"] for g in metrics["groups"])
        resid = max(g["ns_residual"] for g in metrics["groups"])
        _log(f"cli: {mode} wall {wall:.1f} s, update "
             f"{metrics['update_wall_s']:.1f} s, "
             f"{metrics['var_points_per_s']:,.0f} var-point updates/s, "
             f"{len(metrics['groups'])} groups, overflow {ovf}, NS residual "
             f"{resid:.2e}, metrics name {dev['kind']} x{dev['count']}")
        _check(ovf == 0, f"cli {mode} overflow {ovf}")
        _check(resid <= NS_TOL, f"cli {mode} NS residual {resid}")
    _compare_dirs("cli: stream vs eager", os.path.join(workdir, "eager"),
                  os.path.join(workdir, "stream"), k)
    rel = _cli_oracle(case_dir, os.path.join(workdir, "eager"), n_sample)
    _check(rel <= CYCLE_TOL, f"cli error {rel} of max|xa|")


# ---------------------------------------------------------------------------
# four cards
# ---------------------------------------------------------------------------
def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_children(label, cmds, envs, timeout):
    """Run child processes to their end, each writing to its own log; on a
    failure or after ``timeout`` seconds kill all of them and show the end
    of every log."""
    t0 = time.perf_counter()
    logs = [tempfile.TemporaryFile(mode="w+") for _ in cmds]
    procs = [subprocess.Popen(cmd, cwd=HERE, env=env, stdout=log,
                              stderr=subprocess.STDOUT, text=True)
             for cmd, env, log in zip(cmds, envs, logs)]
    try:
        deadline = time.monotonic() + timeout
        for p in procs:
            try:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                break
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        tails = []
        for log in logs:
            log.seek(0)
            tails.append(log.read()[-3000:])
            log.close()
    for i, (p, tail) in enumerate(zip(procs, tails)):
        _check(p.returncode == 0,
               f"{label} child {i} exit {p.returncode} "
               f"({'killed at the time limit' if p.returncode < 0 else 'failed'}"
               f"):\n{tail}")
    _log(f"{label}: {len(procs)} process(es) done in "
         f"{time.perf_counter() - t0:.1f} s; last lines of child 0:")
    for line in tails[0].strip().splitlines()[-8:]:
        _log(f"  | {line}")


def four_cards(workdir, case=None, n_cards=4, child_env=None,
               expect_platform="gpu", timeout=900):
    """The four-card CLI path and what it is compared with.

    ``child_env(card)`` gives each child's environment: ``card`` is a card
    index, or None for a child that sees every card.  The parent never
    touches a device.  Returns the device record of the mesh child.
    """
    case = case or CLI_CASE
    k = case["k"]
    case_dir = os.path.join(workdir, "case")
    _write_case(case_dir, case)

    def cli(out, *extra):
        return [sys.executable, "-m", "cwbnwp_letkf_tpu.cli", "--input",
                case_dir, "--output", os.path.join(workdir, out),
                "--metrics-json",
                os.path.join(workdir, f"metrics_{out}.json"), *extra]

    _run_children("four-cards: one-card reference", [cli("one")],
                  [child_env(0)], timeout)
    _run_children("four-cards: (a) one process, mesh over all cards",
                  [cli("mesh")], [child_env(None)], timeout)
    with open(os.path.join(workdir, "metrics_mesh.json")) as fh:
        metrics = json.load(fh)
    dev = metrics["devices"]
    _log(f"four-cards: (a) devices {dev}, mesh {metrics.get('mesh_layout')}")
    _check(dev["platform"] == expect_platform and dev["count"] == n_cards,
           f"mesh child saw {dev}")
    _check(metrics.get("mesh_layout", {}).get("devices") == n_cards,
           "mesh child ran without a mesh over every card")
    _compare_dirs("four-cards: (a) mesh vs one card",
                  os.path.join(workdir, "one"), os.path.join(workdir, "mesh"),
                  k, tol=MESH_TOL)
    port = _free_port()
    _run_children(
        "four-cards: (b) --distributed, one process per card",
        [cli("dist", "--distributed", "--coordinator", f"localhost:{port}",
             "--num-processes", str(n_cards), "--process-id", str(i))
         for i in range(n_cards)],
        [child_env(i) for i in range(n_cards)], timeout)
    _compare_dirs("four-cards: (b) distributed vs (a)",
                  os.path.join(workdir, "mesh"), os.path.join(workdir, "dist"),
                  k, tol=MESH_TOL)
    return dev


def _gpu_child_env(card):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [HERE] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    if card is not None:
        env["CUDA_VISIBLE_DEVICES"] = str(card)
    return env


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--four-cards", action="store_true",
                   help="run only the four-card path (parent stays off JAX)")
    args = p.parse_args(argv)
    _import_package()
    workdir = tempfile.mkdtemp(prefix="cwbnwp_smoke_")
    try:
        if args.four_cards:
            smi = nvidia_smi()
            n = len(smi.splitlines())
            _check(n >= 4, f"four cards needed, nvidia-smi lists {n}")
            _log(f"four-cards: nvidia-smi name, power.limit: "
                 f"{smi.splitlines()}")
            dev = four_cards(workdir, child_env=_gpu_child_env, timeout=200)
            print(smi.splitlines()[0])
            print(json.dumps({"ok": True, "device": {
                "platform": dev["platform"], "kind": dev["kind"],
                "count": dev["count"]}}))
            return 0

        import jax

        from cwbnwp_letkf_tpu.cli import use_compile_cache

        devs = jax.devices()
        if devs[0].platform != "gpu":
            print(f"chip_smoke: needs a GPU, JAX found {devs[0].platform}",
                  file=sys.stderr)
            return 1
        use_compile_cache()
        smi = nvidia_smi()
        t0 = time.perf_counter()
        for name, run in (
                ("device", lambda: phase_device(smi)),
                ("solver", phase_solver),
                ("precision", phase_precision),
                ("cycle", phase_cycle),
                ("prod", phase_production),
                ("cli", lambda: phase_cli(workdir))):
            t1 = time.perf_counter()
            run()
            _log(f"phase {name} passed in {time.perf_counter() - t1:.1f} s")
        _log(f"all phases passed in {time.perf_counter() - t0:.1f} s")
        print(smi.splitlines()[0])
        print(json.dumps({"ok": True, "device": {
            "platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}}))
        return 0
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
