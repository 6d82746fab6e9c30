"""Device-time breakdown of the FUSED production cycle on the GPU.

Ablates the bench's headline cycle (bench.build_case) into nested stages
and prints the breakdown as one JSON line:

  full_cycle   the bench headline program (accumulate + solve)
  accum_only   shared cull/gather + per-group cap/weight/normal-term
               matmuls, solves skipped
  accum_nocap  accum_only with the max_lz_pts multisection disabled —
               isolates the cap-threshold search cost
  cull_only    candidate culling + gathers + distance expansion only
               (terms_from_r2 replaced by a cheap reduction) — isolates
               gather+distance vs weight+accumulate matmul
  solve_only   per-chunk stacked NS solves + weight application on
               synthetic normal terms
  ns_only      just the Z = A^(-1/2) builds (the solve stage's dominant
               kernel), same launch structure as the cycle

Stage attribution: solve ~ full - accum; within accum, cap ~ accum -
accum_nocap, gather+distance ~ cull_only, accumulate-matmul ~ accum_nocap -
cull_only; within solve, weight-apply ~ solve_only - ns_only.

Run on the card: python examples/profile_cycle.py
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

import bench  # noqa: E402


def _fetch(x):
    import jax

    h = np.asarray(jax.tree_util.tree_leaves(x)[0].reshape(-1)[:1024])
    assert np.isfinite(h).all()
    return h


def main():
    import jax
    import jax.numpy as jnp

    from cwbnwp_letkf_tpu.cli import use_compile_cache
    from cwbnwp_letkf_tpu.ops import cycle as C
    from cwbnwp_letkf_tpu.ops import dense as D
    from cwbnwp_letkf_tpu.ops.update import DevicePlatform, prepare_platform

    use_compile_cache()

    pts, xb, plats = bench.build_case()
    K = bench.K
    dev = [prepare_platform(st, po) for st, po in plats]
    statics = [dp.static for dp in dev]
    arrays = [(dp.xyz, dp.stats) for dp in dev]
    xb_d = jnp.asarray(xb)
    pts_d = jnp.asarray(pts)
    b = pts.shape[0]
    groups = bench._prod_cycle_groups()
    v_tot = sum(len(g.ivars) for g in groups)
    budgets = C.plan_cycle_budgets(pts_d, dev, groups, chunk=4096,
                                   subchunk=512)
    print(f"[prof] budgets: {budgets}", flush=True)

    def make_accum(terms_mode):
        """terms_mode: 'full' | 'nocap' | 'cull'."""
        real_terms = D.terms_from_r2

        def cheap_terms(r2, fused, nvalid, *, n_max, weight_function,
                        r2_cap=None, solver_dtype=jnp.float32,
                        row_mask=None):
            # distance + gather cost only: cheap reductions in place of
            # cap search, weights and the accumulation matmul.  The full
            # sums force every gathered table row to materialize (a
            # single-element read would let XLA narrow the gather away);
            # per-client table reads mirror the real path, where each
            # client's accumulation matmul streams the candidate table.
            c = r2.shape[0]
            kk_k = fused.shape[-1]
            k = int((-1 + (1 + 4 * kk_k) ** 0.5) / 2)
            s = (jnp.sum(r2, axis=-1)
                 + (jnp.sum(fused) + jnp.sum(nvalid)) * 1e-30)
            a = jnp.zeros((c, k, k), solver_dtype) + s[:, None, None]
            g = jnp.zeros((c, k), solver_dtype)
            cnt = jnp.ones((c,), jnp.int32)
            return a, g, cnt

        def nocap_terms(r2, fused, nvalid, **kw):
            kw["n_max"] = r2.shape[1] + 1      # cap never triggers
            return real_terms(r2, fused, nvalid, **kw)

        def accum(xb_a, pts_a, arrays_a):
            plats_a = [DevicePlatform(static=st, xyz=xyz, stats=stats)
                       for st, (xyz, stats) in zip(statics, arrays_a)]
            q = pts_a
            plans = C._resolve_plans(plats_a, groups, method="auto",
                                     solver_dtype=jnp.float32,
                                     max_blocks=budgets)
            plans = [C._materialize_plan(p) for p in plans]
            perm = C._cycle_point_perm(q, plans, "auto")
            if perm is not None:
                q = q[perm]
            chunk, sub = 4096, 512
            n_chunks = -(-b // chunk)
            q_p = jnp.broadcast_to(q[-1:],
                                   (n_chunks * chunk, 3)).at[:b].set(q)
            n_groups = len(groups)

            def inner(qs):
                c = qs.shape[0]
                a_all = jnp.zeros((n_groups, c, K, K), jnp.float32)
                g_all = jnp.zeros((n_groups, c, K), jnp.float32)
                cnt_all = jnp.zeros((n_groups, c), jnp.int32)
                for plan in plans:
                    if plan.kind == "bucketed":
                        outs, _ = C._bucketed_cycle_terms(
                            qs, plan, groups, 0, jnp.float32)
                    else:
                        outs = C._dense_cycle_terms(
                            qs, plan, groups, 0, jnp.float32)
                    for ci, gi in enumerate(plan.clients):
                        a_p, g_p, c_p = outs[ci]
                        a_all = a_all.at[gi].add(a_p)
                        g_all = g_all.at[gi].add(g_p)
                        cnt_all = cnt_all.at[gi].add(c_p)
                # reduce INSIDE the map body: returning full per-subchunk
                # terms materializes [n_sub, G, sub, k, k] (33.5 GB) as
                # the map output — the real cycle consumes terms
                # per-chunk and never holds them all
                return (a_all.sum((1, 2, 3)), g_all.sum((1, 2)),
                        cnt_all.sum(1))

            if terms_mode == "cull":
                C_terms, D_terms = C.terms_from_r2, D.terms_from_r2
                C.terms_from_r2 = cheap_terms
                D.terms_from_r2 = cheap_terms
            elif terms_mode == "nocap":
                C_terms, D_terms = C.terms_from_r2, D.terms_from_r2
                C.terms_from_r2 = nocap_terms
                D.terms_from_r2 = nocap_terms
            try:
                a, g, cnt = jax.lax.map(
                    inner, q_p.reshape(n_chunks * chunk // sub, sub, 3))
            finally:
                if terms_mode != "full":
                    C.terms_from_r2 = C_terms
                    D.terms_from_r2 = D_terms
            return a.sum(), g.sum(), cnt.sum()

        return jax.jit(accum)

    @jax.jit
    def cycle_fn(xb_a, pts_a, arrays_a):
        plats_a = [DevicePlatform(static=st, xyz=xyz, stats=stats)
                   for st, (xyz, stats) in zip(statics, arrays_a)]
        xb_v = jnp.broadcast_to(xb_a[:, None, :], (b, v_tot, K))
        return C.update_points_cycle(
            xb_v, pts_a, plats_a, groups, weight_function=0,
            chunk=4096, subchunk=512, max_blocks=budgets)

    def make_solve(ns_only):
        from cwbnwp_letkf_tpu.ops.solver import (_ns_z,
                                                 letkf_solve_cycle_from_normal)

        def solve(xb_a, pts_a, arrays_a):
            chunk = 4096
            n_chunks = -(-b // chunk)
            xb_v = jnp.broadcast_to(xb_a[:, None, :], (b, v_tot, K))
            xb_p = jnp.zeros((n_chunks * chunk, v_tot, K),
                             xb_v.dtype).at[:b].set(xb_v)
            n_groups = len(groups)
            sizes = [len(g.ivars) for g in groups]
            col0 = [0]
            for s_ in sizes:
                col0.append(col0[-1] + s_)

            def body(xbc):
                c = xbc.shape[0]
                a = jnp.broadcast_to(
                    jnp.eye(K, dtype=jnp.float32) * 3.0,
                    (n_groups, c, K, K))
                a = (a + 0.01 * xbc[None, :, 0, :, None]
                     * xbc[None, :, 0, None, :])
                if ns_only:
                    # the cycle's exact launch structure: one stacked Z
                    # build per distinct inflation value (6 (group, value)
                    # pairs under the production namelist -> 2 launches)
                    by_val = {}
                    for gi, grp in enumerate(groups):
                        for val in set(grp.inflats):
                            by_val.setdefault(float(val), []).append(gi)
                    tot = jnp.zeros((), jnp.float32)
                    for val, gis in by_val.items():
                        astack = jnp.concatenate([a[gi] for gi in gis], 0)
                        z, _ = _ns_z(astack, val)
                        tot = tot + jnp.sum(z[:, 0, 0])
                    return tot
                g = jnp.ones((n_groups, c, K), jnp.float32)
                xa_cols, sdiag = letkf_solve_cycle_from_normal(
                    [a[gi] for gi in range(n_groups)],
                    [g[gi] for gi in range(n_groups)],
                    [xbc[:, col0[gi]:col0[gi + 1], :]
                     for gi in range(n_groups)],
                    [grp.inflats for grp in groups],
                    [jnp.ones((c,), bool) for _ in range(n_groups)],
                    rtpp_alpha_groups=[grp.rtpp_alpha for grp in groups],
                    rtps_alpha_groups=[grp.rtps_alpha for grp in groups],
                    solver_dtype=jnp.float32, return_diagnostics=True)
                return (jnp.concatenate(xa_cols, axis=1).sum()
                        + sdiag["ns_residual"])

            out = jax.lax.map(
                body, xb_p.reshape(n_chunks, chunk, v_tot, K))
            return out.sum()

        return jax.jit(lambda x, p, a: solve(x, p, a))

    stages = (
        ("full_cycle", cycle_fn),
        ("accum_only", make_accum("full")),
        ("accum_nocap", make_accum("nocap")),
        ("cull_only", make_accum("cull")),
        ("solve_only", make_solve(False)),
        ("ns_only", make_solve(True)),
    )
    out = {"points": b, "k": K, "n_vars": bench.N_VARS,
           "chunk": 4096, "subchunk": 512,
           "budgets": {n: list(bb) for n, bb in budgets.items()}}
    for name, fn in stages:
        _fetch(fn(xb_d, pts_d, arrays))
        best = float("inf")
        for _ in range(2):
            t0 = time.time()
            _fetch(fn(xb_d, pts_d, arrays))
            best = min(best, time.time() - t0)
        out[name + "_s"] = round(best, 2)
        print(f"[prof] {name}: {best:.2f} s", flush=True)

    full = out["full_cycle_s"]
    acc = out["accum_only_s"]
    out["derived"] = {
        "solve_s": round(full - acc, 2),
        "cap_search_s": round(acc - out["accum_nocap_s"], 2),
        "gather_distance_s": out["cull_only_s"],
        "accumulate_matmul_s": round(
            out["accum_nocap_s"] - out["cull_only_s"], 2),
        "weight_apply_s": round(
            out["solve_only_s"] - out["ns_only_s"], 2),
        "ns_z_builds_s": out["ns_only_s"],
    }
    out["device"] = bench.device_stamp()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
