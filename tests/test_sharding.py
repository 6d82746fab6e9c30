"""Multi-device sharding correctness: N-device == 1-device, bitwise.

Runs on the 8-way virtual CPU mesh (conftest.py), the stand-in for a
multi-GPU host (SURVEY.md section 4d).
"""
import jax
import jax.numpy as jnp
import numpy as np

from cwbnwp_letkf_tpu.config import MAX_VARS
from cwbnwp_letkf_tpu.obs.base import PlatformStatic, make_platform_obs
from cwbnwp_letkf_tpu.ops.update import prepare_platform, update_points
from cwbnwp_letkf_tpu.parallel import make_mesh, sharded_update_points

K = 8


def _case(rng, nrec=70, b=100):
    xyz = np.stack([rng.uniform(-2e5, 2e5, nrec), rng.uniform(-2e5, 2e5, nrec),
                    rng.uniform(0, 1e4, nrec)], axis=1)
    obs = rng.normal(0, 2, (2, nrec))
    hdxb = obs[:, :, None] + rng.normal(0, 1, (2, nrec, K))
    error = rng.uniform(0.5, 2, (2, nrec))
    po = make_platform_obs(xyz, obs, hdxb, error, np.zeros((2, nrec, K)))
    st = PlatformStatic(
        name="synop", kind="gts", nvar=2, max_lz_pts=48,
        hclr=tuple([60.0] * MAX_VARS), vclr=tuple([3.0] * MAX_VARS),
        err_muti=(1.0, 0.9), err_rej=(5.0, 5.0),
        is_assim=tuple(tuple([True] * MAX_VARS) for _ in range(2)))
    pts = np.stack([rng.uniform(-2e5, 2e5, b), rng.uniform(-2e5, 2e5, b),
                    rng.uniform(0, 1e4, b)], axis=1).astype(np.float32)
    xb = rng.normal(5, 2, (b, K)).astype(np.float32)
    return st, po, pts, xb


def test_eight_devices_match_single_device():
    assert len(jax.devices()) == 8, "conftest must provide 8 CPU devices"
    rng = np.random.default_rng(31)
    st, po, pts, xb = _case(rng)
    dev = [prepare_platform(st, po)]
    kw = dict(inflat=(K - 1) / 1.2, weight_function=0, use_rtps=True,
              rtps_alpha=0.9, chunk=16)

    single = update_points(jnp.asarray(xb), jnp.asarray(pts), dev, 0, **kw)
    mesh = make_mesh()
    multi = sharded_update_points(mesh, jnp.asarray(xb), jnp.asarray(pts),
                                  dev, 0, **kw)
    # b=100 is not divisible by 8 -> exercises the padding path too.
    # Tolerance note: different shard/batch shapes vectorize with different
    # instruction-level reduction orders, so float32 results differ at ULP
    # level (~4e-6); the contract is tight allclose, not bitwise.
    np.testing.assert_allclose(np.asarray(single), np.asarray(multi),
                               rtol=3e-5, atol=3e-5)


def test_two_device_submesh():
    rng = np.random.default_rng(32)
    st, po, pts, xb = _case(rng, b=64)
    dev = [prepare_platform(st, po)]
    kw = dict(inflat=(K - 1) / 1.0, weight_function=1, chunk=32)
    single = update_points(jnp.asarray(xb), jnp.asarray(pts), dev, 0, **kw)
    mesh = make_mesh(jax.devices()[:2])
    multi = sharded_update_points(mesh, jnp.asarray(xb), jnp.asarray(pts),
                                  dev, 0, **kw)
    np.testing.assert_allclose(np.asarray(single), np.asarray(multi),
                               rtol=3e-5, atol=3e-5)


def test_sharded_bucketed_matches_single_device():
    """The bucketed accumulation branch under shard_map (the production
    radar path): per-SHARD planned budgets must keep overflow at 0 and the
    result identical to the single-device bucketed update — each device
    Hilbert-orders its local slice independently, so globally-planned
    budgets would not be sound (ADVICE r2 high finding)."""
    from cwbnwp_letkf_tpu.ops.update import plan_max_blocks, update_points_group
    from cwbnwp_letkf_tpu.parallel.update import sharded_update_points_group

    rng = np.random.default_rng(34)
    st, po, pts, _ = _case(rng, nrec=3000, b=500)
    dev = [prepare_platform(st, po)]
    v = 2
    xb = rng.normal(5, 2, (500, v, K)).astype(np.float32)
    kw = dict(inflats=((K - 1) / 1.2, (K - 1) / 1.0),
              weight_function=0, rtpp_alpha=(0.0, 0.8),
              rtps_alpha=(0.9, 0.0), chunk=64, method="bucketed")

    single, sdiag = update_points_group(
        jnp.asarray(xb), jnp.asarray(pts), dev, (0, 1),
        return_diagnostics=True, **kw)
    assert int(sdiag["bucket_overflow"]) == 0

    mesh = make_mesh()
    budgets = plan_max_blocks(jnp.asarray(pts), dev, 0, chunk=64,
                              method="bucketed", n_shards=8)
    assert budgets, "bucketed platform must get a planned budget"
    multi, mdiag = sharded_update_points_group(
        mesh, jnp.asarray(xb), jnp.asarray(pts), dev, (0, 1),
        max_blocks=budgets, return_diagnostics=True, **kw)
    assert int(mdiag["bucket_overflow"]) == 0, (
        "per-shard planned budgets must be overflow-free")
    np.testing.assert_allclose(np.asarray(single), np.asarray(multi),
                               rtol=3e-5, atol=3e-5)


def test_ns_solver_under_shard_map():
    """The Newton-Schulz solve must trace inside shard_map: its while_loop
    carries must be varying over the mesh axis (an unvarying initial z/err
    fails the varying-manual-axes check — a GPU-only production crash,
    since CPU 'auto' takes the eigh path and never sees it)."""
    from cwbnwp_letkf_tpu.ops.solver import set_eigh_backend

    rng = np.random.default_rng(36)
    st, po, pts, xb = _case(rng, b=64)
    dev = [prepare_platform(st, po)]
    kw = dict(inflat=(K - 1) / 1.2, weight_function=0, chunk=16)
    set_eigh_backend("ns")
    try:
        single = update_points(jnp.asarray(xb), jnp.asarray(pts), dev, 0,
                               **kw)
        mesh = make_mesh()
        multi = sharded_update_points(mesh, jnp.asarray(xb),
                                      jnp.asarray(pts), dev, 0, **kw)
    finally:
        set_eigh_backend("auto")
    np.testing.assert_allclose(np.asarray(single), np.asarray(multi),
                               rtol=3e-5, atol=3e-5)


def test_shard_local_budget_exceeds_global_plan_when_needed():
    """n_shards-aware planning can only grow budgets vs the global plan."""
    from cwbnwp_letkf_tpu.ops.update import plan_max_blocks

    rng = np.random.default_rng(35)
    st, po, pts, _ = _case(rng, nrec=3000, b=333)
    dev = [prepare_platform(st, po)]
    g1 = plan_max_blocks(jnp.asarray(pts), dev, 0, chunk=64,
                         method="bucketed")
    g8 = plan_max_blocks(jnp.asarray(pts), dev, 0, chunk=64,
                         method="bucketed", n_shards=8)
    assert set(g1) == set(g8) == {"synop"}
    assert g1["synop"].block_size == g8["synop"].block_size
    # 333 points / 8 shards -> 42-point local chunks in 8 different Hilbert
    # orders; the max over shards can exceed the single global chunking's
    # need but never undershoot what any shard requires (it IS that max)
    assert g8["synop"].max_blocks >= 16


def test_sharded_group_matches_single_device_group():
    from cwbnwp_letkf_tpu.ops.update import update_points_group
    from cwbnwp_letkf_tpu.parallel.update import sharded_update_points_group

    rng = np.random.default_rng(33)
    st, po, pts, xb2 = _case(rng, b=100)
    dev = [prepare_platform(st, po)]
    v = 3
    xb = rng.normal(5, 2, (100, v, K)).astype(np.float32)
    kw = dict(inflats=((K - 1) / 1.2, (K - 1) / 1.0, (K - 1) / 1.5),
              weight_function=0, rtpp_alpha=(0.0, 0.8, 0.0),
              rtps_alpha=(0.9, 0.0, 0.0), chunk=16)

    single = update_points_group(
        jnp.asarray(xb), jnp.asarray(pts), dev, (0, 1, 2), **kw)
    mesh = make_mesh()
    multi = sharded_update_points_group(
        mesh, jnp.asarray(xb), jnp.asarray(pts), dev, (0, 1, 2), **kw)
    np.testing.assert_allclose(np.asarray(single), np.asarray(multi),
                               rtol=3e-5, atol=3e-5)
