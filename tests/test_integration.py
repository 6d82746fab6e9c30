"""Full-cycle integration: files in -> CLI -> analysis files out, vs oracle.

Drives the complete reference pipeline (cwb_letkf.f90:20-81) through the
public CLI on a synthetic miniature case: WRF member files + namelist + GTS
omboma obs files -> analysis members + mean, then verifies sampled gridpoints
against the pure-Python whiten+solve oracle.
"""
import os

import numpy as np
import pytest

from cwbnwp_letkf_tpu.cli import main as cli_main
from cwbnwp_letkf_tpu.config import LetkfConfig
from cwbnwp_letkf_tpu.constants import GC1999_SQ, GRAVITY
from cwbnwp_letkf_tpu.io.netcdf import NetcdfReader
from cwbnwp_letkf_tpu.obs.gts import GtsRecords, write_member_file
from cwbnwp_letkf_tpu.projection import LambertProjection

from . import reference_impl as ref
from .wrf_fixtures import make_wrf_ensemble

K = 4
NML = """
&control
 nmember          = {k}
 var_update       = 'T', 'QVAPOR', 'U'
 weight_function  = 0
 wrf_mp_physics   = 4
/
&projection
 cen_lon  = 120.0
 cen_lat  = 23.7
 truelat1 = 10.0
 truelat2 = 40.0
 sta_lon  = 120.0
/
&observations
 synop_nml % use_it     = T
 synop_nml % max_lz_pts = 50
 synop_nml % hclr       = 30., 30., 30.
 synop_nml % vclr       =  3.,  3.,  3.
 synop_nml % u % is_assim = F, F, T
 synop_nml % t % is_assim = T, F, F
 synop_nml % q % is_assim = F, T, F
 synop_nml % t % err_muti = 1.0
 synop_nml % q % err_muti = 1.0
/
&inflation
 multi_infl = 1.2, 1.1, 1.2
 use_RTPS   = F, F, F
 use_RTPP   = F, F, F
/
"""


def _make_inputs(tmp_path):
    input_dir = tmp_path / "input"
    output_dir = tmp_path / "output"
    input_dir.mkdir()
    make_wrf_ensemble(str(input_dir), K, seed=3)
    with open(input_dir / "input.nml", "w") as fh:
        fh.write(NML.format(k=K))

    # synthetic synop obs near the domain center
    rng = np.random.default_rng(9)
    nobs = 15
    base = GtsRecords()
    for i in range(nobs):
        base.ids.append(f"T{i:04d}")
        base.lat.append(float(rng.uniform(23.6, 23.8)))
        base.lon.append(float(rng.uniform(119.9, 120.1)))
        base.pre.append(1000.0)
        base.obs.append([float(rng.normal(5, 1)),    # u
                         float(rng.normal(-3, 1)),   # v
                         float(rng.normal(301, 1)),  # t
                         1000.0,                     # p
                         float(abs(rng.normal(8e-3, 1e-3)))])  # q
        base.qc.append([0, 0, 0, 0, 0])
        base.err.append([1.0, 1.0, 0.8, 1.0, 1e-3])
        base.level.append(1)
    members = []
    for m in range(K):
        rec = GtsRecords(
            **{f: list(getattr(base, f))
               for f in ("ids", "lat", "lon", "pre", "obs", "qc", "err",
                         "level")},
            omb=[[float(rng.normal(0, s)) for s in (1, 1, 1, 1, 1e-3)]
                 for _ in range(nobs)])
        write_member_file(str(input_dir / f"gts_letkf_{m+1:03d}"),
                          {"synop": rec})
        members.append(rec)
    return input_dir, output_dir, base, members


def test_full_cycle_cli(tmp_path):
    input_dir, output_dir, base, members = _make_inputs(tmp_path)

    rc = cli_main(["--input", str(input_dir), "--output", str(output_dir),
                   "--quiet", "--chunk", "64"])
    assert rc == 0

    # outputs exist
    for m in range(K):
        assert os.path.exists(output_dir / f"wrfout_nc_{m+1:03d}")
    assert os.path.exists(output_dir / "wrfout_nc_mean")

    # gather prior + analysis T
    t_b, t_a, ph_b, phb = [], [], [], None
    for m in range(K):
        with NetcdfReader(str(input_dir / f"wrfinput_nc_{m+1:03d}")) as nc:
            t_b.append(nc.get_variable("T"))
            ph_b.append(nc.get_variable("PH"))
            if phb is None:
                phb = nc.get_variable("PHB")
        with NetcdfReader(str(output_dir / f"wrfout_nc_{m+1:03d}")) as nc:
            t_a.append(nc.get_variable("T"))
    t_b = np.stack(t_b, -1)
    t_a = np.stack(t_a, -1)
    assert (t_a != t_b).any(), "T was not updated"

    # QVAPOR must be non-negative after tune_q
    for m in range(K):
        with NetcdfReader(str(output_dir / f"wrfout_nc_{m+1:03d}")) as nc:
            assert (nc.get_variable("QVAPOR") >= 0).all()

    # mean file is the member mean
    with NetcdfReader(str(output_dir / "wrfout_nc_mean")) as nc:
        np.testing.assert_allclose(nc.get_variable("T"), t_a.mean(-1),
                                   rtol=1e-6, atol=1e-5)

    # --- oracle check on sampled points -----------------------------------
    cfg = LetkfConfig.from_namelist(str(input_dir / "input.nml"))
    proj = LambertProjection.from_config(cfg.projection)

    # obs arrays exactly as the pipeline builds them
    import jax.numpy as jnp
    obs = np.asarray(base.obs, np.float32).T            # [5, n]
    err = np.asarray(base.err, np.float32).T
    hdxb = np.stack(
        [obs - np.asarray(m.omb, np.float32).T for m in members], -1)
    ox, oy = proj.lonlat_to_xy(jnp.asarray(base.lon), jnp.asarray(base.lat))
    oxyz = np.stack([np.asarray(ox), np.asarray(oy),
                     np.zeros(len(base.ids))], 1)

    # vertical coordinate: mean full geopotential / g at mass levels
    z_w = (np.stack(ph_b, -1) + phb[..., None]).mean(-1) / GRAVITY
    z_m = 0.5 * (z_w[:, :, 1:] + z_w[:, :, :-1])

    with NetcdfReader(str(input_dir / "wrfinput_nc_001")) as nc:
        lat2 = nc.get_variable("XLAT")
        lon2 = nc.get_variable("XLONG")
    gx, gy = proj.lonlat_to_xy(jnp.asarray(lon2), jnp.asarray(lat2))
    gx, gy = np.asarray(gx), np.asarray(gy)

    hclr, vclr = 30.0, 3.0
    ivar_t = 0  # T is var_update position 0
    rng = np.random.default_rng(0)
    for _ in range(8):
        i, j, l = (rng.integers(0, 8), rng.integers(0, 7), rng.integers(0, 5))
        d = (oxyz - np.array([gx[i, j], gy[i, j], z_m[i, j, l]])) \
            * np.array([1 / (hclr * 1e3), 1 / (hclr * 1e3), 1 / (vclr * 1e3)])
        r2 = (d ** 2).sum(1)
        yo, yb = [], []
        for r in np.nonzero(r2 <= GC1999_SQ)[0]:
            ok, yo1, yb1 = ref.whiten_obs(
                obs[2, r], hdxb[2, r], err[2, r] * 1.0, float(r2[r]), 5.0, 0)
            if ok:
                yo.append(yo1)
                yb.append(yb1)
        if yo:
            expected = ref.letkf_solve(
                t_b[i, j, l].astype(np.float64), np.array(yo),
                np.stack(yb, 1), (K - 1) / cfg.inflation.multi_infl[ivar_t])
        else:
            expected = t_b[i, j, l]
        np.testing.assert_allclose(t_a[i, j, l], expected, rtol=2e-4,
                                   atol=2e-4)


def test_cli_no_obs_is_noop(tmp_path):
    input_dir = tmp_path / "input"
    output_dir = tmp_path / "out"
    input_dir.mkdir()
    make_wrf_ensemble(str(input_dir), K, seed=4)
    with open(input_dir / "input.nml", "w") as fh:
        fh.write(NML.format(k=K))
    # no gts/radar files at all
    rc = cli_main(["--input", str(input_dir), "--output", str(output_dir),
                   "--quiet"])
    assert rc == 0
    with NetcdfReader(str(input_dir / "wrfinput_nc_001")) as a, \
            NetcdfReader(str(output_dir / "wrfout_nc_001")) as b:
        np.testing.assert_array_equal(a.get_variable("T"),
                                      b.get_variable("T"))


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_placement(monkeypatch, tmp_path, env_set):
    """JAX_COMPILATION_CACHE_DIR wins and nothing is set; without it the
    cache goes to <checkout>/.jax_cache."""
    import jax

    from cwbnwp_letkf_tpu.cli import use_compile_cache

    before = jax.config.jax_compilation_cache_dir
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if env_set:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        got = use_compile_cache()
        now = jax.config.jax_compilation_cache_dir
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    if env_set:
        assert got == str(tmp_path)
        assert now == before
    else:
        assert got == os.path.join(repo, ".jax_cache")
        assert now == got
