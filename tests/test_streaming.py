"""Memory-bounded streaming mode == eager mode, file for file.

The streaming ensemble (models/state.StreamingWrfEnsemble) is the
reference's one-variable-resident pipeline (module_letkf_core.f90:59-297):
fields are read per variable group and analysis files rewritten in place per
group, never holding the full ~20-field ensemble.  Since both modes feed the
identical update with identical values, every output file must match the
eager path.
"""
import numpy as np

from cwbnwp_letkf_tpu.cli import main as cli_main
from cwbnwp_letkf_tpu.io.netcdf import NetcdfReader

from .test_integration import K, _make_inputs


def _read_all(path):
    with NetcdfReader(str(path)) as nc:
        return {n: nc.get_variable(n) for n in nc.variable_names()
                if n != "Times"}


def test_stream_matches_eager(tmp_path):
    input_dir, output_dir, _, _ = _make_inputs(tmp_path)
    out_eager = output_dir
    out_stream = tmp_path / "out_stream"

    rc = cli_main(["--input", str(input_dir), "--output", str(out_eager),
                   "--quiet", "--chunk", "64"])
    assert rc == 0
    rc = cli_main(["--input", str(input_dir), "--output", str(out_stream),
                   "--quiet", "--chunk", "64", "--stream"])
    assert rc == 0

    # P/PH/MU ride on large base states (PB ~ 1e5 Pa, MUB ~ 9.5e4, PHB ~
    # g*z): the eager path round-trips every member through float32
    # full = pert + base; pert = full - base (exactly the reference's saxpy
    # pair, grid.f90:500-502,521-523), costing a few ULP of the BASE
    # magnitude, while the streaming writer byte-copies untouched priors —
    # so these fields agree only to base-scale f32 rounding.
    base_atol = {"MU": 0.05, "P": 0.05, "PH": 0.05}
    for m in range(K):
        ea = _read_all(out_eager / f"wrfout_nc_{m+1:03d}")
        st = _read_all(out_stream / f"wrfout_nc_{m+1:03d}")
        assert set(ea) == set(st)
        for name in ea:
            np.testing.assert_allclose(
                st[name], ea[name], rtol=1e-6,
                atol=base_atol.get(name, 1e-6),
                err_msg=f"member {m+1} variable {name}")

    # mean file: streaming accumulates in float64 one field at a time,
    # eager means the resident float32 stack — equal to f32 rounding
    ea = _read_all(out_eager / "wrfout_nc_mean")
    st = _read_all(out_stream / "wrfout_nc_mean")
    assert set(ea) == set(st)
    for name in ea:
        np.testing.assert_allclose(st[name], ea[name], rtol=1e-5,
                                   atol=base_atol.get(name, 1e-5),
                                   err_msg=f"mean variable {name}")


def test_stream_preserves_stagger_sliver_and_untouched_vars(tmp_path):
    """The U stagger quirk leaves column nx as background
    (letkf_core.f90:209-210) and untouched variables byte-copy through —
    the streaming writer must preserve both from the PRIOR, not zeros."""
    input_dir, _, _, _ = _make_inputs(tmp_path)
    out_stream = tmp_path / "out_stream2"
    rc = cli_main(["--input", str(input_dir), "--output", str(out_stream),
                   "--quiet", "--chunk", "64", "--stream"])
    assert rc == 0
    for m in range(1, K + 1):
        with NetcdfReader(str(input_dir / f"wrfinput_nc_{m:03d}")) as nc:
            u_b = nc.get_variable("U")
            w_b = nc.get_variable("W")
            psfc_b = nc.get_variable("PSFC")
        with NetcdfReader(str(out_stream / f"wrfout_nc_{m:03d}")) as nc:
            u_a = nc.get_variable("U")
            w_a = nc.get_variable("W")
            psfc_a = nc.get_variable("PSFC")
        assert (u_a[:-1] != u_b[:-1]).any(), "U interior was not updated"
        np.testing.assert_array_equal(u_a[-1], u_b[-1])   # staggered sliver
        np.testing.assert_array_equal(w_a, w_b)           # not in var_update
        np.testing.assert_array_equal(psfc_a, psfc_b)     # untouched var


def test_stream_mean_geopotential_matches_eager(tmp_path):
    """Both ensembles give the bit-identical mean geopotential, so both
    place the analysis points at identical altitudes (a last-bit
    difference moves obs across the cap threshold at near-ties)."""
    from cwbnwp_letkf_tpu.config import LetkfConfig
    from cwbnwp_letkf_tpu.models.state import (StreamingWrfEnsemble,
                                               read_ensemble)

    from .wrf_fixtures import make_wrf_ensemble

    paths = make_wrf_ensemble(str(tmp_path), 7, seed=11, nz=6)
    cfg = LetkfConfig(nmember=7, var_update=("T",), wrf_mp_physics=4)
    eager = read_ensemble(paths, cfg)
    stream = StreamingWrfEnsemble(
        paths, cfg, [str(tmp_path / f"out_{m}") for m in range(7)])
    np.testing.assert_array_equal(stream.mean_ph(), eager.mean_ph())
