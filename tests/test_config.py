"""Namelist importer vs the production-shaped namelist fixture.

``examples/input.nml`` is built from the values SURVEY.md cites for the
reference's production input.nml; the verbatim test at the bottom reads the
reference's own file when it is mounted.
"""
import pytest
import os

from cwbnwp_letkf_tpu.config import LetkfConfig, parse_namelist

NML = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir,
                   "examples", "input.nml")


def test_parse_production_namelist():
    cfg = LetkfConfig.from_namelist(NML)
    assert cfg.nmember == 96                       # input.nml:6
    assert cfg.var_update[0] == "U"
    assert "QVAPOR" in cfg.var_update
    assert cfg.weight_function == 0                # input.nml:9 (Gaussian)
    nv = cfg.nvars
    assert nv == len(cfg.var_update) <= 16


def test_radar_config_rows():
    cfg = LetkfConfig.from_namelist(NML)
    assert cfg.radar.dbz.use_it
    assert cfg.radar.vr.use_it
    # per-analysis-variable localization radii rows (input.nml:34-46)
    assert cfg.radar.dbz.max_lz_pts == 300
    assert len(cfg.radar.dbz.hclr) == 16
    # dbz is assimilated only for hydrometeor variables (input.nml:37 row:
    # -1 for U..QVAPOR, 8 km for QRAIN..QNHAIL)
    assert cfg.radar.dbz.hclr[0] == -1.0
    assert cfg.radar.dbz.hclr[5] == 8.0
    assert cfg.radar.vr.hclr[0] == 36.0
    assert cfg.radar.dbz.error == 2.5
    assert cfg.radar.dbz.err_rej == 20.0


def test_gts_platform_config():
    cfg = LetkfConfig.from_namelist(NML)
    assert cfg.sound.use_it
    assert cfg.synop.use_it
    # is_assim indexed by var_update position (config.f90:19; SURVEY section 5)
    assert len(cfg.sound.u.is_assim) == 16


def test_inflation_tables():
    cfg = LetkfConfig.from_namelist(NML)
    assert len(cfg.inflation.multi_infl) == 16
    assert max(cfg.inflation.multi_infl) > 1.0     # input.nml:160s
    assert any(cfg.inflation.use_rtpp) or any(cfg.inflation.use_rtps)


def test_missing_nmember_raises():
    with pytest.raises(ValueError):
        LetkfConfig()


def test_parse_namelist_repeats_and_bools():
    groups = parse_namelist(
        """
&control
 nmember = 4
 var_update = 'U', 'V'
 flags = 3*.true., F
/
"""
    )
    ctl = groups["control"]
    assert ctl["nmember"] == [4]
    assert ctl["var_update"] == ["U", "V"]
    assert ctl["flags"] == [True, True, True, False]


REFERENCE_NML = "/root/reference/input.nml"


@pytest.mark.skipif(not os.path.exists(REFERENCE_NML),
                    reason="reference input.nml not mounted")
def test_reference_production_namelist_imports_verbatim():
    """The reference's real production input.nml parses without edits."""
    from cwbnwp_letkf_tpu.driver import _group_variables
    from cwbnwp_letkf_tpu.obs.base import platform_statics_from_config

    cfg = LetkfConfig.from_namelist(REFERENCE_NML)
    assert cfg.nmember == 96
    assert len(cfg.var_update) == 16 and cfg.var_update[0] == "U"
    assert cfg.radar.dbz.use_it and cfg.radar.vr.use_it
    assert cfg.radar.dbz.error == 2.5 and cfg.radar.vr.error == 1.0
    assert cfg.synop.hclr[0] == 50.0 and cfg.radar.dbz.hclr[5] == 8.0
    assert cfg.inflation.multi_infl[0] == 1.6
    assert cfg.inflation.use_rtps[0] and cfg.inflation.rtps_alpha[0] == 0.95

    # Variable fusion on the production config: 16 variables collapse into
    # 8 localization-signature groups (all 8 hydrometeors share one
    # eigendecomposition per gridpoint; T+QVAPOR share another).
    class _FakeDP:
        def __init__(self, st):
            self.static = st

    platforms = [_FakeDP(st) for st in platform_statics_from_config(cfg)]
    groups = [[v for _, v, _ in members]
              for _, members in _group_variables(cfg, platforms)]
    assert len(groups) == 8
    assert ["T", "QVAPOR"] in groups
    assert ["QRAIN", "QSNOW", "QGRAUP", "QHAIL", "QNRAIN", "QNSNOW",
            "QNGRAUPEL", "QNHAIL"] in groups
