"""Unified observation containers for the device analysis path.

The reference keeps two parallel obs hierarchies — ``gts_structure`` with
per-record multi-variable obs/error/qc/hdxb arrays
(/root/reference/module_gts_omboma.f90:13-22) and ``radar_structure`` with
scalar obs + hdxb and config-supplied errors
(/root/reference/module_radar.f90:13-16).  Here both are normalized into one
flat, device-friendly layout: every platform is a set of *records* (station
locations, the unit the localization search and the ``max_lz_pts`` cap apply
to — module_localization.f90:148-160, module_kdtree2 trees hold one point per
record) carrying ``nvar`` observed quantities each.

Radar platforms become ``nvar = 1`` with ``error = 1`` and ``qc = 0``
everywhere; the configured retrieval error enters through ``err_muti`` —
algebraically identical to the reference where the radar effective error is
the namelist ``error`` alone (module_letkf_core.f90:502 vs :435).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from ..config import LetkfConfig, MAX_VARS

#: GTS platform families assimilated by the solver and their observed
#: variables in file/column order (module_letkf_core.f90:338-418).
GTS_FAMILY_VARS = {
    "synop": ("u", "v", "t", "p", "q"),
    "ships": ("u", "v", "t", "p", "q"),
    "metar": ("u", "v", "t", "p", "q"),
    "sound": ("u", "v", "t", "q"),
    "gpspw": ("tpw",),
}

RADAR_VARS = ("dbz", "vr", "zdr", "kdp")


class PlatformObs(NamedTuple):
    """Device-resident flat arrays for one obs platform (pytree).

    Shapes (R = records, V = observed vars per record, K = ensemble size):
      xyz:   [R, 3]     Lambert-projected x, y (meters) + altitude
      obs:   [V, R]     observed values
      error: [V, R]     file-supplied obs error (1.0 for radar)
      qc:    [V, R, K]  per-member QC flags (>= 0 is good; 0 for radar)
      hdxb:  [V, R, K]  per-member H(xb) (= obs - omb; gts_omboma.f90:171)
    """

    xyz: np.ndarray
    obs: np.ndarray
    error: np.ndarray
    qc: np.ndarray
    hdxb: np.ndarray

    @property
    def nrec(self) -> int:
        return self.xyz.shape[0]

    @property
    def nvar(self) -> int:
        return self.obs.shape[0]


@dataclass(frozen=True)
class PlatformStatic:
    """Hashable per-platform static config for one LETKF run.

    All per-analysis-variable arrays are indexed by the *position of the
    variable in var_update* — the reference's load-bearing convention
    (config.f90:59-68; module_localization.f90:74-80).
    """

    name: str                      # 'synop' | ... | 'dbz' | 'vr' | ...
    kind: str                      # 'gts' | 'radar'
    nvar: int                      # observed quantities per record
    max_lz_pts: int                # localization cap (config.f90:9,30)
    hclr: Tuple[float, ...]        # [MAX_VARS] km, <=0 -> not assimilated
    vclr: Tuple[float, ...]        # [MAX_VARS] km, <=0 -> 2-D localization
    err_muti: Tuple[float, ...]    # [nvar] error multipliers
    err_rej: Tuple[float, ...]     # [nvar] rejection thresholds
    is_assim: Tuple[Tuple[bool, ...], ...]  # [nvar][MAX_VARS]
    is_dbz: bool = False           # reflectivity no-rain special cases

    def assim_mask(self, ivar: int) -> Tuple[bool, ...]:
        """Which observed variables feed analysis variable ``ivar``.

        A platform contributes only when its ``hclr(ivar) > 0``
        (module_localization.f90:74, module_letkf_core.f90:355-363) and the
        observed variable's ``is_assim(ivar)`` is set.
        """
        if self.hclr[ivar] <= 0.0:
            return tuple(False for _ in range(self.nvar))
        return tuple(self.is_assim[v][ivar] for v in range(self.nvar))

    def active(self, ivar: int) -> bool:
        return any(self.assim_mask(ivar))


def platform_statics_from_config(cfg: LetkfConfig) -> List[PlatformStatic]:
    """Build the static platform table from a run config.

    Only enabled platforms (``use_it``) appear — the same gate as the
    reference's tree construction (module_localization.f90:74,113).
    """
    out: List[PlatformStatic] = []
    for name, vars_ in GTS_FAMILY_VARS.items():
        p = cfg.gts_platform(name)
        if not p.use_it:
            continue
        out.append(
            PlatformStatic(
                name=name,
                kind="gts",
                nvar=len(vars_),
                max_lz_pts=p.max_lz_pts,
                hclr=tuple(p.hclr),
                vclr=tuple(p.vclr),
                err_muti=tuple(p.var(v).err_muti for v in vars_),
                err_rej=tuple(p.var(v).err_rej for v in vars_),
                is_assim=tuple(tuple(p.var(v).is_assim) for v in vars_),
            )
        )
    for name in RADAR_VARS:
        r = cfg.radar.var(name)
        if not r.use_it:
            continue
        out.append(
            PlatformStatic(
                name=name,
                kind="radar",
                nvar=1,
                max_lz_pts=r.max_lz_pts,
                hclr=tuple(r.hclr),
                vclr=tuple(r.vclr),
                err_muti=(r.error,),      # module_letkf_core.f90:488,502
                err_rej=(r.err_rej,),
                # radar assimilation is gated purely by hclr > 0
                # (module_letkf_core.f90:487,491)
                is_assim=(tuple(True for _ in range(MAX_VARS)),),
                is_dbz=(name == "dbz"),
            )
        )
    return out


def make_platform_obs(
    xyz: np.ndarray,
    obs: np.ndarray,
    hdxb: np.ndarray,
    error: Optional[np.ndarray] = None,
    qc: Optional[np.ndarray] = None,
    dtype=np.float32,
) -> PlatformObs:
    """Assemble a :class:`PlatformObs`, filling radar-style defaults."""
    obs = np.asarray(obs, dtype)
    if obs.ndim == 1:
        obs = obs[None, :]
    hdxb = np.asarray(hdxb, dtype)
    if hdxb.ndim == 2:
        hdxb = hdxb[None, :, :]
    v, r = obs.shape
    k = hdxb.shape[-1]
    if error is None:
        error = np.ones((v, r), dtype)
    else:
        error = np.asarray(error, dtype)
        if error.ndim == 1:
            error = error[None, :]
    if qc is None:
        qc = np.zeros((v, r, k), dtype)
    else:
        qc = np.asarray(qc, dtype)
        if qc.ndim == 2:
            qc = qc[None, :, :]
    return PlatformObs(
        xyz=np.asarray(xyz, dtype), obs=obs, error=error, qc=qc, hdxb=hdxb
    )
