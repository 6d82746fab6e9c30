"""Plain NumPy float64 oracles transcribing the reference algorithms.

These are *test oracles only* — direct, unoptimized transcriptions of the
math in the reference's module_letkf_core.f90, module_localization.f90 and
module_projection.f90, written from the algorithm descriptions for verifying
the device implementations point-by-point.
"""
from __future__ import annotations

import math

import numpy as np

GC1999 = 2.0 * math.sqrt(10.0 / 3.0)


def gaspari_cohn_1999(x: float) -> float:
    """module_localization.f90:333-364 (scalar)."""
    a = math.sqrt(10.0 / 3.0)
    z = x / a
    if z <= 1.0:
        return z * z * (z * (z * (-0.25 * z + 0.5) + 0.625) - 5.0 / 3.0) + 1.0
    elif z <= 2.0:
        val = (
            z * (z * (z * (z * ((1.0 / 12.0) * z - 0.5) + 0.625) + 5.0 / 3.0) - 5.0)
            + 4.0
            - (2.0 / 3.0) / z
        )
        return max(val, 0.0)  # rounding can dip below 0 at the z=2 boundary
    return 0.0


def error_inv(r2: float, err: float, weight_function: int) -> float:
    """module_letkf_core.f90:439-450."""
    if weight_function != 1:
        return 1.0 / (err * math.exp(0.25 * r2))
    return math.sqrt(gaspari_cohn_1999(math.sqrt(r2))) / err


def letkf_solve(
    xb,
    yo,
    yb,
    inflat,
    use_rtpp=False,
    rtpp_alpha=0.85,
    use_rtps=False,
    rtps_alpha=0.85,
):
    """module_letkf_core.f90:598-700 in float64.

    xb: [k]; yo: [n]; yb: [k, n] (pre-whitened).  Returns xa [k].
    """
    xb = np.asarray(xb, np.float64)
    yo = np.asarray(yo, np.float64)
    yb = np.asarray(yb, np.float64)
    k = xb.size

    a = inflat * np.eye(k) + yb @ yb.T          # dsyrk           :649
    lam, vec = np.linalg.eigh(a)                # dsyevd          eigen.f90:49
    pa = (vec / lam) @ vec.T                    # inverse_matrix  eigen.f90:51-56
    w = (vec / np.sqrt(lam)) @ vec.T            # sqrt_matrix of A^-1, :89-93
    wm = pa @ (yb @ yo)                         # dgemv+dsymv     :651-652

    xb_mean = xb.mean()
    xb_prime = xb - xb_mean
    # Wtot[i, j] = wm[i] + sqrt(k-1)*W[i, j];  xa = mean + Wtot^T xb'  :662-679
    xa = xb_mean + wm @ xb_prime + math.sqrt(k - 1.0) * (w.T @ xb_prime)

    if use_rtpp or use_rtps:                    # :684-698
        xa_mean = xa.mean()
        xa_prime = xa - xa_mean
        if use_rtpp:
            xa_prime = (1.0 - rtpp_alpha) * xa_prime + rtpp_alpha * xb_prime
        if use_rtps:
            xb_std = xb_prime @ xb_prime
            xa_std = xa_prime @ xa_prime
            xa_prime = xa_prime * (
                rtps_alpha * math.sqrt(xb_std / xa_std) - rtps_alpha + 1.0
            )
        xa = xa_mean + xa_prime
    return xa


def whiten_obs(obs, hdxb, err, r2, err_rej, weight_function, norain_value=None):
    """Single-obs QC + whitening (module_letkf_core.f90:429-455).

    obs: scalar; hdxb: [k] member H(xb); err: effective error.
    Returns (accept, yo_prime, yb_prime[k]).
    ``norain_value``: when set, applies the dbz no-rain special cases
    (letkf_core.f90:504-510).
    """
    hdxb = np.asarray(hdxb, np.float64)
    k = hdxb.size
    mean = hdxb.mean()
    bg = hdxb - mean
    omm = obs - mean
    std = math.sqrt(bg @ bg / (k - 1.0))

    reject = abs(omm) > math.sqrt(std * std + err * err) * err_rej
    if norain_value is not None:
        if reject and obs != norain_value:
            return False, 0.0, np.zeros(k)
        if obs == norain_value and mean == norain_value:
            return False, 0.0, np.zeros(k)
    elif reject:
        return False, 0.0, np.zeros(k)

    einv = error_inv(r2, err, weight_function)
    return True, omm * einv, bg * einv


def lambert_lonlat_to_xy(lon, lat, cen_lat, truelat1, truelat2, sta_lon,
                         earthradius=6.37122e6):
    """module_projection.f90:21-50 in float64 (scalar)."""
    d2r = math.pi / 180.0
    lat0 = cen_lat * d2r
    lat1 = truelat1 * d2r
    lat2 = truelat2 * d2r
    lon0 = sta_lon * d2r

    def cotan(t):
        return 1.0 / math.tan(t)

    n = math.log(math.cos(lat1) / math.cos(lat2)) / math.log(
        math.tan(0.5 * (0.5 * math.pi + lat2)) * cotan(0.5 * (0.5 * math.pi + lat1))
    )
    f = math.cos(lat1) * math.exp(n * math.log(math.tan(0.5 * (0.5 * math.pi + lat1)))) / n
    rh0 = earthradius * f * math.exp(n * math.log(cotan(0.5 * (0.5 * math.pi + lat0))))
    rh = earthradius * f * math.exp(n * math.log(cotan(0.5 * (0.5 * math.pi + lat * d2r))))
    dlon = n * (lon * d2r - lon0)
    return rh * math.sin(dlon), rh0 - rh * math.cos(dlon)


def radius_neighbors_brute(points, query, r2max):
    """Brute-force fixed-radius search oracle (module_kdtree2.f90:1755-1793).

    points: [d, n]; query: [d].  Returns (idx, r2) of all points with
    squared distance <= r2max, sorted by distance.
    """
    d2 = ((points - np.asarray(query)[:, None]) ** 2).sum(axis=0)
    idx = np.nonzero(d2 <= r2max)[0]
    order = np.argsort(d2[idx], kind="stable")
    return idx[order], d2[idx][order]


def tune_q(q):
    """letkf_tune_q (module_letkf_core.f90:702-733); q: [..., k]."""
    q = np.asarray(q, np.float64)
    out = q.copy()
    flat = out.reshape(-1, q.shape[-1])
    for row in flat:
        pos = row > 0.0
        spos = row[pos].sum()
        if spos > 0.0:
            ratio = row.sum() / spos
            row[~pos] = 0.0
            row[pos] *= ratio
        else:
            row[:] = 0.0
    return flat.reshape(q.shape)
