"""Prior parameter fitting from free-energy estimates (a copy of
flashmd_tpu/prior/fitting.py, for a package that imports nothing of it;
the reference's harmonic.py:126-175 ``Harmonic.fit_from_potential_estimates``,
repulsion.py:125-196 ``Repulsion.fit_from_values`` /
``fit_from_potential_estimates``, and fourier_series.py:253-431 with its
linear fit and AIC / adjusted-R2 degree selection).

These run once, on the host, in numpy and scipy, before a simulation.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
from scipy.integrate import trapezoid
from scipy.optimize import curve_fit


def harmonic_compute_np(x, x0, k, v0=0.0):
    return k * (x - x0) ** 2 + v0


def fit_harmonic_from_potential_estimates(
    bin_centers_nz, dG_nz
) -> Dict:
    """Harmonic k/x_0 from a free-energy curve
    (reference: harmonic.py:126-175)."""
    bin_centers_nz = np.asarray(bin_centers_nz, dtype=np.float64)
    dG_nz = np.asarray(dG_nz, dtype=np.float64)
    integral = float(trapezoid(dG_nz, bin_centers_nz))
    mask = np.abs(dG_nz) > 1e-4 * abs(integral)
    try:
        popt, _ = curve_fit(
            harmonic_compute_np,
            bin_centers_nz[mask],
            dG_nz[mask],
            p0=[bin_centers_nz[mask][np.argmin(dG_nz[mask])], 60, -1],
        )
        return {"k": float(popt[1]), "x_0": float(popt[0])}
    except Exception:
        return {"k": float("nan"), "x_0": float("nan")}


def fit_repulsion_from_values(
    values, percentile: float = 1, cutoff: Optional[float] = None
) -> Dict:
    """sigma from a distance-sample percentile
    (reference: repulsion.py:125-158)."""
    values = np.asarray(values, dtype=np.float64)
    if cutoff is not None:
        values = values[values < cutoff]
    return {"sigma": float(np.percentile(values, percentile))}


def fit_repulsion_from_potential_estimates(
    bin_centers_nz, dG_nz=None
) -> Dict:
    """sigma from the first populated free-energy bin
    (reference: repulsion.py:161-196)."""
    bin_centers_nz = np.asarray(bin_centers_nz, dtype=np.float64)
    delta = bin_centers_nz[1] - bin_centers_nz[0]
    return {"sigma": float(bin_centers_nz[0] - 0.5 * delta)}


def _fourier_design(theta, n_degs: int):
    cols = [np.ones_like(theta)]
    for n in range(1, n_degs + 1):
        cols.append(np.sin(n * theta))
    for n in range(1, n_degs + 1):
        cols.append(np.cos(n * theta))
    return np.stack(cols, axis=1)


def fourier_compute_np(theta, v0, k1s, k2s):
    n = np.arange(1, len(k1s) + 1)
    ang = theta[:, None] * n[None, :]
    return v0 + np.sin(ang) @ np.asarray(k1s) + np.cos(ang) @ np.asarray(
        k2s
    )


def _neg_log_likelihood(y, yhat):
    """Boltzmann-weighted divergence (reference:
    fourier_series.py:194-201)."""
    return -float(np.sum(np.exp(-y) * np.log(np.exp(-yhat))))


def fit_fourier_from_potential_estimates(
    bin_centers_nz,
    dG_nz,
    n_degs: int = 6,
    constrain_deg: Optional[int] = None,
    metric: str = "aic",
) -> Dict:
    """Fourier-series fit with AIC / adjusted-R2 degree selection
    (reference: fourier_series.py:292-431).

    Returns the reference statistics schema
    {"k1s": {...}, "k2s": {...}, "v_0": ...} padded to ``n_degs``.
    """
    theta = np.asarray(bin_centers_nz, dtype=np.float64)
    dg = np.asarray(dG_nz, dtype=np.float64)

    def fit_deg(deg):
        x = _fourier_design(theta, deg)
        coef, *_ = np.linalg.lstsq(x, dg, rcond=None)
        v0 = coef[0]
        k1s = coef[1:1 + deg]
        k2s = coef[1 + deg:]
        yhat = x @ coef
        return v0, k1s, k2s, yhat

    if constrain_deg is not None:
        best_deg = int(constrain_deg)
        v0, k1s, k2s, _ = fit_deg(best_deg)
    else:
        best_deg, best_score = None, None
        for deg in range(1, n_degs + 1):
            v0_d, k1_d, k2_d, yhat = fit_deg(deg)
            free = 1 + 2 * deg
            n_samples = len(dg)
            if metric == "aic":
                score = 2 * _neg_log_likelihood(dg, yhat) + 2 * free
                better = best_score is None or score < best_score
            else:  # adjusted R^2 (higher is better)
                ssres = float(np.sum((dg - yhat) ** 2))
                sstot = float(np.sum((dg - dg.mean()) ** 2))
                score = 1 - (ssres / max(n_samples - free - 1, 1)) / (
                    sstot / (n_samples - 1)
                )
                better = best_score is None or score > best_score
            if better:
                best_score, best_deg = score, deg
        v0, k1s, k2s, _ = fit_deg(best_deg)

    stat = {"k1s": {}, "k2s": {}, "v_0": float(v0)}
    for i in range(n_degs):
        stat["k1s"][f"k1_{i + 1}"] = float(k1s[i]) if i < best_deg else 0.0
        stat["k2s"][f"k2_{i + 1}"] = float(k2s[i]) if i < best_deg else 0.0
    return stat
