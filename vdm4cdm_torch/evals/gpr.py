"""Radial-covariance estimation and Gaussian-process posteriors for
inpainting / boundary studies.

Capability parity with the reference's GPR toolkit (src/utils.py:306-399 —
empirical radial covariance of a periodic image, the parametric fit
``a e^{-br} + c/(dr+1) + e``, a Cholesky GP posterior with draws, smooth mask
boundaries and an FFT-cross-correlation smoothness z-score), implemented
independently:

  * the covariance estimator samples random PIXEL PAIRS in one vectorized
    pass (the reference loops a full-image distance map per anchor pixel —
    O(n_anchor * n_pix) host work for the same binned statistic);
  * the GP solve goes through scipy's ``cho_factor``/``cho_solve`` and draws
    posterior samples via a jittered Cholesky of the posterior covariance;
  * the smoothness statistic uses the real FFT (the imaginary part is zero by
    construction rather than asserted away).

Host-side analysis code (numpy and scipy), not a device path: this
package's own copy of ``vdm4cdm_tpu/evals/gpr.py``. It takes the same
``np.random.Generator`` arguments in the same order, so seeded results equal
the JAX package's.
"""

from __future__ import annotations

import numpy as np
import scipy.linalg as sla
import scipy.ndimage as sim
import scipy.optimize as sopt


def _binned_mean_std(values: np.ndarray, bin_idx: np.ndarray, n_bins: int):
    """Per-bin count/mean/std via bincount (one pass, no scipy)."""
    counts = np.bincount(bin_idx, minlength=n_bins).astype(np.float64)
    sums = np.bincount(bin_idx, weights=values, minlength=n_bins)
    sq = np.bincount(bin_idx, weights=values**2, minlength=n_bins)
    safe = np.maximum(counts, 1.0)
    means = sums / safe
    var = np.maximum(sq / safe - means**2, 0.0)
    means[counts == 0] = np.nan
    return counts, means, np.sqrt(var)


def get_radial_cov_func_image(im, r_cov_est: int = 50, n_cov_est: int = 4000,
                              return_stats: bool = False, rng=None,
                              pairs_per_anchor: int = 256):
    """Isotropic radial covariance of a square periodic image.

    Draws ``n_cov_est * pairs_per_anchor`` random (anchor, offset) pixel pairs
    with |offset| <= r_cov_est, bins the de-meaned products by pair distance
    (unit-width bins centered on integer radii), and returns an interpolating
    callable anchored at (0, Var[im]). With ``return_stats``, also returns
    (var, bin_centers, means, stds, sems).
    """
    im = np.asarray(im, np.float64)
    size_x, size_y = im.shape
    assert size_x == size_y, "Image must be square"
    assert r_cov_est < size_x // 2, "estimation radius must be sub-periodic"
    rng = rng or np.random.default_rng()
    centered = im - im.mean()

    n_pairs = int(n_cov_est) * int(pairs_per_anchor)
    ax = rng.integers(0, size_x, n_pairs)
    ay = rng.integers(0, size_y, n_pairs)
    # offsets in the square [-r, r]^2, thinned to the punctured disc
    ox = rng.integers(-r_cov_est, r_cov_est + 1, n_pairs)
    oy = rng.integers(-r_cov_est, r_cov_est + 1, n_pairs)
    r = np.hypot(ox, oy)
    keep = (r > 0) & (r <= r_cov_est)
    ax, ay, ox, oy, r = ax[keep], ay[keep], ox[keep], oy[keep], r[keep]

    prod = centered[ax, ay] * centered[(ax + ox) % size_x, (ay + oy) % size_y]
    # unit bins centered on integer radii: r in (k-1/2, k+1/2] -> bin k-1
    bin_idx = np.clip(np.round(r).astype(np.int64), 1, r_cov_est) - 1
    counts, means, stds = _binned_mean_std(prod, bin_idx, r_cov_est)
    sems = stds / np.sqrt(np.maximum(counts, 1.0))
    centers = np.arange(1, r_cov_est + 1, dtype=np.float64)

    var = centered.var()
    knots_r = np.concatenate([[0.0], centers[np.isfinite(means)]])
    knots_c = np.concatenate([[var], means[np.isfinite(means)]])
    floor = min(np.nanmin(knots_c), 0.0)

    def radial_cov(rq):
        rq = np.asarray(rq, np.float64)
        out = np.interp(rq, knots_r, knots_c, left=knots_c[0], right=floor)
        return np.where(rq > knots_r[-1], floor, out)

    if return_stats:
        return radial_cov, var, centers, means, stds, sems
    return radial_cov


def get_parametric_radial_cov_func(radial_cov_func, fit_range=(0, 50),
                                   n: int = 1000, tol: float = 0.05,
                                   maxfev: int = 5000, return_params: bool = False):
    """Least-squares fit of the (reference-specified) parametric family
    ``cov(r) = a e^{-b r} + c/(d r + 1) + e`` to an empirical covariance
    callable. Raises ValueError if the fit misses any point by more than
    ``tol``."""
    rs = np.linspace(fit_range[0], fit_range[1], n)
    cov = np.asarray(radial_cov_func(rs), np.float64)

    def family(r, a, b, c, d, e):
        return a * np.exp(-b * r) + c / (d * r + 1.0) + e

    # initial guess: pure exponential through the first point with the decay
    # implied by the value at 1/5 of the range (floored to keep log finite)
    r_probe = max(fit_range[1] / 5.0, 1.0)
    ratio = max(float(radial_cov_func(r_probe)) / max(cov[0], 1e-12), 1e-8)
    guess = [cov[0], -np.log(ratio) / r_probe, 0.0, 0.0, 0.0]
    params, _ = sopt.curve_fit(family, rs, cov, p0=guess, maxfev=maxfev)

    resid = np.abs(family(rs, *params) - cov)
    if not np.all(resid < tol):
        raise ValueError(
            f"parametric covariance fit misses tolerance {tol} "
            f"(max residual {resid.max():.4g})")
    fitted = lambda r: family(np.asarray(r, np.float64), *params)
    if return_params:
        return fitted, params
    return fitted


def get_gpr_result(x_uk, x_k, y_k, cov_func, n_samples: int = 24,
                   reg_diag: float = 0.0, reg_all: float = 0.0, rng=None):
    """Exact GP posterior at ``x_uk`` given observations (x_k, y_k) under a
    covariance function ``cov_func(a, b) -> (len(a), len(b))``. Returns
    (posterior mean, posterior variance, (n_samples, len(x_uk)) draws)."""
    rng = rng or np.random.default_rng()
    x_uk, x_k = np.atleast_1d(x_uk), np.atleast_1d(x_k)
    y_k = np.asarray(y_k, np.float64)

    K = np.asarray(cov_func(x_k, x_k), np.float64)
    K = K + reg_diag * np.eye(len(x_k)) + reg_all
    K_cross = np.asarray(cov_func(x_uk, x_k), np.float64)
    K_prior = np.asarray(cov_func(x_uk, x_uk), np.float64)

    chol = sla.cho_factor(K, lower=True)
    mean = K_cross @ sla.cho_solve(chol, y_k)
    cov_post = K_prior - K_cross @ sla.cho_solve(chol, K_cross.T)
    var = np.diag(cov_post).copy()

    # draws via a jittered Cholesky of the (symmetrized) posterior covariance
    sym = 0.5 * (cov_post + cov_post.T)
    jitter = max(1e-12, 1e-10 * max(np.trace(sym) / max(len(sym), 1), 0.0))
    L_post = np.linalg.cholesky(sym + jitter * np.eye(len(sym)))
    draws = mean[None, :] + rng.standard_normal((n_samples, len(mean))) @ L_post.T
    return mean, var, draws


def get_smooth_mask_boundary(mask, sigma: float = 3.0):
    """Gaussian-smoothed mask and the magnitude of its gradient (central
    differences) — a soft boundary weight map."""
    smooth = sim.gaussian_filter(np.asarray(mask, np.float32), sigma=sigma)
    gx, gy = np.gradient(smooth)
    return smooth, np.hypot(gx, gy)


def get_smoothness(field, weight, return_maps: bool = False,
                   gradient: bool = True):
    """z-scored circular cross-correlation of (the gradient magnitude of) a
    field with a weight map — a seam/smoothness detector. Real-FFT based, so
    the result is exactly real."""
    field = np.asarray(field, np.float64)
    if gradient:
        gx, gy = np.gradient(field)
        probe = np.hypot(gx, gy)
    else:
        probe = field
    axes = tuple(range(probe.ndim))
    cc = np.fft.irfftn(
        np.fft.rfftn(probe) * np.fft.rfftn(np.asarray(weight, np.float64)),
        s=probe.shape, axes=axes,
    )
    z = (cc - cc.mean()) / cc.std(ddof=1)
    if return_maps:
        return z, probe, cc
    return z
