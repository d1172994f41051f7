"""Robust functional fitting: model functions, losses, and device-friendly optimizers.

Reference parity (/root/reference/xdem/fit.py): losses (rmse :42, huber_loss :54, soft_loss :69),
models (sumsin_1d :87, polynomial_1d :115, polynomial_2d :127), anti-overfit order selection
(_choice_best_order :157), robust_norder_polynomial_fit (:347), robust_nfreq_sumsin_fit (:463).

Device re-design: scipy's curve_fit/least_squares are replaced by a jit-compiled
Levenberg-Marquardt solver (`levenberg_marquardt`) on fixed-size problems; IRLS with robust
weights solves the (linear) polynomial fits in closed form; basin-hopping for the sum-of-sines
stays a host loop driving jitted residual evaluations.
"""

from __future__ import annotations

from functools import partial
from typing import Any, Callable, Literal, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from xdem_tpu._misc import import_optional
from xdem_tpu.ops.precision import pin_f32_matmuls
from xdem_tpu.ops.transfer import unmask

# --------------------------------------------------------------------------- losses


def _residuals(ytrue: np.ndarray, ypred: np.ndarray | None) -> np.ndarray:
    """One-arg calls pass residuals directly; two-arg calls follow the reference's
    (ytrue, ypred) convention (reference fit.py:42-79)."""
    z = np.asarray(ytrue)
    return z if ypred is None else z - np.asarray(ypred)


def rmse(ytrue: np.ndarray, ypred: np.ndarray | None = None) -> float:
    """Root mean square of residuals — either `rmse(residuals)` or `rmse(ytrue, ypred)`.

    >>> rmse(np.array([3.0, -4.0]))
    3.5355339059327378
    """
    return float(np.sqrt(np.nanmean(np.square(_residuals(ytrue, ypred)))))


def huber_loss(ytrue: np.ndarray, ypred: np.ndarray | None = None) -> float:
    """Huber loss: L2 near zero, L1 in the tails (delta = 1)."""
    z = _residuals(ytrue, ypred)
    out = np.where(np.abs(z) < 1, 0.5 * np.square(z), np.abs(z) - 0.5)
    return float(out.sum())


def soft_loss(ytrue: np.ndarray, ypred: np.ndarray | None = None, scale: float = 0.5) -> float:
    """Smooth approximation of the L1 loss (as in scipy least_squares 'soft_l1')."""
    if ypred is not None and np.ndim(ypred) == 0:
        # A scalar second positional is almost certainly the OLD soft_loss(z, scale) call:
        # refuse rather than silently compute residuals against a constant
        raise TypeError(
            "soft_loss's second argument is now ypred (reference fit.py:69); "
            "pass the scale as a keyword: soft_loss(z, scale=...)."
        )
    z = _residuals(ytrue, ypred)
    return float(np.sum(np.square(scale) * 2 * (np.sqrt(1 + np.square(z / scale)) - 1)))


# --------------------------------------------------------------------------- models


def sumsin_1d(xx: Any, *params: float) -> Any:
    """Sum of N sinusoids: params are 3N values (amplitude, wavelength, phase) per frequency."""
    xp = jnp if isinstance(xx, jnp.ndarray) else np
    p = xp.asarray(params).reshape((len(params) // 3, 3))
    x = xp.asarray(xx)
    shape = x.shape
    xf = x.ravel()
    out = xp.sum(p[:, 0][None, :] * xp.sin(2 * xp.pi / p[:, 1][None, :] * xf[:, None] + p[:, 2][None, :]), axis=1)
    return out.reshape(shape)


def polynomial_1d(xx: Any, *params: float) -> Any:
    """1-D polynomial sum(p[i] * x**i).

    >>> import numpy as np
    >>> polynomial_1d(np.array([0.0, 1.0, 2.0]), 1.0, 0.0, 2.0)
    array([1., 3., 9.])
    """
    xp = jnp if isinstance(xx, jnp.ndarray) else np
    return sum(p * xp.asarray(xx) ** i for i, p in enumerate(params))


def polynomial_2d(xx: tuple[Any, Any], *params: float) -> Any:
    """2-D polynomial of degree p with p^2 coefficients, evaluated as polyval2d."""
    x, y = xx
    p = int(np.sqrt(len(params)))
    if p**2 != len(params):
        raise ValueError("The number of parameters of the 2D polynomial must be a perfect square.")
    xp = jnp if isinstance(x, jnp.ndarray) else np
    c = xp.asarray(params).reshape((p, p))
    out = 0.0
    for i in range(p):
        for j in range(p):
            out = out + c[i, j] * xp.asarray(x) ** i * xp.asarray(y) ** j
    return out


# --------------------------------------------------------------------------- LM solver (device)


def _lm_loop(residual_fn, p0, max_iter, tol, lam0):
    """The traceable LM while_loop body shared by both jit entry points below."""

    def cost(p):
        r = residual_fn(p)
        return 0.5 * jnp.sum(r * r)

    def body(state):
        p, lam, c, it, _ = state
        r = residual_fn(p)
        J = jax.jacfwd(residual_fn)(p)
        JTJ = J.T @ J
        g = J.T @ r
        A = JTJ + lam * jnp.diag(jnp.maximum(jnp.diag(JTJ), 1e-12))
        step = jnp.linalg.solve(A, g)
        p_new = p - step
        c_new = cost(p_new)
        accept = c_new < c
        p = jnp.where(accept, p_new, p)
        lam = jnp.where(accept, lam * 0.3, lam * 3.0)
        improved = jnp.abs(c - c_new) > tol * jnp.maximum(c, 1e-30)
        c = jnp.where(accept, c_new, c)
        return p, lam, c, it + 1, improved | ~accept

    def cond(state):
        _, lam, _, it, keep_going = state
        return (it < max_iter) & keep_going & (lam < 1e12)

    p0 = jnp.asarray(p0, dtype=jnp.float32)
    state = (p0, jnp.asarray(lam0, p0.dtype), cost(p0), jnp.asarray(0), jnp.asarray(True))
    p, _, c, _, _ = jax.lax.while_loop(cond, body, state)
    return p, c


@partial(jax.jit, static_argnames=("residual_fn", "max_iter"))
@pin_f32_matmuls
def levenberg_marquardt(
    residual_fn: Callable[[jnp.ndarray], jnp.ndarray],
    p0: jnp.ndarray,
    max_iter: int = 50,
    tol: float = 1e-10,
    lam0: float = 1e-3,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Levenberg-Marquardt on a fixed-size residual function, as a lax.while_loop.

    Replaces scipy.optimize.curve_fit/least_squares for the framework's small dense problems
    (NuthKaab cosine fit, variogram sum-of-models fit, deramp). Returns (params, final cost).

    NOTE: `residual_fn` is a static argument — a fresh closure per call re-traces. For
    repeated fits of the same model over same-shaped data use :func:`_lm_data`, which takes
    the data as traced arguments and caches on the MODEL function's identity.
    """
    return _lm_loop(residual_fn, p0, max_iter, tol, lam0)


@partial(jax.jit, static_argnames=("func", "n_params", "max_iter"))
@pin_f32_matmuls
def _lm_data(func, x, y0, w, p0, n_params: int, max_iter: int = 50):
    """LM with the model function static but data TRACED: same (func, n_params, shapes)
    hits the in-process jit cache, so repeated fits never re-trace or re-compile."""

    def residual(p):
        return (func(x, *[p[i] for i in range(n_params)]) - y0) * w

    return _lm_loop(residual, p0, max_iter, 1e-10, 1e-3)


def curve_fit_lm(
    func: Callable[..., jnp.ndarray],
    xdata: jnp.ndarray,
    ydata: jnp.ndarray,
    p0: Sequence[float],
    sigma: jnp.ndarray | None = None,
    max_iter: int = 50,
) -> np.ndarray:
    """curve_fit-compatible wrapper over the jitted LM solver (NaN-masked, weighted)."""
    x = jnp.asarray(xdata)
    y = jnp.asarray(ydata)
    w = jnp.where(jnp.isfinite(y), 1.0, 0.0)
    if sigma is not None:
        w = w / jnp.where(jnp.asarray(sigma) > 0, jnp.asarray(sigma), jnp.inf)
    y0 = jnp.where(jnp.isfinite(y), y, 0.0)

    p, _ = _lm_data(func, x, y0, w, jnp.asarray(p0, dtype=jnp.float32),
                    n_params=len(p0), max_iter=max_iter)
    return np.asarray(p, dtype=np.float64)


# --------------------------------------------------------------------------- IRLS polynomial


def _irls_polyfit(x: np.ndarray, y: np.ndarray, degree: int,
                  loss: Literal["linear", "huber", "soft_l1"] = "huber",
                  f_scale: float = 0.1, n_iter: int = 20,
                  sigma: np.ndarray | None = None) -> np.ndarray:
    """Iteratively-reweighted least squares for robust polynomial fitting (linear problem).

    `sigma` (per-point standard error) contributes a 1/sigma base weight, multiplied with
    the robust-loss reweighting — the IRLS analog of scipy curve_fit's sigma."""
    V = np.vander(x, degree + 1, increasing=True)
    base = np.ones_like(y) if sigma is None else 1.0 / np.where(sigma > 0, sigma, np.inf)
    w = base.copy()
    coefs = None
    for _ in range(n_iter if loss != "linear" else 1):
        Vw = V * w[:, None]
        coefs, *_ = np.linalg.lstsq(Vw, y * w, rcond=None)
        r = (V @ coefs - y) / f_scale
        if loss == "huber":
            w = base * np.where(np.abs(r) <= 1, 1.0, 1.0 / np.sqrt(np.abs(r)))
        elif loss == "soft_l1":
            w = base * (1 + r**2) ** -0.25
        else:
            break
    return coefs


def _choice_best_order(cost: np.ndarray, margin_improvement: float = 20.0) -> int:
    """Lowest order whose cost is within `margin_improvement` % of the minimum cost
    (anti-overfitting margin; reference fit.py:157)."""
    ind_min = int(np.argmin(cost))
    min_cost = cost[ind_min]
    ind = [i for i in range(len(cost)) if cost[i] < min_cost + margin_improvement / 100.0 * min_cost]
    return int(min(ind))


def robust_norder_polynomial_fit(
    xdata: np.ndarray,
    ydata: np.ndarray,
    sigma: np.ndarray | None = None,
    max_order: int = 6,
    estimator_name: Literal["Linear", "Theil-Sen", "RANSAC", "Huber"] = "Huber",
    cost_func: Callable[[np.ndarray], float] = soft_loss,
    margin_improvement: float = 20.0,
    subsample: float | int = 1,
    linear_pkg: Literal["scipy", "sklearn"] = "scipy",
    random_state: int | None = None,
    **kwargs: Any,
) -> tuple[np.ndarray, int]:
    """Fit polynomials of order 1..max_order robustly and pick the best order.

    Returns (coefficients, degree). Reference fit.py:347 (scipy path = robust IRLS here;
    sklearn path uses the same estimator names when requested).
    """
    x = np.asarray(unmask(xdata), dtype=np.float64).ravel()
    y = np.asarray(unmask(ydata), dtype=np.float64).ravel()
    s = np.asarray(sigma, dtype=np.float64).ravel() if sigma is not None else None
    valid = np.isfinite(x) & np.isfinite(y)
    x, y = x[valid], y[valid]
    if s is not None:
        s = s[valid]
    if subsample != 1 and len(x) > 0:
        n = len(x)
        count = int(subsample * n) if isinstance(subsample, float) and subsample <= 1 else int(subsample)
        rng = np.random.default_rng(random_state)
        idx = rng.choice(n, min(count, n), replace=False)
        x, y = x[idx], y[idx]
        if s is not None:
            s = s[idx]

    costs = np.empty(max_order)
    coefs_list: list[np.ndarray] = []
    for deg in range(1, max_order + 1):
        if linear_pkg == "sklearn":
            # An invalid estimator_name (incl. None) raises inside, like the reference
            c = _sklearn_polyfit(x, y, deg, estimator_name, random_state=random_state,
                                 sigma=s, **kwargs)
        else:
            c = _irls_polyfit(x, y, deg, loss="huber", sigma=s)
        resid = polynomial_1d(x, *c) - y
        costs[deg - 1] = cost_func(resid)
        coefs_list.append(c)

    best = _choice_best_order(costs, margin_improvement=margin_improvement)
    # Round to 5 decimals for cross-platform determinism (reference fit.py:234-235)
    out = np.zeros(max_order + 1)
    out[: best + 2] = np.round(coefs_list[best], 5)
    return out, best + 1


def _sklearn_polyfit(x: np.ndarray, y: np.ndarray, degree: int, estimator_name: str,
                     random_state: int | None = None, sigma: np.ndarray | None = None,
                     **kwargs: Any) -> np.ndarray:
    """Robust linear estimators from sklearn over a polynomial feature expansion
    (reference fit.py:255). `sigma` becomes sample_weight = 1/sigma^2 for estimators whose
    fit() supports it (reference fit.py:323-329)."""
    import inspect

    lm = import_optional("sklearn.linear_model", package_name="scikit-learn")
    HuberRegressor, LinearRegression = lm.HuberRegressor, lm.LinearRegression
    RANSACRegressor, TheilSenRegressor = lm.RANSACRegressor, lm.TheilSenRegressor

    est_map = {
        "Linear": LinearRegression(),
        "Theil-Sen": TheilSenRegressor(random_state=random_state),
        "RANSAC": RANSACRegressor(random_state=random_state),
        "Huber": HuberRegressor(max_iter=1000),
    }
    if estimator_name not in est_map:
        raise ValueError(f"Attribute estimator must be one of {list(est_map)}, not {estimator_name}.")
    est = est_map[estimator_name]
    V = np.vander(x, degree + 1, increasing=True)[:, 1:]  # skip constant; estimator fits intercept
    if sigma is not None and "sample_weight" in inspect.signature(est.fit).parameters:
        est.fit(V, y, sample_weight=1.0 / sigma**2)
    else:
        est.fit(V, y)
    if estimator_name == "RANSAC":
        inner = est.estimator_
        return np.r_[inner.intercept_, inner.coef_]
    return np.r_[est.intercept_, est.coef_]


# --------------------------------------------------------------------------- sum of sines


def _periodogram_best_wavelength(x: np.ndarray, y: np.ndarray, wavelengths: np.ndarray):
    """For each candidate wavelength, solve the LINEAR least squares
    y ~ A sin(2 pi x / L) + B cos(2 pi x / L) + C and return per-candidate (rss, A, B, C).

    The sum-of-sines model is linear for fixed wavelengths, so scanning a wavelength grid with
    closed-form solves is a deterministic, parallelizable replacement for the reference's
    basin-hopping (fit.py:463) — same model, far more reliable convergence.
    """
    w = 2 * np.pi / wavelengths[:, None]  # (L, 1)
    S = np.sin(w * x[None, :])  # (L, N)
    C = np.cos(w * x[None, :])
    one = np.ones_like(x)
    # Normal equations per candidate (3x3), batched
    G = np.stack([S, C, np.broadcast_to(one, S.shape)], axis=1)  # (L, 3, N)
    A = G @ G.transpose(0, 2, 1)  # (L, 3, 3)
    b = G @ y  # (L, 3)
    sol = np.linalg.solve(A + 1e-9 * np.eye(3)[None], b[..., None])[..., 0]  # (L, 3)
    pred = np.einsum("lkn,lk->ln", G, sol)
    rss = np.sum((pred - y[None, :]) ** 2, axis=1)
    return rss, sol


def robust_nfreq_sumsin_fit(
    xdata: np.ndarray,
    ydata: np.ndarray,
    sigma: np.ndarray | None = None,
    max_nb_frequency: int = 3,
    bounds_amp_wave_phase: Sequence[tuple[float, float]] | None = None,
    cost_func: Callable[[np.ndarray], float] = soft_loss,
    subsample: float | int = 1,
    hop_length: float | None = None,
    random_state: int | None = None,
    **kwargs: Any,
) -> tuple[np.ndarray, int]:
    """Fit a sum of up to N sinusoids: greedy periodogram extraction + joint LM polish.

    Returns (3N coefficients [amplitude, wavelength, phase]*N, N). Same model and outputs as
    the reference (fit.py:463: wavelength bounds from data extent/resolution, near-zero
    amplitudes dropped, sorted by decreasing amplitude); the optimizer is re-designed (see
    `_periodogram_best_wavelength`).

    `sigma` is accepted for signature parity but unused: the reference's own basin-hopping
    cost ignores it too (fit.py:519-525), and this port keeps that behavior.
    """
    x = np.asarray(unmask(xdata), dtype=np.float64).ravel()
    y = np.asarray(unmask(ydata), dtype=np.float64).ravel()
    valid = np.isfinite(x) & np.isfinite(y)
    x, y = x[valid], y[valid]
    rng = np.random.default_rng(random_state)
    if subsample != 1 and len(x) > 0:
        n = len(x)
        count = int(subsample * n) if isinstance(subsample, float) and subsample <= 1 else int(subsample)
        idx = rng.choice(n, min(count, n), replace=False)
        x, y = x[idx], y[idx]
    if len(x) < 10:
        raise ValueError("Too few valid points for sum-of-sinusoids fit.")

    span = np.max(x) - np.min(x)
    if hop_length is None:
        hop_length = span / max(len(x), 1)
    res_x = max(hop_length, span / max(len(x) - 1, 1))
    y_amp = (np.nanmax(y) - np.nanmin(y)) / 2 if len(y) else 1.0
    lam_min, lam_max = 3 * res_x, span
    if bounds_amp_wave_phase is not None and len(bounds_amp_wave_phase) >= 2:
        lam_min, lam_max = bounds_amp_wave_phase[1]

    # Candidate wavelengths: dense log grid
    wavelengths = np.geomspace(max(lam_min, 1e-9), max(lam_max, lam_min * 1.01), 256)

    # Greedy extraction of frequencies on residuals
    resid = y - np.median(y)
    extracted: list[tuple[float, float, float]] = []  # (amp, wavelength, phase)
    costs = np.full(max_nb_frequency, np.inf)
    params_per_n: list[np.ndarray] = []
    offset = np.median(y)
    for k in range(max_nb_frequency):
        rss, sol = _periodogram_best_wavelength(x, resid, wavelengths)
        best = int(np.argmin(rss))
        A, B, C = sol[best]
        lam = wavelengths[best]
        amp = float(np.hypot(A, B))
        # a sin(2 pi x / L + phi): A sin + B cos => phi = atan2(B, A)
        phi = float(np.arctan2(B, A) % (2 * np.pi))
        extracted.append((amp, float(lam), phi))
        resid = resid - (A * np.sin(2 * np.pi * x / lam) + B * np.cos(2 * np.pi * x / lam) + C)
        offset += C

        # Joint LM polish of all k+1 frequencies (+ implicit offset handled by data median)
        p_flat = np.asarray(extracted, dtype=np.float64).ravel()
        p_polished = _polish_sumsin(x, y - offset, p_flat)
        params_per_n.append(p_polished)
        pred = np.asarray(sumsin_1d(x, *p_polished)) + offset
        costs[k] = cost_func(pred - y)

    best_n = _choice_best_order(costs)
    p = params_per_n[best_n].reshape(-1, 3)
    # Drop near-zero amplitudes, sort by decreasing amplitude (reference behavior)
    keep = p[:, 0] > 0.01 * y_amp
    if keep.any():
        p = p[keep]
    p = p[np.argsort(-p[:, 0])]
    p[:, 2] = p[:, 2] % (2 * np.pi)
    return np.round(p.ravel(), 5), p.shape[0]


def _polish_sumsin(x: np.ndarray, y: np.ndarray, p0: np.ndarray, n_iter: int = 30) -> np.ndarray:
    """Joint LM refinement of sum-of-sines parameters on device."""
    xj = jnp.asarray(x, dtype=jnp.float32)
    yj = jnp.asarray(y, dtype=jnp.float32)
    p, _ = _lm_data(sumsin_1d, xj, yj, jnp.float32(1.0),
                    jnp.asarray(p0, dtype=jnp.float32), n_params=len(p0), max_iter=n_iter)
    out = np.asarray(p, dtype=np.float64)
    # Canonicalize WITHOUT changing the model (a plain abs() would sign-flip components):
    #   a sin(2 pi x / L + phi), L < 0  ==  -a sin(2 pi x / |L| - phi)
    #   a sin(... + phi), a < 0         ==  |a| sin(... + phi + pi)
    neg_l = out[1::3] < 0
    out[1::3] = np.abs(out[1::3])
    out[0::3] = np.where(neg_l, -out[0::3], out[0::3])
    out[2::3] = np.where(neg_l, -out[2::3], out[2::3])
    neg_a = out[0::3] < 0
    out[0::3] = np.abs(out[0::3])
    out[2::3] = np.where(neg_a, out[2::3] + np.pi, out[2::3])
    return out
