"""Surface-fit terrain attributes: fixed-stencil partial derivatives + closed-form algebra.

Design: all requested derivative stencils are evaluated in ONE fused pass of shifted slice
multiply-adds over a NaN-padded DEM (XLA fuses this into one elementwise loop). Validity is tracked separately as a footprint
erosion of the finite mask, reproducing the reference's NaN-dilation semantics
(/root/reference/xdem/terrain/surfit.py:1185-1192) while letting zero weights be skipped.

Numerics match the reference exactly (same published stencil tables and formulas):
  * Zevenbergen & Thorne (1987) 3x3 stencils — reference surfit.py:61-140
  * Horn (1981) 3x3 stencils — reference surfit.py:142-159
  * Florinsky (2009) 5x5 stencils — reference surfit.py:161-267
  * resolution dividers — reference surfit.py:278-304
  * attribute algebra (slope/aspect/GDAL-matching hillshade/curvatures, geometric and
    directional variants with flat-surface guards) — reference surfit.py:590-943
"""

from __future__ import annotations

from functools import partial
from typing import Literal, Sequence

import jax
import jax.numpy as jnp
import numpy as np

SurfaceFit = Literal["Horn", "ZevenbergThorne", "Florinsky"]
CurvMethod = Literal["geometric", "directional"]

# ----------------------------------------------------------------------------------
# Published stencil tables (math constants from the original papers; see module docstring)
# ----------------------------------------------------------------------------------

# fmt: off
# Zevenbergen & Thorne (1987), eqs. 3-11 (letters D..H as in the paper)
_ZT = {
    "zt_d": [[0, 1, 0], [0, -2, 0], [0, 1, 0]],
    "zt_e": [[0, 0, 0], [1, -2, 1], [0, 0, 0]],
    "zt_f": [[-1, 0, 1], [0, 0, 0], [1, 0, -1]],
    "zt_g": [[0, 1, 0], [0, 0, 0], [0, -1, 0]],
    "zt_h": [[0, 0, 0], [-1, 0, 1], [0, 0, 0]],
}
# Horn (1981), p.18 finite-difference gradients
_HORN = {
    "h1": [[1, 2, 1], [0, 0, 0], [-1, -2, -1]],
    "h2": [[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]],
}
# Florinsky (2009) third-order polynomial fit on a 5x5 window, eqs. 12-20
_FL = {
    "fl_r": [[2, -1, -2, -1, 2]] * 5,
    "fl_t": [[2, 2, 2, 2, 2], [-1, -1, -1, -1, -1], [-2, -2, -2, -2, -2],
             [-1, -1, -1, -1, -1], [2, 2, 2, 2, 2]],
    "fl_s": [[-4, -2, 0, 2, 4], [-2, -1, 0, 1, 2], [0, 0, 0, 0, 0],
             [2, 1, 0, -1, -2], [4, 2, 0, -2, -4]],
    "fl_p": [[31, -44, 0, 44, -31], [-5, -62, 0, 62, 5], [-17, -68, 0, 68, 17],
             [-5, -62, 0, 62, 5], [31, -44, 0, 44, -31]],
    "fl_q": [[-31, 5, 17, 5, -31], [44, 62, 68, 62, 44], [0, 0, 0, 0, 0],
             [-44, -62, -68, -62, -44], [31, -5, -17, -5, 31]],
}
# fmt: on

ALL_STENCILS = {k: np.asarray(v, dtype=np.float64) for d in (_ZT, _HORN, _FL) for k, v in d.items()}


# Resolution dividers per stencil (reference surfit.py:278-304): each raw stencil response
# is divided by DIV_CONST[name] * res**DIV_POW[role].
DIV_CONST = {
    "zt_d": 1.0, "zt_e": 1.0, "zt_f": 4.0, "zt_g": 2.0, "zt_h": 2.0,
    "h1": 8.0, "h2": 8.0,
    "fl_r": 35.0, "fl_t": 35.0, "fl_s": 100.0, "fl_p": 420.0, "fl_q": 420.0,
}
DIV_POW = {"z_x": 1, "z_y": 1, "z_xx": 2, "z_yy": 2, "z_xy": 2}


# Derivative roles per fit method: names of (z_x, z_y, z_xx, z_yy, z_xy) stencils.
_FIT_DERIVS = {
    "horn": {"z_x": "h2", "z_y": "h1"},
    "zevenbergthorne": {"z_x": "zt_h", "z_y": "zt_g", "z_xx": "zt_e", "z_yy": "zt_d", "z_xy": "zt_f"},
    "florinsky": {"z_x": "fl_p", "z_y": "fl_q", "z_xx": "fl_r", "z_yy": "fl_t", "z_xy": "fl_s"},
}

_CURVATURE_ATTRS = (
    "curvature",
    "profile_curvature",
    "tangential_curvature",
    "planform_curvature",
    "flowline_curvature",
    "max_curvature",
    "min_curvature",
)

SURFACE_FIT_ATTRS = ("slope", "aspect", "hillshade") + _CURVATURE_ATTRS


def _needed_derivs(attrs: Sequence[str], fit: str) -> tuple[str, ...]:
    """Which derivative roles are needed for the requested attributes."""
    roles: list[str] = []
    if any(a in attrs for a in ("slope", "aspect", "hillshade")) or any(a in attrs for a in _CURVATURE_ATTRS):
        roles += ["z_x", "z_y"]
    if any(a in attrs for a in _CURVATURE_ATTRS):
        roles += ["z_xx", "z_yy", "z_xy"]
    avail = _FIT_DERIVS[fit]
    return tuple(r for r in roles if r in avail)


def _erode_valid(valid: jnp.ndarray, k: int) -> jnp.ndarray:
    """Erode a validity mask by a k x k footprint (pixels with any invalid neighbor -> invalid).

    Separable min-reduce over the window; matches the reference's NaN binary_dilation with a
    full kxk structure (surfit.py:1185-1192) and its NaN edge padding in the numba engine.
    """
    pad = k // 2
    v = jnp.pad(valid.astype(jnp.float32), pad, constant_values=0.0)
    v = jax.lax.reduce_window(v, jnp.inf, jax.lax.min, (k, 1), (1, 1), "valid")
    v = jax.lax.reduce_window(v, jnp.inf, jax.lax.min, (1, k), (1, 1), "valid")
    return v > 0.5


def _apply_stencils(dem: jnp.ndarray, kernels: tuple[np.ndarray, ...]) -> list[jnp.ndarray]:
    """Evaluate several stencil convolutions in one fused shifted-slice pass.

    conv semantics match scipy.ndimage.convolve / the reference numba loop: the kernel is
    flipped, i.e. out[r, c] = sum_{u,v} dem[r+u-h, c+v-h] * K[h-u, h-v] (NaN-padded edges, but
    NaN handling is the caller's job via `_erode_valid` — here invalid samples must already be
    zero-filled).
    """
    k = kernels[0].shape[0]
    pad = k // 2
    # Materialized (not fused) pad: XLA otherwise inlines the pad into every shifted read
    # as per-element selects — see the fusion notes on window.fractal_roughness.
    demp = jax.lax.optimization_barrier(jnp.pad(dem, pad, constant_values=0.0))
    h, w = dem.shape
    outs = [jnp.zeros_like(dem) for _ in kernels]
    # One pass over window offsets; each slice is shared across all kernels.
    for u in range(k):
        for v in range(k):
            weights = [float(K[k - 1 - u, k - 1 - v]) for K in kernels]
            if not any(weights):
                continue
            sl = jax.lax.dynamic_slice(demp, (u, v), (h, w))
            for i, wgt in enumerate(weights):
                if wgt:
                    outs[i] = outs[i] + wgt * sl
    return outs


@partial(
    jax.jit,
    static_argnames=(
        "attrs",
        "surface_fit",
        "curv_method",
        "hillshade_altitude",
        "hillshade_azimuth",
        "hillshade_z_factor",
    ),
)
def surface_attributes(
    dem: jnp.ndarray,
    resolution: jnp.ndarray | float,
    attrs: tuple[str, ...],
    surface_fit: SurfaceFit = "Florinsky",
    curv_method: CurvMethod = "geometric",
    hillshade_altitude: float = 45.0,
    hillshade_azimuth: float = 315.0,
    hillshade_z_factor: float = 1.0,
    center: jnp.ndarray | float | None = None,
) -> jnp.ndarray:
    """Compute surface-fit attributes; returns a (len(attrs), H, W) stack.

    Slope/aspect are returned in RADIANS (the dispatcher converts); hillshade unclipped
    (dispatcher clips to [0, 255]) — mirroring the reference's split between surfit.py and
    terrain.py:585-596.
    """
    fit = surface_fit.lower()
    geometric = curv_method.lower() == "geometric"
    if fit == "horn" and any(a in _CURVATURE_ATTRS for a in attrs):
        raise ValueError("'Horn' surface fit cannot compute curvatures; use ZevenbergThorne or Florinsky.")

    dem = jnp.asarray(dem)
    valid_in = jnp.isfinite(dem)
    # Mean-centering: all derivative stencils annihilate constants, and removing the large
    # constant part keeps f32 stencil sums accurate (the device computes in f32).
    # `center` may be passed in (halo-sharded path: the GLOBAL mean, so every block removes
    # the same constant and sharded == unsharded bitwise).
    if center is None:
        center = jnp.where(jnp.any(valid_in), jnp.nanmean(jnp.where(valid_in, dem, jnp.nan)), 0.0)
    dem0 = jnp.where(valid_in, dem - center, 0.0)

    roles = _needed_derivs(attrs, fit)
    names = [_FIT_DERIVS[fit][r] for r in roles]
    res = jnp.asarray(resolution, dtype=dem.dtype)
    kernels = tuple(ALL_STENCILS[n] for n in names)
    ksize = kernels[0].shape[0] if kernels else 3

    raw = _apply_stencils(dem0, kernels)
    # Resolution dividers are applied on device so `resolution` can stay traced.
    D: dict[str, jnp.ndarray] = {}
    for role, name, arr in zip(roles, names, raw):
        D[role] = arr / (DIV_CONST[name] * res ** DIV_POW[role])

    valid = _erode_valid(valid_in, ksize)
    nan = jnp.array(jnp.nan, dtype=dem.dtype)
    vals = _attrs_from_derivs(
        D, attrs, geometric,
        hillshade_altitude=hillshade_altitude,
        hillshade_azimuth=hillshade_azimuth,
        hillshade_z_factor=hillshade_z_factor,
    )
    out = [jnp.where(valid, v, nan) for v in vals]
    return jnp.stack(out, axis=0)


def _attrs_from_derivs(
    D: dict,
    attrs: tuple[str, ...],
    geometric: bool,
    hillshade_altitude: float = 45.0,
    hillshade_azimuth: float = 315.0,
    hillshade_z_factor: float = 1.0,
) -> list:
    """Closed-form attribute algebra from derivative fields. Formulas from the reference
    surfit.py:590-943; no validity masking here."""
    z_x = D.get("z_x")
    z_y = D.get("z_y")
    z_xx = D.get("z_xx")
    z_yy = D.get("z_yy")
    z_xy = D.get("z_xy")

    if z_x is not None:
        grad2 = z_x**2 + z_y**2
        flat = grad2 == 0.0

    slope = aspect = None
    if "slope" in attrs or "hillshade" in attrs:
        slope = jnp.arctan(jnp.sqrt(grad2))
    if "aspect" in attrs or "hillshade" in attrs:
        aspect = (-jnp.arctan2(-z_x, z_y)) % (2 * jnp.pi)

    mean_c = unsphericity = None
    if geometric and ("max_curvature" in attrs or "min_curvature" in attrs):
        # Mean curvature (Gauss 1928) and unsphericity (Shary 1995); reference surfit.py:813-869.
        denom_m = 2 * ((1 + grad2) ** 3) ** 0.5
        mean_c = jnp.where(flat, 0.0, -((1 + z_y**2) * z_xx - 2 * z_xy * z_x * z_y + (1 + z_x**2) * z_yy) / denom_m)
        unsphericity = jnp.where(
            flat,
            0.0,
            jnp.sqrt(
                jnp.maximum(
                    (((1 + z_y**2) * z_xx - 2 * z_y * z_x * z_xy + (1 + z_x**2) * z_yy) / denom_m) ** 2
                    - (z_xx * z_yy - z_xy**2) / (1 + grad2) ** 2,
                    0.0,
                )
            ),
        )

    out = []
    for a in attrs:
        if a == "slope":
            val = slope
        elif a == "aspect":
            val = aspect
        elif a == "hillshade":
            slopemap = jnp.arctan(jnp.tan(slope) * hillshade_z_factor) if hillshade_z_factor != 1.0 else slope
            azimuth_rad = jnp.deg2rad(360.0 - hillshade_azimuth)
            altitude_rad = jnp.deg2rad(hillshade_altitude)
            # GDAL-matching scaling — reference surfit.py:606-622.
            val = 1.5 + 254.0 * (
                jnp.sin(altitude_rad) * jnp.cos(slopemap)
                + jnp.cos(altitude_rad) * jnp.sin(slopemap) * jnp.sin(azimuth_rad - aspect)
            )
        elif a == "curvature":
            # Legacy Moore et al. (1991) curvature — reference surfit.py:628-636.
            val = -2.0 * (z_xx + z_yy) * 100.0
        elif a == "profile_curvature":
            num = -(z_xx * z_x**2 + 2 * z_xy * z_x * z_y + z_yy * z_y**2)
            den = grad2 * jnp.sqrt((1 + grad2) ** 3) if geometric else grad2
            val = jnp.where(flat, 0.0, num / den) * 100.0
        elif a == "tangential_curvature":
            num = -(z_xx * z_y**2 - 2 * z_xy * z_x * z_y + z_yy * z_x**2)
            den = grad2 * jnp.sqrt(1 + grad2) if geometric else grad2
            val = jnp.where(flat, 0.0, num / den) * 100.0
        elif a == "planform_curvature":
            num = -(z_xx * z_y**2 - 2 * z_xy * z_x * z_y + z_yy * z_x**2)
            val = jnp.where(grad2 < 10e-15, 0.0, num / jnp.sqrt(grad2**3)) * 100.0
        elif a == "flowline_curvature":
            num = z_x * z_y * (z_xx - z_yy) - z_xy * (z_x**2 - z_y**2)
            den = jnp.sqrt(grad2**3) * jnp.sqrt(1 + grad2) if geometric else jnp.sqrt(grad2**3)
            val = jnp.where(grad2 < 10e-15 if geometric else flat, 0.0, num / den) * 100.0
        elif a == "max_curvature":
            if geometric:
                val = jnp.where(flat, 0.0, mean_c + unsphericity) * 100.0
            else:
                val = jnp.where(flat, 0.0, -((z_xx + z_yy) / 2 - jnp.sqrt(((z_xx - z_yy) / 2) ** 2 + z_xy**2))) * 100.0
        elif a == "min_curvature":
            if geometric:
                val = jnp.where(flat, 0.0, mean_c - unsphericity) * 100.0
            else:
                val = jnp.where(flat, 0.0, -((z_xx + z_yy) / 2 + jnp.sqrt(((z_xx - z_yy) / 2) ** 2 + z_xy**2))) * 100.0
        else:
            raise ValueError(f"Unknown surface-fit attribute: {a}")
        out.append(val)
    return out
