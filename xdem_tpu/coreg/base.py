"""Coregistration framework: matrix toolbox, apply_matrix tiers, Coreg base class, pipelines.

Reference parity (/root/reference/xdem/coreg/base.py): input pre/post-processing (:124-573),
subsampling machinery (:576-905), generic bin/fit engine (:906), affine matrix toolbox
(:1056-1286), matrix application tiers (:1290-1766), Coreg metadata/fit/apply (:1786-2875),
CoregPipeline (:2880-3199).

Device re-design: dense numerics (matrix application, interpolation, the iterative
small-rotation regrid) run as jitted gather kernels; the fixed-point regrid is a lax.while_loop;
class shells, georeferencing and the rst/pts fallback ladder stay host-side.
"""

from __future__ import annotations

import copy as _copy
import logging
import warnings
from typing import Any, Callable, Iterable, Literal, TypedDict

import jax
import jax.numpy as jnp
import numpy as np

from xdem_tpu.georef import CRS, Affine
from xdem_tpu.ops.interp import interp_points as _interp_points_dev
from xdem_tpu.ops.interp import interp_rowcol
from xdem_tpu.ops.transfer import unmask
from xdem_tpu.profiler import profile as _profile
from xdem_tpu.pointcloud import PointCloud
from xdem_tpu.raster import Raster


class NotImplementedCoregFit(NotImplementedError):
    """Raised when a Coreg does not implement a given fit input combination (base.py:1774)."""


class NotImplementedCoregApply(NotImplementedError):
    """Raised when a Coreg does not implement a given apply input (base.py:1779)."""


# ------------------------------------------------------------------ matrix toolbox


def _check_matrix(matrix: np.ndarray) -> np.ndarray:
    """Validate a 4x4 rigid transform matrix (reference base.py:1056)."""
    matrix = np.asarray(matrix, dtype=np.float64)
    if matrix.shape != (4, 4):
        raise ValueError(f"Invalid transform matrix shape {matrix.shape}, must be (4, 4).")
    if not np.allclose(matrix[3, :], [0, 0, 0, 1]):
        raise ValueError("Last row of transform matrix must be [0, 0, 0, 1].")
    R = matrix[:3, :3]
    if not np.allclose(R @ R.T, np.eye(3), atol=1e-6):
        raise ValueError("The rotation part of the matrix is not orthogonal (not a rigid transform).")
    return matrix


def _make_matrix_valid(matrix: np.ndarray) -> np.ndarray:
    """Orthogonalize the rotation part via SVD (reference base.py:1090)."""
    matrix = np.asarray(matrix, dtype=np.float64).copy()
    U, _, Vt = np.linalg.svd(matrix[:3, :3])
    matrix[:3, :3] = U @ Vt
    matrix[3, :] = [0, 0, 0, 1]
    return matrix


def matrix_from_translations_rotations(
    t_x: float = 0.0,
    t_y: float = 0.0,
    t_z: float = 0.0,
    alpha: float = 0.0,
    beta: float = 0.0,
    gamma: float = 0.0,
    use_degrees: bool = True,
    *,
    t1: float | None = None,
    t2: float | None = None,
    t3: float | None = None,
    alpha1: float | None = None,
    alpha2: float | None = None,
    alpha3: float | None = None,
) -> np.ndarray:
    """Build a 4x4 rigid matrix from translations and extrinsic-Euler xyz rotations
    (reference base.py:1188).

    The reference's keyword names (``t1/t2/t3`` for the translations, ``alpha1/alpha2/alpha3``
    for the rotations) are accepted as aliases of this project's ``t_x/t_y/t_z`` and
    ``alpha/beta/gamma``.

    Translations land in the last column, and inversion negates a pure translation:

    >>> m = matrix_from_translations_rotations(1.0, 2.0, 3.0, 0.0, 0.0, 0.0)
    >>> m[:3, 3]
    array([1., 2., 3.])
    >>> [round(float(v), 6) for v in translations_rotations_from_matrix(invert_matrix(m))[:3]]
    [-1.0, -2.0, -3.0]
    """
    t_x = t_x if t1 is None else t1
    t_y = t_y if t2 is None else t2
    t_z = t_z if t3 is None else t3
    alpha = alpha if alpha1 is None else alpha1
    beta = beta if alpha2 is None else alpha2
    gamma = gamma if alpha3 is None else alpha3
    if use_degrees:
        alpha, beta, gamma = np.deg2rad([alpha, beta, gamma])
    Rx = np.array([[1, 0, 0], [0, np.cos(alpha), -np.sin(alpha)], [0, np.sin(alpha), np.cos(alpha)]])
    Ry = np.array([[np.cos(beta), 0, np.sin(beta)], [0, 1, 0], [-np.sin(beta), 0, np.cos(beta)]])
    Rz = np.array([[np.cos(gamma), -np.sin(gamma), 0], [np.sin(gamma), np.cos(gamma), 0], [0, 0, 1]])
    M = np.eye(4)
    M[:3, :3] = Rz @ Ry @ Rx  # extrinsic x-y-z
    M[:3, 3] = [t_x, t_y, t_z]
    return M


def translations_rotations_from_matrix(matrix: np.ndarray, return_degrees: bool = True):
    """Extract (t_x, t_y, t_z, alpha, beta, gamma) from a rigid matrix (reference base.py:1231)."""
    matrix = _check_matrix(matrix)
    t_x, t_y, t_z = matrix[:3, 3]
    R = matrix[:3, :3]
    # Extrinsic xyz Euler decomposition of R = Rz @ Ry @ Rx
    beta = np.arcsin(np.clip(-R[2, 0], -1, 1))
    if np.isclose(np.cos(beta), 0):
        alpha = np.arctan2(R[0, 1], R[1, 1])
        gamma = 0.0
    else:
        alpha = np.arctan2(R[2, 1], R[2, 2])
        gamma = np.arctan2(R[1, 0], R[0, 0])
    if return_degrees:
        alpha, beta, gamma = np.rad2deg([alpha, beta, gamma])
    return float(t_x), float(t_y), float(t_z), float(alpha), float(beta), float(gamma)


def invert_matrix(matrix: np.ndarray, atol: float = 10e-8) -> np.ndarray:
    """Invert a rigid 4x4 matrix (reference base.py:1259); ``atol`` bounds how far the
    bottom row may sit from [0, 0, 0, 1] before the matrix is rejected as non-affine."""
    matrix = np.asarray(matrix, dtype=np.float64)
    if matrix.shape == (4, 4) and not np.allclose(matrix[3], [0, 0, 0, 1], atol=atol):
        raise ValueError("Matrix is not affine: bottom row must be [0, 0, 0, 1].")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        checked = _check_matrix(_make_matrix_valid(matrix))
    return np.linalg.inv(checked)


def _matrix_is_translation_only(matrix: np.ndarray) -> bool:
    return np.allclose(matrix[:3, :3], np.eye(3), atol=1e-12)


# ------------------------------------------------------------------ matrix application


def _apply_matrix_pts_arr(
    x: np.ndarray, y: np.ndarray, z: np.ndarray, matrix: np.ndarray, centroid: tuple[float, float, float] | None = None,
    invert: bool = False,
):
    """Exact rigid transform of points (reference base.py:1290-1347)."""
    if invert:
        matrix = invert_matrix(matrix)
    cx, cy, cz = centroid if centroid is not None else (0.0, 0.0, 0.0)
    pts = np.stack([np.asarray(x) - cx, np.asarray(y) - cy, np.asarray(z) - cz, np.ones_like(np.asarray(z))], axis=0)
    out = np.asarray(matrix) @ pts
    return out[0] + cx, out[1] + cy, out[2] + cz


def _apply_matrix_pts(
    epc: PointCloud, matrix: np.ndarray, centroid: tuple[float, float, float] | None = None, invert: bool = False,
    z_name: str = "z",
) -> PointCloud:
    """Apply a rigid matrix to a point cloud (reference base.py:1350)."""
    x, y, z = _apply_matrix_pts_arr(epc.x, epc.y, epc.z, matrix, centroid=centroid, invert=invert)
    out = epc.copy()
    out.x, out.y, out.z = np.asarray(x), np.asarray(y), np.asarray(z)
    return out


def _iterate_affine_regrid_small_rotations(
    dem: jnp.ndarray,
    transform: Affine,
    matrix: np.ndarray,
    centroid: tuple[float, float, float] | None,
    resampling: str = "linear",
    max_iterations: int = 20,
    tolerance: float = 1e-4,
) -> jnp.ndarray:
    """Iterative inverse-regrid fixed point for small rotations (<20 deg), as a lax.while_loop.

    For each output grid node (x, y) we seek the source z such that the forward-transformed
    point lands on (x, y): iterate z-guess -> inverse-transform -> interpolate z -> check
    horizontal residual < tolerance px (reference base.py:1389-1519; the reference drops
    converged points from the iteration, here expressed with masks under fixed shapes).
    """
    h, w = dem.shape
    inv = invert_matrix(matrix)
    cx, cy, cz = centroid if centroid is not None else (0.0, 0.0, 0.0)

    rows = jnp.arange(h, dtype=jnp.float32)
    cols = jnp.arange(w, dtype=jnp.float32)
    cgrid, rgrid = jnp.meshgrid(cols, rows)
    a, b, c, d, e, f = (float(v) for v in tuple(transform))
    # Group the large constants IN F64 before they meet the f32 grids: `+ c - cx` evaluated
    # left-to-right in f32 cancels two ~1e6-magnitude numbers and loses up to ~1 m
    X = a * (cgrid + 0.5) + b * (rgrid + 0.5) + (c - cx)
    Y = d * (cgrid + 0.5) + e * (rgrid + 0.5) + (f - cy)

    inv_j = jnp.asarray(inv, dtype=jnp.float32)
    res_x = transform.xres
    res_y = transform.yres

    # Initial z guess: interpolate the (unshifted) DEM at the output coordinates.
    # Works in CENTROID-CENTERED space: the centroid's pixel offsets are folded into f64
    # host constants so the f32 device math only ever sees small values.
    det = a * e - b * d
    col_off = (e * cx - b * cy - (e * c - b * f)) / det - 0.5
    row_off = (-d * cx + a * cy - (-d * c + a * f)) / det - 0.5

    def src_rowcol(xs_c, ys_c):
        colp = (e * xs_c - b * ys_c) / det + col_off
        rowp = (-d * xs_c + a * ys_c) / det + row_off
        return rowp, colp

    def interp_src(xs_c, ys_c):
        rr, cc = src_rowcol(xs_c, ys_c)
        return interp_rowcol(dem, rr, cc, method=resampling)

    z0 = dem - cz

    def body(state):
        zg, it, _maxres = state
        # Inverse-transform output coords with current z guess (centered space throughout)
        xs = inv_j[0, 0] * X + inv_j[0, 1] * Y + inv_j[0, 2] * zg + inv_j[0, 3]
        ys = inv_j[1, 0] * X + inv_j[1, 1] * Y + inv_j[1, 2] * zg + inv_j[1, 3]
        zsrc = interp_src(xs, ys) - cz
        # Forward-transform the found source point; residual to the target (X, Y)
        xf = jnp.asarray(matrix[0, 0], jnp.float32) * xs + jnp.asarray(matrix[0, 1], jnp.float32) * ys \
            + jnp.asarray(matrix[0, 2], jnp.float32) * zsrc + jnp.asarray(matrix[0, 3], jnp.float32)
        yf = jnp.asarray(matrix[1, 0], jnp.float32) * xs + jnp.asarray(matrix[1, 1], jnp.float32) * ys \
            + jnp.asarray(matrix[1, 2], jnp.float32) * zsrc + jnp.asarray(matrix[1, 3], jnp.float32)
        zf = jnp.asarray(matrix[2, 0], jnp.float32) * xs + jnp.asarray(matrix[2, 1], jnp.float32) * ys \
            + jnp.asarray(matrix[2, 2], jnp.float32) * zsrc + jnp.asarray(matrix[2, 3], jnp.float32)
        res = jnp.hypot((xf - X) / res_x, (yf - Y) / res_y)
        maxres = jnp.nanmax(jnp.where(jnp.isfinite(zf), res, 0.0))
        return zf, it + 1, maxres

    def cond(state):
        _, it, maxres = state
        return (it < max_iterations) & (maxres > tolerance)

    state = (z0, jnp.asarray(0), jnp.asarray(jnp.inf, jnp.float32))
    zf, _, _ = jax.lax.while_loop(cond, body, state)
    return zf + cz


def _apply_matrix_rst(
    dem: jnp.ndarray,
    transform: Affine,
    matrix: np.ndarray,
    centroid: tuple[float, float, float] | None = None,
    resampling: str = "linear",
    force_regrid_method: str | None = None,
) -> tuple[jnp.ndarray, Affine]:
    """Apply a rigid matrix to a DEM with the reference's 4-tier strategy (base.py:1522-1590):
    (1) pure z shift, (2) pure translation via transform update, (3) small rotations via
    fixed-point regrid, (4) big rotations via host Delaunay regridding."""
    matrix = np.asarray(matrix, dtype=np.float64)

    # Tier 1: vertical shift only
    if np.allclose(matrix, np.diag(np.diag(matrix))) and np.allclose(np.diag(matrix), 1) and np.allclose(
        matrix[:2, 3], 0
    ):
        return dem + matrix[2, 3], transform

    # Tier 2: translation only — update the geotransform, shift z
    if _matrix_is_translation_only(matrix) and force_regrid_method is None:
        new_transform = transform.translation(matrix[0, 3], matrix[1, 3])
        return dem + matrix[2, 3], new_transform

    # Rotation magnitude
    _, _, _, a_deg, b_deg, g_deg = translations_rotations_from_matrix(_make_matrix_valid(matrix))
    small = max(abs(a_deg), abs(b_deg)) < 20.0

    if (small and force_regrid_method is None) or force_regrid_method == "iterative":
        if centroid is None:
            # Re-center the transform about the raster center (exact algebra, f64 host):
            # R p + t == R (p - c0) + (t + R c0 - c0) + c0. Without this the device regrid
            # would carry full UTM magnitudes through f32 and lose up to ~1 m to the ULP.
            h0, w0 = dem.shape
            c0x, c0y = transform.xy((h0 - 1) / 2.0, (w0 - 1) / 2.0)
            c0 = np.array([c0x, c0y, 0.0])
            matrix = matrix.copy()
            matrix[:3, 3] = matrix[:3, 3] + matrix[:3, :3] @ c0 - c0
            centroid = (float(c0x), float(c0y), 0.0)
        out = _iterate_affine_regrid_small_rotations(
            jnp.asarray(dem), transform, matrix, centroid, resampling=resampling
        )
        return out, transform

    # Tier 4: large rotations — host-side point transform + Delaunay regrid (rare path)
    from scipy.interpolate import griddata

    arr = np.asarray(dem, dtype=np.float64)
    h, w = arr.shape
    rr, cc = np.nonzero(np.isfinite(arr))
    x, y = transform.xy(rr, cc)
    z = arr[rr, cc]
    xt, yt, zt = _apply_matrix_pts_arr(x, y, z, matrix, centroid=centroid)
    cgrid, rgrid = np.meshgrid(np.arange(w), np.arange(h))
    gx, gy = transform.xy(rgrid, cgrid)
    out = griddata((xt, yt), zt, (gx, gy), method="linear")
    return jnp.asarray(out, dtype=jnp.float32), transform


def apply_matrix(
    elev: Raster | PointCloud | np.ndarray,
    matrix: np.ndarray,
    invert: bool = False,
    centroid: tuple[float, float, float] | None = None,
    resample: bool = True,
    resampling: str = "linear",
    transform: Affine | None = None,
    crs: Any = None,
    z_name: str = "z",
    force_regrid_method: str | None = None,
    **kwargs: Any,
):
    """Apply a 4x4 rigid transform matrix to an elevation dataset (reference base.py:1686).

    `resample=True` (the reference's default, base.py:1678) resamples the result back onto
    the INPUT georeferencing; `resample=False` returns the data with the translated
    transform — lossless for pure translations. `crs` is accepted
    for reference-signature parity: the grid `transform` fully determines the regrid (the
    matrix acts in projected coordinates), so the CRS never enters the computation.
    `z_name` names the elevation column when `elev` is a dataframe (the reference's
    geodataframe path, base.py:1701); the transformed dataframe is returned with the same
    column layout.
    """
    resampling = {"bilinear": "linear", "cubic_spline": "cubic"}.get(resampling, resampling)
    if invert:
        matrix = invert_matrix(matrix)
    if isinstance(elev, PointCloud):
        return _apply_matrix_pts(elev, matrix, centroid=centroid)
    if hasattr(elev, "columns"):  # dataframe point input: x/y + z_name columns
        cols = {str(c).lower(): c for c in elev.columns}
        xcol, ycol = cols.get("x"), cols.get("y")
        if xcol is None or ycol is None or z_name not in elev.columns:
            raise ValueError(
                f"Dataframe input needs x/y columns and elevation in z_name={z_name!r}."
            )
        ox, oy, oz = _apply_matrix_pts_arr(
            np.asarray(elev[xcol], np.float64), np.asarray(elev[ycol], np.float64),
            np.asarray(elev[z_name], np.float64), matrix, centroid=centroid,
        )
        out_df = elev.copy()
        out_df[xcol], out_df[ycol], out_df[z_name] = ox, oy, oz
        return out_df
    if isinstance(elev, Raster):
        data, new_transform = _apply_matrix_rst(
            elev.data, elev.transform, matrix, centroid=centroid, resampling=resampling,
            force_regrid_method=force_regrid_method,
        )
        if resample and not new_transform.almost_equals(elev.transform):
            data = _reproject_horizontal_shift_samecrs(
                data, src_transform=new_transform, dst_transform=elev.transform,
                resampling=resampling,
            )
            new_transform = elev.transform
        out = elev.copy(new_array=data)
        out.transform = new_transform
        return out
    # bare array + transform
    if transform is None:
        raise ValueError("'transform' must be given for array input.")
    data, new_transform = _apply_matrix_rst(
        jnp.asarray(elev), transform, matrix, centroid=centroid, resampling=resampling,
        force_regrid_method=force_regrid_method,
    )
    if resample and not new_transform.almost_equals(transform):
        data = _reproject_horizontal_shift_samecrs(
            data, src_transform=new_transform, dst_transform=transform, resampling=resampling,
        )
        new_transform = transform
    return np.asarray(data), new_transform


def _reproject_horizontal_shift_samecrs(
    raster_arr: jnp.ndarray, src_transform: Affine, dst_transform: Affine | None = None,
    resampling: str = "linear",
) -> jnp.ndarray:
    """Subpixel-exact same-CRS horizontal-shift reprojection (reference base.py:1615) as a
    gather-interpolation on device."""
    h, w = raster_arr.shape
    dst_transform = dst_transform or src_transform
    # Compose dst-pixel -> src-pixel ON HOST IN F64: building world coordinates as f32
    # device arrays loses up to ~1 m to the ULP at UTM northings (~8.7e6 m), i.e. up to a
    # pixel of jitter at sub-meter resolutions. The composed affine has small offsets, so
    # the f32 grid math below is exact to ~1e-4 px.
    comp = src_transform.invert() * dst_transform
    a, b, c, d, e, f = (float(v) for v in tuple(comp))
    cols = jnp.arange(w, dtype=jnp.float32) + 0.5
    rows = jnp.arange(h, dtype=jnp.float32) + 0.5
    cgrid, rgrid = jnp.meshgrid(cols, rows)
    src_col = a * cgrid + b * rgrid + (c - 0.5)
    src_row = d * cgrid + e * rgrid + (f - 0.5)
    return interp_rowcol(raster_arr, src_row, src_col, method=resampling)


# ------------------------------------------------------------------ preprocessing helpers


def _elev_to_arr(elev: Any) -> tuple[Any, Affine | None, Any, bool]:
    """Normalize an elevation input to (array-or-pointcloud, transform, crs, is_raster)."""
    if isinstance(elev, Raster):
        return elev.data, elev.transform, elev.crs, True
    if isinstance(elev, PointCloud):
        return elev, None, elev.crs, False
    arr = jnp.asarray(elev)
    return arr, None, None, True


def _mask_to_array(inlier_mask: Any, ref: Raster | None) -> np.ndarray | None:
    from xdem_tpu.vector import Vector

    if inlier_mask is None:
        return None
    if isinstance(inlier_mask, Vector):
        if ref is None:
            raise ValueError("A raster reference is needed to rasterize a vector inlier mask.")
        return inlier_mask.create_mask(ref)
    if isinstance(inlier_mask, Raster):
        # A mask raster on a different grid (e.g. cropped) is regridded onto the reference
        # grid first, everything outside its extent excluded (reference test_base.py:455).
        if ref is not None and (inlier_mask.shape != ref.shape or inlier_mask.transform != ref.transform):
            regridded = inlier_mask.reproject(ref, resampling="nearest")
            return np.nan_to_num(np.asarray(regridded.data), nan=0.0) > 0
        return np.asarray(inlier_mask.data) > 0
    if isinstance(inlier_mask, np.ma.MaskedArray):
        # geoutils Mask.data is a masked bool array; masked slots are NOT inliers
        return np.asarray(inlier_mask.filled(False), dtype=bool)
    return np.asarray(inlier_mask, dtype=bool)


def _as_affine(transform: Any) -> Affine | None:
    """Accept any 6-value affine form (Affine, rasterio-style tuple/list/iterable) for the
    `transform=` kwargs, like the reference accepts any rio.transform input."""
    if transform is None or isinstance(transform, Affine):
        return transform
    vals = [float(v) for v in tuple(transform)]
    if len(vals) < 6:
        raise ValueError(f"'transform' must have 6 affine coefficients, got {len(vals)}.")
    return Affine(*vals[:6])


def _preprocess_coreg_fit(
    reference_elev: Any,
    to_be_aligned_elev: Any,
    inlier_mask: Any = None,
    transform: Affine | None = None,
    crs: Any = None,
    area_or_point: str | None = None,
) -> tuple[Any, Any, np.ndarray | None, Affine | None, Any, str | None]:
    """Normalize fit inputs: raster-raster (reprojected to common grid), raster-point, or
    point-point (reference base.py:316)."""
    transform = _as_affine(transform)
    ref_is_rst = isinstance(reference_elev, Raster) or (
        not isinstance(reference_elev, PointCloud) and np.ndim(reference_elev) == 2
    )
    tba_is_rst = isinstance(to_be_aligned_elev, Raster) or (
        not isinstance(to_be_aligned_elev, PointCloud) and np.ndim(to_be_aligned_elev) == 2
    )

    ref_raster = reference_elev if isinstance(reference_elev, Raster) else None
    tba_raster = to_be_aligned_elev if isinstance(to_be_aligned_elev, Raster) else None

    # Reproject to common grid for raster-raster
    if isinstance(ref_raster, Raster) and isinstance(tba_raster, Raster):
        if ref_raster.shape != tba_raster.shape or not ref_raster.transform.almost_equals(tba_raster.transform):
            tba_raster = tba_raster.reproject(ref_raster)
        transform = ref_raster.transform
        crs = ref_raster.crs
        # Pixel-interpretation casting (reference base.py:163 via geoutils
        # _cast_pixel_interpretation): equal interpretations pass through; a mismatch warns
        # and drops to None (undefined) rather than silently preferring one side.
        from xdem_tpu.config import config

        if ref_raster.area_or_point == tba_raster.area_or_point:
            area_or_point = ref_raster.area_or_point
        elif not config["warn_area_or_point"]:
            area_or_point = None
        else:
            warnings.warn(
                f"The reference and to-be-aligned rasters have different pixel interpretations "
                f"({ref_raster.area_or_point!r} vs {tba_raster.area_or_point!r}), which "
                f"implies a half-pixel georeferencing offset between them; the interpretation "
                f"is cast to undefined. Harmonize them before coregistering.",
                UserWarning,
            )
            area_or_point = None
        ref_out: Any = ref_raster.data
        tba_out: Any = tba_raster.data
    elif isinstance(ref_raster, Raster) and isinstance(to_be_aligned_elev, PointCloud):
        transform = ref_raster.transform
        crs = ref_raster.crs
        area_or_point = ref_raster.area_or_point
        ref_out = ref_raster.data
        tba_out = to_be_aligned_elev.to_crs(crs) if to_be_aligned_elev.crs != CRS(crs) else to_be_aligned_elev
    elif isinstance(reference_elev, PointCloud) and isinstance(tba_raster, Raster):
        transform = tba_raster.transform
        crs = tba_raster.crs
        area_or_point = tba_raster.area_or_point
        tba_out = tba_raster.data
        ref_out = reference_elev.to_crs(crs) if reference_elev.crs != CRS(crs) else reference_elev
    elif isinstance(reference_elev, PointCloud) and isinstance(to_be_aligned_elev, PointCloud):
        ref_out = reference_elev
        tba_out = to_be_aligned_elev.to_crs(reference_elev.crs) if to_be_aligned_elev.crs != reference_elev.crs \
            else to_be_aligned_elev
        crs = reference_elev.crs
    else:
        # Mixed plain-array + Raster raster-raster: the raster side's georeferencing applies
        # to both grids (reference base.py:124 uses any raster input's transform/crs when
        # none is given; an array cannot be reprojected, so the shapes must already agree).
        one_raster = ref_raster if ref_raster is not None else tba_raster
        if one_raster is not None and ref_is_rst and tba_is_rst:
            arr_side = to_be_aligned_elev if ref_raster is not None else reference_elev
            if np.shape(arr_side) != one_raster.shape:
                raise ValueError(
                    f"A plain-array elevation ({np.shape(arr_side)}) must already be on the "
                    f"raster input's grid ({one_raster.shape}); reproject or pass two Rasters."
                )
            if transform is None:
                transform = one_raster.transform
            else:
                warnings.warn(
                    "A raster was passed alongside an explicit 'transform'; the raster's own "
                    "transform is used.", UserWarning,
                )
                transform = one_raster.transform
            crs = one_raster.crs if crs is None else crs
            if area_or_point is None:
                area_or_point = one_raster.area_or_point
        # Bare arrays: transform/crs must be provided
        if (ref_is_rst and tba_is_rst) and transform is None:
            raise ValueError("'transform' must be given if both inputs are plain arrays.")
        ref_out = jnp.asarray(reference_elev.data if ref_raster is not None else unmask(reference_elev)) \
            if ref_is_rst else reference_elev
        tba_out = jnp.asarray(to_be_aligned_elev.data if tba_raster is not None else unmask(to_be_aligned_elev)) \
            if tba_is_rst else to_be_aligned_elev

    mask = _mask_to_array(inlier_mask, ref_raster if ref_raster is not None else tba_raster)
    # Pixel-interpretation shift at the RESOLVED level so bare-array raster-point inputs
    # behave like Raster-wrapped ones: a "Point" grid carries samples at pixel corners; the
    # gather interpolation assumes centers, so the mixed raster-point paths get a half-pixel-
    # translated working transform (exactly Raster.interp_points' shift, geoutils'
    # shift_area_or_point). Raster-raster paths compare like grids — no shift needed.
    mixed = isinstance(ref_out, PointCloud) != isinstance(tba_out, PointCloud)
    if mixed and area_or_point == "Point" and transform is not None:
        from xdem_tpu.config import config as _pkg_config

        if _pkg_config["shift_area_or_point"]:
            t = transform
            transform = t.translation(-0.5 * (t.a + t.b), -0.5 * (t.d + t.e))
    return ref_out, tba_out, mask, transform, crs, area_or_point


# ------------------------------------------------------------------ metadata typing
# Typed views of the nested Coreg metadata dict (reference base.py:1786-1941). total=False:
# every key is optional; methods populate only the sections they use.


class InRandomDict(TypedDict, total=False):
    """Inputs associated with randomization and subsampling."""

    subsample: int | float
    random_state: int | np.random.Generator | None


class OutRandomDict(TypedDict, total=False):
    """Outputs associated with randomization and subsampling."""

    subsample_final: int


class InFitOrBinDict(TypedDict, total=False):
    """Inputs associated with binning and/or fitting."""

    fit_or_bin: Literal["fit", "bin", "bin_and_fit"]
    fit_func: Callable[..., Any]
    fit_optimizer: Callable[..., Any]
    fit_minimizer: Callable[..., Any]
    fit_loss_func: Callable[..., Any]
    bin_sizes: int | dict[str, int | Iterable[float]]
    bin_statistic: Callable[..., Any]
    bin_apply_method: Literal["linear", "per_bin"]
    bias_var_names: list[str]
    nd: int | None


class OutFitOrBinDict(TypedDict, total=False):
    """Outputs associated with binning and/or fitting."""

    fit_params: Any
    fit_perr: Any
    bin_dataframe: Any


class InIterativeDict(TypedDict, total=False):
    """Inputs associated with iterative methods."""

    max_iterations: int
    tolerance: float


class OutIterativeDict(TypedDict, total=False):
    """Outputs associated with iterative methods."""

    last_iteration: int
    all_tolerances: list[float]


class InSpecificDict(TypedDict, total=False):
    """Inputs specific to a single method (terrain attribute, angle, poly order, ...)."""

    terrain_attribute: str
    angle: float
    poly_order: int
    best_poly_order: int
    best_nb_sin_freq: int


class OutSpecificDict(TypedDict, total=False):
    """Outputs specific to a single method."""

    partition: Any


class InAffineDict(TypedDict, total=False):
    """Inputs associated with affine methods."""

    vshift_reduc_func: Callable[[Any], Any]
    initial_shift: tuple[float, float] | None
    standardize: bool
    only_translation: bool
    picky: bool


class OutAffineDict(TypedDict, total=False):
    """Outputs associated with affine methods."""

    centroid: tuple[float, float, float]
    matrix: Any
    shift_x: float
    shift_y: float
    shift_z: float


class InputCoregDict(TypedDict, total=False):
    random: InRandomDict
    fitorbin: InFitOrBinDict
    iterative: InIterativeDict
    specific: InSpecificDict
    affine: InAffineDict


class OutputCoregDict(TypedDict, total=False):
    random: OutRandomDict
    fitorbin: OutFitOrBinDict
    iterative: OutIterativeDict
    specific: OutSpecificDict
    affine: OutAffineDict


class CoregDict(TypedDict, total=False):
    """Type of the full metadata dictionary of Coreg classes."""

    inputs: InputCoregDict
    outputs: OutputCoregDict


# ------------------------------------------------------------------ Coreg class


class Coreg:
    """Generic coregistration class with fit/apply and serializable metadata
    (reference base.py:1946)."""

    _fit_called = False
    _is_affine: bool | None = None
    _needs_vars = False
    _supports_mesh_fit = False  # True on methods whose fit() honors mesh= (multi-chip)

    # Known meta keys route to their section (reference base.py:1962-1997's key mapping);
    # anything else lands in "specific". Without this, every key except subsample/
    # random_state fell into "specific" and fits silently ran with defaults.
    _META_KEY_SECTIONS: dict[str, str] = {
        "subsample": "random", "random_state": "random",
        "fit_or_bin": "fitorbin", "fit_func": "fitorbin", "fit_optimizer": "fitorbin",
        "bin_sizes": "fitorbin", "bin_statistic": "fitorbin",
        "bin_apply_method": "fitorbin", "bias_var_names": "fitorbin", "nd": "fitorbin",
        "max_iterations": "iterative", "tolerance": "iterative",
        "offset_threshold": "iterative",
        "matrix": "affine", "shift_x": "affine", "shift_y": "affine", "shift_z": "affine",
        "centroid": "affine", "only_translation": "affine", "standardize": "affine",
    }

    def __init__(self, meta: dict[str, Any] | None = None):
        inputs = {
            "random": {"subsample": 1.0, "random_state": None},
            "fitorbin": {},
            "iterative": {},
            "specific": {},
            "affine": {},
        }
        if meta:
            for k, v in meta.items():
                section = self._META_KEY_SECTIONS.get(k)
                if section is None:
                    for name, sec in inputs.items():
                        if k in sec:
                            section = name
                            break
                inputs[section or "specific"][k] = v
        self._meta: dict[str, Any] = {"inputs": inputs, "outputs": {}}

    # ------------------------------- metadata access

    @property
    def meta(self) -> dict[str, Any]:
        return self._meta

    def info(self, as_str: bool = False) -> None | str:
        """Summarize the coreg metadata; print it, or return the text with ``as_str=True``
        (reference base.py:2064)."""
        import json

        def _default(o):
            if isinstance(o, np.ndarray):
                return o.tolist()
            return str(o)

        text = json.dumps(self._meta, indent=2, default=_default)
        if as_str:
            return text
        print(text)
        return None

    @property
    def is_affine(self) -> bool:
        # Recomputed each call: caching before fit() would pin False permanently on
        # subclasses that only write outputs["affine"] during fitting
        if self._is_affine is not None:
            return self._is_affine
        return "affine" in self._meta["outputs"]

    @property
    def is_translation(self) -> bool | None:
        """Whether the fitted transform is a pure translation — None when no matrix can be
        derived yet (reference base.py:2036-2050)."""
        matrix = self._meta["outputs"].get("affine", {}).get("matrix")
        if matrix is None:
            try:
                matrix = self.to_matrix()
            except (AttributeError, KeyError, ValueError, NotImplementedError):
                return None
        return bool(np.allclose(np.asarray(matrix)[:3, :3], np.eye(3), rtol=1e-2))

    # ------------------------------- fit / apply

    @_profile("xdem_tpu.coreg.Coreg.fit", memprof=True)
    def fit(
        self,
        reference_elev: Any,
        to_be_aligned_elev: Any,
        inlier_mask: Any = None,
        bias_vars: dict[str, Any] | None = None,
        weights: np.ndarray | None = None,
        subsample: float | int | None = None,
        transform: Affine | None = None,
        crs: Any = None,
        area_or_point: str | None = None,
        z_name: str = "z",
        random_state: int | None = None,
        **kwargs: Any,
    ) -> "Coreg":
        """Estimate the coregistration from a reference and a to-be-aligned elevation
        (reference base.py:2250)."""
        if weights is not None:
            # No method consumes observation weights yet; refuse rather than silently ignore
            # (the reference likewise errors on unsupported weights).
            raise NotImplementedError(
                f"{type(self).__name__} does not support weighted fitting yet; leave weights=None."
            )
        if kwargs.get("mesh") is not None and not self._supports_mesh_fit:
            # Refuse rather than silently run single-device: a mesh= the method cannot honor
            # would otherwise look like a working multi-chip fit. Every AffineCoreg method
            # shards; BiasCorr fits are host bin-and-fit programs (their APPLY evaluates on
            # device) — inside a CoregPipeline such steps fall back with a logged notice.
            raise NotImplementedError(
                f"{type(self).__name__} does not support mesh= fitting; mesh= is available on "
                "every affine method (NuthKaab, VerticalShift, DhMinimize, ICP, CPD, LZD; "
                "BlockwiseCoreg takes mesh= at construction)."
            )
        ref, tba, mask, transform, crs, area_or_point = _preprocess_coreg_fit(
            reference_elev, to_be_aligned_elev, inlier_mask, transform, crs, area_or_point
        )
        if subsample is not None:
            self._meta["inputs"]["random"]["subsample"] = subsample
        if random_state is not None:
            self._meta["inputs"]["random"]["random_state"] = random_state

        if bias_vars is not None:
            bias_vars = {
                k: (v.data if isinstance(v, Raster) else jnp.asarray(unmask(v))) for k, v in bias_vars.items()
            }

        # Initial shift: pre-translate the to-be-aligned input before fitting, and re-add the
        # shift to the estimated outputs afterwards (reference base.py:2307-2314, 2356-2363).
        initial_shift = self._meta["inputs"].get("affine", {}).get("initial_shift")
        if initial_shift is not None:
            sx0, sy0 = initial_shift[0], initial_shift[1]
            sz0 = initial_shift[2] if len(initial_shift) > 2 else 0.0
            if isinstance(tba, PointCloud):
                tba = tba.translate(sx0, sy0, sz0)
            else:
                shift_matrix = matrix_from_translations_rotations(t_x=sx0, t_y=sy0, t_z=sz0)
                tba_r = Raster(tba, transform, crs)
                shifted = apply_matrix(tba_r, shift_matrix, resample=False)
                data = _reproject_horizontal_shift_samecrs(
                    shifted.data, src_transform=shifted.transform, dst_transform=transform
                )
                tba = data

        self._fit_func(
            ref_elev=ref,
            tba_elev=tba,
            inlier_mask=mask,
            transform=transform,
            crs=crs,
            area_or_point=area_or_point,
            z_name=z_name,
            weights=weights,
            bias_vars=bias_vars,
            **kwargs,
        )
        # Re-add the initial shift to the estimated outputs
        if initial_shift is not None:
            aff = self._meta["outputs"].get("affine", {})
            for key, add in (("shift_x", sx0), ("shift_y", sy0), ("shift_z", sz0)):
                if key in aff:
                    aff[key] = aff[key] + add
            if "matrix" in aff:
                m = np.asarray(aff["matrix"]).copy()
                m[:3, 3] += [sx0, sy0, sz0]
                aff["matrix"] = m

        # Graceful failure on broken solves (reference surfaces these as ValueError from its
        # scipy optimizers): a fit that produced non-finite parameters must not be applied.
        aff_out = self._meta["outputs"].get("affine", {})
        for key in ("matrix", "shift_x", "shift_y", "shift_z"):
            if key in aff_out and not np.all(np.isfinite(np.asarray(aff_out[key]))):
                raise ValueError(
                    f"Coregistration failed: fitted '{key}' contains non-finite values "
                    f"(degenerate input data — check valid-pixel overlap and terrain variety)."
                )

        self._fit_called = True
        return self

    # ------------------------------- serialization (checkpoint/resume of the model state)

    def save(self, path: str) -> None:
        """Serialize the fitted coreg state (meta dict) to disk — the `Coreg.meta` dict is the
        model state (SURVEY §5 / reference base.py:1786-1941); callables are stored by name."""
        import pickle

        def sanitize(obj: Any) -> Any:
            if isinstance(obj, dict):
                return {k: sanitize(v) for k, v in obj.items()}
            if isinstance(obj, (list, tuple)):
                return type(obj)(sanitize(v) for v in obj)
            if callable(obj) and not isinstance(obj, type):
                return {"__callable__": f"{getattr(obj, '__module__', '')}.{getattr(obj, '__qualname__', '')}"}
            return obj

        payload: dict[str, Any] = {"class": type(self).__name__, "meta": sanitize(self._meta),
                                   "fit_called": self._fit_called}
        steps = getattr(self, "pipeline", None)
        if steps is not None:  # CoregPipeline: the fitted state lives in the steps
            payload["steps"] = [{"class": type(st).__name__, "meta": sanitize(st._meta),
                                 "fit_called": st._fit_called} for st in steps]
        with open(path, "wb") as f:
            pickle.dump(payload, f)

    @staticmethod
    def load(path: str) -> "Coreg":
        """Load a serialized coreg state; returns an instance of the stored class with the
        fitted outputs restored (callables restored by import where possible)."""
        import importlib
        import pickle

        with open(path, "rb") as f:
            payload = pickle.load(f)

        from xdem_tpu import coreg as _coreg_pkg

        cls = getattr(_coreg_pkg, payload["class"])
        if "steps" in payload:  # CoregPipeline round-trip
            steps = []
            for st in payload["steps"]:
                step = getattr(_coreg_pkg, st["class"])()
                step._meta = Coreg._restore_tree(st["meta"])
                step._fit_called = st["fit_called"]
                steps.append(step)
            obj = cls(steps)
        else:
            obj = cls()

        obj._meta = Coreg._restore_tree(payload["meta"])
        obj._fit_called = payload["fit_called"]
        return obj

    @staticmethod
    def _restore_tree(o: Any) -> Any:
        """Restore a sanitized meta tree (callables re-imported by qualified name)."""
        import importlib

        if isinstance(o, dict):
            if set(o.keys()) == {"__callable__"}:
                mod_name, _, qual = o["__callable__"].rpartition(".")
                try:
                    return getattr(importlib.import_module(mod_name), qual)
                except (ImportError, AttributeError):
                    return None
            return {k: Coreg._restore_tree(v) for k, v in o.items()}
        if isinstance(o, (list, tuple)):
            return type(o)(Coreg._restore_tree(v) for v in o)
        return o

    def _fit_func(self, **kwargs: Any) -> None:
        """Dispatch fit by input type with the rst-rst -> rst-pts -> pts-pts fallback ladder
        (reference base.py:2612-2688)."""
        ref = kwargs["ref_elev"]
        tba = kwargs["tba_elev"]
        ref_is_pts = isinstance(ref, PointCloud)
        tba_is_pts = isinstance(tba, PointCloud)

        if not ref_is_pts and not tba_is_pts:
            try:
                self._fit_rst_rst(**kwargs)
                return
            except NotImplementedCoregFit:
                # Convert the reference raster to points and retry
                sub = kwargs.copy()
                ref_pc = _raster_to_pointcloud(ref, kwargs["transform"], kwargs["crs"])
                sub["ref_elev"] = ref_pc
                try:
                    self._fit_rst_pts(**sub)
                    return
                except NotImplementedCoregFit:
                    tba_pc = _raster_to_pointcloud(tba, kwargs["transform"], kwargs["crs"])
                    sub["tba_elev"] = tba_pc
                    self._fit_pts_pts(**sub)
                    return
        elif ref_is_pts != tba_is_pts:
            try:
                self._fit_rst_pts(**kwargs)
                return
            except NotImplementedCoregFit:
                sub = kwargs.copy()
                if ref_is_pts:
                    sub["tba_elev"] = _raster_to_pointcloud(tba, kwargs["transform"], kwargs["crs"])
                else:
                    sub["ref_elev"] = _raster_to_pointcloud(ref, kwargs["transform"], kwargs["crs"])
                self._fit_pts_pts(**sub)
                return
        else:
            self._fit_pts_pts(**kwargs)

    def _fit_rst_rst(self, **kwargs: Any) -> None:
        raise NotImplementedCoregFit(f"{type(self).__name__} does not implement raster-raster fit.")

    def _fit_rst_pts(self, **kwargs: Any) -> None:
        raise NotImplementedCoregFit(f"{type(self).__name__} does not implement raster-point fit.")

    def _fit_pts_pts(self, **kwargs: Any) -> None:
        raise NotImplementedCoregFit(f"{type(self).__name__} does not implement point-point fit.")

    @_profile("xdem_tpu.coreg.Coreg.apply", memprof=True)
    def apply(
        self,
        elev: Any,
        bias_vars: dict[str, Any] | None = None,
        resample: bool = True,
        resampling: str | None = None,
        transform: Affine | None = None,
        crs: Any = None,
        z_name: str = "z",
        **kwargs: Any,
    ) -> Any:
        """Apply the estimated transform to an elevation dataset (reference base.py:2409).

        `resampling=None` uses the package default (`xdem_tpu.config["resampling"]`)."""
        if not self._fit_called and not (self.is_affine and "matrix" in self._meta["outputs"].get("affine", {})):
            raise AssertionError(".fit() does not seem to have been called yet")
        if resampling is None:
            from xdem_tpu.config import config as _pkg_config

            resampling = _pkg_config["resampling"]
        # Alias applies to EXPLICIT arguments too (the canonical rasterio name)
        resampling = {"bilinear": "linear", "cubic_spline": "cubic"}.get(resampling, resampling)

        if bias_vars is not None:
            bias_vars = {k: (v.data if isinstance(v, Raster) else jnp.asarray(unmask(v))) for k, v in bias_vars.items()}

        is_raster_obj = isinstance(elev, Raster)
        if is_raster_obj:
            transform = elev.transform
            crs = elev.crs
        else:
            transform = _as_affine(transform)
            elev = unmask(elev)

        try:
            applied = self._apply_func(
                elev=elev, bias_vars=bias_vars, transform=transform, crs=crs, z_name=z_name,
                resample=resample, resampling=resampling, **kwargs,
            )
        except NotImplementedCoregApply:
            # Affine fallback: apply the matrix (reference base.py:2690-2723)
            if not self.is_affine:
                raise
            # resample=False: the shared post-processing below resamples back onto the
            # original grid exactly when the caller asked for it.
            applied = apply_matrix(
                elev, self.to_matrix(), centroid=self._meta["outputs"]["affine"].get("centroid"),
                resample=False, resampling=resampling, transform=transform, crs=crs,
            )

        # Post-processing: resample back onto the original grid (base.py:535) — for Raster
        # objects AND bare (array, transform) outputs (the reference resamples both).
        if resample:
            if is_raster_obj and isinstance(applied, Raster):
                if not applied.transform.almost_equals(elev.transform):
                    data = _reproject_horizontal_shift_samecrs(
                        applied.data, src_transform=applied.transform, dst_transform=elev.transform,
                        resampling=resampling,
                    )
                    applied = elev.copy(new_array=data)
            elif (not is_raster_obj and transform is not None and isinstance(applied, tuple)
                  and len(applied) == 2):
                data, new_transform = applied
                if not new_transform.almost_equals(transform):
                    data = np.asarray(_reproject_horizontal_shift_samecrs(
                        jnp.asarray(data), src_transform=new_transform, dst_transform=transform,
                        resampling=resampling,
                    ))
                    applied = (data, transform)
        return applied

    def _apply_func(self, **kwargs: Any) -> Any:
        raise NotImplementedCoregApply(f"{type(self).__name__} has no custom apply.")

    def fit_and_apply(
        self,
        reference_elev: Any,
        to_be_aligned_elev: Any,
        inlier_mask: Any = None,
        bias_vars: dict[str, Any] | None = None,
        fit_kwargs: dict[str, Any] | None = None,
        apply_kwargs: dict[str, Any] | None = None,
        **kwargs: Any,
    ) -> Any:
        """Fit then apply to the to-be-aligned elevation (reference base.py:2542).

        Shared keywords (subsample, z_name, random_state, ...) can be passed flat and are
        routed to fit(); apply-only ones (resample, resampling, ...) go to apply(). The
        reference's explicit ``fit_kwargs``/``apply_kwargs`` dicts are also accepted and
        take precedence over the flat routing."""
        fkw = {
            k: kwargs.pop(k)
            for k in ("weights", "subsample", "transform", "crs", "area_or_point", "z_name",
                      "random_state", "mesh")
            if k in kwargs
        }
        akw = dict(kwargs)
        if "transform" in fkw and "transform" not in akw:
            akw["transform"] = fkw["transform"]
        if "crs" in fkw and "crs" not in akw:
            akw["crs"] = fkw["crs"]
        if "z_name" in fkw and "z_name" not in akw:
            akw["z_name"] = fkw["z_name"]
        fkw.update(fit_kwargs or {})
        akw.update(apply_kwargs or {})
        self.fit(reference_elev, to_be_aligned_elev, inlier_mask=inlier_mask, bias_vars=bias_vars, **fkw)
        return self.apply(to_be_aligned_elev, bias_vars=bias_vars, **akw)

    def residuals(self, reference_elev: Any, to_be_aligned_elev: Any, **kwargs: Any) -> np.ndarray:
        """dh residuals after applying the fitted transform."""
        aligned = self.apply(to_be_aligned_elev, **kwargs)
        if isinstance(reference_elev, Raster) and isinstance(aligned, Raster):
            return np.asarray((reference_elev - aligned).data)
        raise NotImplementedError("Residuals currently require raster inputs.")

    # ------------------------------- matrix access

    def to_matrix(self) -> np.ndarray:
        """The affine transform matrix of the fitted method."""
        return self._to_matrix_func()

    def to_translations(self) -> tuple[float, float, float]:
        t = translations_rotations_from_matrix(self.to_matrix())
        return t[0], t[1], t[2]

    def to_rotations(self, return_degrees: bool = True) -> tuple[float, float, float]:
        t = translations_rotations_from_matrix(self.to_matrix(), return_degrees=return_degrees)
        return t[3], t[4], t[5]

    def _to_matrix_func(self) -> np.ndarray:
        affine_out = self._meta["outputs"].get("affine", {})
        if "matrix" in affine_out:
            return np.asarray(affine_out["matrix"])
        if {"shift_x", "shift_y", "shift_z"} <= set(affine_out):
            return matrix_from_translations_rotations(
                t_x=affine_out["shift_x"], t_y=affine_out["shift_y"], t_z=affine_out["shift_z"]
            )
        raise NotImplementedError("This coreg method does not produce a transform matrix.")

    # ------------------------------- pipeline composition

    def __add__(self, other: "Coreg") -> "CoregPipeline":
        if not isinstance(other, Coreg):
            raise ValueError(f"Incompatible add type: {type(other)}. Expected 'Coreg' subclass")
        return CoregPipeline([self, other])

    def copy(self) -> "Coreg":
        return _copy.deepcopy(self)


def _raster_to_pointcloud(arr_or_raster: Any, transform: Affine, crs: Any, subsample: int | None = None) -> PointCloud:
    arr = np.asarray(arr_or_raster.data if isinstance(arr_or_raster, Raster) else arr_or_raster)
    valid = np.isfinite(arr)
    rr, cc = np.nonzero(valid)
    x, y = transform.xy(rr, cc)
    return PointCloud(x=x, y=y, z=arr[valid], crs=crs if crs is not None else 32633)


class CoregPipeline(Coreg):
    """A sequential pipeline of Coreg steps (reference base.py:2880)."""

    def __init__(self, pipeline: list[Coreg]):
        self.pipeline = pipeline
        super().__init__()

    def __repr__(self) -> str:
        return f"Pipeline: {self.pipeline}"

    def copy(self) -> "CoregPipeline":
        return CoregPipeline([step.copy() for step in self.pipeline])

    def __iter__(self):
        return iter(self.pipeline)

    def __getitem__(self, idx: int) -> Coreg:
        return self.pipeline[idx]

    def _parse_bias_vars(self, step_idx: int, bias_vars: dict[str, Any] | None) -> dict[str, Any] | None:
        """Select the bias_vars each step needs (reference base.py:2930)."""
        step = self.pipeline[step_idx]
        if not getattr(step, "_needs_vars", False) or bias_vars is None:
            return None
        needed = step._meta["inputs"]["fitorbin"].get("bias_var_names")
        if needed is None:
            return bias_vars
        return {k: bias_vars[k] for k in needed if k in bias_vars}

    def fit(
        self,
        reference_elev: Any,
        to_be_aligned_elev: Any,
        inlier_mask: Any = None,
        bias_vars: dict[str, Any] | None = None,
        **kwargs: Any,
    ) -> "CoregPipeline":
        """Fit each step on the running to-be-aligned elevation (reference base.py:2972)."""
        tba = to_be_aligned_elev
        # The in-fit apply of each step needs the georeferencing when tba is a bare array
        # (reference base.py:3018-3051 threads transform/crs through the step applies)
        apply_kw = {k: kwargs[k] for k in ("transform", "crs", "z_name") if k in kwargs}
        for i, step in enumerate(self.pipeline):
            logging.info("Running pipeline step: %d / %d", i + 1, len(self.pipeline))
            step_bias = self._parse_bias_vars(i, bias_vars)
            step_kwargs = kwargs
            if kwargs.get("mesh") is not None and not step._supports_mesh_fit:
                # mesh= applies to the steps that can shard their fit; the others run
                # single-device rather than failing the whole pipeline
                logging.info("Pipeline step %d (%s) has no mesh= fit path; running single-device.",
                             i + 1, type(step).__name__)
                step_kwargs = {k: v for k, v in kwargs.items() if k != "mesh"}
            step.fit(reference_elev, tba, inlier_mask=inlier_mask, bias_vars=step_bias, **step_kwargs)
            tba = step.apply(tba, bias_vars=step_bias, **apply_kw)
            if isinstance(tba, tuple):  # array input returns (array, transform)
                apply_kw["transform"] = tba[1]
                tba = tba[0]
        self._fit_called = True
        return self

    def apply(self, elev: Any, bias_vars: dict[str, Any] | None = None, **kwargs: Any) -> Any:
        """Chain the apply of each step (reference base.py:3098). For bare-array input each
        step returns (array, transform); the updated transform threads into the next step
        and the final pair is returned like a single Coreg.apply would."""
        out = elev
        for i, step in enumerate(self.pipeline):
            step_bias = self._parse_bias_vars(i, bias_vars)
            out = step.apply(out, bias_vars=step_bias, **kwargs)
            if isinstance(out, tuple):
                kwargs["transform"] = out[1]
                out = out[0]
        if "transform" in kwargs and not isinstance(elev, Raster):
            return out, kwargs["transform"]
        return out

    # fit_and_apply is inherited from Coreg: the same flat-kwarg routing (transform/crs/
    # z_name copied into the apply call) and fit_kwargs/apply_kwargs dicts apply to pipelines.

    def _to_matrix_func(self) -> np.ndarray:
        """Product of the step matrices (reference base.py:3187)."""
        out = np.eye(4)
        for step in self.pipeline:
            out = step.to_matrix() @ out
        return out
