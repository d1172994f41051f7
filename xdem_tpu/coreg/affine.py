"""Affine coregistration methods: VerticalShift, NuthKaab, DhMinimize, ICP, CPD, LZD.

Reference parity (/root/reference/xdem/coreg/affine.py): iteration driver (:102-147),
NuthKaab (:340-609, class :2386), DhMinimize (:617-717, class :2667), VerticalShift (:721,
class :2002), ICP (:773-1184, class :2107), CPD (:1190-1384, class :2262), LZD (:1461-1779,
class :2544), AffineCoreg base (:1786-1999).

Device re-design highlights:
  * NuthKaab's whole iterative fit is ONE jitted lax.while_loop: gather-based bilinear dh
    evaluation at 5e5 points, sort-based 72-bin aspect medians, and a closed-form 3x3 solve of
    the cosine model (y = a*cos(b-x) + c is linear in (a cos b, a sin b, c) — no curve_fit).
  * DhMinimize: host Nelder-Mead driving a jitted NMAD(dh(sx, sy)) evaluation.
  * ICP: point-to-plane with Low (2004) linearized 6x6 solve on device; neighbor search via a
    host KD-tree built once (reference does the same) or blocked brute-force on device.
  * CPD: the O(N*M) EM responsibilities as device matmul-shaped kernels.
  * LZD: jitted linearized 6-param LSQ per iteration with gather interpolation.
"""

from __future__ import annotations

import logging
import warnings
from functools import partial
from typing import Any, Callable, Iterable, Literal

import jax
import jax.numpy as jnp
import numpy as np

from xdem_tpu.coreg.base import (
    Coreg,
    NotImplementedCoregFit,
    _apply_matrix_pts_arr,
    _make_matrix_valid,
    invert_matrix,
    matrix_from_translations_rotations,
    translations_rotations_from_matrix,
)
from xdem_tpu.georef import Affine
from xdem_tpu.ops.interp import interp_rowcol
from xdem_tpu.ops.precision import pin_f32_matmuls
from xdem_tpu.ops.transfer import device_mask
from xdem_tpu.pointcloud import PointCloud
from xdem_tpu.raster import Raster

# ======================================================================================
# Shared preprocessing: subsampling to fixed-size device arrays
# ======================================================================================


def _grad_slope_aspect(dem: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Slope tangent (pixel units) and aspect via np.gradient, as NuthKaab expects
    (reference affine.py:422-447)."""
    gradient_y, gradient_x = np.gradient(np.asarray(dem, dtype=np.float64))
    slope_tan = np.sqrt(gradient_x**2 + gradient_y**2)
    aspect = np.arctan2(-gradient_x, gradient_y) + np.pi
    return slope_tan, aspect


def _warn_if_not_converged(it: int, max_iterations: int, stat: float, tolerance: float,
                           sx: float, sy: float) -> None:
    if it >= max_iterations and stat > tolerance:
        logging.warning(
            "Nuth and Kääb did not converge after %d iterations (last offset step %.3f px > "
            "tolerance %.3f px); the estimated shift (%.1f, %.1f) m may be unreliable. "
            "Moving terrain in the inputs (pass a stable-terrain inlier_mask) is the most "
            "common cause.", int(it), float(stat), float(tolerance), float(sx), float(sy),
        )


def _count_from_subsample(subsample: float | int, n_valid: int) -> int:
    if subsample <= 1:
        return max(int(subsample * n_valid), 1)
    return min(int(subsample), n_valid)


def _subsample_pair(
    ref_elev: Any,
    tba_elev: Any,
    inlier_mask: np.ndarray | None,
    transform: Affine,
    subsample: float | int,
    random_state: int | None,
    aux_vars: dict[str, np.ndarray] | None = None,
    z_name: str = "z",
):
    """Subsample raster-raster or raster-point pairs to fixed-size aligned 1-D arrays.

    Returns dict with: pts_z (reference-side z), rows/cols (fractional pixel coords into
    `raster`), raster (the gridded dataset to interpolate when shifting), invert (True when the
    raster side is the reference), subsampled aux vars, and the final count.
    Mirrors reference base.py:576-905 and affine.py:150-293.
    """
    rng = np.random.default_rng(random_state)
    ref_is_pts = isinstance(ref_elev, PointCloud)
    tba_is_pts = isinstance(tba_elev, PointCloud)

    if not ref_is_pts and not tba_is_pts:
        # Residence-split transfers (see _subsample_pair_values): device grids contribute one
        # joint finite mask + one gather dispatch; host grids are indexed in numpy. No full
        # f32 raster is read back to the host.
        items = [("__ref__", ref_elev)] + [(k, v) for k, v in (aux_vars or {}).items()]
        dev = {k: v for k, v in items if isinstance(v, jnp.ndarray)}
        host = {k: np.asarray(v) for k, v in items if not isinstance(v, jnp.ndarray)}
        tba_j = jnp.asarray(tba_elev, jnp.float32)
        valid = np.array(
            _finite_all(tuple([tba_j] + list(dev.values())))
        )  # np.array: the device readback is read-only, and the mask is &='d below
        for v in host.values():
            valid &= np.isfinite(v)
        if inlier_mask is not None:
            valid &= inlier_mask
        idx_flat = np.flatnonzero(valid)
        if idx_flat.size == 0:
            raise ValueError("No valid (finite, inlier) pixels in common between the elevation data.")
        count = _count_from_subsample(subsample, idx_flat.size)
        choice = rng.choice(idx_flat, count, replace=False) if count < idx_flat.size else idx_flat
        rr, cc = np.unravel_index(choice, valid.shape)
        vals: dict[str, np.ndarray] = {}
        if dev:
            gathered = np.asarray(
                _gather_flat(tuple(dev.values()), jnp.asarray(choice))
            )
            for i, k in enumerate(dev):
                vals[k] = gathered[i]
        for k, v in host.items():
            vals[k] = v[rr, cc].astype(np.float32)
        out = {
            "pts_z": vals["__ref__"],
            "rows": rr.astype(np.float32),
            "cols": cc.astype(np.float32),
            "raster": tba_j,
            "invert": False,
            "count": int(count),
        }
        if aux_vars is not None:
            out["aux"] = {k: vals[k] for k in aux_vars}
        return out

    # Raster-point: identify sides
    pts: PointCloud = ref_elev if ref_is_pts else tba_elev
    rst_in = tba_elev if ref_is_pts else ref_elev
    rst_j = jnp.asarray(rst_in, jnp.float32)
    rows_f, cols_f = transform.rowcol(pts.x, pts.y)
    h, w = rst_j.shape
    # Validity mirrors the reference (base.py:676-705): the joint raster-side valid mask is
    # interpolated at the point coords with NaN poisoning, so a point only passes when ALL
    # FOUR bilinear neighbors are valid — a rounded-pixel check would admit points next to
    # nodata edges whose interpolated dh is NaN. (The finite mask crosses to the host as
    # 1 byte/px; the f32 raster itself stays on the device.)
    rst_valid = np.array(jnp.isfinite(rst_j))  # writable: &='d below
    if inlier_mask is not None:
        rst_valid &= inlier_mask
    if aux_vars is not None:
        for v in aux_vars.values():
            rst_valid &= np.isfinite(v)
    ri = np.clip(np.round(rows_f).astype(int), 0, h - 1)
    ci = np.clip(np.round(cols_f).astype(int), 0, w - 1)
    r0 = np.clip(np.floor(rows_f).astype(int), 0, h - 1)
    c0 = np.clip(np.floor(cols_f).astype(int), 0, w - 1)
    r1 = np.minimum(r0 + 1, h - 1)
    c1 = np.minimum(c0 + 1, w - 1)
    valid = (
        np.isfinite(pts.z)
        & (rows_f >= 0) & (rows_f <= h - 1) & (cols_f >= 0) & (cols_f <= w - 1)
        & rst_valid[r0, c0] & rst_valid[r0, c1] & rst_valid[r1, c0] & rst_valid[r1, c1]
    )
    idx = np.flatnonzero(valid)
    if idx.size == 0:
        raise ValueError("No valid points overlapping the raster.")
    count = _count_from_subsample(subsample, idx.size)
    choice = rng.choice(idx, count, replace=False) if count < idx.size else idx
    out = {
        "pts_z": pts.z[choice].astype(np.float32),
        "rows": rows_f[choice].astype(np.float32),
        "cols": cols_f[choice].astype(np.float32),
        "raster": rst_j,
        "invert": not ref_is_pts,  # raster side is the reference
        "count": int(count),
    }
    if aux_vars is not None:
        out["aux"] = {k: v[ri[choice], ci[choice]].astype(np.float32) for k, v in aux_vars.items()}
    return out


def _dh_device(pts_z, rows, cols, raster, sx_px, sy_px, invert: bool):
    """dh(shift) at subsampled points: ref - tba with the raster shifted by (sx, sy) pixels.

    Shift sign follows reference affine.py:179-231: for a raster tba, dh = ref - tba(x+s);
    when the raster is the reference, dh = ref(x-s) - tba (expressed via `invert`).
    """
    sgn = -1.0 if invert else 1.0
    rr = rows - sgn * sy_px
    cc = cols + sgn * sx_px
    interp = interp_rowcol(raster, rr, cc, method="linear")
    dh = pts_z - interp
    return -dh if invert else dh


# ======================================================================================
# Nuth & Kaab: fully jitted iterative solver
# ======================================================================================


def _binned_median(y: jnp.ndarray, bin_idx: jnp.ndarray, valid: jnp.ndarray, n_bins: int):
    """Per-bin median via one lexsort + gathers (jit-safe, fixed shapes)."""
    parked = jnp.where(valid, bin_idx, n_bins)
    order = jnp.lexsort((y, parked))
    ys = y[order]
    counts = jnp.bincount(parked, length=n_bins + 1)[:n_bins]
    starts = jnp.cumsum(counts) - counts
    lo = ys[jnp.clip(starts + (counts - 1) // 2, 0, y.size - 1)]
    hi = ys[jnp.clip(starts + counts // 2, 0, y.size - 1)]
    return jnp.where(counts > 0, 0.5 * (lo + hi), jnp.nan)


def _masked_median(x: jnp.ndarray) -> jnp.ndarray:
    """Median over finite entries as 0.5*(lo+hi) of the two middle order statistics — the
    SAME formula as the distributed radix selection (parallel/selection.py), so mesh= fits
    match single-device fits bitwise (jnp.nanmedian's interpolation is not guaranteed to
    share that exact rounding)."""
    flat = x.ravel()
    return _binned_median(flat, jnp.zeros(flat.shape, jnp.int32), jnp.isfinite(flat), 1)[0]


@partial(jax.jit, static_argnames=("max_iterations", "n_bins", "invert", "bin_before_fit"))
@pin_f32_matmuls
def _nuth_kaab_solve(
    pts_z: jnp.ndarray,
    rows: jnp.ndarray,
    cols: jnp.ndarray,
    raster: jnp.ndarray,
    slope_tan: jnp.ndarray,
    aspect: jnp.ndarray,
    res_x: float,
    res_y: float,
    tolerance: float,
    max_iterations: int = 10,
    n_bins: int = 72,
    invert: bool = False,
    bin_before_fit: bool = True,
):
    """Jit-compiled Nuth & Kaab iterations (reference affine.py:477-536 semantics).

    Carries (sx_px, sy_px, vshift, stat, it); each step: bilinear dh at shifted points, median
    vshift removal, dh/tan(slope) binned by aspect, closed-form cosine fit, pixel-offset
    increment. Stops after >= 3 steps once the offset statistic drops below tolerance.
    """
    bin_centers = (jnp.arange(n_bins) + 0.5) * (2 * jnp.pi / n_bins)
    G = jnp.stack([jnp.cos(bin_centers), jnp.sin(bin_centers), jnp.ones(n_bins)], axis=1)

    def fit_cosine(x: jnp.ndarray, yv: jnp.ndarray, valid: jnp.ndarray):
        """LSQ of y = A cos x + B sin x + C; returns (A, B, C). Used for fit-only mode."""
        Gf = jnp.stack([jnp.cos(x), jnp.sin(x), jnp.ones_like(x)], axis=1)
        w = valid.astype(jnp.float32)
        A = (Gf * w[:, None]).T @ Gf
        b = (Gf * w[:, None]).T @ jnp.where(valid, yv, 0.0)
        return jnp.linalg.solve(A + 1e-12 * jnp.eye(3), b)

    def step(carry):
        sx, sy, _vs, _stat, it = carry
        dh = _dh_device(pts_z, rows, cols, raster, sx, sy, invert)
        vshift = _masked_median(dh)
        dh = dh - vshift
        y = dh / slope_tan
        valid = jnp.isfinite(y)

        if bin_before_fit:
            bin_idx = jnp.clip((aspect / (2 * jnp.pi / n_bins)).astype(jnp.int32), 0, n_bins - 1)
            med = _binned_median(y, bin_idx, valid, n_bins)
            bin_ok = jnp.isfinite(med)
            w = bin_ok.astype(jnp.float32)
            A_mat = (G * w[:, None]).T @ G
            b_vec = (G * w[:, None]).T @ jnp.where(bin_ok, med, 0.0)
            p = jnp.linalg.solve(A_mat + 1e-12 * jnp.eye(3), b_vec)
        else:
            p = fit_cosine(aspect, y, valid)

        north_px = p[0]  # a*cos(b)
        east_px = p[1]  # a*sin(b)
        sx_new = sx + east_px  # pixel units (slope_tan is per-pixel)
        sy_new = sy + north_px
        stat = jnp.hypot(east_px, north_px)
        return sx_new, sy_new, vshift, stat, it + 1

    def cond(carry):
        _sx, _sy, _vs, stat, it = carry
        return (it < max_iterations) & ~((it >= 3) & (stat < tolerance))

    init = (jnp.asarray(0.0, jnp.float32), jnp.asarray(0.0, jnp.float32),
            jnp.asarray(0.0, jnp.float32), jnp.asarray(jnp.inf, jnp.float32), jnp.asarray(0))
    sx, sy, vshift, stat, it = jax.lax.while_loop(cond, step, init)
    return sx * res_x, sy * res_y, vshift, stat, it


def _nk_slope_aspect_valid(ref, tba, inlier):
    """Slope-tangent/aspect gradients and the joint valid mask for device NuthKaab paths
    (shared by the fused raster-raster program and the blockwise tile batch)."""
    # Gradients are translation-invariant: mean-center so f32 differencing stays accurate.
    ref_c = ref - jnp.nanmean(ref)
    gy, gx = jnp.gradient(ref_c)
    slope_tan = jnp.hypot(gx, gy)
    aspect = jnp.arctan2(-gx, gy) + jnp.pi
    slope_tan = jnp.where(jnp.isclose(slope_tan, 0.0), jnp.nan, slope_tan)
    valid = jnp.isfinite(ref) & jnp.isfinite(tba) & inlier & jnp.isfinite(slope_tan)
    return slope_tan, aspect, valid


def _topk_subsample(key, valid_flat, count: int):
    """Seeded fixed-size subsample without replacement: uniform scores with invalid slots
    parked at -inf, then top_k. Returns (indices, picked_valid); when count exceeds the
    valid population the overflow picks have picked_valid=False and must be NaN-poisoned."""
    scores = jnp.where(valid_flat, jax.random.uniform(key, valid_flat.shape), -jnp.inf)
    _, idx = jax.lax.top_k(scores, count)
    return idx, valid_flat[idx]


@partial(jax.jit, static_argnames=("count", "max_iterations", "n_bins", "bin_before_fit"))
@pin_f32_matmuls
def _nuth_kaab_rst_rst_device(
    ref: jnp.ndarray,
    tba: jnp.ndarray,
    inlier: jnp.ndarray,
    seed: jnp.ndarray,
    count: int,
    res_x: float,
    res_y: float,
    tolerance: float,
    max_iterations: int = 10,
    n_bins: int = 72,
    bin_before_fit: bool = True,
) -> jnp.ndarray:
    """One fused device program for raster-raster Nuth & Kaab: slope/aspect stencils, seeded
    subsampling over the joint valid mask (SURVEY §7.4), and the iterative solver — a single
    dispatch and a single result readback.

    Returns f32 [shift_x_m, shift_y_m, vshift, stat, iterations, n_valid, populated_bins].
    """
    h, w = ref.shape
    slope_tan, aspect, valid = _nk_slope_aspect_valid(ref, tba, inlier)
    n_valid = valid.sum()

    # Seeded subsample without replacement: uniform scores, invalid parked at -inf, top_k.
    # Fixed shapes keep this one compiled program per raster shape.
    idx, picked_ok = _topk_subsample(jax.random.PRNGKey(seed), valid.ravel(), count)
    rr = (idx // w).astype(jnp.float32)
    cc = (idx % w).astype(jnp.float32)
    # When count > n_valid the overflow picks land on non-valid pixels (masked-out inliers can
    # still have finite z and slope) — NaN-poison both their height (so the solver's vshift
    # median never sees them) and their slope (so the cosine fit excludes them).
    pts_z = jnp.where(picked_ok, ref.ravel()[idx], jnp.nan)
    st = jnp.where(picked_ok, slope_tan.ravel()[idx], jnp.nan)
    asp = aspect.ravel()[idx]

    # Aspect-degeneracy diagnostic: how many aspect bins are well-populated in the subsample
    sub_ok = jnp.isfinite(st)
    bin_idx = jnp.clip((asp / (2 * jnp.pi / n_bins)).astype(jnp.int32), 0, n_bins - 1)
    hist = jnp.bincount(jnp.where(sub_ok, bin_idx, n_bins), length=n_bins + 1)[:n_bins]
    populated = (hist > 10).sum()

    sx, sy, vshift, stat, it = _nuth_kaab_solve(
        pts_z, rr, cc, tba, st, asp, res_x, res_y, tolerance,
        max_iterations=max_iterations, n_bins=n_bins, invert=False,
        bin_before_fit=bin_before_fit,
    )
    return jnp.stack([
        sx, sy, vshift, stat,
        it.astype(jnp.float32), n_valid.astype(jnp.float32), populated.astype(jnp.float32),
    ])


def nuth_kaab(
    ref_elev: Any,
    tba_elev: Any,
    inlier_mask: np.ndarray | None,
    transform: Affine,
    crs: Any,
    tolerance: float,
    max_iterations: int,
    subsample: float | int,
    random_state: int | None,
    bin_before_fit: bool = True,
    n_bins: int = 72,
    z_name: str = "z",
    mesh: Any = None,
) -> tuple[tuple[float, float, float], int, int]:
    """Nuth and Kaab (2011) coregistration driver (reference affine.py:539).

    With `mesh=` (any jax.sharding.Mesh), the subsampled points are sharded across the mesh
    devices and every per-iteration statistic is computed with exact distributed medians
    (parallel/coreg.py) — the fit matches the single-device one bitwise in the default
    bin_before_fit mode. Raster-raster pairs with an absolute subsample count run the fused
    on-device subsample + solver program; point-cloud inputs and fractional subsamples draw
    the SAME host subsample as the single-device path and shard only the solver.
    """
    logging.info("Running Nuth and Kääb (2011) coregistration")
    from xdem_tpu.georef import CRS

    if crs is not None and not CRS(crs).is_projected:
        raise NotImplementedError(
            f"Nuth and Kääb coregistration needs planar (projected) coordinates, but the input CRS "
            f"is {crs}. Reproject both elevations to a local projected system first, e.g. "
            f"dem.reproject(crs=dem.get_metric_crs())."
        )

    if isinstance(ref_elev, PointCloud) and isinstance(tba_elev, PointCloud):
        raise TypeError(
            "The Nuth and Kääb (2011) coregistration does not support two point clouds, one elevation "
            "dataset in the pair must be a DEM."
        )

    res_x = transform.xres
    res_y = transform.yres

    # Raster-raster with an absolute subsample count: one fused device program (slope/aspect,
    # seeded top_k subsample, solver) — a single dispatch + readback. Fractional subsamples
    # need the valid count first and stay on the host path.
    if not isinstance(ref_elev, PointCloud) and not isinstance(tba_elev, PointCloud) and subsample > 1:
        # jnp.asarray is a no-op for device-resident arrays (a np.asarray here would force
        # a full device->host->device round trip)
        ref_arr = jnp.asarray(ref_elev, jnp.float32)
        tba_arr = jnp.asarray(tba_elev, jnp.float32)
        inlier = device_mask(inlier_mask, ref_arr.shape)  # bit-packed upload, 8x smaller
        # Shape bucketing (config["shape_bucketing"] = N): NaN/False-pad to the next bucket
        # multiple so rasters of many sizes share ONE compiled solver (the fused NuthKaab is
        # the library's costliest compile). Padded pixels
        # are invalid everywhere; only the former outer border loses its one-sided gradients
        # (those pixels become NaN-adjacent), a statistically negligible subsample change.
        from xdem_tpu.config import config as _pkg_config
        from xdem_tpu.ops.transfer import pad_to_bucket

        (ref_arr, tba_arr, inlier), _hw = pad_to_bucket(
            int(_pkg_config["shape_bucketing"]),
            (ref_arr, jnp.nan), (tba_arr, jnp.nan), (inlier, False),
        )
        # Static under jit: base it on the (possibly padded) size so every raster in a
        # bucket shares the program — overflow picks are NaN-poisoned inside the solver
        count = min(int(subsample), ref_arr.size)
        if isinstance(random_state, (int, np.integer)):
            seed = int(random_state)
        else:  # None or a np.random.Generator: draw the device seed from it
            seed = int(np.random.default_rng(random_state).integers(2**31))
        if mesh is not None:
            # SURVEY 2.7: the iterative fit data-parallel over a point-sharded mesh, with
            # exact distributed medians (bitwise-matching the single-device program)
            from xdem_tpu.parallel.coreg import nuth_kaab_rst_rst_sharded
            from xdem_tpu.parallel.mesh import as_mesh_1d

            res_dev = np.asarray(
                nuth_kaab_rst_rst_sharded(
                    ref_arr, tba_arr, inlier, np.uint32(seed), count, res_x, res_y,
                    tolerance, as_mesh_1d(mesh), max_iterations=int(max_iterations),
                    n_bins=int(n_bins), bin_before_fit=bin_before_fit,
                )
            )
        else:
            res_dev = np.asarray(
                _nuth_kaab_rst_rst_device(
                    ref_arr, tba_arr, inlier, np.uint32(seed), count, res_x, res_y, tolerance,
                    max_iterations=int(max_iterations), n_bins=int(n_bins),
                    bin_before_fit=bin_before_fit,
                )
            )
        sx, sy, vshift, _stat, it, n_valid, populated = (float(v) for v in res_dev)
        if n_valid == 0:
            raise ValueError("No valid (finite, inlier) pixels in common between the elevation data.")
        _warn_if_not_converged(int(it), int(max_iterations), _stat, tolerance, sx, sy)
        if populated < n_bins // 4:
            logging.warning(
                "Only %d/%d aspect bins are well-populated: the terrain faces few directions, so "
                "the Nuth and Kääb horizontal offsets are poorly constrained and may diverge. "
                "Use a larger extent with diverse aspects, or DhMinimize/LZD instead.",
                int(populated), n_bins,
            )
        if not (np.isfinite(sx) and np.isfinite(sy) and np.isfinite(vshift)):
            raise ValueError(
                "No valid points remain in the subsample: either the shift to correct moved the "
                "grids out of overlap, or the solver diverged. Passing subsample=1 keeps every "
                "valid pixel available at each iteration."
            )
        return (sx, sy, vshift), int(min(count, n_valid)), int(it)

    # Slope/aspect from the raster side (or the reference for raster-raster)
    grid_side = ref_elev if not isinstance(ref_elev, PointCloud) else tba_elev
    slope_tan, aspect = _grad_slope_aspect(np.asarray(grid_side))
    slope_tan[np.isclose(slope_tan, 0)] = np.nan

    sub = _subsample_pair(
        ref_elev, tba_elev, inlier_mask, transform, subsample, random_state,
        aux_vars={"slope_tan": slope_tan, "aspect": aspect}, z_name=z_name,
    )

    # Diagnose aspect degeneracy: the cosine fit needs terrain facing many directions; a
    # single-hillside extent makes the horizontal offsets ill-constrained and can diverge.
    hist, _ = np.histogram(sub["aux"]["aspect"], bins=n_bins, range=(0, 2 * np.pi))
    populated = int((hist > 10).sum())
    if populated < n_bins // 4:
        logging.warning(
            "Only %d/%d aspect bins are well-populated: the terrain faces few directions, so "
            "the Nuth and Kääb horizontal offsets are poorly constrained and may diverge. "
            "Use a larger extent with diverse aspects, or DhMinimize/LZD instead.",
            populated, n_bins,
        )

    if mesh is not None:
        # Point-cloud inputs and fractional subsamples with mesh=: the SAME host subsample
        # feeds a point-sharded solver with exact distributed medians — identical sample,
        # bitwise-equal fit in the default bin_before_fit mode (parallel/coreg.py).
        from xdem_tpu.parallel.coreg import nuth_kaab_points_sharded
        from xdem_tpu.parallel.mesh import as_mesh_1d

        res_dev = np.asarray(nuth_kaab_points_sharded(
            jnp.asarray(sub["pts_z"]),
            jnp.asarray(sub["rows"]),
            jnp.asarray(sub["cols"]),
            sub["raster"],
            jnp.asarray(sub["aux"]["slope_tan"]),
            jnp.asarray(sub["aux"]["aspect"]),
            res_x, res_y, tolerance, as_mesh_1d(mesh),
            max_iterations=int(max_iterations), n_bins=int(n_bins),
            bin_before_fit=bin_before_fit, invert=bool(sub["invert"]),
        ))
        sx, sy, vshift, _stat, it = (float(v) for v in res_dev)
    else:
        sx, sy, vshift, _stat, it = _nuth_kaab_solve(
            jnp.asarray(sub["pts_z"]),
            jnp.asarray(sub["rows"]),
            jnp.asarray(sub["cols"]),
            sub["raster"],
            jnp.asarray(sub["aux"]["slope_tan"]),
            jnp.asarray(sub["aux"]["aspect"]),
            res_x,
            res_y,
            tolerance,
            max_iterations=int(max_iterations),
            n_bins=int(n_bins),
            invert=bool(sub["invert"]),
            bin_before_fit=bin_before_fit,
        )
    if not (np.isfinite(float(sx)) and np.isfinite(float(sy)) and np.isfinite(float(vshift))):
        raise ValueError(
            "No valid points remain in the subsample: either the shift to correct moved the grids "
            "out of overlap, or the solver diverged. Passing subsample=1 keeps every valid pixel "
            "available at each iteration."
        )
    _warn_if_not_converged(int(it), int(max_iterations), float(_stat), tolerance,
                           float(sx), float(sy))
    return (float(sx), float(sy), float(vshift)), sub["count"], int(it)


# ======================================================================================
# AffineCoreg base + simple methods
# ======================================================================================


class AffineCoreg(Coreg):
    """Generic affine coregistration (reference affine.py:1786): produces a 4x4 matrix."""

    _is_affine = True

    def __init__(self, subsample: float | int = 1.0, matrix: np.ndarray | None = None,
                 meta: dict[str, Any] | None = None, initial_shift: tuple | None = None):
        super().__init__(meta=meta)
        # The kwarg wins when explicitly set; the default must not clobber meta routing
        if not (meta and "subsample" in meta and subsample == 1.0):
            self._meta["inputs"]["random"]["subsample"] = subsample
        if initial_shift is not None:
            # Validation matches the reference (affine.py:1813-1828): a 2- or 3-tuple of
            # numbers; a nonzero z component is zeroed with a warning (not yet supported)
            if not (
                isinstance(initial_shift, tuple)
                and len(initial_shift) in (2, 3)
                and all(isinstance(v, (float, int)) for v in initial_shift)
            ):
                raise ValueError(
                    "Argument `initial_shift` must be a tuple of exactly two or three numerical values."
                )
            if len(initial_shift) == 2:
                initial_shift = (*initial_shift, 0)
            elif initial_shift[2] != 0:
                initial_shift = (*initial_shift[:2], 0)
                warnings.warn(
                    "Initial shift in altitude is currently work in progress.",
                    category=UserWarning,
                )
            self._meta["inputs"]["affine"]["initial_shift"] = tuple(initial_shift)
        if matrix is not None:
            from xdem_tpu.coreg.base import _check_matrix

            self._meta["outputs"]["affine"] = {"matrix": _check_matrix(np.asarray(matrix))}
            self._fit_called = True

    @property
    def is_affine(self) -> bool:
        return True

    @classmethod
    def from_matrix(cls, matrix: np.ndarray) -> "AffineCoreg":
        return cls(matrix=matrix)  # type: ignore[call-arg]

    @classmethod
    def from_translations(cls, x_off: float = 0.0, y_off: float = 0.0, z_off: float = 0.0) -> "AffineCoreg":
        return cls.from_matrix(matrix_from_translations_rotations(t_x=x_off, t_y=y_off, t_z=z_off))

    @classmethod
    def from_rotations(cls, x_rot: float = 0.0, y_rot: float = 0.0, z_rot: float = 0.0,
                       use_degrees: bool = True) -> "AffineCoreg":
        return cls.from_matrix(matrix_from_translations_rotations(
            alpha=x_rot, beta=y_rot, gamma=z_rot, use_degrees=use_degrees))

    @property
    def centroid(self) -> tuple[float, float, float] | None:
        return self._meta["outputs"].get("affine", {}).get("centroid")


@jax.jit
def _masked_median_diff(ref: jnp.ndarray, tba: jnp.ndarray, inlier: jnp.ndarray):
    """Median of (ref - tba) over inlier+finite pixels, plus the valid count — the whole
    default VerticalShift fit as one elementwise device reduction (no gathers, no value
    readback beyond two scalars)."""
    dh = jnp.where(inlier, ref - tba, jnp.nan)
    return _masked_median(dh), jnp.isfinite(dh).sum()


def vertical_shift(
    ref_elev: Any,
    tba_elev: Any,
    inlier_mask: np.ndarray | None,
    transform: Affine,
    subsample: float | int,
    random_state: int | None,
    vshift_reduc_func: Callable[[np.ndarray], Any] = np.median,
    z_name: str = "z",
    mesh: Any = None,
) -> tuple[float, int]:
    """Vertical shift coregistration for any point-raster or raster-raster input
    (reference affine.py:721): reduce the subsampled elevation differences.

    With `mesh=`, the default full-raster median path row-shards the raster pair and the
    median is the exact distributed order statistic (bitwise equal to the single-device
    fit). Subsampled and point-cloud fits draw the SAME host subsample as the single-device
    path and shard the gathers; median reductors reduce on device (exact distributed
    median), arbitrary callables reduce on host over identical dh values.

    :return: (vertical shift in georeferenced units, final subsample count).
    """
    logging.info("Running vertical shift coregistration")
    # Default config on a raster pair (all valid pixels, median reductor): a single
    # elementwise device reduction — the subsample/gather machinery would move tens of MB
    # of values for an answer that is one scalar.
    full = isinstance(subsample, float) and subsample == 1.0
    if (full and vshift_reduc_func in (np.median, np.nanmedian)
            and not isinstance(ref_elev, PointCloud) and not isinstance(tba_elev, PointCloud)):
        inlier = device_mask(inlier_mask, tuple(np.shape(ref_elev)))
        ref_a = jnp.asarray(ref_elev, jnp.float32)
        tba_a = jnp.asarray(tba_elev, jnp.float32)
        from xdem_tpu.config import config as _pkg_config
        from xdem_tpu.ops.transfer import pad_to_bucket

        # NaN/False padding leaves the masked median EXACTLY unchanged; one compiled
        # reduction then serves every raster shape in the bucket
        (ref_a, tba_a, inlier), _hw = pad_to_bucket(
            int(_pkg_config["shape_bucketing"]),
            (ref_a, jnp.nan), (tba_a, jnp.nan), (inlier, False),
        )
        if mesh is not None:
            from xdem_tpu.parallel.coreg import masked_median_diff_sharded
            from xdem_tpu.parallel.mesh import as_mesh_1d

            med, n_valid = masked_median_diff_sharded(ref_a, tba_a, inlier, as_mesh_1d(mesh))
        else:
            med, n_valid = _masked_median_diff(ref_a, tba_a, inlier)
        res = np.asarray(jnp.stack([med.astype(jnp.float32), n_valid.astype(jnp.float32)]))
        if res[1] == 0:
            raise ValueError("No valid (finite, inlier) pixels in common between the elevation data.")
        return float(res[0]), int(res[1])
    sub = _subsample_pair(ref_elev, tba_elev, inlier_mask, transform,
                          subsample, random_state, z_name=z_name)
    if mesh is not None:
        # Point inputs / subsampled fits with mesh=: the SAME host subsample, gathers
        # sharded. Median reductors stay fully on device (exact distributed order statistic,
        # two scalars cross to the host); arbitrary callables reduce on the host over the
        # identical sharded-computed dh values.
        from xdem_tpu.parallel.coreg import dh_median_points_sharded, dh_points_sharded
        from xdem_tpu.parallel.mesh import as_mesh_1d

        m1 = as_mesh_1d(mesh)
        args = (jnp.asarray(sub["pts_z"]), jnp.asarray(sub["rows"]),
                jnp.asarray(sub["cols"]), sub["raster"])
        if vshift_reduc_func in (np.median, np.nanmedian):
            med, n_fin = dh_median_points_sharded(*args, m1, invert=bool(sub["invert"]))
            if int(n_fin) == 0:
                raise ValueError("No valid (finite, inlier) pixels in common between the elevation data.")
            return float(med), sub["count"]
        dh = np.asarray(dh_points_sharded(*args, m1, invert=bool(sub["invert"])))
    else:
        dh = np.asarray(_dh_device(jnp.asarray(sub["pts_z"]), jnp.asarray(sub["rows"]),
                                   jnp.asarray(sub["cols"]), sub["raster"], 0.0, 0.0, sub["invert"]))
    dh = dh[np.isfinite(dh)]
    return float(vshift_reduc_func(dh)), sub["count"]


class VerticalShift(AffineCoreg):
    """Vertical translation alignment (reference affine.py:2002). Default reductor: median."""

    _supports_mesh_fit = True  # fit(..., mesh=): exact distributed median (parallel/coreg.py)

    def __init__(self, vshift_reduc_func: Callable[[np.ndarray], Any] = np.median,
                 subsample: float | int = 1.0, initial_shift: tuple | None = None):
        super().__init__(subsample=subsample, initial_shift=initial_shift)
        self._meta["inputs"]["affine"]["vshift_reduc_func"] = vshift_reduc_func

    def _fit_rst_rst(self, ref_elev, tba_elev, inlier_mask, transform, crs, z_name="z",
                     mesh=None, **kwargs):
        self._fit_any(ref_elev, tba_elev, inlier_mask, transform, z_name=z_name, mesh=mesh)

    def _fit_rst_pts(self, ref_elev, tba_elev, inlier_mask, transform, crs, z_name="z",
                     mesh=None, **kwargs):
        self._fit_any(ref_elev, tba_elev, inlier_mask, transform, z_name=z_name, mesh=mesh)

    def _fit_any(self, ref_elev, tba_elev, inlier_mask, transform, z_name="z", mesh=None):
        p = self._meta["inputs"]["random"]
        vshift, count = vertical_shift(
            ref_elev, tba_elev, inlier_mask, transform, p["subsample"], p["random_state"],
            vshift_reduc_func=self._meta["inputs"]["affine"]["vshift_reduc_func"], z_name=z_name,
            mesh=mesh,
        )
        self._meta["outputs"]["affine"] = {"shift_z": vshift}
        self._meta["outputs"]["random"] = {"subsample_final": count}

    def _to_matrix_func(self) -> np.ndarray:
        m = np.eye(4)
        m[2, 3] += self._meta["outputs"]["affine"]["shift_z"]
        return m


class NuthKaab(AffineCoreg):
    """Nuth and Kaab (2011) iterative slope/aspect alignment (reference affine.py:2386)."""

    _supports_mesh_fit = True  # fit(..., mesh=): point-sharded median-exact iterations

    def __init__(
        self,
        max_iterations: int = 10,
        offset_threshold: float = 0.001,
        bin_before_fit: bool = True,
        fit_optimizer: Any = None,
        bin_sizes: int | dict[str, int] = 72,
        bin_statistic: Callable = np.nanmedian,
        subsample: int | float = 5e5,
        vertical_shift: bool = True,
        initial_shift: tuple | None = None,
    ):
        super().__init__(subsample=subsample, initial_shift=initial_shift)
        self._meta["inputs"]["iterative"] = {"max_iterations": max_iterations, "tolerance": offset_threshold}
        self._meta["inputs"]["fitorbin"] = {
            "fit_or_bin": "bin_and_fit" if bin_before_fit else "fit",
            "bin_sizes": bin_sizes,
            "bin_statistic": bin_statistic,
        }
        self.vertical_shift = vertical_shift

    def _fit_rst_rst(self, ref_elev, tba_elev, inlier_mask, transform, crs, z_name="z",
                     mesh=None, **kwargs):
        self._fit_any(ref_elev, tba_elev, inlier_mask, transform, crs, z_name=z_name, mesh=mesh)

    def _fit_rst_pts(self, ref_elev, tba_elev, inlier_mask, transform, crs, z_name="z",
                     mesh=None, **kwargs):
        self._fit_any(ref_elev, tba_elev, inlier_mask, transform, crs, z_name=z_name, mesh=mesh)

    def _fit_any(self, ref_elev, tba_elev, inlier_mask, transform, crs, z_name="z", mesh=None):
        p = self._meta["inputs"]["random"]
        fb = self._meta["inputs"]["fitorbin"]
        n_bins = fb["bin_sizes"] if isinstance(fb["bin_sizes"], int) else list(fb["bin_sizes"].values())[0]
        (easting, northing, vertical), count, n_it = nuth_kaab(
            ref_elev, tba_elev, inlier_mask, transform, crs,
            tolerance=self._meta["inputs"]["iterative"]["tolerance"],
            max_iterations=self._meta["inputs"]["iterative"]["max_iterations"],
            subsample=p["subsample"], random_state=p["random_state"],
            bin_before_fit=fb["fit_or_bin"] == "bin_and_fit", n_bins=n_bins, z_name=z_name,
            mesh=mesh,
        )
        # Sampling offsets convert to apply-translations with a sign flip (reference :2525-2528)
        self._meta["outputs"]["affine"] = {
            "shift_x": -easting,
            "shift_y": -northing,
            "shift_z": vertical * self.vertical_shift,
        }
        self._meta["outputs"]["random"] = {"subsample_final": count}
        self._meta["outputs"]["iterative"] = {"last_iteration": n_it}

    def _to_matrix_func(self) -> np.ndarray:
        m = np.eye(4)
        aff = self._meta["outputs"]["affine"]
        m[0, 3] += aff["shift_x"]
        m[1, 3] += aff["shift_y"]
        m[2, 3] += aff["shift_z"]
        return m


@jax.jit
def _nmad_dev(x: jnp.ndarray) -> jnp.ndarray:
    # Two-order-statistic medians (_masked_median), not jnp.nanmedian: the SAME formula as
    # the distributed radix selection, so a mesh= fit reproduces the single-device NM
    # trajectory bitwise (parallel/coreg.py dh_minimize_nm_sharded).
    med = _masked_median(x)
    return 1.4826 * _masked_median(jnp.abs(x - med))


def _nelder_mead_2d(f):
    """Generic 2-D Nelder-Mead as one lax.while_loop over a traced objective `f(v)`.

    Mirrors scipy's defaults (reflect/expand/contract/shrink with alpha=1, gamma=2, rho=0.5,
    sigma=0.5; xatol=fatol=1e-4; maxiter=400) starting from (1, 1) with the standard 5%
    initial simplex. Shared by the single-device DhMinimize program and the mesh-sharded one
    (where `f` reduces with distributed medians): the NM machinery itself is pure replicated
    scalar algebra, so identical objectives give bit-identical trajectories.

    Returns (x_best (2,), f_best, iterations).
    """
    x0 = jnp.asarray([1.0, 1.0], jnp.float32)
    simplex = jnp.stack([x0, x0 + jnp.asarray([0.05, 0.0], jnp.float32),
                         x0 + jnp.asarray([0.0, 0.05], jnp.float32)])
    fvals = jnp.stack([f(simplex[0]), f(simplex[1]), f(simplex[2])])

    def _sorted(s, fv):
        idx = jnp.argsort(fv)
        return s[idx], fv[idx]

    def cond(carry):
        s, fv, it = carry
        s, fv = _sorted(s, fv)
        xa = jnp.max(jnp.abs(s[1:] - s[0]))
        fa = jnp.max(jnp.abs(fv[1:] - fv[0]))
        return (it < 400) & ((xa > 1e-4) | (fa > 1e-4))

    def body(carry):
        s, fv, it = carry
        s, fv = _sorted(s, fv)
        centroid = (s[0] + s[1]) / 2.0
        xr = centroid + (centroid - s[2])
        fr = f(xr)

        def expand(args):
            s, fv = args
            xe = centroid + 2.0 * (centroid - s[2])
            fe = f(xe)
            better = fe < fr
            return (s.at[2].set(jnp.where(better, xe, xr)), fv.at[2].set(jnp.where(better, fe, fr)))

        def reflect(args):
            s, fv = args
            return (s.at[2].set(xr), fv.at[2].set(fr))

        def contract(args):
            s, fv = args
            outside = fr < fv[2]
            xc = jnp.where(outside, centroid + 0.5 * (centroid - s[2]),
                           centroid - 0.5 * (centroid - s[2]))
            fc = f(xc)
            accept = fc < jnp.where(outside, fr, fv[2])

            def accepted(args):
                s, fv = args
                return (s.at[2].set(xc), fv.at[2].set(fc))

            def shrink(args):
                # Only evaluated when the contraction is rejected (cond skips the two extra
                # objective evaluations on the common accept path)
                s, fv = args
                s_shr = jnp.stack([s[0], s[0] + 0.5 * (s[1] - s[0]), s[0] + 0.5 * (s[2] - s[0])])
                return (s_shr, jnp.stack([fv[0], f(s_shr[1]), f(s_shr[2])]))

            return jax.lax.cond(accept, accepted, shrink, (s, fv))

        s_new, fv_new = jax.lax.cond(
            fr < fv[0], expand,
            lambda args: jax.lax.cond(fr < fv[1], reflect, contract, args),
            (s, fv),
        )
        return (s_new, fv_new, it + 1)

    s, fv, it = jax.lax.while_loop(cond, body, (simplex, fvals, jnp.asarray(0)))
    s, fv = _sorted(s, fv)
    return s[0], fv[0], it


@partial(jax.jit, static_argnames=("invert",))
def _dh_minimize_nm_device(pts_z, rows, cols, raster, res_x, res_y, invert: bool):
    """Whole Nelder-Mead minimization of NMAD(dh(sx, sy)) as ONE jitted lax.while_loop
    (a host loop pays one dispatch and readback per objective call)."""
    res = jnp.asarray([res_x, res_y], jnp.float32)

    def f(v):
        return _nmad_dev(_dh_device(pts_z, rows, cols, raster, v[0] / res[0], v[1] / res[1], invert))

    x_best, f_best, it = _nelder_mead_2d(f)
    # Median dh at the optimum — part of the same dispatch (a separate jitted call costs a
    # retrace + an extra round trip)
    vshift = _masked_median(
        _dh_device(pts_z, rows, cols, raster, x_best[0] / res[0], x_best[1] / res[1], invert)
    )
    return x_best, f_best, it, vshift


def dh_minimize(
    ref_elev: Any,
    tba_elev: Any,
    inlier_mask: np.ndarray | None,
    transform: Affine,
    subsample: float | int,
    random_state: int | None,
    fit_minimizer: Any = None,
    fit_loss_func: Callable | None = None,
    z_name: str = "z",
    mesh: Any = None,
) -> tuple[tuple[float, float, float], int]:
    """Elevation-difference minimization coregistration for any point-raster or raster-raster
    input (reference affine.py:677): minimize a dispersion loss (default NMAD) of dh over a
    2-D shift. The default path runs the whole Nelder-Mead as one jitted while_loop.

    With `mesh=`, the subsampled points (same host subsample) shard across the mesh and the
    NMAD objective reduces with exact distributed medians — the default fit matches the
    single-device one bitwise (parallel/coreg.py dh_minimize_nm_sharded). Custom
    fit_minimizer/fit_loss_func paths evaluate dh through the sharded gathers and keep the
    minimizer on the host.

    :return: ((east, north, vertical) offsets in georeferenced units, final subsample count).
    """
    logging.info("Running dh minimization coregistration.")
    from scipy.optimize import minimize

    sub = _subsample_pair(ref_elev, tba_elev, inlier_mask, transform, subsample, random_state,
                          z_name=z_name)
    pts_z = jnp.asarray(sub["pts_z"])
    rows = jnp.asarray(sub["rows"])
    cols = jnp.asarray(sub["cols"])
    raster = sub["raster"]
    invert = sub["invert"]
    res_x, res_y = transform.xres, transform.yres
    mesh_1d = None
    if mesh is not None:
        from xdem_tpu.parallel.mesh import as_mesh_1d

        mesh_1d = as_mesh_1d(mesh)

    @partial(jax.jit)
    def dh_fn(sx_px, sy_px):
        # Host-minimizer paths: interp gathers sharded when a mesh is given (values are
        # per-point independent, so sharding never changes them)
        if mesh_1d is not None:
            from xdem_tpu.parallel.coreg import dh_shifted_points_sharded

            return dh_shifted_points_sharded(pts_z, rows, cols, raster, sx_px, sy_px,
                                             mesh_1d, invert=bool(invert))
        return _dh_device(pts_z, rows, cols, raster, sx_px, sy_px, invert)

    if fit_loss_func is None:
        @jax.jit
        def loss_fn(sx_px, sy_px):
            return _nmad_dev(dh_fn(sx_px, sy_px))

        def objective(v):
            return float(loss_fn(v[0] / res_x, v[1] / res_y))
    else:
        def objective(v):
            return float(fit_loss_func(np.asarray(dh_fn(v[0] / res_x, v[1] / res_y))))

    if fit_minimizer is None and fit_loss_func is None:
        # Default path: the whole Nelder-Mead runs as one jitted while_loop, vshift included
        # (a host NM pays a dispatch and readback per objective evaluation)
        if mesh_1d is not None:
            from xdem_tpu.parallel.coreg import dh_minimize_nm_sharded

            res_parts = dh_minimize_nm_sharded(pts_z, rows, cols, raster, res_x, res_y,
                                               mesh_1d, invert=bool(invert))
        else:
            res_parts = _dh_minimize_nm_device(pts_z, rows, cols, raster, res_x, res_y,
                                               bool(invert))
        res_dev = np.asarray(jnp.concatenate(
            [jnp.asarray(v).reshape(-1).astype(jnp.float32) for v in res_parts]
        ))
        offset_east = -float(res_dev[0])
        offset_north = -float(res_dev[1])
        vshift = float(res_dev[4])
    else:
        minimizer = fit_minimizer or minimize
        # Nelder-Mead struggles from exactly (0, 0) (reference :664-666)
        result = minimizer(objective, (1.0, 1.0), method="Nelder-Mead") if minimizer is minimize \
            else minimizer(objective, (1.0, 1.0))
        offset_east = -float(result.x[0])
        offset_north = -float(result.x[1])
        vshift = float(np.nanmedian(np.asarray(dh_fn(-offset_east / res_x, -offset_north / res_y))))
    return (offset_east, offset_north, vshift), sub["count"]


class DhMinimize(AffineCoreg):
    """Direct 2-D minimization of a dispersion loss of dh (reference affine.py:2667).

    The default fit runs the whole Nelder-Mead of NMAD(dh(sx, sy)) as one jitted while_loop.
    """

    _supports_mesh_fit = True  # fit(..., mesh=): point-sharded NM with distributed medians

    def __init__(self, fit_minimizer: Any = None, fit_loss_func: Callable | None = None,
                 subsample: int | float = 5e5, initial_shift: tuple | None = None):
        super().__init__(subsample=subsample, initial_shift=initial_shift)
        self._meta["inputs"]["fitorbin"] = {"fit_minimizer": fit_minimizer, "fit_loss_func": fit_loss_func}

    def _fit_rst_rst(self, ref_elev, tba_elev, inlier_mask, transform, crs, z_name="z",
                     mesh=None, **kwargs):
        self._fit_any(ref_elev, tba_elev, inlier_mask, transform, z_name=z_name, mesh=mesh)

    def _fit_rst_pts(self, ref_elev, tba_elev, inlier_mask, transform, crs, z_name="z",
                     mesh=None, **kwargs):
        self._fit_any(ref_elev, tba_elev, inlier_mask, transform, z_name=z_name, mesh=mesh)

    def _fit_any(self, ref_elev, tba_elev, inlier_mask, transform, z_name="z", mesh=None):
        p = self._meta["inputs"]["random"]
        fb = self._meta["inputs"]["fitorbin"]
        (offset_east, offset_north, vshift), count = dh_minimize(
            ref_elev, tba_elev, inlier_mask, transform, p["subsample"], p["random_state"],
            fit_minimizer=fb["fit_minimizer"], fit_loss_func=fb["fit_loss_func"], z_name=z_name,
            mesh=mesh,
        )
        self._meta["outputs"]["affine"] = {"shift_x": offset_east, "shift_y": offset_north, "shift_z": vshift}
        self._meta["outputs"]["random"] = {"subsample_final": count}

    def _to_matrix_func(self) -> np.ndarray:
        m = np.eye(4)
        aff = self._meta["outputs"]["affine"]
        m[0, 3] += aff["shift_x"]
        m[1, 3] += aff["shift_y"]
        m[2, 3] += aff["shift_z"]
        return m


# ======================================================================================
# Shared value-subsampling for EPC-based methods (ICP/CPD/LZD)
# ======================================================================================


@jax.jit
def _interp_stack_valid(arrays, rows: jnp.ndarray, cols: jnp.ndarray):
    """Bilinear-interpolate a tuple of (H, W) grids at shared point coords in one dispatch
    (the stacking and f32 casts happen IN-PROGRAM: an eager jnp.stack costs one
    broadcast_in_dim launch per grid plus a concatenate — ~5 launches).

    Returns (vals (K, N), joint finite-validity (N,) over all K grids)."""
    from xdem_tpu.ops.interp import interp_rowcol as _ir

    stack = jnp.stack([jnp.asarray(a, jnp.float32) for a in arrays])
    vals = jax.vmap(lambda a: _ir(a, rows, cols, method="linear"))(stack)
    return vals, jnp.all(jnp.isfinite(vals), axis=0)


@jax.jit
def _finite_all(arrays) -> jnp.ndarray:
    """Joint finite mask over a tuple of same-shape grids, stacked IN-PROGRAM (one
    launch; an eager jnp.stack costs a broadcast per grid + a concatenate)."""
    stack = jnp.stack([jnp.asarray(a, jnp.float32) for a in arrays])
    return jnp.all(jnp.isfinite(stack), axis=0)


@jax.jit
def _gather_flat(arrays, flat_idx: jnp.ndarray) -> jnp.ndarray:
    """Gather flat pixel indices from every grid of a tuple, stacked IN-PROGRAM."""
    stack = jnp.stack([jnp.asarray(a, jnp.float32) for a in arrays])
    return stack.reshape(stack.shape[0], -1)[:, flat_idx]


@jax.jit
def _gather_cols(vals: jnp.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
    """vals[:, idx] as one launch: eager advanced indexing on a device array issues the
    whole index-normalization chain (less/add/select_n/broadcast/gather) as ~5 separate
    dispatches."""
    return vals[:, idx]


def _subsample_pair_values(
    ref_elev: Any,
    tba_elev: Any,
    inlier_mask: np.ndarray | None,
    transform: Affine,
    subsample: float | int,
    random_state: int | None,
    aux_vars: dict[str, np.ndarray] | None = None,
):
    """Subsample to aligned (sub_ref, sub_tba, x, y, aux) value arrays at common locations.

    Mirrors reference base.py:825-905 (_preprocess_pts_rst_subsample): raster-raster samples
    both grids at the same pixels; raster-point interpolates the raster at the point coords.
    """
    rng = np.random.default_rng(random_state)
    ref_is_pts = isinstance(ref_elev, PointCloud)
    tba_is_pts = isinstance(tba_elev, PointCloud)

    if not ref_is_pts and not tba_is_pts:
        # Split grids by residence: device-resident members contribute a single joint finite
        # mask (1 byte/px) and one gather dispatch at the chosen pixels; host members are
        # indexed in numpy. Neither side crosses the host boundary at full-raster f32 size
        # (two 2048^2 rasters would be 32 MB of transfers).
        items = [("__ref__", ref_elev), ("__tba__", tba_elev)]
        items += [(k, v) for k, v in (aux_vars or {}).items()]
        dev = {k: v for k, v in items if isinstance(v, jnp.ndarray)}
        host = {k: np.asarray(v) for k, v in items if not isinstance(v, jnp.ndarray)}
        shape = items[0][1].shape
        valid = np.ones(shape, bool)
        if dev:
            valid &= np.asarray(_finite_all(tuple(dev.values())))
        for v in host.values():
            valid &= np.isfinite(v)
        if inlier_mask is not None:
            valid &= inlier_mask
        idx_flat = np.flatnonzero(valid)
        if idx_flat.size == 0:
            raise ValueError("No valid (finite, inlier) pixels in common between the elevation data.")
        count = _count_from_subsample(subsample, idx_flat.size)
        choice = rng.choice(idx_flat, count, replace=False) if count < idx_flat.size else idx_flat
        rr, cc = np.unravel_index(choice, shape)
        out: dict[str, np.ndarray] = {}
        if dev:
            gathered = np.asarray(_gather_flat(tuple(dev.values()), jnp.asarray(choice)),
                                  dtype=np.float64)
            for i, k in enumerate(dev):
                out[k] = gathered[i]
        for k, v in host.items():
            out[k] = v[rr, cc].astype(np.float64)
        x, y = transform.xy(rr, cc)
        aux = {k: out[k] for k in (aux_vars or {})}
        return out["__ref__"], out["__tba__"], x, y, aux

    pts: PointCloud = ref_elev if ref_is_pts else tba_elev
    # Keep the raster (and every interpolant) on device: the coords go up ONCE, all K grids
    # are interpolated in one dispatch, and only a 1-byte/pt validity mask plus the final
    # subsample-sized gathers cross the host boundary (not per-grid interp calls with a full
    # f64 value readback each).
    rst = jnp.asarray(tba_elev if ref_is_pts else ref_elev, jnp.float32)

    rows_f, cols_f = transform.rowcol(pts.x, pts.y)
    rows_j = jnp.asarray(np.asarray(rows_f, np.float32))
    cols_j = jnp.asarray(np.asarray(cols_f, np.float32))
    aux_keys = list(aux_vars.keys()) if aux_vars is not None else []
    # Aux grids share the raster's shape; the stack forms INSIDE the jitted interp program
    vals_dev, valid_dev = _interp_stack_valid(
        tuple([rst] + [aux_vars[k] for k in aux_keys]), rows_j, cols_j)

    valid = np.asarray(valid_dev) & np.isfinite(pts.z)
    h, w = rst.shape
    if inlier_mask is not None:
        ri = np.clip(np.round(rows_f).astype(int), 0, h - 1)
        ci = np.clip(np.round(cols_f).astype(int), 0, w - 1)
        valid &= inlier_mask[ri, ci]
    idx = np.flatnonzero(valid)
    if idx.size == 0:
        raise ValueError("No valid points overlapping the raster.")
    count = _count_from_subsample(subsample, idx.size)
    choice = rng.choice(idx, count, replace=False) if count < idx.size else idx
    sub_vals = np.asarray(_gather_cols(vals_dev, jnp.asarray(np.asarray(choice, np.int32))),
                          dtype=np.float64)
    sub_pts_z = pts.z[choice]
    sub_rst_z = sub_vals[0]
    x, y = pts.x[choice], pts.y[choice]
    aux = {k: sub_vals[1 + i] for i, k in enumerate(aux_keys)}
    sub_ref = sub_pts_z if ref_is_pts else sub_rst_z
    sub_tba = sub_rst_z if ref_is_pts else sub_pts_z
    return sub_ref, sub_tba, x, y, aux


def _standardize_epc(ref_epc: np.ndarray, tba_epc: np.ndarray, scale_std: bool = True):
    """Centroid removal + NMAD standardization of 3xN point clouds (reference affine.py:296)."""
    centroid = np.median(ref_epc, axis=1)
    ref_epc = ref_epc - centroid[:, None]
    tba_epc = tba_epc - centroid[:, None]
    if scale_std:
        def _nmad(v):
            med = np.nanmedian(v)
            return 1.4826 * np.nanmedian(np.abs(v - med))

        std_fac = np.mean([_nmad(ref_epc[0]), _nmad(ref_epc[1]), _nmad(ref_epc[2])])
    else:
        std_fac = 1.0
    return ref_epc / std_fac if scale_std else ref_epc, tba_epc / std_fac if scale_std else tba_epc, \
        (float(centroid[0]), float(centroid[1]), float(centroid[2])), float(std_fac)


def _apply_matrix_pts_mat(mat: np.ndarray, matrix: np.ndarray, invert: bool = False) -> np.ndarray:
    """Apply a 4x4 matrix to a 3xN point array."""
    if invert:
        matrix = invert_matrix(matrix)
    pts = np.vstack([mat, np.ones((1, mat.shape[1]))])
    return (np.asarray(matrix) @ pts)[:3]


# ======================================================================================
# ICP
# ======================================================================================


# Coordinate value used to pad reference clouds to block/shard multiples: squares to
# ~3e30 (finite in f32, unlike inf whose differences can go NaN) so padded points never
# win a distance argmin against any real point.
_NN_PAD_COORD = 1e15


def _nn_planes_scan(ref_pts: jnp.ndarray, rblk: int = 2048):
    """Build an ``nn(q) -> (index, d2)`` nearest-neighbor closure over a fixed reference
    cloud: direct-difference squared distances reduced blockwise with a running argmin.

    Elementwise work deliberately, NOT a matmul: at K=3 the ``|a|^2 + |b|^2 - 2 a.b``
    expansion wastes a matrix unit on a contraction of 3, materializes the (M, N) distance
    blocks in device memory, and loses ~1e-4 relative to cancellation. Separated
    per-coordinate planes keep the reference block contiguous, and XLA fuses the
    subtract/square/sum straight into the min/argmin reduce (nothing (M, N)-sized is
    written out). Per-pair d2 is computed identically however the reference
    cloud is later sharded, so per-shard results merge bitwise (parallel/coreg.py relies
    on this).

    Ties break to the LOWEST reference index (within-block argmin + strict ``<`` across
    blocks), matching a full-row argmin and the host KD-tree convention. The reference
    cloud is padded to a block multiple with ``_NN_PAD_COORD`` sentinel coordinates.
    """
    n = ref_pts.shape[0]
    padr = (-n) % rblk
    r = jnp.pad(ref_pts, ((0, padr), (0, 0)), constant_values=_NN_PAD_COORD)
    rx = r[:, 0].reshape(-1, rblk)
    ry = r[:, 1].reshape(-1, rblk)
    rz = r[:, 2].reshape(-1, rblk)
    bases = (jnp.arange(rx.shape[0]) * rblk).astype(jnp.int32)

    def nn(q):
        qx, qy, qz = q[:, 0:1], q[:, 1:2], q[:, 2:3]  # (M, 1) each

        def block_min(bx, by, bz):
            dx = qx - bx[None, :]
            dy = qy - by[None, :]
            dz = qz - bz[None, :]
            d2 = dx * dx + dy * dy + dz * dz  # (M, rblk), fused into the reduces
            return jnp.min(d2, axis=1), jnp.argmin(d2, axis=1).astype(jnp.int32)

        def step(carry, inp):
            best_d2, best_i = carry
            bx, by, bz, base = inp
            bd, bi = block_min(bx, by, bz)
            take = bd < best_d2
            return (jnp.where(take, bd, best_d2), jnp.where(take, base + bi, best_i)), None

        # Block 0 seeds the carry (equivalent to an inf init under the strict-< merge,
        # and keeps the carry's mesh-varying type when tracing inside a shard_map)
        init = block_min(rx[0], ry[0], rz[0])
        (d2b, ib), _ = jax.lax.scan(step, init, (rx[1:], ry[1:], rz[1:], bases[1:]))
        return ib, d2b

    return nn


@partial(jax.jit, static_argnames=("chunk",))
def _brute_nearest(ref_pts: jnp.ndarray, query_pts: jnp.ndarray, chunk: int = 2048):
    """Nearest reference index for each query point via the blocked direct-difference
    argmin (`_nn_planes_scan`; `chunk` is the reference block size).

    Device alternative to the host KD-tree (reference builds scipy KDTree, affine.py:1155).
    Returns (indices, distances) of shape (M,).
    """
    idx, d2 = _nn_planes_scan(ref_pts, rblk=chunk)(query_pts)
    return idx, jnp.sqrt(jnp.maximum(d2, 0.0))


def _icp_while_loop(
    ref: jnp.ndarray,
    tba: jnp.ndarray,
    norms: jnp.ndarray,
    nn,
    tolerance,
    max_iterations: int,
    method: str,
    picky: bool,
    only_translation: bool,
    n_segments: int,
):
    """The ICP iteration body shared by the single-device program and the mesh-sharded one:
    `nn(q) -> (nearest reference index, squared distance)` abstracts the neighbor search
    (full blocked argmin vs per-shard argmin merged across devices). `ref`/`norms` must be
    the FULL cloud (the post-search gathers `ref[ind]`/`norms[ind]` index globally);
    `n_segments` bounds the Picky segment-min (>= any index `nn` can return).

    Matches the host loop's semantics (reference affine.py:977-1081): transform the original
    cloud by the running matrix each iteration, compose the step estimate, stop once the
    tolerance statistic drops below `tolerance` after the second iteration.
    """
    n = n_segments
    m = tba.shape[0]

    def body(carry):
        matrix, it, _stat = carry
        tq = tba @ matrix[:3, :3].T + matrix[:3, 3]  # (M,3)
        ind, d2 = nn(tq)
        if picky:
            # Zinsser et al. (2003): one query per matched reference point — the closest,
            # ties broken to the lowest query index (pandas idxmin parity)
            dmin = jax.ops.segment_min(d2, ind, num_segments=n)
            is_min = d2 <= dmin[ind]
            qidx = jnp.arange(m)
            qmin = jax.ops.segment_min(jnp.where(is_min, qidx, m), ind, num_segments=n)
            keep = is_min & (qidx == qmin[ind])
        else:
            keep = jnp.ones(m, bool)
        w = keep.astype(jnp.float32)
        r = ref[ind]

        if method == "point-to-plane":
            nrm = norms[ind]
            B = jnp.sum((r - tq) * nrm, axis=1)
            if only_translation:
                A = nrm
            else:
                A = jnp.concatenate([jnp.cross(tq, nrm), nrm], axis=1)  # (M,6)
            Aw = A * w[:, None]
            x = jnp.linalg.solve(Aw.T @ A + 1e-8 * jnp.eye(A.shape[1], dtype=A.dtype), Aw.T @ B)
            if only_translation:
                R = jnp.eye(3, dtype=A.dtype)
                t = x
            else:
                ca, sa = jnp.cos(x[0]), jnp.sin(x[0])
                cb, sb = jnp.cos(x[1]), jnp.sin(x[1])
                cg, sg = jnp.cos(x[2]), jnp.sin(x[2])
                Rx = jnp.array([[1, 0, 0], [0, ca, -sa], [0, sa, ca]], dtype=A.dtype)
                Ry = jnp.array([[cb, 0, sb], [0, 1, 0], [-sb, 0, cb]], dtype=A.dtype)
                Rz = jnp.array([[cg, -sg, 0], [sg, cg, 0], [0, 0, 1]], dtype=A.dtype)
                R = Rz @ Ry @ Rx
                t = x[3:]
        else:
            # Point-to-point closed form (Besl & McKay via SVD of the cross-covariance)
            wsum = jnp.maximum(w.sum(), 1.0)
            mu_r = (r * w[:, None]).sum(axis=0) / wsum
            mu_t = (tq * w[:, None]).sum(axis=0) / wsum
            H = ((tq - mu_t) * w[:, None]).T @ (r - mu_r)
            U, _s, Vt = jnp.linalg.svd(H)
            d = jnp.sign(jnp.linalg.det(Vt.T @ U.T))
            R = Vt.T @ jnp.diag(jnp.array([1.0, 1.0, 0.0], H.dtype) + jnp.array([0.0, 0.0, 1.0], H.dtype) * d) @ U.T
            if only_translation:
                R = jnp.eye(3, dtype=H.dtype)
            t = mu_r - R @ mu_t

        step = jnp.eye(4, dtype=ref.dtype).at[:3, :3].set(R).at[:3, 3].set(t)
        new_matrix = step @ matrix
        stat = jnp.abs(jnp.sum(step[:3, 3]))  # reference's tolerance statistic (affine.py:1044)
        return new_matrix, it + 1, stat

    def cond(carry):
        _matrix, it, stat = carry
        return (it < max_iterations) & ((it <= 2) | (stat >= tolerance))

    matrix0 = jnp.eye(4, dtype=ref.dtype)
    matrix, it, stat = jax.lax.while_loop(cond, body, (matrix0, jnp.asarray(0), jnp.asarray(jnp.inf, ref.dtype)))
    return matrix, it, stat


@partial(jax.jit, static_argnames=("max_iterations", "method", "picky", "only_translation", "chunk"))
@pin_f32_matmuls
def _icp_solve_device(
    ref: jnp.ndarray,
    tba: jnp.ndarray,
    norms: jnp.ndarray,
    tolerance,
    max_iterations: int,
    method: str = "point-to-plane",
    picky: bool = True,
    only_translation: bool = False,
    chunk: int = 2048,
):
    """The FULL ICP iteration as one jitted lax.while_loop: blocked direct-difference
    distance argmin (`_nn_planes_scan`), Picky duplicate removal as segment-min, and the
    Low (2004) point-to-plane solve (or the Besl-McKay SVD for point-to-point) via masked
    normal equations — a single dispatch for the whole registration instead of
    per-iteration host<->device round trips.
    """
    n = ref.shape[0]
    nn = _nn_planes_scan(ref, rblk=chunk)
    return _icp_while_loop(ref, tba, norms, nn, tolerance, max_iterations, method, picky,
                           only_translation, n_segments=n)


@jax.jit
def _icp_norms_device(dem: jnp.ndarray, xres: jnp.ndarray, yres: jnp.ndarray):
    """Plane normals from DEM gradients for point-to-plane ICP (reference affine.py:1062),
    computed on device (the host version cost ~2.7 s in gradient+norm on a 2048^2 grid).

    Mirrors the reference's exact formulation, including its (gradient_x, gradient_y) naming
    of np.gradient's (d/drow, d/dcol) outputs.
    """
    gradient_x, gradient_y = jnp.gradient(dem)
    normal_east = jnp.sin(jnp.arctan(gradient_y / yres)) * -1
    normal_north = jnp.sin(jnp.arctan(gradient_x / xres))
    normal_up = 1 - jnp.hypot(normal_east, normal_north)
    return normal_east, normal_north, normal_up


def _icp_norms(dem: np.ndarray, transform: Affine) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Device-computed plane normals, returned as device arrays (gathered at the subsample)."""
    e, n, u = _icp_norms_device(jnp.asarray(dem, jnp.float32), transform.xres, transform.yres)
    return e, n, u


def _icp_fit_approx_lsq(ref: np.ndarray, tba: np.ndarray, norms: np.ndarray,
                        only_translation: bool = False) -> np.ndarray:
    """Low (2004) linearized point-to-plane least squares: x = (A^T A)^-1 A^T B with
    A = [tba x n, n] (reference affine.py:835-885)."""
    B = np.sum(ref * norms, axis=1) - np.sum(tba * norms, axis=1)
    if only_translation:
        A = norms
        x, *_ = np.linalg.lstsq(A, B, rcond=None)
        return matrix_from_translations_rotations(t_x=x[0], t_y=x[1], t_z=x[2], use_degrees=False)
    A = np.hstack((np.cross(tba, norms), norms))
    x, *_ = np.linalg.lstsq(A, B, rcond=None)
    return matrix_from_translations_rotations(
        alpha=x[0], beta=x[1], gamma=x[2], t_x=x[3], t_y=x[4], t_z=x[5], use_degrees=False
    )


def _icp_fit_minimizer_step(
    ref: np.ndarray,
    tba: np.ndarray,
    norms: np.ndarray | None,
    method: str,
    fit_minimizer: Callable,
    fit_loss_func: Any,
    only_translation: bool,
) -> np.ndarray:
    """Per-iteration rigid solve through a user-supplied scipy-style minimizer (reference
    affine.py:920-975): residuals of the 6-parameter rigid transform (3 when
    ``only_translation``) between the fixed nearest-point pairs of this iteration.

    ``ref``/``tba``/``norms`` are 3xN arrays; ``fit_minimizer`` is called as
    ``fit_minimizer(fit_func, x0, loss=fit_loss_func)`` (scipy.optimize.least_squares
    signature) and must return an object with an ``x`` attribute.
    """

    def fit_func(x: np.ndarray) -> np.ndarray:
        ts, als = (x, (0.0, 0.0, 0.0)) if only_translation else (x[:3], x[3:])
        m = matrix_from_translations_rotations(
            t_x=ts[0], t_y=ts[1], t_z=ts[2], alpha=als[0], beta=als[1], gamma=als[2],
            use_degrees=False,
        )
        trans = _apply_matrix_pts_mat(tba, matrix=m)
        if method == "point-to-plane":
            return np.sum((trans - ref) * norms, axis=0)
        return np.sqrt(np.sum((trans - ref) ** 2, axis=0))

    results = fit_minimizer(fit_func, np.zeros(3 if only_translation else 6), loss=fit_loss_func)
    x = np.asarray(results.x, dtype=np.float64)
    ts, als = (x, (0.0, 0.0, 0.0)) if only_translation else (x[:3], x[3:])
    return matrix_from_translations_rotations(
        t_x=ts[0], t_y=ts[1], t_z=ts[2], alpha=als[0], beta=als[1], gamma=als[2],
        use_degrees=False,
    )


def icp(
    ref_elev: Any,
    tba_elev: Any,
    inlier_mask: np.ndarray | None,
    transform: Affine,
    crs: Any,
    subsample: float | int,
    random_state: int | None,
    max_iterations: int = 20,
    tolerance: float = 0.01,
    method: str = "point-to-plane",
    picky: bool = True,
    only_translation: bool = False,
    standardize: bool = True,
    fit_minimizer: Any = "lsq_approx",
    fit_loss_func: Any = "linear",
    nn_method: str = "auto",
    mesh: Any = None,
) -> tuple[np.ndarray, tuple[float, float, float], int]:
    """Iterative closest point registration (reference affine.py:1084).

    Point-to-plane (Chen & Medioni) with Low (2004) linearized solve by default
    (``fit_minimizer="lsq_approx"``); point-to-point solves the Besl & McKay closed form
    (SVD). Pass a scipy-style minimizer callable (e.g. ``scipy.optimize.least_squares``,
    the reference's default) plus ``fit_loss_func`` to solve each iteration's 6-parameter
    rigid fit through it instead (reference affine.py:920-975). Neighbor search: "kdtree" =
    host KD-tree built once (reference parity), "brute" = blocked direct-difference argmin fully
    on device (see _brute_nearest); the brute device loop supports the built-in solvers only.
    The default "auto" picks brute on an accelerator backend when the minimizer is built-in
    and the pair-count fits the blocked-cdist budget (the kdtree path's per-iteration host
    NN round-trips cost ~10 dispatches each), and kdtree otherwise — in
    particular always on the CPU backend, where scipy's KD-tree wins and the reference
    parity tests pin the exact host semantics.
    `crs` is accepted for reference-signature parity: the registration runs in the projected
    coordinates the inputs already carry, so the CRS never enters the computation.

    With `mesh=`, the registration runs the brute device path with the REFERENCE cloud
    sharded across the mesh (the O(N*M) distance argmin splits; per-shard winners merge with
    the single-device tie-break) — bitwise equal to nn_method="brute" on one device. Only
    built-in minimizers shard (a callable runs on the host and cannot be traced).
    """
    if callable(fit_minimizer) and (nn_method == "brute" or mesh is not None):
        raise ValueError(
            "A custom fit_minimizer runs on the host: it cannot be traced into the "
            'nn_method="brute" device while_loop (which mesh= shards). Use '
            'nn_method="kdtree" without mesh= for a callable minimizer, or '
            'fit_minimizer="lsq_approx".'
        )
    if nn_method == "kdtree" and mesh is not None:
        # Explicit engine requests always win: refuse rather than silently reroute the
        # host KD-tree semantics onto the sharded brute path.
        raise ValueError(
            'nn_method="kdtree" runs per-iteration host KD-tree queries and cannot be '
            'sharded over a mesh. Drop mesh= to keep the kdtree path, or use '
            'nn_method="brute"/"auto" with mesh=.'
        )
    logging.info("Running ICP coregistration")
    from scipy.spatial import KDTree

    if method == "point-to-plane":
        dem_side = ref_elev if not isinstance(ref_elev, PointCloud) else tba_elev
        nx, ny, nz = _icp_norms(dem_side, transform)
        aux = {"nx": nx, "ny": ny, "nz": nz}
    else:
        aux = None

    sub_ref, sub_tba, x, y, sub_aux = _subsample_pair_values(
        ref_elev, tba_elev, inlier_mask, transform, subsample, random_state, aux_vars=aux
    )
    ref_epc = np.vstack((x, y, sub_ref))
    tba_epc = np.vstack((x, y, sub_tba))
    norms = np.vstack((sub_aux["nx"], sub_aux["ny"], sub_aux["nz"])) if aux is not None else None

    ref_epc, tba_epc, centroid, std_fac = _standardize_epc(ref_epc, tba_epc, scale_std=standardize)
    tolerance = tolerance / std_fac

    if nn_method == "auto":
        n_pts = ref_epc.shape[1]
        # Brute pays off where per-iteration host NN round-trips dominate (accelerator
        # behind ~50 ms dispatch latency) and the O(N*M) blocked cdist stays within budget:
        # N*M <= 1e10 pairwise terms and the 2048-row query chunk against all N reference
        # points <= ~1.5 GB of device memory. Deriving this bound from the device (its
        # memory and measured rates) is an open item.
        on_accel = jax.default_backend() != "cpu"
        fits = (float(n_pts) * float(tba_epc.shape[1]) <= 1e10) and (2048 * n_pts * 4 <= 1.5e9)
        nn_method = "brute" if (on_accel and not callable(fit_minimizer) and fits) else "kdtree"
        logging.info("ICP nn_method='auto' resolved to '%s' (backend=%s, %d points)",
                     nn_method, jax.default_backend(), n_pts)

    if nn_method == "brute" or mesh is not None:
        # The whole registration runs as ONE jitted while_loop on device (per-iteration host
        # KD-tree queries + pandas dedup cost a host round trip each)
        norms_dev = (
            jnp.asarray(norms.T.astype(np.float32))
            if norms is not None
            else jnp.asarray(np.zeros((ref_epc.shape[1], 3), np.float32))
        )
        if mesh is not None:
            from xdem_tpu.parallel.coreg import icp_solve_sharded
            from xdem_tpu.parallel.mesh import as_mesh_1d

            matrix_dev, n_it, _stat = icp_solve_sharded(
                jnp.asarray(ref_epc.T.astype(np.float32)),
                jnp.asarray(tba_epc.T.astype(np.float32)),
                norms_dev,
                np.float32(tolerance),
                as_mesh_1d(mesh),
                max_iterations=int(max_iterations),
                method=method,
                picky=picky,
                only_translation=only_translation,
            )
        else:
            matrix_dev, n_it, _stat = _icp_solve_device(
                jnp.asarray(ref_epc.T.astype(np.float32)),
                jnp.asarray(tba_epc.T.astype(np.float32)),
                norms_dev,
                np.float32(tolerance),
                max_iterations=int(max_iterations),
                method=method,
                picky=picky,
                only_translation=only_translation,
            )
        # f32 rotation composition drifts off orthogonality by ~1e-6; re-orthogonalize (SVD)
        matrix = _make_matrix_valid(np.asarray(matrix_dev, dtype=np.float64))
        logging.info("ICP converged in %d device iterations", int(n_it))
        matrix[:3, 3] *= std_fac
        return matrix, centroid, len(sub_ref)

    tree = KDTree(ref_epc.T)
    matrix = np.eye(4)
    for it in range(max_iterations):
        trans_tba = _apply_matrix_pts_mat(tba_epc, matrix=matrix)
        dists, ind = tree.query(trans_tba.T, k=1)
        if picky:
            # Zinsser et al. (2003): for duplicated nearest-reference indices keep the closest
            from xdem_tpu._misc import import_optional

            pd = import_optional("pandas")

            df = pd.DataFrame({"ind": ind, "dists": dists})
            ind_tba = df.groupby("ind")["dists"].idxmin().values
        else:
            ind_tba = np.arange(len(ind))
        ind_ref = ind[ind_tba]
        step_ref = ref_epc[:, ind_ref]
        step_tba = trans_tba[:, ind_tba]
        if callable(fit_minimizer):
            step_norms = norms[:, ind_ref] if norms is not None else None
            step_matrix = _icp_fit_minimizer_step(
                step_ref, step_tba, step_norms, method, fit_minimizer, fit_loss_func,
                only_translation=only_translation,
            )
        elif method == "point-to-plane":
            step_norms = norms[:, ind_ref]
            step_matrix = _icp_fit_approx_lsq(step_ref.T, step_tba.T, step_norms.T,
                                              only_translation=only_translation)
        else:
            # Point-to-point closed form (Besl & McKay via SVD of the cross-covariance)
            mu_r = step_ref.mean(axis=1, keepdims=True)
            mu_t = step_tba.mean(axis=1, keepdims=True)
            H = (step_tba - mu_t) @ (step_ref - mu_r).T
            U, _, Vt = np.linalg.svd(H)
            d = np.sign(np.linalg.det(Vt.T @ U.T))
            R = Vt.T @ np.diag([1, 1, d]) @ U.T if not only_translation else np.eye(3)
            t = (mu_r - R @ mu_t).ravel()
            step_matrix = np.eye(4)
            step_matrix[:3, :3] = R
            step_matrix[:3, 3] = t
        matrix = step_matrix @ matrix
        stat = np.sqrt(np.sum(step_matrix[:3, 3]) ** 2)
        logging.info("ICP iteration %d: tolerance statistic %.6f", it + 1, stat)
        if it > 1 and stat < tolerance:
            break

    matrix[:3, 3] *= std_fac
    return matrix, centroid, len(sub_ref)


class ICP(AffineCoreg):
    """Iterative closest point registration (reference affine.py:2107).

    Defaults: point-to-plane with Picky duplicate removal and the Low (2004) linearized solve.
    """

    _supports_mesh_fit = True  # fit(..., mesh=): reference cloud sharded over the brute path

    def __init__(
        self,
        method: Literal["point-to-point", "point-to-plane"] = "point-to-plane",
        picky: bool = True,
        only_translation: bool = False,
        fit_minimizer: Any = "lsq_approx",
        fit_loss_func: Any = "linear",
        max_iterations: int = 20,
        tolerance: float = 0.01,
        standardize: bool = True,
        subsample: float | int = 5e5,
        initial_shift: tuple | None = None,
        nn_method: Literal["auto", "kdtree", "brute"] = "auto",
    ):
        super().__init__(subsample=subsample, initial_shift=initial_shift)
        self._meta["inputs"]["specific"] = {
            "icp_method": method, "icp_picky": picky, "only_translation": only_translation,
            "standardize": standardize, "nn_method": nn_method,
        }
        self._meta["inputs"]["fitorbin"] = {"fit_minimizer": fit_minimizer, "fit_loss_func": fit_loss_func}
        self._meta["inputs"]["iterative"] = {"max_iterations": max_iterations, "tolerance": tolerance}

    def _fit_rst_rst(self, ref_elev, tba_elev, inlier_mask, transform, crs, z_name="z",
                     mesh=None, **kwargs):
        self._fit_any(ref_elev, tba_elev, inlier_mask, transform, crs, mesh=mesh)

    def _fit_rst_pts(self, ref_elev, tba_elev, inlier_mask, transform, crs, z_name="z",
                     mesh=None, **kwargs):
        self._fit_any(ref_elev, tba_elev, inlier_mask, transform, crs, mesh=mesh)

    def _fit_any(self, ref_elev, tba_elev, inlier_mask, transform, crs, mesh=None):
        p = self._meta["inputs"]["random"]
        s = self._meta["inputs"]["specific"]
        it = self._meta["inputs"]["iterative"]
        matrix, centroid, count = icp(
            ref_elev, tba_elev, inlier_mask, transform, crs,
            subsample=p["subsample"], random_state=p["random_state"],
            max_iterations=it["max_iterations"], tolerance=it["tolerance"],
            method=s["icp_method"], picky=s["icp_picky"], only_translation=s["only_translation"],
            standardize=s["standardize"], fit_minimizer=self._meta["inputs"]["fitorbin"]["fit_minimizer"],
            fit_loss_func=self._meta["inputs"]["fitorbin"]["fit_loss_func"],
            nn_method=s.get("nn_method", "auto"), mesh=mesh,
        )
        tx, ty, tz, *_ = translations_rotations_from_matrix(matrix)
        self._meta["outputs"]["affine"] = {
            "matrix": matrix, "centroid": centroid, "shift_x": tx, "shift_y": ty, "shift_z": tz,
        }
        self._meta["outputs"]["random"] = {"subsample_final": count}


# ======================================================================================
# CPD
# ======================================================================================


@partial(jax.jit, static_argnames=("only_translation",))
@pin_f32_matmuls
def _cpd_em_step(X: jnp.ndarray, Y: jnp.ndarray, TY: jnp.ndarray, weight_cpd: float,
                 sigma2: jnp.ndarray, sigma2_min: float, only_translation: bool = False):
    """One CPD expectation-maximization step on device (Myronenko & Song 2010, Fig. 2).

    The O(N*M) responsibility matrix is the device-friendly part: formed via a matmul-shaped
    pairwise squared-distance kernel. Reference affine.py:1190-1294.
    """
    N, D = X.shape
    M, _ = Y.shape
    # Pairwise squared distances via the expansion |x|^2 + |y|^2 - 2 x.y (a matmul)
    x2 = jnp.sum(X * X, axis=1)[None, :]
    t2 = jnp.sum(TY * TY, axis=1)[:, None]
    P = t2 + x2 - 2.0 * TY @ X.T  # (M, N)
    P = jnp.exp(-P / (2 * sigma2))
    Pden = jnp.sum(P, axis=0, keepdims=True)
    c = (2 * jnp.pi * sigma2) ** (D / 2) * weight_cpd / (1.0 - weight_cpd) * M / N
    Pden = jnp.clip(Pden, jnp.finfo(X.dtype).eps, None) + c
    P = P / Pden

    Pt1 = jnp.sum(P, axis=0)
    P1 = jnp.sum(P, axis=1)
    Np = jnp.sum(P1)
    PX = P @ X

    muX = jnp.sum(PX, axis=0) / Np
    muY = (P.T @ Y).sum(axis=0) / Np
    X_hat = X - muX[None, :]
    Y_hat = Y - muY[None, :]
    YPY = P1 @ jnp.sum(Y_hat * Y_hat, axis=1)
    A = X_hat.T @ P.T @ Y_hat

    if not only_translation:
        U, _, Vt = jnp.linalg.svd(A, full_matrices=True)
        C = jnp.ones((D,)).at[D - 1].set(jnp.linalg.det(U @ Vt))
        R = (U @ jnp.diag(C) @ Vt).T
    else:
        R = jnp.eye(D)
    s = 1.0
    t = muX - s * (R.T @ muY)

    trAR = jnp.trace(A @ R)
    xPx = Pt1 @ jnp.sum(X_hat * X_hat, axis=1)
    q = (xPx - 2 * s * trAR + s * s * YPY) / (2 * sigma2) + D * Np / 2 * jnp.log(sigma2)
    new_sigma2 = (xPx - s * trAR) / (Np * D)
    new_sigma2 = jnp.where(new_sigma2 <= 0, sigma2_min, new_sigma2)
    return R, t, new_sigma2, q


@partial(jax.jit, static_argnames=("only_translation", "max_iterations"))
@pin_f32_matmuls
def _cpd_solve(X, Y, weight_cpd, sigma2_init, sigma2_min, tolerance, max_iterations: int,
               only_translation: bool):
    """The full CPD EM iteration as one lax.while_loop (reference re-fits the whole transform
    each step, no compounding). Returns (R, t, iterations, degenerate_flag)."""

    def cond(c):
        R, t, s2, q, it, stat = c
        return (it < max_iterations) & ~((it > 2) & (stat < tolerance))

    def body(c):
        R, t, s2, q, it, _ = c
        # TY = R^T (y + t) for row vectors; the previous step's matrix is [R | -t], and its
        # rigid inverse is [R^T | R^T t] (no SVD needed: R is det-corrected orthonormal)
        TY = (Y + t[None, :]) @ R
        Rn, tn, s2n, qn = _cpd_em_step(X, Y, TY, weight_cpd, s2, sigma2_min,
                                       only_translation=only_translation)
        ok = jnp.all(jnp.isfinite(Rn)) & jnp.all(jnp.isfinite(tn))
        stat = jnp.abs(qn - q)
        # Degenerate EM (variance collapse): keep the previous estimate and force a stop
        return (jnp.where(ok, Rn, R), jnp.where(ok, tn, t), jnp.where(ok, s2n, s2),
                jnp.where(ok, qn, q), it + 1, jnp.where(ok, stat, -jnp.inf))

    init = (jnp.eye(3, dtype=jnp.float32), jnp.zeros(3, jnp.float32),
            jnp.asarray(sigma2_init, jnp.float32), jnp.asarray(jnp.inf, jnp.float32),
            jnp.asarray(0), jnp.asarray(jnp.inf, jnp.float32))
    R, t, s2, q, it, stat = jax.lax.while_loop(cond, body, init)
    return R, t, it, stat == -jnp.inf


def cpd(
    ref_elev: Any,
    tba_elev: Any,
    inlier_mask: np.ndarray | None,
    transform: Affine,
    crs: Any,
    subsample: float | int,
    random_state: int | None,
    weight_cpd: float = 0.0,
    max_iterations: int = 100,
    tolerance: float = 0.01,
    only_translation: bool = False,
    standardize: bool = True,
    mesh: Any = None,
) -> tuple[np.ndarray, tuple[float, float, float], int]:
    """Coherent Point Drift rigid registration (reference affine.py:1340).

    `crs` is accepted for reference-signature parity: the EM runs in the projected
    coordinates the inputs already carry, so the CRS never enters the computation.

    With `mesh=`, the reference cloud is row-sharded across the mesh and the O(N*M)
    responsibility matrix never materializes on one chip (memory per chip: M x N/n_devices)
    — the path past CPD's reference-documented subsample limit. f32-reassociation tolerance
    vs the single-device solve (~1e-4 on the transform parameters).
    """
    logging.info("Running CPD coregistration")
    sub_ref, sub_tba, x, y, _ = _subsample_pair_values(
        ref_elev, tba_elev, inlier_mask, transform, subsample, random_state
    )
    ref_epc = np.vstack((x, y, sub_ref))
    tba_epc = np.vstack((x, y, sub_tba))
    ref_epc, tba_epc, centroid, std_fac = _standardize_epc(ref_epc, tba_epc, scale_std=standardize)
    tolerance = tolerance / std_fac
    sigma2_min = tolerance / 10

    X = jnp.asarray(ref_epc.T, dtype=jnp.float32)
    Y = jnp.asarray(tba_epc.T, dtype=jnp.float32)

    # Initialize variance as mean pairwise squared distance (reference :1216-1218)
    diff2 = float(jnp.mean(jnp.sum(Y * Y, axis=1)) + jnp.mean(jnp.sum(X * X, axis=1))
                  - 2 * float(jnp.mean(Y @ jnp.mean(X, axis=0))))
    # The full EM iteration runs as ONE jitted while_loop (a host loop pays a dispatch and
    # readback per step)
    if mesh is not None:
        from xdem_tpu.parallel.cpd import cpd_solve_sharded
        from xdem_tpu.parallel.mesh import as_mesh_1d

        m1 = as_mesh_1d(mesh)
        n_dev = int(m1.devices.size)
        n_pts = X.shape[0]
        pad = (-n_pts) % n_dev
        Xp = jnp.concatenate([X, jnp.full((pad, 3), jnp.nan, jnp.float32)]) if pad else X
        R_d, t_d, it_d, degenerate = cpd_solve_sharded(
            Xp, Y, float(weight_cpd), diff2, float(sigma2_min), float(tolerance),
            int(max_iterations), bool(only_translation), m1, n_true=n_pts,
        )
    else:
        R_d, t_d, it_d, degenerate = _cpd_solve(
            X, Y, float(weight_cpd), diff2, float(sigma2_min), float(tolerance),
            int(max_iterations), bool(only_translation),
        )
    if bool(degenerate):
        logging.warning(
            "CPD EM step became degenerate (variance collapsed) at iteration %d; "
            "stopping with the previous estimate.", int(it_d),
        )
    logging.info("CPD converged in %d iterations", int(it_d))
    matrix = np.eye(4)
    matrix[:3, :3] = np.asarray(R_d, dtype=np.float64)
    matrix[:3, 3] = -np.asarray(t_d, dtype=np.float64)

    final_matrix = invert_matrix(matrix)
    final_matrix[:3, 3] *= std_fac
    return final_matrix, centroid, len(sub_ref)


class CPD(AffineCoreg):
    """Coherent Point Drift rigid registration (reference affine.py:2262)."""

    _supports_mesh_fit = True  # fit(..., mesh=): reference cloud sharded across the mesh

    def __init__(
        self,
        weight: float = 0,
        only_translation: bool = False,
        max_iterations: int = 100,
        tolerance: float = 0.01,
        standardize: bool = True,
        subsample: int | float = 5e3,
        initial_shift: tuple | None = None,
    ):
        super().__init__(subsample=subsample, initial_shift=initial_shift)
        self._meta["inputs"]["specific"] = {
            "weight_cpd": weight, "only_translation": only_translation, "standardize": standardize,
        }
        self._meta["inputs"]["iterative"] = {"max_iterations": max_iterations, "tolerance": tolerance}

    def _fit_rst_rst(self, ref_elev, tba_elev, inlier_mask, transform, crs, z_name="z",
                     mesh=None, **kwargs):
        self._fit_any(ref_elev, tba_elev, inlier_mask, transform, crs, mesh=mesh)

    def _fit_rst_pts(self, ref_elev, tba_elev, inlier_mask, transform, crs, z_name="z",
                     mesh=None, **kwargs):
        self._fit_any(ref_elev, tba_elev, inlier_mask, transform, crs, mesh=mesh)

    def _fit_any(self, ref_elev, tba_elev, inlier_mask, transform, crs, mesh=None):
        p = self._meta["inputs"]["random"]
        s = self._meta["inputs"]["specific"]
        it = self._meta["inputs"]["iterative"]
        matrix, centroid, count = cpd(
            ref_elev, tba_elev, inlier_mask, transform, crs,
            subsample=p["subsample"], random_state=p["random_state"],
            weight_cpd=s["weight_cpd"], max_iterations=it["max_iterations"], tolerance=it["tolerance"],
            only_translation=s["only_translation"], standardize=s["standardize"], mesh=mesh,
        )
        tx, ty, tz, *_ = translations_rotations_from_matrix(matrix)
        self._meta["outputs"]["affine"] = {
            "matrix": matrix, "centroid": centroid, "shift_x": tx, "shift_y": ty, "shift_z": tz,
        }
        self._meta["outputs"]["random"] = {"subsample_final": count}


# ======================================================================================
# LZD
# ======================================================================================


@jax.jit
def _lzd_eval(raster: jnp.ndarray, gradx: jnp.ndarray, grady: jnp.ndarray,
              rows: jnp.ndarray, cols: jnp.ndarray):
    """Interpolate DEM and its gradients at fractional pixel coords (device gathers)."""
    return (
        interp_rowcol(raster, rows, cols, method="linear"),
        interp_rowcol(gradx, rows, cols, method="linear"),
        interp_rowcol(grady, rows, cols, method="linear"),
    )


def _lzd_while_loop(
    raster: jnp.ndarray,
    gradx: jnp.ndarray,
    grady: jnp.ndarray,
    xc0: jnp.ndarray,
    yc0: jnp.ndarray,
    zc0: jnp.ndarray,
    cz,
    inv_transform: jnp.ndarray,
    tolerance,
    max_iterations: int,
    only_translation: bool = False,
    axis: str | None = None,
    n_total: int | None = None,
):
    """The FULL LZD iteration as one lax.while_loop: transform the points by the
    running matrix (rotation around the centroid), gather-interpolate the DEM and its
    gradients at the transformed coords, and solve the linearized 6-parameter model by
    column-equilibrated masked normal equations (the raw columns mix ~1e4 m coordinates
    with ~0.1 gradients, ill-conditioned in f32 without the scaling).

    Coordinates arrive CENTROID-CENTERED: absolute UTM eastings/northings (~1e6-1e7 m) lose
    ~0.5 m to f32 rounding, far above the method's precision. `inv_transform` is the
    6-vector (a, b, c, d, e, f) of the inverted georeferencing transform with the centroid
    folded into the constants: col = a*xc + b*yc + c, row = d*xc + e*yc + f.

    With `axis` (inside a shard_map over point shards), the 6x6 normal equations, the
    equilibration scale sums, and the valid count are psum'd across shards — f32
    reassociation differs from the single-device reduction order (documented ~1e-4 relative
    tolerance on the fitted parameters). `n_total` is the GLOBAL point count (including any
    shard padding; padded points carry NaN z so their weight is 0).
    """
    pts = jnp.stack([xc0, yc0, zc0])  # (3, N_local), centered on the centroid
    if n_total is None:
        n_total = xc0.shape[0]

    def _psum(v):
        return jax.lax.psum(v, axis) if axis is not None else v

    def body(carry):
        matrix, it, _stat, _nvalid = carry
        trans = matrix[:3, :3] @ pts + matrix[:3, 3][:, None]
        xc, yc, zc = trans
        cols = inv_transform[0] * xc + inv_transform[1] * yc + inv_transform[2]
        rows = inv_transform[3] * xc + inv_transform[4] * yc + inv_transform[5]
        z_rst = interp_rowcol(raster, rows, cols, method="linear")
        gx = interp_rowcol(gradx, rows, cols, method="linear")
        gy = interp_rowcol(grady, rows, cols, method="linear")
        dh = z_rst - (zc + cz)
        w = (jnp.isfinite(dh) & jnp.isfinite(gx) & jnp.isfinite(gy) & jnp.isfinite(zc)).astype(raster.dtype)
        dh = jnp.where(w > 0, dh, 0.0)
        gx = jnp.where(w > 0, gx, 0.0)
        gy = jnp.where(w > 0, gy, 0.0)
        # Neutralize coordinates on zero-weight points: shard padding carries NaN z,
        # which the matrix multiply above spreads into xc/yc as well (0*NaN = NaN), and
        # the rotation columns below would carry it (yc + gy*zc with gy zeroed is still
        # NaN + 0*NaN) into the psum'd equilibration scale and normal equations.
        xc = jnp.where(w > 0, xc, 0.0)
        yc = jnp.where(w > 0, yc, 0.0)
        zc = jnp.where(w > 0, zc, 0.0)
        ones = jnp.ones_like(gx)
        if only_translation:
            A = jnp.stack([-gx, -gy, ones], axis=1)
        else:
            A = jnp.stack(
                [-gx, -gy, ones, yc + gy * zc, -xc - gx * zc, gx * yc - gy * xc], axis=1
            )
        # Column equilibration keeps the f32 normal equations well-conditioned
        scale = jnp.sqrt(jnp.maximum(_psum((A * A * w[:, None]).sum(axis=0)) / n_total, 1e-12))
        As = A / scale[None, :]
        Aw = As * w[:, None]
        sol = jnp.linalg.solve(
            _psum(Aw.T @ As) + 1e-7 * jnp.eye(As.shape[1], dtype=As.dtype), _psum(Aw.T @ dh)
        ) / scale
        t = sol[:3]
        if only_translation:
            R = jnp.eye(3, dtype=raster.dtype)
        else:
            # Same extrinsic-euler composition as the host path's
            # matrix_from_translations_rotations(alpha=sol[3], beta=sol[4], gamma=sol[5])
            ca, sa = jnp.cos(sol[3]), jnp.sin(sol[3])
            cb, sb = jnp.cos(sol[4]), jnp.sin(sol[4])
            cg, sg = jnp.cos(sol[5]), jnp.sin(sol[5])
            Rx = jnp.array([[1, 0, 0], [0, ca, -sa], [0, sa, ca]], dtype=raster.dtype)
            Ry = jnp.array([[cb, 0, sb], [0, 1, 0], [-sb, 0, cb]], dtype=raster.dtype)
            Rz = jnp.array([[cg, -sg, 0], [sg, cg, 0], [0, 0, 1]], dtype=raster.dtype)
            R = Rz @ Ry @ Rx
        step = jnp.eye(4, dtype=raster.dtype).at[:3, :3].set(R).at[:3, 3].set(t)
        new_matrix = step @ matrix
        stat = jnp.abs(jnp.sum(step[:3, 3]))
        return new_matrix, it + 1, stat, _psum(w.sum())

    def cond(carry):
        _matrix, it, stat, nvalid = carry
        return (it < max_iterations) & ((it <= 2) | (stat >= tolerance)) & ((it == 0) | (nvalid > 0))

    matrix0 = jnp.eye(4, dtype=raster.dtype)
    return jax.lax.while_loop(
        cond, body,
        (matrix0, jnp.asarray(0), jnp.asarray(jnp.inf, raster.dtype), jnp.asarray(1.0, raster.dtype)),
    )


@partial(jax.jit, static_argnames=("max_iterations", "only_translation"))
@pin_f32_matmuls
def _lzd_solve_device(
    raster: jnp.ndarray,
    gradx: jnp.ndarray,
    grady: jnp.ndarray,
    xc0: jnp.ndarray,
    yc0: jnp.ndarray,
    zc0: jnp.ndarray,
    cz,
    inv_transform: jnp.ndarray,
    tolerance,
    max_iterations: int,
    only_translation: bool = False,
):
    """Single-device jitted LZD program (one dispatch); see _lzd_while_loop."""
    return _lzd_while_loop(raster, gradx, grady, xc0, yc0, zc0, cz, inv_transform,
                           tolerance, max_iterations, only_translation=only_translation)


def lzd(
    ref_elev: Any,
    tba_elev: Any,
    inlier_mask: np.ndarray | None,
    transform: Affine,
    crs: Any,
    subsample: float | int,
    random_state: int | None,
    max_iterations: int = 200,
    tolerance: float = 0.01,
    only_translation: bool = False,
    mesh: Any = None,
) -> tuple[np.ndarray, tuple[float, float, float], int]:
    """Least Z-difference coregistration, Rosenholm & Torlegard 1988 (reference affine.py:1680).

    The linearized model lambda = t3 - x*a2 + y*a1 - gradx*(t1 - y*a3 + z*a2)
    - grady*(t2 + x*a3 - z*a1) is LINEAR in the 6 parameters, so each iteration is a direct
    least-squares solve on device-gathered dh/gradients (no scipy optimizer needed).

    With `mesh=`, the subsampled points (same host subsample) shard across the mesh and each
    iteration's 6x6 normal equations are psum'd partial sums — a documented ~1e-4 relative
    f32-reassociation tolerance on the fitted parameters vs the single-device program.
    """
    logging.info("Running LZD coregistration")
    from xdem_tpu.georef import CRS

    if crs is not None and not CRS(crs).is_projected:
        raise NotImplementedError(
            f"LZD coregistration needs planar (projected) coordinates, but the input CRS is {crs}. "
            f"Reproject to a local projected system first."
        )
    if isinstance(ref_elev, PointCloud) and isinstance(tba_elev, PointCloud):
        raise TypeError("The LZD coregistration does not support two point clouds.")

    ref_is_pts = isinstance(ref_elev, PointCloud)
    # Gradients on device: a host np.gradient plus re-upload would move full rasters both
    # ways
    raster_j = jnp.asarray(tba_elev if ref_is_pts else ref_elev, dtype=jnp.float32)
    gy_j, gx_j = jnp.gradient(raster_j)
    gradx_j = gx_j / transform.xres
    grady_j = -gy_j / transform.yres  # raster Y axis is inverted

    sub_ref, sub_tba, x, y, _ = _subsample_pair_values(
        ref_elev, tba_elev, inlier_mask, transform, subsample, random_state
    )
    # The point side moves; the raster side is interpolated at transformed coords
    sub_pts = sub_ref if ref_is_pts else sub_tba

    centroid = (float(np.nanmean(x)), float(np.nanmean(y)), float(np.nanmean(sub_pts)))

    # The whole iteration runs as ONE jitted while_loop on device: transform points, gather
    # DEM/gradient interpolants, solve the linear 6-parameter model, compose — a per-iteration
    # host loop costs several round trips each.
    inv = transform.invert()
    cx, cy, cz = centroid
    # Fold the centroid into the inverse-transform constants (f64 on host) so the device
    # works entirely in small centered coordinates: col = a*xc + b*yc + cc, row = d*xc + ...
    cc = inv.a * cx + inv.b * cy + inv.c - 0.5
    cf = inv.d * cx + inv.e * cy + inv.f - 0.5
    lzd_args = (
        raster_j, gradx_j, grady_j,
        jnp.asarray(np.asarray(x - cx, np.float32)),
        jnp.asarray(np.asarray(y - cy, np.float32)),
        jnp.asarray(np.asarray(sub_pts - cz, np.float32)),
        jnp.float32(cz),
        jnp.asarray(np.asarray([inv.a, inv.b, cc, inv.d, inv.e, cf], np.float32)),
        jnp.float32(tolerance),
    )
    if mesh is not None:
        from xdem_tpu.parallel.coreg import lzd_solve_sharded
        from xdem_tpu.parallel.mesh import as_mesh_1d

        matrix_dev, n_it, stat_dev, nvalid = lzd_solve_sharded(
            *lzd_args, as_mesh_1d(mesh),
            max_iterations=int(max_iterations),
            only_translation=only_translation,
        )
    else:
        matrix_dev, n_it, stat_dev, nvalid = _lzd_solve_device(
            *lzd_args,
            max_iterations=int(max_iterations),
            only_translation=only_translation,
        )
    if float(nvalid) == 0.0:
        raise ValueError(
            "The subsample contains no more valid values. This can happen if the affine transformation "
            "to correct is larger than the data extent, or if the algorithm diverged."
        )
    # f32 rotation composition drifts off orthogonality by ~1e-6; re-orthogonalize (SVD)
    matrix = _make_matrix_valid(np.asarray(matrix_dev, dtype=np.float64))
    logging.info("LZD converged in %d device iterations (statistic %.6f)", int(n_it), float(stat_dev))

    if ref_is_pts:
        matrix = invert_matrix(matrix)
    return matrix, centroid, len(sub_pts)


class LZD(AffineCoreg):
    """Least Z-difference coregistration (reference affine.py:2544)."""

    _supports_mesh_fit = True  # fit(..., mesh=): psum'd 6x6 normal equations per iteration

    def __init__(
        self,
        only_translation: bool = False,
        fit_minimizer: Any = None,
        fit_loss_func: Any = "linear",
        max_iterations: int = 200,
        tolerance: float = 0.01,
        subsample: float | int = 5e5,
        initial_shift: tuple | None = None,
    ):
        super().__init__(subsample=subsample, initial_shift=initial_shift)
        self._meta["inputs"]["specific"] = {"only_translation": only_translation}
        self._meta["inputs"]["iterative"] = {"max_iterations": max_iterations, "tolerance": tolerance}

    def _fit_rst_rst(self, ref_elev, tba_elev, inlier_mask, transform, crs, z_name="z",
                     mesh=None, **kwargs):
        self._fit_any(ref_elev, tba_elev, inlier_mask, transform, crs, mesh=mesh)

    def _fit_rst_pts(self, ref_elev, tba_elev, inlier_mask, transform, crs, z_name="z",
                     mesh=None, **kwargs):
        self._fit_any(ref_elev, tba_elev, inlier_mask, transform, crs, mesh=mesh)

    def _fit_any(self, ref_elev, tba_elev, inlier_mask, transform, crs, mesh=None):
        p = self._meta["inputs"]["random"]
        s = self._meta["inputs"]["specific"]
        it = self._meta["inputs"]["iterative"]
        matrix, centroid, count = lzd(
            ref_elev, tba_elev, inlier_mask, transform, crs,
            subsample=p["subsample"], random_state=p["random_state"],
            max_iterations=it["max_iterations"], tolerance=it["tolerance"],
            only_translation=s["only_translation"], mesh=mesh,
        )
        tx, ty, tz, *_ = translations_rotations_from_matrix(matrix)
        self._meta["outputs"]["affine"] = {
            "matrix": matrix, "centroid": centroid, "shift_x": tx, "shift_y": ty, "shift_z": tz,
        }
        self._meta["outputs"]["random"] = {"subsample_final": count}
