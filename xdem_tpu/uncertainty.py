"""Uncertainty estimation pipeline: heteroscedasticity + spatial correlation of dh errors.

Backend for DEM.estimate_uncertainty (reference /root/reference/xdem/dem.py:667-780):
  * H2022 (default): heteroscedasticity modelled from terrain variables by N-D binning +
    multi-range variogram of the standardized dh (Hugonnet et al., 2022).
  * R2009: constant error (NMAD of stable dh) + multi-range variogram (Rolstad et al., 2009).
  * Basic: NMAD + single-range variogram.
Defaults: vars ("slope", "max_curvature"), models ("gaussian", "spherical"), sqrt(2) division
for a same-precision pair (reference dem.py:735-736).

``other_elev`` may also be an elevation point cloud (PointCloud/EPC, or a DataFrame with
x/y columns and the elevation in column ``z_name`` — the geodataframe analog of reference
dem.py:725-731): dh is then evaluated at the point coordinates against the interpolated DEM,
the heteroscedasticity is binned against the terrain variables interpolated at the points,
and the variogram is sampled from the explicit point coordinates.
"""

from __future__ import annotations

import warnings
from typing import Any, Callable, Literal, Sequence

import numpy as np

from xdem_tpu import spatialstats, terrain
from xdem_tpu.raster import Raster


def _point_stable_mask(stable_terrain: Any, dem: Raster, x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Per-point stable mask: boolean array of len(points), a raster mask sampled at the
    points (nearest pixel), or a Vector rasterized on the DEM grid then sampled."""
    from xdem_tpu.vector import Vector

    if stable_terrain is None:
        return np.ones(len(x), dtype=bool)
    if isinstance(stable_terrain, Vector):
        grid_mask = stable_terrain.create_mask(dem)
    elif isinstance(stable_terrain, Raster):
        if stable_terrain.shape != dem.shape or not stable_terrain.transform.almost_equals(dem.transform):
            raise ValueError(
                "A Raster stable_terrain must live on the DEM's grid (shape "
                f"{stable_terrain.shape} vs {dem.shape}); reproject it onto the DEM first."
            )
        grid_mask = np.asarray(stable_terrain.data) > 0
    else:
        if isinstance(stable_terrain, np.ma.MaskedArray):
            stable_terrain = stable_terrain.filled(False)  # masked slots are not stable
        m = np.asarray(stable_terrain)
        if m.shape == (len(x),):
            return m.astype(bool)
        if m.shape == dem.shape:
            grid_mask = m.astype(bool)
        else:
            raise ValueError(
                "stable_terrain for point input must be per-point booleans, a mask on the "
                f"DEM grid, a Raster or a Vector (got shape {m.shape})."
            )
    rows, cols = dem.transform.rowcol(np.asarray(x), np.asarray(y))
    # rowcol is center-convention fractional: nearest center = containing pixel
    rows = np.clip(np.round(rows).astype(int), 0, dem.height - 1)
    cols = np.clip(np.round(cols).astype(int), 0, dem.width - 1)
    return grid_mask[rows, cols]


def _point_xyz(other_elev: Any, dem: Raster, z_name: str) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Extract (x, y, z) in the DEM's CRS from a PointCloud/EPC or x/y/z_name DataFrame."""
    from xdem_tpu.pointcloud import PointCloud

    if isinstance(other_elev, PointCloud):
        pc = other_elev.to_crs(dem.crs) if other_elev.crs != dem.crs else other_elev
        return pc.x, pc.y, pc.z
    if not hasattr(other_elev, "columns"):
        # Reference dem.py:733 raises the same class for unsupported input types
        raise TypeError(
            "Other elevation should be a DEM/Raster, an elevation point cloud "
            "(EPC/PointCloud), or a dataframe with x/y columns and elevation in "
            f"z_name (got {type(other_elev).__name__})."
        )
    # DataFrame-like with named columns (the reference's geodataframe analog)
    cols = {c.lower(): c for c in other_elev.columns}
    if z_name not in other_elev.columns:
        raise ValueError(f"Point elevation column {z_name!r} not found in the dataframe.")
    xcol = cols.get("x") or cols.get("e") or cols.get("easting")
    ycol = cols.get("y") or cols.get("n") or cols.get("northing")
    if xcol is None or ycol is None:
        raise ValueError("Point dataframe needs x/y (or E/N) coordinate columns.")
    return (np.asarray(other_elev[xcol], np.float64),
            np.asarray(other_elev[ycol], np.float64),
            np.asarray(other_elev[z_name], np.float64))


def estimate_uncertainty(
    dem: Raster,
    other_elev: Any,
    stable_terrain: Any = None,
    approach: Literal["H2022", "R2009", "Basic"] = "H2022",
    precision_of_other: Literal["finer", "same"] = "finer",
    spread_estimator: Callable[[np.ndarray], float] | None = None,
    variogram_estimator: str = "dowd",
    list_vars: Sequence[str] = ("slope", "max_curvature"),
    list_vario_models: Sequence[str] = ("gaussian", "spherical"),
    z_name: str = "z",
    subsample: int = 1000,
    random_state: int | None = None,
    mesh: Any = None,
) -> tuple[Raster, Callable[[np.ndarray], np.ndarray]]:
    """Estimate (sigma(x, y) raster, rho(lag) function) of the elevation differences.

    :param dem: The DEM whose uncertainty is estimated.
    :param other_elev: An independent elevation dataset overlapping the DEM — a Raster, or
        an elevation point cloud (PointCloud/EPC or a DataFrame with x/y + ``z_name``).
    :param stable_terrain: Stable-terrain mask (boolean array, Raster mask or Vector; for
        point input, alternatively per-point booleans).
    :param approach: "H2022", "R2009" or "Basic".
    :param precision_of_other: "finer" attributes all error to this DEM; "same" divides the
        pair error by sqrt(2).
    :param spread_estimator: Statistical-dispersion estimator (defaults to the NMAD,
        reference dem.py:700).
    :param variogram_estimator: Empirical-variogram estimator ("matheron", "cressie",
        "genton" or "dowd"; reference dem.py:702).
    :param z_name: Elevation column name, used for dataframe point input only.
    :param mesh: A jax.sharding.Mesh to run the pipeline multi-chip: terrain attributes via
        halo-sharded stencils, the error-raster evaluation row-sharded, and the variogram
        runs sharded with psum'd bin reductions (mesh-invariant-exact; SURVEY 2.7 P4).
        Raster input only (point variograms sample explicit coordinate pairs).
    """
    if spread_estimator is None:
        spread_estimator = spatialstats._stat_nmad

    if not isinstance(other_elev, Raster):
        return _estimate_uncertainty_points(
            dem, other_elev, stable_terrain=stable_terrain, approach=approach,
            precision_of_other=precision_of_other, spread_estimator=spread_estimator,
            variogram_estimator=variogram_estimator, list_vars=list_vars,
            list_vario_models=list_vario_models, z_name=z_name, subsample=subsample,
            random_state=random_state, mesh=mesh,
        )

    # Difference on the common grid
    other = other_elev.reproject(dem) if (
        other_elev.shape != dem.shape or not other_elev.transform.almost_equals(dem.transform)
    ) else other_elev
    dh = Raster((other.data - dem.data), dem.transform, dem.crs)

    if approach == "H2022":
        attrs = terrain.get_terrain_attribute(dem, list(list_vars), mesh=mesh)
        if not isinstance(attrs, list):
            attrs = [attrs]
        # Upload the stable mask ONCE (bit-packed) and let both stages reuse the
        # device-resident copy instead of uploading the raw bool mask twice
        stable_terrain = spatialstats._device_mask_of(stable_terrain, dh)
        # Bin the spread on at most 5e6 stable samples (identical statistics, tractable at
        # 1e8-pixel rasters); the error raster is still evaluated over the full extent.
        sig_dh, _df, _err_fun = spatialstats.infer_heteroscedasticity_from_stable(
            dvalues=dh,
            list_var=attrs,
            list_var_names=list(list_vars),
            stable_mask=stable_terrain,
            spread_statistic=spread_estimator,
            subsample=5_000_000,
            random_state=random_state,
            mesh=mesh,
        )
        emp, params, rho = spatialstats.infer_spatial_correlation_from_stable(
            dvalues=dh,
            list_models=list(list_vario_models),
            stable_mask=stable_terrain,
            errors=sig_dh,
            estimator=variogram_estimator,
            subsample=subsample,
            random_state=random_state,
            mesh=mesh,
        )
    elif approach == "R2009":
        arr, _ = spatialstats._preprocess_values_with_mask_to_array(dh, include_mask=stable_terrain)
        # Like the reference (dem.py:760: dh[stable_terrain]), hand the estimator only the
        # finite stable values so non-NaN-aware estimators (np.std, ...) work too
        sigma = spread_estimator(arr[np.isfinite(arr)])
        sig_dh = Raster(np.full(dem.shape, sigma, dtype=np.float32), dem.transform, dem.crs)
        emp, params, rho = spatialstats.infer_spatial_correlation_from_stable(
            dvalues=dh,
            list_models=list(list_vario_models),
            stable_mask=stable_terrain,
            estimator=variogram_estimator,
            subsample=subsample,
            random_state=random_state,
            mesh=mesh,
        )
    elif approach == "Basic":
        arr, _ = spatialstats._preprocess_values_with_mask_to_array(dh, include_mask=stable_terrain)
        sigma = spread_estimator(arr[np.isfinite(arr)])
        sig_dh = Raster(np.full(dem.shape, sigma, dtype=np.float32), dem.transform, dem.crs)
        emp, params, rho = spatialstats.infer_spatial_correlation_from_stable(
            dvalues=dh,
            list_models=_single_range_models(list_vario_models),
            stable_mask=stable_terrain,
            estimator=variogram_estimator,
            subsample=subsample,
            random_state=random_state,
            mesh=mesh,
        )
    else:
        raise ValueError(f"Unknown uncertainty approach: {approach} (use 'H2022', 'R2009' or 'Basic').")

    # For a same-precision pair, each DEM contributes half the error variance
    if precision_of_other == "same":
        sig_dh = Raster(sig_dh.data / np.float32(np.sqrt(2)), sig_dh.transform, sig_dh.crs)

    return sig_dh, rho


def _single_range_models(list_vario_models: Sequence[str] | str) -> list[str]:
    """The 'Basic' approach uses a single correlation range: keep only the FIRST model,
    warning like the reference (dem.py:762-768) when several were passed."""
    if isinstance(list_vario_models, str):
        return [list_vario_models]
    models = list(list_vario_models)
    if len(models) > 1:
        warnings.warn(
            "Several variogram models passed but this approach uses a single range, "
            "keeping only the first model.",
            category=UserWarning,
        )
    return models[:1]


def _estimate_uncertainty_points(
    dem: Raster,
    other_elev: Any,
    stable_terrain: Any,
    approach: str,
    precision_of_other: str,
    spread_estimator: Callable[[np.ndarray], float],
    variogram_estimator: str,
    list_vars: Sequence[str],
    list_vario_models: Sequence[str],
    z_name: str,
    subsample: int,
    random_state: int | None,
    mesh: Any,
) -> tuple[Raster, Callable[[np.ndarray], np.ndarray]]:
    """Point-cloud branch: dh at the point coordinates, variogram over explicit coords.

    The reference's geodataframe branch (dem.py:725-731) computes the point dh the same way;
    its downstream binning/variogram steps assume raster shapes, so this path is designed
    for points end-to-end instead: terrain variables are interpolated at the points for the
    binning, and the empirical variogram runs on the explicit coordinate pairs.
    """
    if mesh is not None:
        raise ValueError(
            "mesh= supports the raster pipeline (halo-sharded stencils + grid-mode "
            "variogram runs); point-cloud uncertainty samples explicit coordinate pairs on "
            "one device. Pass a Raster other_elev to run multi-chip."
        )
    x, y, z = _point_xyz(other_elev, dem, z_name)
    dh_pts = z - np.asarray(dem.interp_points((x, y)), np.float64)
    stable = _point_stable_mask(stable_terrain, dem, x, y) & np.isfinite(dh_pts)
    if stable.sum() < 10:
        raise ValueError("Too few stable, finite points to estimate uncertainty.")
    dh_stable = np.where(stable, dh_pts, np.nan)
    coords = np.column_stack([x, y]).astype(np.float64)
    gsd = float(dem.res[0])

    if approach == "H2022":
        attrs = terrain.get_terrain_attribute(dem, list(list_vars))
        if not isinstance(attrs, list):
            attrs = [attrs]
        var_pts = [np.asarray(a.interp_points((x, y)), np.float64) for a in attrs]
        _sig_pts, _df, err_fun = spatialstats.infer_heteroscedasticity_from_stable(
            dvalues=dh_stable,
            list_var=var_pts,
            list_var_names=list(list_vars),
            spread_statistic=spread_estimator,
            subsample=None,
        )
        # Evaluate the fitted error function over the full DEM grid for the sigma raster
        sig_arr = err_fun(*[a.get_nanarray() for a in attrs]).astype(np.float32)
        sig_dh = Raster(sig_arr, dem.transform, dem.crs)
        err_pts = err_fun(*var_pts)
        emp, params, rho = spatialstats.infer_spatial_correlation_from_stable(
            dvalues=dh_stable,
            list_models=list(list_vario_models),
            errors=err_pts,
            estimator=variogram_estimator,
            gsd=gsd,
            coords=coords,
            subsample=subsample,
            random_state=random_state,
        )
    elif approach in ("R2009", "Basic"):
        sigma = spread_estimator(dh_stable[np.isfinite(dh_stable)])
        sig_dh = Raster(np.full(dem.shape, sigma, dtype=np.float32), dem.transform, dem.crs)
        models = (list(list_vario_models) if approach == "R2009"
                  else _single_range_models(list_vario_models))
        emp, params, rho = spatialstats.infer_spatial_correlation_from_stable(
            dvalues=dh_stable,
            list_models=models,
            estimator=variogram_estimator,
            gsd=gsd,
            coords=coords,
            subsample=subsample,
            random_state=random_state,
        )
    else:
        raise ValueError(f"Unknown uncertainty approach: {approach} (use 'H2022', 'R2009' or 'Basic').")

    if precision_of_other == "same":
        sig_dh = Raster(sig_dh.data / np.float32(np.sqrt(2)), sig_dh.transform, sig_dh.crs)
    return sig_dh, rho
