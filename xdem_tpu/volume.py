"""Volume change: hypsometric binning, interpolation, area/volume, and gap-filling.

Reference parity: /root/reference/xdem/volume.py — hypsometric_binning (:43),
interpolate_hypsometric_bins (:131), fit_hypsometric_bins_poly (:183),
calculate_hypsometry_area (:239), idw_interpolation (:302), hypsometric_interpolation (:353),
local_hypsometric_interpolation (:407), get_regional_hypsometric_signal (:568),
norm_regional_hypsometric_interpolation (:668).
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Any, Callable, Literal, Sequence

import warnings

import numpy as np

from xdem_tpu._misc import import_optional
from xdem_tpu.ops.transfer import unmask
from xdem_tpu.raster import Raster

if TYPE_CHECKING:
    import pandas as pd


def _nmad(x: np.ndarray) -> float:
    med = np.nanmedian(x)
    return float(1.4826 * np.nanmedian(np.abs(x - med)))


def hypsometric_binning(
    ddem: np.ndarray,
    ref_dem: np.ndarray,
    bins: float | np.ndarray = 50.0,
    kind: Literal["fixed", "count", "quantile", "custom"] = "fixed",
    aggregation_function: Callable[[np.ndarray], float] = np.median,
) -> pd.DataFrame:
    """Bin dh by reference elevation; returns a DataFrame indexed by elevation intervals.

    :param ddem: Elevation differences (same shape as ref_dem), NaN = nodata.
    :param ref_dem: Reference elevations.
    :param bins: Bin size (fixed), number of bins (count), count per bin (quantile), or edges.
    :param kind: Binning strategy.
    :param aggregation_function: Statistic per bin (default median).

    >>> import numpy as np
    >>> ref = np.repeat(np.arange(4.0), 4).reshape(4, 4) * 100
    >>> dh = np.ones((4, 4)) * np.arange(4)[:, None]
    >>> df = hypsometric_binning(dh, ref, bins=100.0)
    >>> list(df["value"])
    [0.0, 1.0, 2.0, 3.0]
    """
    pd = import_optional("pandas")
    # Device fast path for the default median statistic on large / device-resident inputs:
    # segment-sort binned medians in one dispatch (f32 binning; a boundary pixel within
    # f32 eps of a bin edge may take the neighboring bin vs the host f64 path)
    ddem, ref_dem = unmask(ddem), unmask(ref_dem)
    if _wants_device(ddem, ref_dem, stat_ok=aggregation_function in (np.median, np.nanmedian)):
        import jax.numpy as jnp

        ref_j = jnp.ravel(jnp.asarray(ref_dem, jnp.float32))
        dh_j = jnp.ravel(jnp.asarray(ddem, jnp.float32))
        if isinstance(bins, np.ndarray) or kind == "custom":
            zbins = np.asarray(bins, dtype=np.float64)
        elif kind == "fixed":
            lo, hi = float(jnp.nanmin(ref_j)), float(jnp.nanmax(ref_j))
            zbins = np.arange(lo, hi + bins + 1e-6, step=bins)
        elif kind == "count":
            lo, hi = float(jnp.nanmin(ref_j)), float(jnp.nanmax(ref_j))
            zbins = np.linspace(lo, hi + 1e-6 / bins, num=int(bins) + 1)
        elif kind == "quantile":
            qs = np.linspace(0, 100, int(bins) + 1)
            zbins = np.asarray(jnp.nanpercentile(ref_j, jnp.asarray(qs)), np.float64)
            zbins[-1] += 1e-6
        else:
            raise ValueError(f"Invalid bin kind: {kind}")
        values, counts = _hypso_bin_device(dh_j, ref_j, zbins)
        return pd.DataFrame({"value": values, "count": counts},
                            index=pd.IntervalIndex.from_breaks(zbins))

    ddem = np.asarray(ddem, dtype=np.float64).ravel()
    ref = np.asarray(ref_dem, dtype=np.float64).ravel()
    # Bin edges are derived from ALL valid reference pixels (reference volume.py:70-74):
    # ddem nodata only excludes pairs from the aggregation, not from the elevation range.
    ref_ok = np.isfinite(ref)
    ref = ref[ref_ok]
    ddem = ddem[ref_ok]

    if isinstance(bins, np.ndarray) or kind == "custom":
        zbins = np.asarray(bins, dtype=np.float64)
    elif kind == "fixed":
        zbins = np.arange(ref.min(), ref.max() + bins + 1e-6, step=bins)
    elif kind == "count":
        zbins = np.linspace(ref.min(), ref.max() + 1e-6 / bins, num=int(bins) + 1)
    elif kind == "quantile":
        # `bins` equal-count bins via percentiles (reference :83-88)
        zbins = np.percentile(ref, np.linspace(0, 100, int(bins) + 1))
        zbins[-1] += 1e-6
    else:
        raise ValueError(f"Invalid bin kind: {kind}")

    indices = np.digitize(ref, zbins, right=False)
    values = np.full(len(zbins) - 1, np.nan)
    counts = np.zeros(len(zbins) - 1, dtype=int)
    for i in range(1, len(zbins)):
        vals_in = ddem[indices == i]
        vals_in = vals_in[np.isfinite(vals_in)]
        counts[i - 1] = vals_in.size
        if vals_in.size > 0:
            # NOTE: the reference assigns bin i's statistic to row i-1 (volume.py:116-117),
            # rotating every value down one interval (the lowest bin wraps into the last
            # row). We align values with their intervals instead of replicating the bug.
            values[i - 1] = aggregation_function(vals_in)

    return pd.DataFrame(
        {"value": values, "count": counts},
        index=pd.IntervalIndex.from_breaks(zbins),
    )


def interpolate_hypsometric_bins(
    hypsometric_bins: pd.DataFrame,
    value_column: str = "value",
    method: str = "polynomial",
    order: int = 3,
    count_threshold: int | None = None,
) -> pd.DataFrame:
    """Interpolate NaN (or under-populated) bins from their neighbors (reference volume.py:131)."""
    bins = hypsometric_bins.copy()
    bins.index = bins.index.mid
    if count_threshold is not None:
        assert "count" in hypsometric_bins.columns
        under = bins["count"] < count_threshold
        bins.loc[under, value_column] = np.nan
    nvalids = int(np.count_nonzero(np.isfinite(bins[value_column])))
    if nvalids <= order + 1:
        warnings.warn("Not enough valid bins for interpolation -> returning copy", UserWarning)
        return hypsometric_bins.copy()
    bins[value_column] = bins[value_column].interpolate(method=method, order=order, limit_direction="both")
    if count_threshold is not None:
        # Excluded-but-measured bins keep their original values (reference :174-175)
        bins.loc[under, value_column] = hypsometric_bins.loc[under.values, value_column].values
    bins.index = hypsometric_bins.index
    return bins


def fit_hypsometric_bins_poly(
    hypsometric_bins: pd.DataFrame,
    value_column: str = "value",
    degree: int = 3,
    iterations: int = 1,
    count_threshold: int | None = None,
) -> pd.DataFrame:
    """Iterative 3-sigma-clipped polynomial fit over bin midpoints (reference volume.py:183)."""
    bins = hypsometric_bins.copy()
    mids = hypsometric_bins.index.mid.values.astype(np.float64)
    vals = bins[value_column].values.astype(np.float64)
    if count_threshold is not None:
        vals = np.where(bins["count"].values < count_threshold, np.nan, vals)

    keep = np.isfinite(vals)
    coefs = None
    for _ in range(iterations):
        if keep.sum() < degree + 1:
            break
        coefs = np.polyfit(mids[keep], vals[keep], deg=degree)
        resid = vals - np.polyval(coefs, mids)
        sigma = np.nanstd(resid[keep])
        new_keep = keep & (np.abs(resid) < 3 * sigma)
        if new_keep.sum() == keep.sum():
            keep = new_keep
            break
        keep = new_keep
    if coefs is None:
        raise ValueError("Not enough valid bins for polynomial fit.")
    out = hypsometric_bins.copy()
    out[value_column] = np.polyval(coefs, mids)
    return out


def calculate_hypsometry_area(
    ddem_bins: pd.Series | pd.DataFrame,
    ref_dem: np.ndarray,
    pixel_size: float | tuple[float, float],
    timeframe: Literal["reference", "nonreference", "mean"] = "reference",
) -> pd.Series:
    """Representative area per elevation bin at a given timeframe (reference volume.py:239)."""
    pd = import_optional("pandas")
    if timeframe not in ("reference", "nonreference", "mean"):
        raise ValueError(
            f"Argument 'timeframe={timeframe}' is invalid. Choices: ['reference', 'nonreference', 'mean']."
        )
    if isinstance(ddem_bins, pd.DataFrame):
        ddem_series = ddem_bins["value"]
    else:
        ddem_series = ddem_bins

    ref = np.asarray(unmask(ref_dem), dtype=np.float64)
    assert not np.any(np.isnan(ref)), "The given reference DEM has NaNs. No NaNs are allowed to calculate area!"

    if timeframe in ("nonreference", "mean"):
        assert not np.any(np.isnan(ddem_series.values)), \
            "The dDEM bins cannot contain NaNs. Remove or fill them first."
        # dh is defined as ref - other, so the other timeframe's elevations are ref - dh;
        # linear extrapolation beyond the outermost bin midpoints (reference :278-297)
        from scipy.interpolate import interp1d

        dh_of_z = interp1d(ddem_series.index.mid.values, ddem_series.values,
                           kind="linear", fill_value="extrapolate")
        if timeframe == "nonreference":
            ref = ref - dh_of_z(ref)
        else:
            ref = ref - dh_of_z(ref) / 2

    edges = np.r_[[iv.left for iv in ddem_series.index], ddem_series.index[-1].right]
    counts, _ = np.histogram(ref, bins=edges)
    px_area = pixel_size**2 if not isinstance(pixel_size, (tuple, list)) else pixel_size[0] * pixel_size[1]
    return pd.Series(counts * px_area, index=ddem_series.index)


def idw_interpolation(array: np.ndarray, max_search_distance: int = 10, extrapolate: bool = False,
                      force_fill: bool = False) -> np.ndarray:
    """Distance-weighted gap filling (substitute for rasterio.fill.fillnodata; volume.py:302).

    Iterative 3x3 NaN-aware mean dilation up to max_search_distance rings, optionally trimming
    extrapolated values outside the convex data region (approximated by a validity dilation).
    ``force_fill=True`` replaces any remaining gap with the median of all valid input values
    (reference :340-343).
    """
    from scipy import ndimage

    array = unmask(array)

    arr = np.asarray(array, dtype=np.float64).copy()
    if arr.ndim != 2:
        arr = arr.squeeze()
    valid0 = np.isfinite(arr)
    filled = arr.copy()
    for _ in range(int(max_search_distance)):
        invalid = ~np.isfinite(filled)
        if not invalid.any():
            break
        vals = np.where(np.isfinite(filled), filled, 0.0)
        cnts = np.isfinite(filled).astype(np.float64)
        ksum = ndimage.uniform_filter(vals, size=3) * 9
        kcnt = ndimage.uniform_filter(cnts, size=3) * 9
        with np.errstate(invalid="ignore", divide="ignore"):
            est = ksum / kcnt
        filled = np.where(invalid & (kcnt > 0), est, filled)
    if not extrapolate:
        # Trim values extrapolated OUTSIDE the data hull; interior holes stay filled
        struct = np.ones((3, 3))
        inside = ndimage.binary_fill_holes(ndimage.binary_dilation(valid0, structure=struct, iterations=1))
        filled[~inside] = np.nan
    if force_fill:
        filled[~np.isfinite(filled)] = np.nanmedian(arr)
    return filled.astype(array.dtype if hasattr(array, "dtype") else np.float32)


def hypsometric_interpolation(
    voided_ddem: np.ndarray,
    ref_dem: np.ndarray,
    mask: np.ndarray,
    count_threshold: int | None = 1,
) -> np.ma.MaskedArray:
    """Fill gaps within `mask` using the hypsometric signal of dh vs elevation (volume.py:353)."""
    voided_ddem, ref_dem = unmask(voided_ddem), unmask(ref_dem)
    ddem = np.where(np.asarray(mask, bool), np.asarray(voided_ddem, np.float64), np.nan)
    bins = hypsometric_binning(ddem, np.asarray(ref_dem, np.float64))
    interp_bins = interpolate_hypsometric_bins(bins, count_threshold=count_threshold)
    mids = interp_bins.index.mid.values
    signal = np.interp(np.asarray(ref_dem, np.float64), mids, interp_bins["value"].values)
    out = np.where(np.isfinite(ddem), ddem, signal)
    out = np.where(np.asarray(mask, bool) & np.isfinite(np.asarray(ref_dem)), out, np.nan)
    return np.ma.masked_invalid(out)


def local_hypsometric_interpolation(
    voided_ddem: np.ndarray,
    ref_dem: np.ndarray,
    mask: np.ndarray,
    min_coverage: float = 0.2,
    count_threshold: int | None = 1,
    nodata: float | int = -9999,
    plot: bool = False,
) -> np.ma.MaskedArray:
    """Feature-wise hypsometric filling: one signal per connected mask feature (volume.py:407).

    ``count_threshold`` excludes under-populated elevation bins from each feature's curve,
    ``nodata`` sets the returned masked array's fill value, and ``plot=True`` displays the
    per-feature inlier masks (reference :414,429-431)."""
    from scipy import ndimage

    voided_ddem, ref_dem = unmask(voided_ddem), unmask(ref_dem)
    mask = np.asarray(mask, bool)
    labels, n = ndimage.label(mask)
    out = np.where(mask, np.asarray(voided_ddem, np.float64), np.nan)
    if plot:
        plt = import_optional("matplotlib.pyplot", package_name="matplotlib")

        plt.matshow(mask & np.isfinite(np.asarray(voided_ddem, np.float64)))
        plt.title("inlier mask")
        plt.show()
    for i in range(1, n + 1):
        feat = labels == i
        dh_feat = np.where(feat, np.asarray(voided_ddem, np.float64), np.nan)
        coverage = np.isfinite(dh_feat[feat]).mean() if feat.sum() else 0.0
        if coverage < min_coverage:
            continue
        with warnings.catch_warnings():
            # Small features can have too few populated bins to interpolate; the bins are
            # then returned as-is (same warn-and-copy behavior as the reference) and only
            # the populated part of the signal fills this feature.
            warnings.simplefilter("ignore", UserWarning)
            filled = hypsometric_interpolation(dh_feat, ref_dem, feat,
                                               count_threshold=count_threshold)
        out = np.where(feat, filled.filled(np.nan), out)
    res = np.ma.masked_invalid(out)
    res.fill_value = nodata
    return res


def get_regional_hypsometric_signal(
    ddem: np.ndarray,
    ref_dem: np.ndarray,
    glacier_index_map: np.ndarray | None = None,
    n_bins: int = 20,
    min_coverage: float = 0.05,
) -> pd.DataFrame:
    """Normalized regional hypsometric signal: dh/dh_max vs normalized elevation (volume.py:568)."""
    pd = import_optional("pandas")
    ddem, ref_dem = unmask(ddem), unmask(ref_dem)
    if glacier_index_map is None:
        glacier_index_map = np.ones(np.shape(ref_dem), dtype=int)
    # Device fast path: per-glacier segment reductions + binned medians in one dispatch
    # (the host loop scans the full raster once PER glacier)
    if _wants_device(ddem, ref_dem, stat_ok=True):
        return _regional_signal_device(ddem, ref_dem, glacier_index_map, n_bins, min_coverage)
    ddem = np.asarray(ddem, np.float64)
    ref = np.asarray(ref_dem, np.float64)
    glacier_index_map = np.asarray(glacier_index_map)

    norm_z_all = []
    norm_dh_all = []
    for gid in np.unique(glacier_index_map):
        if gid == 0:
            continue
        sel = (glacier_index_map == gid) & np.isfinite(ref)
        if sel.sum() < 10:
            continue
        z = ref[sel]
        dh = ddem[sel]
        if np.isfinite(dh).mean() < min_coverage:
            continue
        zmin, zmax = z.min(), z.max()
        if zmax == zmin:
            continue
        norm_z = 1 - (z - zmin) / (zmax - zmin)
        med = np.nanmedian(dh)
        scale = np.nanmax(np.abs(dh)) if np.isfinite(dh).any() else np.nan
        del med
        if not np.isfinite(scale) or scale == 0:
            continue
        norm_z_all.append(norm_z[np.isfinite(dh)])
        norm_dh_all.append(dh[np.isfinite(dh)] / scale)

    if not norm_z_all:
        raise ValueError("No valid glaciers for regional hypsometric signal.")
    norm_z = np.concatenate(norm_z_all)
    norm_dh = np.concatenate(norm_dh_all)

    edges = np.linspace(0, 1, n_bins + 1)
    idx = np.clip(np.digitize(norm_z, edges) - 1, 0, n_bins - 1)
    med = np.full(n_bins, np.nan)
    std = np.full(n_bins, np.nan)
    cnt = np.zeros(n_bins, dtype=int)
    sigma_filt = np.isfinite(norm_dh)
    for i in range(n_bins):
        sel = (idx == i) & sigma_filt
        cnt[i] = sel.sum()
        if cnt[i]:
            med[i] = np.median(norm_dh[sel])
            std[i] = np.std(norm_dh[sel])
    return pd.DataFrame(
        {"w_mean": med, "median": med, "std": std, "sigma-1-lower": med - std, "sigma-1-upper": med + std, "count": cnt},
        index=pd.IntervalIndex.from_breaks(edges),
    )


def norm_regional_hypsometric_interpolation(
    voided_ddem: np.ndarray,
    ref_dem: np.ndarray,
    glacier_index_map: np.ndarray | None = None,
    min_coverage: float = 0.1,
    regional_signal: pd.DataFrame | None = None,
    min_elevation_range: float = 0.33,
    idealized_ddem: bool = False,
) -> np.ma.MaskedArray:
    """Fill gaps per glacier by scaling the regional normalized signal (volume.py:668).

    Glaciers whose valid pixels cover less than ``min_elevation_range`` of the normalized
    elevation bins are skipped (a signal scaled from one elevation band extrapolates badly,
    reference :764-768). ``idealized_ddem=True`` replaces ALL glacier values with the scaled
    signal — useful for error assessments (reference :689)."""
    ddem = np.asarray(unmask(voided_ddem), np.float64)
    ref = np.asarray(unmask(ref_dem), np.float64)
    if glacier_index_map is None:
        glacier_index_map = np.ones(ref.shape, dtype=int)
    glacier_index_map = np.asarray(glacier_index_map)

    if regional_signal is None:
        regional_signal = get_regional_hypsometric_signal(ddem, ref, glacier_index_map)
    mids = regional_signal.index.mid.values
    signal_vals = regional_signal["median"].values

    out = ddem.copy()
    for gid in np.unique(glacier_index_map):
        if gid == 0:
            continue
        sel = (glacier_index_map == gid) & np.isfinite(ref)
        if sel.sum() < 10:
            continue
        z = ref[sel]
        dh = ddem[sel]
        finite = np.isfinite(dh)
        if finite.mean() < min_coverage or finite.sum() < 5:
            continue
        zmin, zmax = z.min(), z.max()
        if zmax == zmin:
            continue
        norm_z = 1 - (z - zmin) / (zmax - zmin)
        # Skip glaciers whose valid dh covers too little of the elevation range: the bins
        # of the signal touched by valid pixels must span >= min_elevation_range of [0, 1]
        n_bins = len(mids)
        touched = np.unique(np.clip(np.digitize(norm_z[finite], np.linspace(0, 1, n_bins + 1)) - 1,
                                    0, n_bins - 1))
        if len(touched) / n_bins < min_elevation_range:
            continue
        signal_here = np.interp(norm_z, mids, signal_vals)
        # Scale factor from overlapping valid pixels (least squares through origin)
        denom = np.sum(signal_here[finite] ** 2)
        scale = np.sum(dh[finite] * signal_here[finite]) / denom if denom > 0 else 0.0
        filled = signal_here * scale
        vals = out[sel]
        if idealized_ddem:
            vals = filled
        else:
            vals[~finite] = filled[~finite]
        out[sel] = vals
    out = np.where(glacier_index_map > 0, out, np.nan)
    return np.ma.masked_invalid(out)


# --------------------------------------------------------------------------------------
# Device fast paths (segment-sort binned statistics; VERDICT r2 task 6)
# --------------------------------------------------------------------------------------
# The reference's volume.py is host numpy/pandas end to end. At 1e8-pixel dDEMs the
# digitize-and-loop aggregation crawls; the device paths below reuse the same segment-sort
# binned-table machinery built for heteroscedasticity (spatialstats._binned_count_med_nmad):
# one device dispatch, only the ~n_bins-row tables cross the host boundary. Engaged
# automatically for the default statistics on large (or device-resident) inputs; the host
# path remains bit-exact with the reference's semantics for everything else.

_DEVICE_BIN_THRESHOLD = 1 << 21  # ~2 Mpx: below this the host loop is faster than a dispatch


def _wants_device(*arrays: Any, stat_ok: bool) -> bool:
    import jax

    if not stat_ok:
        return False
    if any(isinstance(a, jax.Array) for a in arrays):
        return True
    return int(np.size(arrays[0])) >= _DEVICE_BIN_THRESHOLD


def _binned_count_median_device(vals, ids, n_bins: int):
    """Per-bin (count, median) on device; ids == n_bins marks invalid."""
    import jax
    import jax.numpy as jnp

    from xdem_tpu.spatialstats import _segment_median_sorted

    counts_all = jnp.zeros(n_bins + 1, jnp.int32).at[ids].add(1)
    counts = counts_all[:n_bins]
    starts = jnp.concatenate([jnp.zeros(1, jnp.int32), jnp.cumsum(counts_all)[:-1]])[:n_bins]
    _, vals_s = jax.lax.sort((ids, vals), num_keys=2)
    med = _segment_median_sorted(vals_s, starts, counts)
    return counts, med


_HYPSO_RUN = None  # cached module-level jit: per-call closures would re-trace every call


def _hypso_bin_device(ddem_flat, ref_flat, zbins: np.ndarray):
    """Device hypsometric binning: returns (values, counts) as numpy arrays."""
    global _HYPSO_RUN
    import jax
    import jax.numpy as jnp

    n_bins = len(zbins) - 1

    if _HYPSO_RUN is None:
        from functools import partial

        @partial(jax.jit, static_argnames=("n_bins",))
        def run(dh, z, edges, n_bins):
            # np.digitize(right=False) == searchsorted(side='right'); out-of-range and
            # NaN-dh pixels park in the invalid bin n_bins
            idx = jnp.searchsorted(edges, z, side="right") - 1
            ok = jnp.isfinite(dh) & jnp.isfinite(z) & (idx >= 0) & (idx < n_bins)
            ids = jnp.where(ok, idx, n_bins).astype(jnp.int32)
            return _binned_count_median_device(dh, ids, n_bins)

        _HYPSO_RUN = run

    counts, med = _HYPSO_RUN(jnp.asarray(ddem_flat, jnp.float32),
                             jnp.asarray(ref_flat, jnp.float32),
                             jnp.asarray(zbins, jnp.float32), n_bins=n_bins)
    values = np.asarray(med, np.float64)
    counts_np = np.asarray(counts, np.int64)
    values[counts_np == 0] = np.nan
    return values, counts_np


_REGIONAL_RUN = None  # cached module-level jit (see _HYPSO_RUN)


def _regional_signal_device(ddem, ref, gid_map, n_bins: int, min_coverage: float) -> pd.DataFrame:
    """One-pass device regional hypsometric signal (per-glacier segment reductions)."""
    pd = import_optional("pandas")
    global _REGIONAL_RUN
    import jax
    import jax.numpy as jnp

    gids = np.asarray(gid_map).ravel()
    gmax = int(gids.max(initial=0))
    if gmax > 4_000_000 or gids.min(initial=0) < 0:
        # Sparse/huge/negative ids: densify on host first (jax scatter would WRAP negative
        # indices into glacier K-1's statistics; the host path treats them as ordinary ids)
        uniq, gids = np.unique(gids, return_inverse=True)
        gmax = len(uniq) - 1
        zero_id = int(np.searchsorted(uniq, 0)) if 0 in uniq else -1
    else:
        zero_id = 0
    K = gmax + 1

    if _REGIONAL_RUN is None:
        from functools import partial

        @partial(jax.jit, static_argnames=("K", "n_bins", "zero_id"))
        def _run(dh, z, g, min_cov, K, n_bins, zero_id):
            valid_ref = jnp.isfinite(z)
            valid_dh = valid_ref & jnp.isfinite(dh)
            gi = jnp.where(valid_ref, g, K).astype(jnp.int32)
            cnt_ref = jnp.zeros(K + 1, jnp.int32).at[gi].add(1)[:K]
            cnt_dh = jnp.zeros(K + 1, jnp.int32).at[jnp.where(valid_dh, g, K).astype(jnp.int32)].add(1)[:K]
            zmin = jnp.full(K + 1, jnp.inf).at[gi].min(jnp.where(valid_ref, z, jnp.inf))[:K]
            zmax = jnp.full(K + 1, -jnp.inf).at[gi].max(jnp.where(valid_ref, z, -jnp.inf))[:K]
            scale = jnp.zeros(K + 1).at[jnp.where(valid_dh, g, K).astype(jnp.int32)].max(
                jnp.where(valid_dh, jnp.abs(dh), 0.0))[:K]
            ok_g = (cnt_ref >= 10) & (cnt_dh >= min_cov * cnt_ref) & (zmax > zmin) \
                & jnp.isfinite(scale) & (scale > 0)
            if zero_id >= 0:
                ok_g = ok_g.at[zero_id].set(False)
            gc = jnp.clip(g, 0, K - 1)
            norm_z = 1.0 - (z - zmin[gc]) / jnp.maximum(zmax[gc] - zmin[gc], 1e-30)
            norm_dh = dh / jnp.maximum(scale[gc], 1e-30)
            px_ok = valid_dh & ok_g[gc]
            edges = jnp.linspace(0.0, 1.0, n_bins + 1)
            idx = jnp.clip(jnp.searchsorted(edges, norm_z, side="right") - 1, 0, n_bins - 1)
            ids = jnp.where(px_ok, idx, n_bins).astype(jnp.int32)
            counts, med = _binned_count_median_device(norm_dh.astype(jnp.float32), ids, n_bins)
            s1 = jnp.zeros(n_bins + 1).at[ids].add(jnp.where(px_ok, norm_dh, 0.0))[:n_bins]
            s2 = jnp.zeros(n_bins + 1).at[ids].add(jnp.where(px_ok, norm_dh**2, 0.0))[:n_bins]
            any_ok = jnp.any(px_ok)
            return counts, med, s1, s2, any_ok

        _REGIONAL_RUN = _run

    counts, med, s1, s2, any_ok = _REGIONAL_RUN(
        jnp.asarray(np.ravel(ddem), jnp.float32), jnp.asarray(np.ravel(ref), jnp.float32),
        jnp.asarray(gids, jnp.int32), jnp.float32(min_coverage),
        K=K, n_bins=n_bins, zero_id=zero_id)
    if not bool(any_ok):
        raise ValueError("No valid glaciers for regional hypsometric signal.")
    counts = np.asarray(counts, np.int64)
    med = np.asarray(med, np.float64)
    with np.errstate(invalid="ignore", divide="ignore"):
        mean = np.asarray(s1, np.float64) / np.maximum(counts, 1)
        var = np.asarray(s2, np.float64) / np.maximum(counts, 1) - mean**2
        std = np.sqrt(np.maximum(var, 0.0))
    med[counts == 0] = np.nan
    std[counts == 0] = np.nan
    edges = np.linspace(0, 1, n_bins + 1)
    return pd.DataFrame(
        {"w_mean": med, "median": med, "std": std, "sigma-1-lower": med - std,
         "sigma-1-upper": med + std, "count": counts},
        index=pd.IntervalIndex.from_breaks(edges),
    )
