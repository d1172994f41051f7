"""Spatial statistics: N-D binning, heteroscedasticity, variograms, effective samples, patches.

Reference parity: /root/reference/xdem/spatialstats.py — nd_binning (:91), interp_nd_binning
(:237), get_perbin_nd_binning (:425), two_step_standardization (:530),
infer_heteroscedasticity_from_stable (:808), sample_empirical_variogram (:1295), variogram
models/fitting (:1583-1967), n_eff estimators (:2011-2311), spatial_error_propagation (:2405),
convolution (:2558), mean_filter_nan (:2597), patches_method (:2920).

Device design: binned statistics as segment reductions; the empirical variogram as
block-pairwise distance + robust-estimator kernels (shardable across devices);
n_eff double sums as tiled covariance kernels.
"""

from __future__ import annotations

import itertools
import logging
import math
import warnings
from functools import partial
from typing import TYPE_CHECKING, Any, Callable, Iterable, Literal, Sequence, TypedDict

import jax
import jax.numpy as jnp
import numpy as np

from xdem_tpu._misc import deprecate, import_optional
from xdem_tpu.ops.precision import pin_f32_matmuls
from xdem_tpu.ops.transfer import unmask
from xdem_tpu.raster import Raster

if TYPE_CHECKING:
    import pandas as pd

_NMAD_FACTOR = 1.4826


@deprecate(removal_version="0.3", details="Use xdem_tpu.ops.nmad instead.")
def nmad(data: np.ndarray, nfact: float = _NMAD_FACTOR) -> float:
    """Normalized median absolute deviation (deprecated forwarding, reference :73-88)."""
    data = np.asarray(data)
    med = np.nanmedian(data)
    return float(nfact * np.nanmedian(np.abs(data - med)))


def _stat_nmad(x: np.ndarray) -> float:
    med = np.nanmedian(x)
    return float(_NMAD_FACTOR * np.nanmedian(np.abs(x - med)))


# Binned-statistic DataFrames are column-named after the statistic's __name__; the
# reference's spread columns read "nmad" (geoutils.stats.nmad), not a private identifier.
_stat_nmad.__name__ = "nmad"


# ---------------------------------------------------------------------- N-D binning


def nd_binning(
    values: np.ndarray,
    list_var: Sequence[np.ndarray],
    list_var_names: Sequence[str],
    list_var_bins: int | Sequence[int] | Sequence[np.ndarray] | None = None,
    statistics: Sequence[Callable[[np.ndarray], float] | str] = ("count", np.nanmedian, _stat_nmad),
    list_ranges: Sequence[tuple[float, float]] | None = None,
) -> pd.DataFrame:
    """N-dimensional binned statistics: all 1-D, all 2-D combinations, and the full N-D binning.

    Returns a tidy DataFrame with IntervalIndex columns per variable, an `nd` column for the
    binning dimensionality, and one column per statistic (count always included).
    Reference spatialstats.py:91.
    """
    pd = import_optional("pandas")
    values = np.asarray(unmask(values)).ravel()
    list_var = [np.asarray(unmask(v)).ravel() for v in list_var]
    if len(list_var) != len(list_var_names):
        raise ValueError("Number of variables and variable names must match.")
    n_vars = len(list_var)

    # Statistics: always lead with count
    stats: list[tuple[str, Callable[[np.ndarray], float]]] = []
    seen_count = False
    for s in statistics:
        if isinstance(s, str):
            if s == "count":
                seen_count = True
                continue
            raise ValueError(f"Unknown statistic name: {s}")
        stats.append((s.__name__, s))
    del seen_count

    # Bin edges per variable
    if list_var_bins is None:
        list_var_bins = [10] * n_vars
    elif np.isscalar(list_var_bins):
        list_var_bins = [int(list_var_bins)] * n_vars  # type: ignore[list-item]
    # Joint validity mask first: bin ranges are derived from the jointly valid sample, as in
    # the reference (it removes no-data across values AND all variables before binning).
    valid_all = np.isfinite(values)
    for v in list_var:
        valid_all &= np.isfinite(v)

    edges: list[np.ndarray] = []
    for i, b in enumerate(list_var_bins):  # type: ignore[arg-type]
        finite = list_var[i][valid_all]
        if isinstance(b, (int, np.integer)):
            lo, hi = (
                list_ranges[i] if list_ranges is not None and list_ranges[i] is not None else (finite.min(), finite.max())
            )
            edges.append(np.linspace(lo, hi, int(b) + 1))
        else:
            edges.append(np.asarray(b, dtype=np.float64))

    def _binned(var_idx: list[int]) -> pd.DataFrame:
        sel_edges = [edges[i] for i in var_idx]
        sel_vars = [list_var[i][valid_all] for i in var_idx]
        vals = values[valid_all]
        # Digitize into flat bin ids
        ids = np.zeros(len(vals), dtype=np.int64)
        n_bins_tot = 1
        dims = []
        for e, v in zip(sel_edges, sel_vars):
            d = len(e) - 1
            idx = np.clip(np.digitize(v, e) - 1, -1, d)
            idx = np.where((v >= e[0]) & (v <= e[-1]), np.clip(idx, 0, d - 1), -1)
            ids = ids * d + np.where(idx >= 0, idx, 0)
            ids = np.where(idx >= 0, ids, -1) if len(dims) == 0 else np.where((idx >= 0) & (ids >= 0), ids, -1)
            n_bins_tot *= d
            dims.append(d)
        ok = ids >= 0
        # Group values by bin with one stable argsort, then evaluate statistics on contiguous
        # segments: O(N log N) grouping + O(N) partition-based medians, instead of O(bins * N)
        # boolean masking. Matters at 1e8-pixel dDEMs (the 10k^2 uncertainty config).
        ids_ok = ids[ok]
        vals_ok = vals[ok]
        order = np.argsort(ids_ok, kind="stable")
        sorted_vals = vals_ok[order]
        counts_arr = np.bincount(ids_ok, minlength=n_bins_tot)
        starts = np.concatenate([[0], np.cumsum(counts_arr)[:-1]])

        rows = []
        for flat in range(n_bins_tot):
            sub = sorted_vals[starts[flat]: starts[flat] + counts_arr[flat]]
            rec: dict[str, Any] = {"count": int(counts_arr[flat])}
            for name, fn in stats:
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore", RuntimeWarning)
                    rec[name] = fn(sub) if len(sub) else np.nan
            # Decompose flat index into per-var bins
            rem = flat
            per = []
            for d in dims[::-1]:
                per.append(rem % d)
                rem //= d
            per = per[::-1]
            for k, i_var in enumerate(var_idx):
                e = edges[i_var]
                rec[list_var_names[i_var]] = pd.Interval(e[per[k]], e[per[k] + 1], closed="left")
            rows.append(rec)
        df = pd.DataFrame(rows)
        df["nd"] = len(var_idx)
        return df

    frames = []
    # 1-D binnings
    for i in range(n_vars):
        frames.append(_binned([i]))
    # 2-D combinations
    if n_vars > 1:
        for combo in itertools.combinations(range(n_vars), 2):
            frames.append(_binned(list(combo)))
    # Full N-D
    if n_vars > 2:
        frames.append(_binned(list(range(n_vars))))

    df_all = pd.concat(frames, ignore_index=True)
    # Consistent column order
    stat_cols = ["count"] + [name for name, _ in stats]
    cols = [c for c in stat_cols if c in df_all.columns] + list(list_var_names) + ["nd"]
    return df_all[cols]


def _pandas_str_to_interval(s: Any) -> Any:
    """Parse '[a, b)'-style strings back into pd.Interval (reference :221)."""
    import pandas as pd  # called per element by callers that already imported pandas
    if isinstance(s, str):
        import re

        m = re.match(r"[\[\(]\s*([-\d.e+]+)\s*,\s*([-\d.e+]+)\s*[\]\)]", s)
        if m:
            return pd.Interval(float(m.group(1)), float(m.group(2)), closed="left")
    return s


def interp_nd_binning(
    df: pd.DataFrame,
    list_var_names: str | Sequence[str],
    statistic: str | Callable[[np.ndarray], float] = _stat_nmad,
    interpolate_method: str = "linear",
    min_count: int | None = 100,
) -> Callable[..., np.ndarray]:
    """N-D linear interpolator over binned statistics with edge-propagating extrapolation.

    Reference spatialstats.py:237: under-populated bins (count < min_count) are masked, the grid
    is extended by propagating nearest valid values outward, and a RegularGridInterpolator-like
    linear interpolator with nearest extrapolation is returned. ``interpolate_method``
    ("linear" default, or "nearest") controls how masked/edge bins are in-filled before
    building the interpolator (reference :241,377).

    Accepts an ``nd_binning`` output frame (interval columns + "nd") or a from-scratch
    frame with numeric mid-value columns (the reference's doctest form, :268-289):

    >>> import pandas as pd
    >>> df = pd.DataFrame({"var1": [1, 2, 3, 1, 2, 3, 1, 2, 3],
    ...                    "var2": [1, 1, 1, 2, 2, 2, 3, 3, 3],
    ...                    "statistic": [1, 2, 3, 4, 5, 6, 7, 8, 9]})
    >>> fun = interp_nd_binning(df, list_var_names=["var1", "var2"],
    ...                         statistic="statistic", min_count=None)
    >>> float(fun((2, 2)))      # right on a bin midpoint
    5.0
    >>> float(fun((1.5, 1.5)))  # linear inside the grid
    3.0
    >>> float(fun((-1, 1)))     # nearest (flat) extrapolation outside
    1.0
    """
    pd = import_optional("pandas")
    if interpolate_method not in ("linear", "nearest"):
        raise ValueError(f"interpolate_method must be 'linear' or 'nearest', got {interpolate_method!r}.")
    if isinstance(list_var_names, str):
        list_var_names = [list_var_names]
    stat_name = statistic if isinstance(statistic, str) else statistic.__name__

    # Input validation with the reference's semantics (spatialstats.py:295-305): the frame
    # can be an nd_binning output OR built from scratch with numeric mid-value columns.
    for name in list_var_names:
        if name not in df.columns:
            raise ValueError(f'Variable "{name}" does not exist in the provided dataframe.')
    if stat_name not in df.columns:
        raise ValueError(f'Statistic "{stat_name}" does not exist in the provided dataframe.')
    if min_count is not None and "count" not in df.columns:
        raise ValueError('Statistic "count" is not in the provided dataframe, necessary to '
                         "use the min_count argument.")
    if df.empty:
        raise ValueError("Dataframe is empty.")

    sub = df.copy()
    # nd_binning outputs carry an "nd" column: keep only the requested dimensionality.
    # Sibling combos of the SAME dimensionality (e.g. (var1,var3) rows when asking for
    # (var1,var2) out of a 3-variable binning) carry NaN in the requested columns: filter
    # them like the reference (spatialstats.py:331)
    if "nd" in sub.columns:
        sub = sub[sub["nd"] == len(list_var_names)]
    for name in list_var_names:
        sub = sub[sub[name].notna()]
    sub = sub.copy()
    # Each variable column may hold numeric mid values, pd.Interval objects, or interval
    # strings (a round-trip through CSV stringifies intervals; reference :315-328)
    for name in list_var_names:
        vals = sub[name].values
        if all(isinstance(x, (int, float, np.integer, np.floating)) for x in vals):
            sub[name] = np.asarray(vals, dtype=np.float64)
        elif any(isinstance(x, pd.Interval) for x in vals):
            sub[name] = pd.IntervalIndex(vals).mid.values
        elif any(isinstance(_pandas_str_to_interval(x), pd.Interval) for x in vals):
            sub[name] = pd.IntervalIndex([_pandas_str_to_interval(x) for x in vals]).mid.values
        else:
            raise ValueError("The variable columns must be provided as numerical mid values, "
                             "or pd.Interval values.")
    sub = sub[np.logical_and.reduce([np.isfinite(sub[name].values.astype(np.float64))
                                     for name in list_var_names])]
    if len(sub) == 0:
        raise ValueError(f"No {len(list_var_names)}-D binning found in the DataFrame.")

    # Build the regular grid of bin midpoints
    mids = []
    for name in list_var_names:
        uniq = sorted(set(np.asarray(sub[name].values, dtype=np.float64)))
        mids.append(np.asarray(uniq, dtype=np.float64))
    shape = tuple(len(m) for m in mids)
    grid = np.full(shape, np.nan)
    counts = np.zeros(shape)
    for _, row in sub.iterrows():
        idx = tuple(int(np.argmin(np.abs(mids[i] - float(row[name]))))
                    for i, name in enumerate(list_var_names))
        grid[idx] = row[stat_name]
        counts[idx] = row.get("count", np.nan)
    if min_count is not None:
        grid = np.where(counts >= min_count, grid, np.nan)

    if not np.isfinite(grid).any():
        raise ValueError("No valid bins to interpolate from (check min_count).")
    # In-fill masked bins: linearly inside the valid hull when requested (reference :377),
    # then nearest-neighbor for the rest. Both passes work in bin-MIDPOINT coordinate space
    # (griddata), matching the reference: with unequal bin widths per variable, the nearest
    # bin by coordinate distance is not the nearest by index.
    if np.isnan(grid).any():
        from scipy.interpolate import griddata

        pts = np.stack(np.meshgrid(*mids, indexing="ij"), axis=-1).reshape(-1, len(mids))
        valid = np.isfinite(grid)
        if interpolate_method == "linear" and valid.sum() > len(mids):
            try:
                filled = griddata(pts[valid.ravel()], grid[valid], pts,
                                  method="linear").reshape(grid.shape)
                grid = np.where(valid, grid, filled)
            except Exception:  # degenerate hulls (collinear points) fall back to nearest
                pass
        if np.isnan(grid).any():
            valid = np.isfinite(grid)
            try:
                filled = griddata(pts[valid.ravel()], grid[valid], pts,
                                  method="nearest").reshape(grid.shape)
                grid = np.where(valid, grid, filled)
            except Exception:  # degenerate point sets: index-space nearest propagation
                from scipy import ndimage

                idx_nearest = ndimage.distance_transform_edt(
                    ~valid, return_distances=False, return_indices=True)
                grid = grid[tuple(idx_nearest)]

    from scipy.interpolate import RegularGridInterpolator

    # Extend the grid by one cell on each side with edge values for nearest extrapolation
    mids_ext = []
    for m in mids:
        step0 = m[1] - m[0] if len(m) > 1 else 1.0
        step1 = m[-1] - m[-2] if len(m) > 1 else 1.0
        mids_ext.append(np.r_[m[0] - step0, m, m[-1] + step1])
    grid_ext = np.pad(grid, 1, mode="edge")
    rgi = RegularGridInterpolator(tuple(mids_ext), grid_ext, method="linear", bounds_error=False, fill_value=None)

    def interpolator(*args: np.ndarray) -> np.ndarray:
        if len(args) == 1 and isinstance(args[0], (tuple, list)):
            args = tuple(args[0])
        pts = np.stack([np.asarray(a, dtype=np.float64).ravel() for a in args], axis=-1)
        out = rgi(pts)
        return out.reshape(np.asarray(args[0]).shape)

    # Exposed so device-resident pipelines can evaluate the same grid without a host
    # round-trip (see _interp_grid_device / infer_heteroscedasticity_from_stable)
    interpolator.mids_ext = mids_ext
    interpolator.grid_ext = grid_ext
    return interpolator


_INTERP_SELECT_MAX_TABLE = 256  # select-sum unroll bound (compile time grows with the table)


@jax.jit
def _interp_grid_device(mids_ext, grid_ext, vars_dev) -> jnp.ndarray:
    """Multilinear interpolation of a small binned grid at device-resident coordinates.

    Equivalent to interp_nd_binning's host interpolator (the edge-padded grid makes
    out-of-hull extrapolation flat, so clamping reproduces it); NaN coordinates give NaN.
    Jitted (pytree args): eager execution issued ~30 separate dispatches per full-raster
    evaluation.

    The corner lookups use an unrolled select-sum over the flattened table when it is small
    (the default 2-var/10-bin pipeline grid is 12x12): a gather from a tiny table with 1e8
    indices can lower to a slow serialized loop, where the 144-way select-sum is plain
    elementwise work. Larger tables keep the gather, which bounds the unroll (and its
    compile time). Which is faster on a GPU is not measured yet.
    """
    import itertools

    grid_j = jnp.asarray(grid_ext, jnp.float32)
    grid_flat = grid_j.ravel()
    use_select = grid_flat.shape[0] <= _INTERP_SELECT_MAX_TABLE
    idxs = []
    fracs = []
    nan_any = None
    for d, m in enumerate(mids_ext):
        mj = jnp.asarray(m, jnp.float32)
        x = jnp.asarray(vars_dev[d], jnp.float32)
        isnan = jnp.isnan(x)
        nan_any = isnan if nan_any is None else (nan_any | isnan)
        xc = jnp.clip(jnp.where(isnan, mj[0], x), mj[0], mj[-1])
        i = jnp.clip(jnp.searchsorted(mj, xc, side="right") - 1, 0, len(m) - 2)
        f = (xc - mj[i]) / (mj[i + 1] - mj[i])
        idxs.append(i)
        fracs.append(f)
    dims = grid_j.shape
    out = jnp.zeros_like(fracs[0])
    for corner in itertools.product((0, 1), repeat=len(mids_ext)):
        wgt = None
        flat = None
        for d, c in enumerate(corner):
            w_d = fracs[d] if c else (1.0 - fracs[d])
            wgt = w_d if wgt is None else wgt * w_d
            i_d = (idxs[d] + c).astype(jnp.int32)
            flat = i_d if flat is None else flat * dims[d] + i_d
        if use_select:
            val = jnp.zeros_like(wgt)
            for k in range(grid_flat.shape[0]):
                val = jnp.where(flat == k, grid_flat[k], val)
        else:
            val = jnp.take(grid_flat, flat)
        out = out + wgt * val
    return jnp.where(nan_any, jnp.nan, out)


def get_perbin_nd_binning(
    df: pd.DataFrame,
    list_var: Sequence[np.ndarray],
    list_var_names: str | Sequence[str],
    statistic: str | Callable[[np.ndarray], float] = np.nanmedian,
    min_count: int | None = 0,
) -> np.ndarray:
    """Per-bin (piecewise-constant) lookup of a binned statistic at variable values
    (reference :425, default statistic nanmedian like the reference); bins with fewer
    than ``min_count`` samples stay NaN."""
    if isinstance(list_var_names, str):
        list_var_names = [list_var_names]
    stat_name = statistic if isinstance(statistic, str) else statistic.__name__
    sub = df[df["nd"] == len(list_var_names)]
    for name in list_var_names:
        sub = sub[sub[name].notna()]  # drop sibling same-nd combos (see interp_nd_binning)
    sub = sub.copy()
    for name in list_var_names:
        sub[name] = sub[name].apply(_pandas_str_to_interval)

    shape = np.asarray(list_var[0]).shape
    out = np.full(shape, np.nan)
    flat_vars = [np.asarray(v).ravel() for v in list_var]
    out_flat = out.ravel()
    for _, row in sub.iterrows():
        if min_count and row.get("count", 0) < min_count:
            continue
        sel = np.ones(len(flat_vars[0]), dtype=bool)
        for v, name in zip(flat_vars, list_var_names):
            iv = row[name]
            sel &= (v >= iv.left) & (v < iv.right)
        out_flat[sel] = row[stat_name]
    return out_flat.reshape(shape)


# ---------------------------------------------------------------------- heteroscedasticity


def _segment_median_sorted(vals_sorted: jnp.ndarray, starts: jnp.ndarray, counts: jnp.ndarray):
    """Midpoint median of contiguous sorted segments (np.median semantics); NaN when empty."""
    lo = starts + jnp.maximum((counts - 1) // 2, 0)
    hi = starts + jnp.maximum(counts // 2, 0)
    med = (vals_sorted[lo] + vals_sorted[hi]) / 2.0
    return jnp.where(counts > 0, med, jnp.nan)


def _binned_count_med_nmad(vals: jnp.ndarray, ids: jnp.ndarray, n_bins: int):
    """Per-bin (count, median, NMAD) via two segment sorts — the device analog of
    nd_binning's group-sorted host loop. `ids` in [0, n_bins), n_bins marks invalid."""
    counts_all = jnp.zeros(n_bins + 1, jnp.int32).at[ids].add(1)
    counts = counts_all[:n_bins]
    starts = jnp.concatenate([jnp.zeros(1, jnp.int32), jnp.cumsum(counts_all)[:-1]])[:n_bins]
    _, vals_s = jax.lax.sort((ids, vals), num_keys=2)
    med = _segment_median_sorted(vals_s, starts, counts)
    absdev = jnp.abs(vals - med[jnp.clip(ids, 0, n_bins - 1)])
    _, dev_s = jax.lax.sort((ids, absdev), num_keys=2)
    nmad = 1.4826 * _segment_median_sorted(dev_s, starts, counts)
    return counts, med, nmad


@partial(jax.jit, static_argnames=("n_bins",))
def _hetero_bin_tables_device(gathered: jnp.ndarray, n_bins: int):
    """All nd_binning combos (each 1-D, each 2-D pair, the full N-D) of a gathered stable
    sample, computed on device: only one tiny packed table vector crosses the host boundary.

    gathered: (1 + nvars, N) with row 0 = dh. Bin edges are linspace(min, max, n_bins + 1)
    of each variable over the jointly-valid sample, computed in-graph; the per-variable
    (min, max) pair is appended to the packed output so the host can rebuild the edges.
    Returns one flat f32 vector: per combo [counts (int32-bitcast), median, nmad], then
    [gmin..., gmax...].
    """
    d = gathered[0]
    nvars = gathered.shape[0] - 1
    valid = jnp.isfinite(d)
    for i in range(nvars):
        valid = valid & jnp.isfinite(gathered[1 + i])

    gmin = jnp.min(jnp.where(valid[None, :], gathered[1:], jnp.inf), axis=1)
    gmax = jnp.max(jnp.where(valid[None, :], gathered[1:], -jnp.inf), axis=1)
    edges = gmin[:, None] + (gmax - gmin)[:, None] * jnp.linspace(0.0, 1.0, n_bins + 1)[None, :]

    def var_ids(i):
        # Edges derive from the jointly-valid sample min/max, so every valid value is in
        # range: digitize reduces to a clipped right-side searchsorted (host parity)
        idx = jnp.searchsorted(edges[i], gathered[1 + i], side="right") - 1
        return jnp.clip(idx, 0, n_bins - 1)

    combos: list[tuple[int, ...]] = [(i,) for i in range(nvars)]
    if nvars > 1:
        combos += list(itertools.combinations(range(nvars), 2))
    if nvars > 2:
        combos.append(tuple(range(nvars)))

    out = []
    for combo in combos:
        ids = jnp.zeros_like(d, dtype=jnp.int32)
        tot = 1
        for i in combo:
            ids = ids * n_bins + var_ids(i).astype(jnp.int32)
            tot *= n_bins
        ids = jnp.where(valid, ids, tot)
        out.append(_binned_count_med_nmad(d, ids, tot))
    # ONE packed f32 vector for a single host readback: the per-combo tuples would take
    # 3*len(combos) pulls, each with its own latency. Counts are bitcast (exact past 2^24); the host unpacks by known lengths.
    packed = jnp.concatenate(
        [jnp.concatenate([jax.lax.bitcast_convert_type(c.astype(jnp.int32), jnp.float32),
                          m.astype(jnp.float32), s.astype(jnp.float32)])
         for (c, m, s) in out]
        + [gmin.astype(jnp.float32), gmax.astype(jnp.float32)]
    )
    return packed


@partial(jax.jit, static_argnames=("count", "has_inc", "has_exc"))
def _hetero_prepare_device(d_j, vars_j: tuple, inc, exc, seed, count: int,
                           has_inc: bool, has_exc: bool) -> jnp.ndarray:
    """The heteroscedasticity prepare as ONE device program: joint-validity chain, seeded
    top_k subsample over the valid mask, and the NaN-poisoned gathers. Returns the gathered
    (1 + nvars, count) sample. Op-for-op the former eager chain (same seed -> same sample)."""
    valid = jnp.isfinite(d_j)
    for vj in vars_j:
        valid = valid & jnp.isfinite(vj)
    if has_inc:
        valid = valid & inc
    if has_exc:
        valid = valid & ~exc
    key = jax.random.PRNGKey(seed)
    scores = jnp.where(valid.ravel(), jax.random.uniform(key, (d_j.size,)), -jnp.inf)
    _, idx = jax.lax.top_k(scores, count)
    picked_ok = valid.ravel()[idx]
    return jnp.stack(
        [jnp.where(picked_ok, a.ravel()[idx], jnp.nan) for a in (d_j,) + tuple(vars_j)]
    )


@jax.jit
def _scale_and_sigma_device(gathered: jnp.ndarray, mids_ext: tuple, grid_ext: jnp.ndarray,
                            fac_spread_outliers, vars_full: tuple):
    """Fused two-step standardization scale + full-extent sigma evaluation: one dispatch,
    one scalar readback (the sigma raster stays device-resident)."""
    scale = _two_step_scale_core(gathered, mids_ext, grid_ext, fac_spread_outliers)
    sig = scale * _interp_grid_device(mids_ext, grid_ext, list(vars_full))
    return scale, sig


def _two_step_scale_core(gathered: jnp.ndarray, mids_ext: tuple, grid_ext: jnp.ndarray,
                         fac_spread_outliers) -> jnp.ndarray:
    """jnp-only body of _two_step_scale_device (traceable inside larger programs)."""
    d = gathered[0]
    err = _interp_grid_device(mids_ext, grid_ext, [gathered[1 + i] for i in range(gathered.shape[0] - 1)])
    z = d / err

    def _nmad(v):
        med = jnp.nanmedian(v)
        return 1.4826 * jnp.nanmedian(jnp.abs(v - med))

    spread0 = _nmad(z)
    z = jnp.where(jnp.abs(z) > fac_spread_outliers * spread0, jnp.nan, z)
    return _nmad(z)


@jax.jit
def _two_step_scale_device(gathered: jnp.ndarray, mids_ext: tuple, grid_ext: jnp.ndarray,
                           fac_spread_outliers) -> jnp.ndarray:
    """two_step_standardization's scale on device: z-score the gathered dh by the interpolated
    unscaled error, clip outliers at fac * NMAD, return the re-normalizing NMAD."""
    return _two_step_scale_core(gathered, mids_ext, grid_ext, fac_spread_outliers)


def two_step_standardization(
    dvalues: np.ndarray,
    list_var: Sequence[np.ndarray],
    unscaled_error_fun: Callable[..., np.ndarray],
    spread_statistic: Callable[[np.ndarray], float] = _stat_nmad,
    fac_spread_outliers: float | None = 7,
) -> tuple[np.ndarray, Callable[..., np.ndarray]]:
    """Two-step standardization (reference :530): z-score by the unscaled error function, clip
    outliers at `fac_spread_outliers` * spread, then rescale so the final spread is exactly 1."""
    zscores = np.asarray(unmask(dvalues)) / unscaled_error_fun(*[np.asarray(unmask(v)) for v in list_var])
    if fac_spread_outliers is not None:
        spread0 = spread_statistic(zscores)
        zscores[np.abs(zscores) > fac_spread_outliers * spread0] = np.nan
    scale = spread_statistic(zscores)
    zscores /= scale

    def error_fun(*args: np.ndarray) -> np.ndarray:
        return scale * unscaled_error_fun(*args)

    error_fun.scale = scale
    error_fun.unscaled = unscaled_error_fun

    return zscores, error_fun


_DUMMY_MASK: jnp.ndarray | None = None


def _dummy_mask() -> jnp.ndarray:
    """A cached (1, 1) bool placeholder for absent-mask jit arguments: creating it inline
    costs one broadcast_in_dim device launch per call."""
    global _DUMMY_MASK
    if _DUMMY_MASK is None:
        _DUMMY_MASK = jnp.zeros((1, 1), bool)
    return _DUMMY_MASK


@partial(jax.jit, static_argnames=("has_inc", "has_exc"))
def _standardize_masked_device(d, e, inc, exc, has_inc: bool, has_exc: bool):
    """dh / sigma with include/exclude masks applied, as one fused launch."""
    z = d.astype(jnp.float32) / e.astype(jnp.float32)
    if has_inc:
        z = jnp.where(inc, z, jnp.nan)
    if has_exc:
        z = jnp.where(exc, jnp.nan, z)
    return z


def _device_mask_of(m: Any, ref_raster: Any = None) -> jnp.ndarray | None:
    """Mask as a device bool array: device-resident inputs pass through, host masks are
    coerced then uploaded bit-packed (ops.transfer.device_mask: 8x fewer bytes). Lets a caller upload the stable
    mask ONCE and reuse it across the heteroscedasticity and variogram stages."""
    from xdem_tpu.ops.transfer import device_mask

    if m is None:
        return None
    if isinstance(m, jax.Array):
        return m.astype(bool)
    return device_mask(_coerce_mask(m, ref_raster))


def _coerce_mask(m: Any, ref_raster: Any = None) -> np.ndarray | None:
    """Normalize a Vector / Raster / boolean-array mask into a boolean numpy array."""
    from xdem_tpu.vector import Vector

    if m is None:
        return None
    if isinstance(m, Vector):
        if ref_raster is None:
            raise ValueError("A raster is needed to rasterize vector masks.")
        return m.create_mask(ref_raster)
    if isinstance(m, Raster):
        return np.asarray(m.data) > 0
    if isinstance(m, np.ma.MaskedArray):
        # geoutils Mask.data is a masked bool array; masked slots are excluded
        return np.asarray(m.filled(False), dtype=bool)
    return np.asarray(m, dtype=bool)


def _preprocess_values_with_mask_to_array(
    values: Sequence[Any] | Any,
    include_mask: Any = None,
    exclude_mask: Any = None,
    gsd: float | None = None,
    preserve_shape: bool = True,
) -> tuple[list[np.ndarray] | np.ndarray, float | None]:
    """Normalize rasters/arrays + vector or boolean masks into NaN-masked arrays
    (reference :653)."""
    single = not isinstance(values, (list, tuple))
    vals_list = [values] if single else list(values)

    ref_raster = next((v for v in vals_list if isinstance(v, Raster)), None)
    arrays = []
    for v in vals_list:
        arrays.append(v.get_nanarray() if isinstance(v, Raster) else np.array(np.asarray(unmask(v)), dtype=np.float64))
    if gsd is None and ref_raster is not None:
        gsd = ref_raster.res[0]

    inc = _coerce_mask(include_mask, ref_raster)
    exc = _coerce_mask(exclude_mask, ref_raster)
    stable = np.ones(arrays[0].shape, dtype=bool)
    if inc is not None:
        stable &= inc
    if exc is not None:
        stable &= ~exc
    out = [np.where(stable, a, np.nan) for a in arrays]
    return (out[0] if single else out), gsd


def _estimate_model_heteroscedasticity(
    dvalues: np.ndarray,
    list_var: Sequence[np.ndarray],
    list_var_names: Sequence[str],
    spread_statistic: Callable[[np.ndarray], float] = _stat_nmad,
    list_var_bins: Any = None,
    min_count: int | None = 100,
    fac_spread_outliers: float | None = 7,
) -> tuple[pd.DataFrame, Callable[..., np.ndarray]]:
    """Bin spread against variables, interpolate, standardize (reference :576)."""
    df = nd_binning(
        values=dvalues,
        list_var=list_var,
        list_var_names=list_var_names,
        list_var_bins=list_var_bins,
        statistics=("count", np.nanmedian, spread_statistic),
    )
    unscaled = interp_nd_binning(df, list_var_names=list(list_var_names),
                                 statistic=spread_statistic.__name__, min_count=min_count)
    _, error_fun = two_step_standardization(
        dvalues, list_var, unscaled, spread_statistic=spread_statistic, fac_spread_outliers=fac_spread_outliers
    )
    return df, error_fun


def infer_heteroscedasticity_from_stable(
    dvalues: Any,
    list_var: Sequence[Any],
    stable_mask: Any = None,
    unstable_mask: Any = None,
    list_var_names: Sequence[str] | None = None,
    spread_statistic: Callable[[np.ndarray], float] = _stat_nmad,
    list_var_bins: Any = None,
    min_count: int | None = 100,
    fac_spread_outliers: float | None = 7,
    subsample: int | None = None,
    random_state: int | None = None,
    mesh: Any = None,
) -> tuple[Any, pd.DataFrame, Callable[..., np.ndarray]]:
    """Infer the per-pixel error sigma(vars) from stable terrain (reference :808).

    Returns (error raster/array over the full extent, binning dataframe, error function) —
    the reference's tuple order (reference :875-877).
    `subsample` optionally bins a random subset of the stable values (the binned spread is
    statistically identical for >~1e6 samples and keeps 1e8-pixel rasters tractable); the
    error is still evaluated over the full extent.

    `mesh` (a jax.sharding.Mesh) shards the full-raster error evaluation row-wise across the
    mesh devices (the binned tables stay replicated — they are ~1e2 rows). Requires the
    device path: Raster/jax inputs with an absolute `subsample`.
    """
    pd = import_optional("pandas")
    # (the full device-path condition is re-checked below once inputs are inspected;
    #  mesh= must never be silently ignored)
    if list_var_names is None:
        list_var_names = [f"var{i+1}" for i in range(len(list_var))]

    # Device-resident fast path: the subsample is gathered on device and the error raster is
    # evaluated on device, so no full raster ever crosses the host boundary (at 1e8 px each
    # transfer moves 400 MB). Requires raster/array inputs
    # living on device and an absolute subsample count.
    device_ok = (
        subsample is not None
        and isinstance(dvalues, Raster)
        and all(isinstance(v, (Raster, jax.Array)) for v in list_var)
    )
    if mesh is not None and not device_ok:
        raise ValueError(
            "mesh= requires the device path: a Raster `dvalues`, Raster/jax-array "
            "`list_var` entries, and an absolute `subsample` count."
        )
    if device_ok:
        d_j = jnp.asarray(dvalues.data, jnp.float32)
        vars_j = [jnp.asarray(v.data if isinstance(v, Raster) else v, jnp.float32) for v in list_var]
        inc = _device_mask_of(stable_mask, dvalues)
        exc = _device_mask_of(unstable_mask, dvalues)

        count = int(min(subsample, d_j.size))
        seed = (int(random_state) if isinstance(random_state, (int, np.integer))
                else int(np.random.default_rng(random_state).integers(2**31)))
        # ONE jitted program for the whole prepare (validity chain, seeded top_k subsample,
        # gathers): the eager op-by-op version issued ~20 separate device dispatches.
        dummy = _dummy_mask()
        gathered = _hetero_prepare_device(
            d_j, tuple(vars_j),
            inc if inc is not None else dummy,
            exc if exc is not None else dummy,
            np.uint32(seed), count, inc is not None, exc is not None,
        )

        # Fully-device statistics for the default config (int bins, NMAD spread): the binned
        # count/median/NMAD tables are computed by segment sorts on device and only ~1e2-row
        # tables plus one scale scalar cross to the host. Custom statistics fall back to
        # pulling the gathered sample.
        device_stats = (
            spread_statistic is _stat_nmad
            and (list_var_bins is None or isinstance(list_var_bins, (int, np.integer)))
            and fac_spread_outliers is not None
        )
        if device_stats:
            n_bins = int(list_var_bins) if list_var_bins is not None else 10
            nvars = len(vars_j)
            # Bin edges computed IN-GRAPH from the jointly-valid sample min/max (host
            # nd_binning parity) and appended to the packed readback: a separate lohi pull
            # would serialize two readbacks
            packed = np.asarray(
                _hetero_bin_tables_device(gathered, n_bins), dtype=np.float32)
            lohi = packed[-2 * nvars:].astype(np.float64).reshape(2, nvars)
            packed = packed[:-2 * nvars]
            edges_np = np.stack([np.linspace(lohi[0, i], lohi[1, i], n_bins + 1) for i in range(nvars)])
            combos: list[tuple[int, ...]] = [(i,) for i in range(nvars)]
            if nvars > 1:
                combos += list(itertools.combinations(range(nvars), 2))
            if nvars > 2:
                combos.append(tuple(range(nvars)))
            tables_np = []
            off = 0
            for combo in combos:
                tot = n_bins ** len(combo)
                c = packed[off: off + tot].view(np.int32).astype(np.float64)
                m = packed[off + tot: off + 2 * tot].astype(np.float64)
                s = packed[off + 2 * tot: off + 3 * tot].astype(np.float64)
                tables_np.append([c, m, s])
                off += 3 * tot
            spread_name = spread_statistic.__name__
            frames = []
            for combo, (counts, med, nmad) in zip(combos, tables_np):
                tot = n_bins ** len(combo)
                rec: dict[str, Any] = {
                    "count": counts.astype(int),
                    "nanmedian": med,
                    spread_name: nmad,
                }
                # Decompose flat ids into per-var bin intervals (first var most significant)
                rem = np.arange(tot)
                per = []
                for _ in combo:
                    per.append(rem % n_bins)
                    rem //= n_bins
                per = per[::-1]
                for k, i_var in enumerate(combo):
                    e = edges_np[i_var]
                    rec[list_var_names[i_var]] = pd.arrays.IntervalArray.from_arrays(
                        e[per[k]], e[per[k] + 1], closed="left"
                    )
                f = pd.DataFrame(rec)
                f["nd"] = len(combo)
                frames.append(f)
            df = pd.concat(frames, ignore_index=True)
            cols = ["count", "nanmedian", spread_name] + list(list_var_names) + ["nd"]
            df = df[cols]

            unscaled = interp_nd_binning(df, list_var_names=list(list_var_names),
                                         statistic=spread_name, min_count=min_count)
            sig_fused = None
            if mesh is None:
                # Fuse the standardization scale AND the full-extent sigma evaluation into
                # one dispatch (one scalar readback; the sigma raster stays on device)
                scale_dev, sig_fused = _scale_and_sigma_device(
                    gathered,
                    tuple(np.asarray(m, np.float32) for m in unscaled.mids_ext),
                    np.asarray(unscaled.grid_ext, np.float32),
                    np.float32(fac_spread_outliers), tuple(vars_j),
                )
                scale = float(scale_dev)
            else:
                scale = float(_two_step_scale_device(
                    gathered,
                    tuple(np.asarray(m, np.float32) for m in unscaled.mids_ext),
                    np.asarray(unscaled.grid_ext, np.float32),
                    np.float32(fac_spread_outliers),
                ))

            def error_fun(*args: np.ndarray) -> np.ndarray:
                return scale * unscaled(*args)

            error_fun.scale = scale
            error_fun.unscaled = unscaled
        else:
            gathered_np = np.asarray(gathered, dtype=np.float64)
            d_stable = gathered_np[0]
            vars_stable = list(gathered_np[1:])
            df, error_fun = _estimate_model_heteroscedasticity(
                d_stable, vars_stable, list_var_names,
                spread_statistic=spread_statistic, list_var_bins=list_var_bins,
                min_count=min_count, fac_spread_outliers=fac_spread_outliers,
            )
            unscaled = error_fun.unscaled
            sig_fused = None
        if sig_fused is not None:
            return (Raster(sig_fused.astype(jnp.float32), dvalues.transform, dvalues.crs),
                    df, error_fun)
        pad_rows = 0
        if mesh is not None:
            # Shard the full-extent evaluation row-wise: the interp kernel is elementwise in
            # the raster, so XLA partitions it with zero collectives. Rows NaN-pad to a
            # multiple of the device count (NamedSharding requires even division).
            from jax.sharding import NamedSharding, PartitionSpec

            from xdem_tpu.parallel.mesh import as_mesh_1d

            mesh1 = as_mesh_1d(mesh)
            rows = NamedSharding(mesh1, PartitionSpec(mesh1.axis_names[0], None))
            pad_rows = (-vars_j[0].shape[0]) % mesh1.devices.size
            if pad_rows:
                vars_j = [jnp.pad(v, ((0, pad_rows), (0, 0)), constant_values=jnp.nan)
                          for v in vars_j]
            vars_j = [jax.device_put(v, rows) for v in vars_j]
        sig_dev = error_fun.scale * _interp_grid_device(unscaled.mids_ext, unscaled.grid_ext, vars_j)
        if pad_rows:
            sig_dev = sig_dev[:-pad_rows]
        return Raster(sig_dev.astype(jnp.float32), dvalues.transform, dvalues.crs), df, error_fun

    all_arrays, _ = _preprocess_values_with_mask_to_array(
        [dvalues] + list(list_var), include_mask=stable_mask, exclude_mask=unstable_mask
    )
    d_stable = all_arrays[0]
    vars_stable = all_arrays[1:]

    if subsample is not None and d_stable.size > subsample:
        rng = np.random.default_rng(random_state)
        flat_valid = np.flatnonzero(np.isfinite(d_stable).ravel())
        if len(flat_valid) > subsample:
            sel = rng.choice(flat_valid, subsample, replace=False)
            d_stable = d_stable.ravel()[sel]
            vars_stable = [np.asarray(v).ravel()[sel] for v in vars_stable]

    df, error_fun = _estimate_model_heteroscedasticity(
        d_stable, vars_stable, list_var_names,
        spread_statistic=spread_statistic, list_var_bins=list_var_bins,
        min_count=min_count, fac_spread_outliers=fac_spread_outliers,
    )

    full_vars = [v.get_nanarray() if isinstance(v, Raster) else np.asarray(v, dtype=np.float64) for v in list_var]
    error = error_fun(*full_vars)
    if isinstance(dvalues, Raster):
        error = Raster(error.astype(np.float32), dvalues.transform, dvalues.crs)
    return error, df, error_fun


# ---------------------------------------------------------------------- convolution utils


@partial(jax.jit, static_argnames=())
def _conv2d_multi(imgs: jnp.ndarray, filters: jnp.ndarray) -> jnp.ndarray:
    """True convolution of (N, H, W) images with (M, k1, k2) kernels -> (N, M, H, W)."""
    n, h, w = imgs.shape
    m, k1, k2 = filters.shape
    lhs = imgs[:, None, :, :]  # N, C=1, H, W
    rhs = filters[:, None, ::-1, ::-1]  # O=M, I=1, k1, k2 (flip = convolution)
    out = jax.lax.conv_general_dilated(
        lhs, rhs, window_strides=(1, 1),
        # Asymmetric for even kernels: ((k-1)//2, k//2) matches scipy.ndimage.convolve's
        # same-shape output and center convention (symmetric k//2 padding grew the output
        # by one row/col for even k, silently misaligning the patches method)
        padding=(((k1 - 1) // 2, k1 // 2), ((k2 - 1) // 2, k2 // 2)),
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
        # Full f32: a GPU may otherwise run a float32 convolution in TF32 (~3 decimal
        # digits), and these sums feed the patches-method statistics.
        precision=jax.lax.Precision.HIGHEST,
    )
    return out


def convolution(imgs: np.ndarray, filters: np.ndarray, method: str = "scipy") -> np.ndarray:
    """Multi-image x multi-kernel convolution (reference :2558), on device via XLA conv.

    NaN handling matches scipy.ndimage.convolve on NaN inputs (NaN poisons its footprint);
    edges use zero padding with NaN-footprint invalidation. ``method`` is kept for signature
    parity with the reference's scipy/numba backend switch — both names run the same XLA
    convolution here (numerically identical); any other value raises.
    """
    if method not in ("scipy", "numba"):
        raise ValueError(f"Convolution method must be 'scipy' or 'numba', got {method!r}.")
    imgs_j = jnp.asarray(imgs, dtype=jnp.float32)
    filt_j = jnp.asarray(np.asarray(filters), dtype=jnp.float32)
    nanmask = ~jnp.isfinite(imgs_j)
    imgs0 = jnp.where(nanmask, 0.0, imgs_j)
    out = _conv2d_multi(imgs0, filt_j)
    # Poison any output whose footprint touched a NaN
    k1, k2 = filters.shape[-2:]
    ones = jnp.ones((1, k1, k2), dtype=jnp.float32)
    touched = _conv2d_multi(nanmask.astype(jnp.float32), ones) > 0
    out = jnp.where(touched, jnp.nan, out)
    return np.asarray(out)


def mean_filter_nan(
    img: np.ndarray, kernel_size: int, kernel_shape: str = "circular", method: str = "scipy"
) -> tuple[np.ndarray, np.ndarray, int]:
    """NaN-aware mean filter via two convolutions (sum & valid count) — reference :2597.

    ``method`` is kept for signature parity (scipy/numba select the same XLA kernel here).
    """
    if method not in ("scipy", "numba"):
        raise ValueError(f"Convolution method must be 'scipy' or 'numba', got {method!r}.")
    if kernel_shape == "circular":
        # Reference convention (:880-904): integer center at p//2, radius = distance to the
        # nearest wall, STRICT inequality — e.g. 9 pixels for a 5x5 kernel, not 13.
        c = int(kernel_size / 2)
        radius = min(c, kernel_size - c)
        yy, xx = np.mgrid[:kernel_size, :kernel_size]
        kernel = (np.hypot(xx - c, yy - c) < radius).astype(np.float32)
    else:
        kernel = np.ones((kernel_size, kernel_size), dtype=np.float32)
    img_j = jnp.asarray(img, dtype=jnp.float32)
    valid = jnp.isfinite(img_j)
    img0 = jnp.where(valid, img_j, 0.0)
    filt = jnp.asarray(kernel)[None]
    sums = _conv2d_multi(img0[None], filt)[0, 0]
    cnts = _conv2d_multi(valid.astype(jnp.float32)[None], filt)[0, 0]
    with np.errstate(invalid="ignore", divide="ignore"):
        mean = np.asarray(sums) / np.asarray(cnts)
    nb_pixel_per_kernel = int(kernel.sum())
    return mean, np.asarray(cnts), nb_pixel_per_kernel


# ---------------------------------------------------------------------- variogram models

_VARIOGRAM_MODELS = ("spherical", "gaussian", "exponential", "cubic", "stable", "matern")


def _get_variogram_model_name(model: Any) -> str:
    """Normalize a model name ('Sph'/'Spherical'/'spherical') — reference :1583."""
    if callable(model):
        return model.__name__
    if isinstance(model, str):
        for supp in _VARIOGRAM_MODELS:
            if model.lower() in (supp[:3], supp):
                return supp
    raise ValueError(
        f"Variogram model name {model} not recognized. Supported models are: "
        + ", ".join(_VARIOGRAM_MODELS) + "."
    )


def _model_gamma(h: Any, model: str, r: float, psill: float, smooth: float | None = None, xp: Any = np) -> Any:
    """Variogram model forms with skgstat's effective-range conventions:
    spherical (range = r), exponential (a = r/3), gaussian (a = r/2), cubic (range = r),
    stable (a = r / 3^(1/s)), matern (a = r/2, Bessel-K form)."""
    h = xp.asarray(h, dtype=np.float64 if xp is np else None)
    if model == "spherical":
        hr = xp.clip(h / r, 0, 1)
        return psill * (1.5 * hr - 0.5 * hr**3)
    if model == "exponential":
        a = r / 3.0
        return psill * (1 - xp.exp(-h / a))
    if model == "gaussian":
        a = r / 2.0
        return psill * (1 - xp.exp(-(h**2) / a**2))
    if model == "cubic":
        hr = xp.clip(h / r, 0, 1)
        return psill * (7 * hr**2 - 8.75 * hr**3 + 3.5 * hr**5 - 0.75 * hr**7)
    if model == "stable":
        s = smooth if smooth is not None else 1.0
        a = r / (3 ** (1 / s))
        return psill * (1 - xp.exp(-((h / a) ** s)))
    if model == "matern":
        from scipy.special import gamma as _gamma, kv as _kv

        s = smooth if smooth is not None else 0.5
        a = r / 2.0
        hh = np.asarray(h, dtype=np.float64)
        with np.errstate(invalid="ignore"):
            val = psill * (1 - (2 / _gamma(s)) * ((hh * np.sqrt(s)) / a) ** s * _kv(s, 2 * ((hh * np.sqrt(s)) / a)))
        return np.where(hh == 0, 0.0, val)
    raise ValueError(f"Unknown variogram model: {model}")


def _check_validity_params_variogram(params_variogram_model: pd.DataFrame) -> None:
    """Validate a variogram-parameters dataframe (reference :1967)."""
    expected = ["model", "range", "psill"]
    for col in expected:
        if col not in params_variogram_model.columns:
            raise ValueError(
                f'The dataframe with variogram parameters must contain the columns "model", "range" and "psill".'
            )
    for m in params_variogram_model["model"]:
        _get_variogram_model_name(m)
    if (params_variogram_model["range"] < 0).any() or (params_variogram_model["psill"] < 0).any():
        raise ValueError("The variogram ranges and partial sills must have non-negative values.")


def get_variogram_model_func(params_variogram_model: pd.DataFrame) -> Callable[[np.ndarray], np.ndarray]:
    """Sum-of-models variogram function gamma(h) (reference :1583)."""
    _check_validity_params_variogram(params_variogram_model)
    rows = params_variogram_model.to_dict("records")

    def sum_model(h: np.ndarray) -> np.ndarray:
        h = np.asarray(h, dtype=np.float64)
        out = np.zeros(np.shape(h))
        for row in rows:
            out = out + _model_gamma(h, _get_variogram_model_name(row["model"]), row["range"], row["psill"],
                                     row.get("smooth"))
        return out

    return sum_model


def covariance_from_variogram(params_variogram_model: pd.DataFrame) -> Callable[[np.ndarray], np.ndarray]:
    """Covariance C(h) = total sill - gamma(h) (reference :1623)."""
    _check_validity_params_variogram(params_variogram_model)
    total_sill = np.sum(params_variogram_model["psill"].values)
    gamma = get_variogram_model_func(params_variogram_model)

    def cov(h: np.ndarray) -> np.ndarray:
        return total_sill - gamma(h)

    return cov


def correlation_from_variogram(params_variogram_model: pd.DataFrame) -> Callable[[np.ndarray], np.ndarray]:
    """Correlation rho(h) = C(h) / total sill (reference :1652)."""
    _check_validity_params_variogram(params_variogram_model)
    total_sill = np.sum(params_variogram_model["psill"].values)
    cov = covariance_from_variogram(params_variogram_model)

    def rho(h: np.ndarray) -> np.ndarray:
        return cov(h) / total_sill

    return rho


# ---------------------------------------------------------------------- empirical variogram


def _binned_pair_estimator(
    diffs: jnp.ndarray, dists: jnp.ndarray, bin_edges: np.ndarray, estimator: str
) -> tuple[np.ndarray, np.ndarray]:
    """Per-lag-bin variogram estimator over pairwise samples, on device.

    Estimators (skgstat-compatible):
      * matheron: gamma = sum(d^2) / (2 n)
      * dowd:     gamma = 2.198 * median(|d|)^2 / 2
      * cressie:  gamma = (mean(sqrt(|d|)))^4 / (0.457 + 0.494/n + 0.045/n^2) / 2
      * genton:   gamma = (2.2191 * Qn)^2 / 2 with Qn the Rousseeuw-Croux k-th order statistic
        of pairwise |d_i - d_j| (per-bin values capped at 400 random samples for the O(n^2)
        inner pairs, host-side — the robust scale is insensitive to this subsampling)
    Returns (gamma per bin, count per bin). NaN diffs/dists are excluded.
    """
    if estimator == "genton":
        return _binned_genton(diffs, dists, bin_edges)
    gamma, counts = _binned_pair_core(
        diffs, dists, jnp.asarray(bin_edges, jnp.float32), estimator, len(bin_edges) - 1
    )
    return np.asarray(gamma, dtype=np.float64), np.asarray(counts, dtype=np.int64)


def _binned_pair_core(
    diffs: jnp.ndarray, dists: jnp.ndarray, edges: jnp.ndarray, estimator: str, n_bins: int
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """jnp-only estimator body, traceable inside larger jitted programs."""
    d = jnp.abs(diffs.ravel())
    h = dists.ravel()
    valid = jnp.isfinite(d) & jnp.isfinite(h) & (h >= edges[0]) & (h <= edges[-1])
    idx = jnp.clip(jnp.searchsorted(edges, h, side="right") - 1, 0, n_bins - 1)
    parked = jnp.where(valid, idx, n_bins)

    if estimator == "dowd":
        # Median of |d| per bin: one two-key sort (the payload comes out sorted — an
        # argsort + random gather of 5e7 elements measured ~2x slower on an earlier
        # accelerator). Counts come from the sorted keys too: jnp.bincount is a scatter-add,
        # measured there at about twice the cost of the ENTIRE sort — searchsorted over the
        # sorted bin ids gives the same counts for ~free. Not re-measured on a GPU yet.
        ps, ds = jax.lax.sort((parked, d), num_keys=2)
        bounds = jnp.searchsorted(ps, jnp.arange(n_bins + 1, dtype=parked.dtype), side="left")
        counts = bounds[1:] - bounds[:-1]
        starts = bounds[:n_bins]
        lo = ds[jnp.clip(starts + (counts - 1) // 2, 0, d.size - 1)]
        hi = ds[jnp.clip(starts + counts // 2, 0, d.size - 1)]
        med = jnp.where(counts > 0, 0.5 * (lo + hi), jnp.nan)
        gamma = 2.198 * med**2 / 2
        return gamma, counts

    counts = jnp.bincount(parked, length=n_bins + 1)[:n_bins]

    if estimator == "matheron":
        sums = jnp.bincount(parked, weights=jnp.where(valid, d * d, 0.0), length=n_bins + 1)[:n_bins]
        gamma = jnp.where(counts > 0, sums / (2 * jnp.maximum(counts, 1)), jnp.nan)
    elif estimator == "cressie":
        sums = jnp.bincount(parked, weights=jnp.where(valid, jnp.sqrt(d), 0.0), length=n_bins + 1)[:n_bins]
        n = jnp.maximum(counts, 1)
        mean_sqrt = sums / n
        gamma = jnp.where(
            counts > 0, (mean_sqrt**4) / (0.457 + 0.494 / n + 0.045 / n**2) / 2, jnp.nan
        )
    else:
        raise ValueError(
            f"Estimator '{estimator}' not supported; use 'matheron', 'dowd', 'cressie' or 'genton'."
        )
    return gamma, counts


@partial(jax.jit, static_argnames=("estimator", "n_bins"))
def _grid_variogram_device(
    arr: jnp.ndarray,
    ija: jnp.ndarray,
    ijb: jnp.ndarray,
    gsd,
    edges: jnp.ndarray,
    estimator: str,
    n_bins: int,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """One dispatch for the grid equidistant variogram: gather the sampled pixels, form the
    batched pairwise diffs/dists, and reduce to per-lag-bin (gamma, counts). Only two n_bins
    vectors cross the host boundary (the eager per-op chain costs ~20 dispatches)."""

    def gz(ij):
        ok = ij[..., 0] >= 0
        ii = jnp.clip(ij[..., 0], 0, arr.shape[0] - 1)
        jj = jnp.clip(ij[..., 1], 0, arr.shape[1] - 1)
        z = jnp.where(ok, arr[ii, jj], jnp.nan)
        ci = jnp.where(ok, ii.astype(jnp.float32) * gsd, jnp.nan)
        cj = jnp.where(ok, jj.astype(jnp.float32) * gsd, jnp.nan)
        return z, ci, cj

    za, cai, caj = gz(ija)
    zb, cbi, cbj = gz(ijb)
    diffs = za[:, :, None] - zb[:, None, :]
    dists = jnp.sqrt(
        (cai[:, :, None] - cbi[:, None, :]) ** 2 + (caj[:, :, None] - cbj[:, None, :]) ** 2
    )
    dists = jnp.where(dists <= 0, jnp.nan, dists)
    return _binned_pair_core(diffs, dists, edges, estimator, n_bins)


@partial(jax.jit, static_argnames=("estimator", "n_bins", "chunk"))
def _grid_variogram_device_chunked(
    arr: jnp.ndarray,
    ija: jnp.ndarray,
    ijb: jnp.ndarray,
    gsd,
    edges: jnp.ndarray,
    estimator: str,
    n_bins: int,
    chunk: int,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Memory-bounded variant of _grid_variogram_device for huge pair counts (1e9+ pairs at
    the 1e8-px uncertainty config OOM the flat two-key sort): lax.scan over run chunks
    accumulates per-bin counts and sums (matheron/cressie), and for dowd the exact global
    per-bin median comes from two scans of 16-bit-radix histograms over the positive-f32 bit
    pattern (the same selection as parallel.variogram's distributed median, with scan
    accumulation replacing psum). Device memory is O(chunk*N*M + n_bins*65536) regardless of pairs;
    per-bin counts are int32, so callers guard total pairs <= 2^31-1 (_check_pair_count).

    ija/ijb run counts must be padded to a multiple of `chunk` with -1 (invalid) rows.
    """
    n_chunks = ija.shape[0] // chunk
    ija_c = ija.reshape(n_chunks, chunk, *ija.shape[1:])
    ijb_c = ijb.reshape(n_chunks, chunk, *ijb.shape[1:])

    def pair_block(ij_a, ij_b):
        def gz(ij):
            ok = ij[..., 0] >= 0
            ii = jnp.clip(ij[..., 0], 0, arr.shape[0] - 1)
            jj = jnp.clip(ij[..., 1], 0, arr.shape[1] - 1)
            z = jnp.where(ok, arr[ii, jj], jnp.nan)
            ci = jnp.where(ok, ii.astype(jnp.float32) * gsd, jnp.nan)
            cj = jnp.where(ok, jj.astype(jnp.float32) * gsd, jnp.nan)
            return z, ci, cj

        za, cai, caj = gz(ij_a)
        zb, cbi, cbj = gz(ij_b)
        d = jnp.abs(za[:, :, None] - zb[:, None, :]).ravel()
        h = jnp.sqrt((cai[:, :, None] - cbi[:, None, :]) ** 2
                     + (caj[:, :, None] - cbj[:, None, :]) ** 2).ravel()
        valid = jnp.isfinite(d) & jnp.isfinite(h) & (h > 0) & (h >= edges[0]) & (h <= edges[-1])
        idx = jnp.clip(jnp.searchsorted(edges, h, side="right") - 1, 0, n_bins - 1)
        parked = jnp.where(valid, idx, n_bins)
        return d, parked, valid

    return _chunked_pair_reduce(pair_block, (ija_c, ijb_c), estimator, n_bins)


@partial(jax.jit, static_argnames=("estimator", "n_bins", "chunk"))
def _pairs_variogram_device_chunked(
    za: jnp.ndarray,
    zb: jnp.ndarray,
    ca: jnp.ndarray,
    cb: jnp.ndarray,
    edges: jnp.ndarray,
    estimator: str,
    n_bins: int,
    chunk: int,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Chunked-scan variogram over explicit (R, N)/(R, M) sample arrays and (.., 2) coords
    (the non-grid / point-cloud path) — same memory-bounded reduction as the grid variant.
    Run counts must be padded to a multiple of `chunk` with NaN rows."""
    n_chunks = za.shape[0] // chunk

    def r(a):
        return a.reshape(n_chunks, chunk, *a.shape[1:])

    def pair_block(za_c, zb_c, ca_c, cb_c):
        d = jnp.abs(za_c[:, :, None] - zb_c[:, None, :]).ravel()
        h = jnp.sqrt(jnp.sum((ca_c[:, :, None, :] - cb_c[:, None, :, :]) ** 2, axis=-1)).ravel()
        valid = jnp.isfinite(d) & jnp.isfinite(h) & (h > 0) & (h >= edges[0]) & (h <= edges[-1])
        idx = jnp.clip(jnp.searchsorted(edges, h, side="right") - 1, 0, n_bins - 1)
        parked = jnp.where(valid, idx, n_bins)
        return d, parked, valid

    return _chunked_pair_reduce(pair_block, (r(za), r(zb), r(ca), r(cb)), estimator, n_bins)


def _chunked_pair_reduce(pair_block, xs, estimator: str, n_bins: int):
    """Shared scan-accumulated estimator skeleton for the chunked variogram paths.

    `pair_block(*chunk_inputs) -> (|diffs|, parked bin idx, valid)`; `xs` is the per-chunk
    input pytree scanned over. Traceable only (called from jitted wrappers).
    """

    def counts_sums_scan(weight_fn):
        # Kahan-compensated f32 accumulation: the scan can add billions of O(1) terms, where
        # plain sequential f32 sums drift by ~1e-5..1e-4 relative (f64 is unavailable with
        # x64 off); the compensation keeps the total at f32 roundoff of the true sum.
        def body(carry, inputs):
            counts_acc, sum_acc, comp = carry
            d, parked, valid = pair_block(*inputs)
            counts_acc = counts_acc + jnp.bincount(parked, length=n_bins + 1)[:n_bins]
            chunk_sum = jnp.bincount(
                parked, weights=jnp.where(valid, weight_fn(d), 0.0), length=n_bins + 1
            )[:n_bins]
            y = chunk_sum - comp
            t = sum_acc + y
            comp = (t - sum_acc) - y
            return (counts_acc, t, comp), None

        init = (jnp.zeros(n_bins, jnp.int64 if jax.config.x64_enabled else jnp.int32),
                jnp.zeros(n_bins, jnp.float32), jnp.zeros(n_bins, jnp.float32))
        (counts, sums, _comp), _ = jax.lax.scan(body, init, xs)
        return counts, sums

    if estimator == "matheron":
        counts, sums = counts_sums_scan(lambda d: d * d)
        gamma = jnp.where(counts > 0, sums / (2 * jnp.maximum(counts, 1)), jnp.nan)
        return gamma, counts
    if estimator == "cressie":
        counts, sums = counts_sums_scan(jnp.sqrt)
        n = jnp.maximum(counts, 1)
        gamma = jnp.where(counts > 0, ((sums / n) ** 4) / (0.457 + 0.494 / n + 0.045 / n**2) / 2,
                          jnp.nan)
        return gamma, counts
    if estimator != "dowd":
        raise ValueError(f"Estimator '{estimator}' not supported in the chunked device path.")

    # ---- dowd: exact global per-bin median by two-level radix selection over scans
    def hist_hi_scan():
        def body(carry, inputs):
            counts_acc, hist_acc = carry
            d, parked, _valid = pair_block(*inputs)
            counts_acc = counts_acc + jnp.bincount(parked, length=n_bins + 1)[:n_bins]
            bits = jax.lax.bitcast_convert_type(d.astype(jnp.float32), jnp.int32)
            hi = jnp.where(parked < n_bins, bits >> 16, 0)
            flat = jnp.where(parked < n_bins, parked * 32768 + hi, n_bins * 32768)
            hist_acc = hist_acc + jnp.bincount(flat, length=n_bins * 32768 + 1)[:-1].reshape(
                n_bins, 32768)
            return (counts_acc, hist_acc), None

        init = (jnp.zeros(n_bins, jnp.int32), jnp.zeros((n_bins, 32768), jnp.int32))
        (counts, hist), _ = jax.lax.scan(body, init, xs)
        return counts, hist

    counts, hist_hi = hist_hi_scan()
    cum_hi = jnp.cumsum(hist_hi, axis=1)
    k_lo = jnp.maximum((counts - 1) // 2, 0)
    k_hi = counts // 2

    def bucket_of(k):
        sel = jnp.argmax(cum_hi > k[:, None], axis=1)
        below = jnp.where(sel > 0, jnp.take_along_axis(
            cum_hi, jnp.maximum(sel - 1, 0)[:, None], axis=1)[:, 0], 0)
        return sel, below

    sel_a, below_a = bucket_of(k_lo)
    sel_b, below_b = bucket_of(k_hi)

    # One pass resolves BOTH median ranks: accumulate a lo-bits histogram per selected hi
    # bucket (they usually coincide; when k_lo/k_hi straddle a bucket edge they differ).
    def body(carry, inputs):
        ha, hb = carry
        d, parked, _valid = pair_block(*inputs)
        bits = jax.lax.bitcast_convert_type(d.astype(jnp.float32), jnp.int32)
        hi = bits >> 16
        lo = bits & 0xFFFF
        pk = jnp.clip(parked, 0, n_bins - 1)
        in_a = (parked < n_bins) & (hi == sel_a[pk])
        in_b = (parked < n_bins) & (hi == sel_b[pk])
        flat_a = jnp.where(in_a, parked * 65536 + lo, n_bins * 65536)
        flat_b = jnp.where(in_b, parked * 65536 + lo, n_bins * 65536)
        ha = ha + jnp.bincount(flat_a, length=n_bins * 65536 + 1)[:-1].reshape(n_bins, 65536)
        hb = hb + jnp.bincount(flat_b, length=n_bins * 65536 + 1)[:-1].reshape(n_bins, 65536)
        return (ha, hb), None

    zero = jnp.zeros((n_bins, 65536), jnp.int32)
    (hist_a, hist_b), _ = jax.lax.scan(body, (zero, zero), xs)

    def resolve(hist_lo, sel, below, k):
        cum_lo = jnp.cumsum(hist_lo, axis=1)
        sel_lo = jnp.argmax(cum_lo > (k - below)[:, None], axis=1)
        kth_bits = (sel << 16) | sel_lo
        return jax.lax.bitcast_convert_type(kth_bits.astype(jnp.int32), jnp.float32)

    med = 0.5 * (resolve(hist_a, sel_a, below_a, k_lo) + resolve(hist_b, sel_b, below_b, k_hi))
    med = jnp.where(counts > 0, med, jnp.nan)
    return 2.198 * med**2 / 2, counts


# Pair budget above which the one-dispatch grid variogram switches to the chunked scan
# (the flat two-key sort needs ~20 B/pair of device memory; 2e8 pairs ~ 4 GB). Deriving
# the budget from the device's memory is an open item.
_PAIR_CHUNK_BUDGET = int(2e8)
# Per-bin counts accumulate in on-device int32 (jax x64 is off): past 2^31-1 total pairs the
# counts could wrap silently, so the dispatchers refuse instead.
_PAIR_COUNT_LIMIT = 2**31 - 1


def _check_pair_count(total_pairs: int, chunked_available: bool = True) -> None:
    if not chunked_available and total_pairs > _PAIR_CHUNK_BUDGET:
        raise ValueError(
            f"This sampling method materializes all {total_pairs:.2e} pairwise comparisons "
            f"in one block (limit {_PAIR_CHUNK_BUDGET:.0e}). Reduce `subsample`, or use "
            f"subsample_method='cdist_equidistant' (memory-bounded at any pair count)."
        )
    if total_pairs > _PAIR_COUNT_LIMIT:
        raise ValueError(
            f"The requested variogram forms {total_pairs:.2e} pairwise comparisons, beyond "
            f"the int32 per-bin count limit ({_PAIR_COUNT_LIMIT:.2e}). Reduce `subsample` "
            f"(pairs grow ~subsample^2/2) or split into several `n_variograms` runs."
        )


@partial(jax.jit, static_argnames=("n_bins", "chunk"))
def _pairs_genton_reservoir_chunked(
    za: jnp.ndarray,
    zb: jnp.ndarray,
    ca: jnp.ndarray,
    cb: jnp.ndarray,
    edges: jnp.ndarray,
    n_bins: int,
    chunk: int,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Memory-bounded Genton reservoir: a lax.scan over run chunks keeps the global top-CAP
    signed pair differences per lag bin, ranked by the tie-free deterministic pair keys
    shared with parallel.variogram's distributed Genton — so chunking (like mesh size
    there) never changes which 400 values feed the Qn. Returns
    ((n_bins, CAP) reservoir NaN-padded, per-bin counts)."""
    from xdem_tpu.parallel.variogram import (_GENTON_CAP, _genton_local_topcap,
                                             _genton_merge_topcap, _genton_pair_keys)

    n_chunks = za.shape[0] // chunk
    N, M = za.shape[1], zb.shape[1]

    def r(a):
        return a.reshape(n_chunks, chunk, *a.shape[1:])

    def body(carry, inputs):
        res_v, res_k, counts = carry
        chunk_idx, za_c, zb_c, ca_c, cb_c = inputs
        d_signed = (za_c[:, :, None] - zb_c[:, None, :]).ravel()
        h = jnp.sqrt(jnp.sum((ca_c[:, :, None, :] - cb_c[:, None, :, :]) ** 2, axis=-1)).ravel()
        valid = (jnp.isfinite(d_signed) & jnp.isfinite(h) & (h > 0)
                 & (h >= edges[0]) & (h <= edges[-1]))
        idx = jnp.clip(jnp.searchsorted(edges, h, side="right") - 1, 0, n_bins - 1)
        parked = jnp.where(valid, idx, n_bins)
        counts = counts + jnp.bincount(parked, length=n_bins + 1)[:n_bins]

        key = _genton_pair_keys(chunk_idx * chunk, chunk, N, M, parked, n_bins)
        loc_v, loc_k = _genton_local_topcap(d_signed, parked, key, n_bins)
        res_v, res_k = _genton_merge_topcap(jnp.concatenate([res_v, loc_v], axis=1),
                                            jnp.concatenate([res_k, loc_k], axis=1))
        return (res_v, res_k, counts), None

    init = (jnp.full((n_bins, _GENTON_CAP), jnp.nan, jnp.float32),
            jnp.zeros((n_bins, _GENTON_CAP), jnp.uint32),
            jnp.zeros(n_bins, jnp.int32))
    (res_v, _res_k, counts), _ = jax.lax.scan(
        body, init, (jnp.arange(n_chunks, dtype=jnp.uint32), r(za), r(zb), r(ca), r(cb)))
    return res_v, counts


def _genton_qn_from_reservoir(reservoir: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """Finalize Genton's gamma per bin from the (n_bins, CAP) NaN-padded reservoir."""
    n_bins = reservoir.shape[0]
    gamma = np.full(n_bins, np.nan)
    for b in range(n_bins):
        x = reservoir[b][np.isfinite(reservoir[b])]
        n = len(x)
        if n < 2:
            continue
        pair_diffs = np.abs(x[:, None] - x[None, :])[np.triu_indices(n, k=1)]
        k = int((n // 2 + 1) * (n // 2) / 2)
        k = min(max(k, 1), len(pair_diffs))
        qn = np.partition(pair_diffs, k - 1)[k - 1]
        gamma[b] = (2.2191 * qn) ** 2 / 2
    return gamma


def _binned_genton(diffs: jnp.ndarray, dists: jnp.ndarray, bin_edges: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Genton (1998) highly-robust variogram: (2.2191 * Qn(d))^2 / 2 per lag bin, where Qn is
    the k-th order statistic (k = C(n//2+1, 2)) of the pairwise |d_i - d_j|."""
    # Bin in float32 like every device estimator path: grid-mode distances are
    # pixel-quantized and often tie EXACTLY at the sqrt(2)-geometric edges, so a float64
    # comparison here would systematically classify those boundary pairs one bin lower.
    edges = np.asarray(bin_edges, dtype=np.float32)
    n_bins = len(edges) - 1
    # Qn operates on the SIGNED pairwise value differences (their spread is what it estimates)
    d = np.asarray(diffs, dtype=np.float64).ravel()
    h = np.asarray(dists, dtype=np.float32).ravel()
    valid = np.isfinite(d) & np.isfinite(h) & (h >= edges[0]) & (h <= edges[-1])
    idx = np.clip(np.searchsorted(edges, h[valid], side="right") - 1, 0, n_bins - 1)
    dv = d[valid]
    counts = np.bincount(idx, minlength=n_bins)
    gamma = np.full(n_bins, np.nan)
    rng = np.random.default_rng(0)
    for b in range(n_bins):
        x = dv[idx == b]
        if len(x) < 2:
            continue
        if len(x) > 400:
            x = rng.choice(x, 400, replace=False)
        n = len(x)
        pair_diffs = np.abs(x[:, None] - x[None, :])[np.triu_indices(n, k=1)]
        k = int((n // 2 + 1) * (n // 2) / 2)
        k = min(max(k, 1), len(pair_diffs))
        qn = np.partition(pair_diffs, k - 1)[k - 1]
        gamma[b] = (2.2191 * qn) ** 2 / 2
    return gamma, counts.astype(np.int64)


def _choose_cdist_equidistant_sampling_parameters(
    extent: tuple[float, float, float, float], shape: tuple[int, int], subsample: int, nb_rings: int = 10
) -> tuple[int, int, float]:
    """Partition `subsample` into runs/samples matching ~N^2/2 pairwise comparisons
    (reference :1104-1183)."""
    min_subsample = np.ceil(np.sqrt(2 * nb_rings * 2**2) + 1)
    if subsample < min_subsample:
        raise ValueError(f"The number of subsamples needs to be at least {min_subsample:.0f}.")
    pairwise_comp_per_disk = np.ceil(subsample**2 / (2 * nb_rings))
    if pairwise_comp_per_disk < 10:
        runs = int(pairwise_comp_per_disk / 2**2)
    else:
        runs = int(min(100, 10 * np.ceil((pairwise_comp_per_disk / (2**2 * 10)) ** (1 / 3))))
    samples = int(np.ceil(np.sqrt(pairwise_comp_per_disk / runs)))
    maxdist = np.sqrt((extent[1] - extent[0]) ** 2 + (extent[3] - extent[2]) ** 2)
    res = np.mean([(extent[1] - extent[0]) / (shape[0] - 1), (extent[3] - extent[2]) / (shape[1] - 1)])
    ratio_subsample = res**2 * samples / (np.pi * maxdist**2 / np.sqrt(2) ** (2 * nb_rings))
    return runs, samples, ratio_subsample


def _sample_with_pad(rng: np.random.Generator, candidates: np.ndarray, n: int) -> np.ndarray:
    """Random choice of up to n indices, padded with -1 (masked later) when insufficient."""
    out = np.full(n, -1, dtype=np.int64)
    if len(candidates) == 0:
        return out
    take = min(n, len(candidates))
    out[:take] = rng.choice(candidates, take, replace=False)
    return out


class EmpiricalVariogramKArgs(TypedDict, total=False):
    """Optional keyword arguments of sample_empirical_variogram, for forwarding through
    higher-level wrappers (reference spatialstats.py:1284-1292)."""

    runs: int
    samples: int
    nb_rings: int
    maxlag: float
    bin_func: Sequence[float]
    estimator: str



@partial(jax.jit, static_argnames=("runs", "samples", "nb_rings", "nx", "ny", "m"))
def _draw_equidistant_rings_device(key, valid, runs: int, samples: int, nb_rings: int,
                                   nx: int, ny: int, radius0_px, m: int):
    """Device-native equidistant disk/ring sampling (the host draw's exact algorithm):
    random valid run centers, m candidate draws per (run, ring) slot, first `samples`
    valid-landing candidates kept (stable argsort), empty slots marked -1.

    Returns (ija, ijb) int32 index arrays of shapes (runs, samples, 2) and
    (runs, (nb_rings + 1) * samples, 2) — consumed directly by the device estimators, so
    neither the validity mask nor the samples round-trip the host.
    """
    k1, k2, k3 = jax.random.split(key, 3)
    valid_flat = valid.ravel()
    scores = jnp.where(valid_flat, jax.random.uniform(k1, valid_flat.shape), -jnp.inf)
    _, ci = jax.lax.top_k(scores, runs)  # `runs` random valid pixels (without replacement)
    cr = (ci // ny).astype(jnp.float32)
    cc = (ci % ny).astype(jnp.float32)
    n_rings1 = nb_rings + 1
    ring_hi = radius0_px * jnp.sqrt(2.0) ** jnp.arange(n_rings1, dtype=jnp.float32)
    ring_lo = jnp.concatenate([jnp.zeros(1, jnp.float32), ring_hi[:-1]])
    theta = jax.random.uniform(k2, (runs, n_rings1, m), minval=0.0, maxval=2.0 * jnp.pi)
    u = jax.random.uniform(k3, (runs, n_rings1, m))
    r = jnp.sqrt(ring_lo[None, :, None] ** 2
                 + u * (ring_hi[None, :, None] ** 2 - ring_lo[None, :, None] ** 2))
    ii = jnp.round(cr[:, None, None] + r * jnp.cos(theta)).astype(jnp.int32)
    jj = jnp.round(cc[:, None, None] + r * jnp.sin(theta)).astype(jnp.int32)
    okm = (ii >= 0) & (ii < nx) & (jj >= 0) & (jj < ny)
    okm &= valid_flat[jnp.clip(ii, 0, nx - 1) * ny + jnp.clip(jj, 0, ny - 1)]
    order = jnp.argsort(~okm, axis=-1, stable=True)[..., :samples]
    n_ok = okm.sum(axis=-1, keepdims=True)
    keep = jnp.arange(samples) < n_ok
    ii_s = jnp.where(keep, jnp.take_along_axis(ii, order, -1), -1)
    jj_s = jnp.where(keep, jnp.take_along_axis(jj, order, -1), -1)
    rings = jnp.stack([ii_s, jj_s], axis=-1)  # (runs, n_rings1, samples, 2)
    ija = rings[:, 0]
    ijb = rings.reshape(runs, n_rings1 * samples, 2)
    return ija, ijb


@partial(jax.jit, static_argnames=("runs", "samples", "nb_rings", "nx", "ny", "m"))
def _draw_rings_from_arr(seed, arr, runs: int, samples: int, nb_rings: int,
                         nx: int, ny: int, radius0_px, m: int):
    """One launch for the device annuli draw: the PRNGKey creation, the validity mask and
    the ring sampling fuse into a single program (issued eagerly, the key/isfinite ops cost
    2 extra dispatches per variogram)."""
    return _draw_equidistant_rings_device(jax.random.PRNGKey(seed), jnp.isfinite(arr),
                                          runs, samples, nb_rings, nx, ny, radius0_px, m)


@partial(jax.jit, static_argnames=("estimator", "n_bins"))
def _grid_variogram_packed(arr, ija, ijb, gsd, edges, estimator: str, n_bins: int):
    """_grid_variogram_device + the int32-counts bitcast pack as ONE launch (one readback,
    no precision loss: a bin can exceed 2^24 pairs, where an f32 count would round)."""
    gamma, counts = _grid_variogram_device(arr, ija, ijb, gsd, edges, estimator, n_bins)
    return jnp.concatenate(
        [gamma, jax.lax.bitcast_convert_type(counts.astype(jnp.int32), jnp.float32)]
    )


@partial(jax.jit, static_argnames=("estimator", "n_bins", "chunk"))
def _grid_variogram_packed_chunked(arr, ija, ijb, gsd, edges, estimator: str, n_bins: int,
                                   chunk: int):
    """Chunked-scan variant of _grid_variogram_packed (same packed contract)."""
    gamma, counts = _grid_variogram_device_chunked(arr, ija, ijb, gsd, edges, estimator,
                                                   n_bins, chunk)
    return jnp.concatenate(
        [gamma, jax.lax.bitcast_convert_type(counts.astype(jnp.int32), jnp.float32)]
    )


def sample_empirical_variogram(
    values: Any,
    gsd: float | None = None,
    coords: np.ndarray | None = None,
    subsample: int = 1000,
    subsample_method: str = "cdist_equidistant",
    n_variograms: int = 1,
    n_jobs: int = 1,
    random_state: int | None = None,
    estimator: str = "dowd",
    maxlag: float | None = None,
    bin_func: Sequence[float] | None = None,
    nb_rings: int = 10,
    runs: int | None = None,
    samples: int | None = None,
    mesh: Any = None,
    **kwargs: Any,
) -> pd.DataFrame:
    """Sample an empirical variogram with spatial subsampling adapted to grids.

    Reference :1295 — same sampling schemes re-architected as device pairwise kernels:
      * "cdist_equidistant" (default): Hugonnet et al. (2022) disk/ring equidistant sampling;
        runs/samples partitioned automatically (reference :1104-1183); all runs batched into
        one pairwise-distance + binned-estimator device computation.
      * "cdist_point"/"pdist_point": random-point ensembles, matmul-shaped distance blocks.
      * "pdist_disk"/"pdist_ring": subsampling within a disk/ring footprint.
    Lag bins are sqrt(2)-geometric from sqrt(2)*gsd to maxlag (reference :1439-1449); the last
    (undersampled) bin is dropped; estimators: dowd (default), matheron, cressie.

    `mesh` (a jax.sharding.Mesh) shards the sampling runs across devices with psum'd bin
    reductions (parallel/variogram.py) — mesh-invariant-exact for all four estimators; only
    available with the default "cdist_equidistant" method. This replaces the reference's
    multiprocessing.Pool `n_jobs` (reference :1499-1509): a value other than 1 raises, since
    a single device already computes all runs in one dispatch.

    Returns a DataFrame with (exp, lags, count, err_exp).
    """
    pd = import_optional("pandas")
    if n_jobs != 1:
        raise NotImplementedError(
            "n_jobs process parallelism does not exist on this backend (one device computes "
            "all runs in a single dispatch); pass mesh= to shard runs across devices."
        )
    if mesh is not None and subsample_method != "cdist_equidistant":
        raise ValueError("mesh= sharding is only implemented for subsample_method="
                         "'cdist_equidistant' (the reference's default scheme).")
    from xdem_tpu.raster import Raster

    arr_dev = None  # device-resident values (grid equidistant mode only)
    if isinstance(values, Raster):
        gsd = values.res[0]
        if subsample_method == "cdist_equidistant":
            arr_dev = jnp.asarray(values.data, jnp.float32)
        arr = None if arr_dev is not None else values.get_nanarray()
    elif isinstance(values, jnp.ndarray) and subsample_method == "cdist_equidistant" and values.ndim == 2:
        arr_dev = values
        arr = None
    else:
        arr = np.asarray(unmask(values), dtype=np.float64)
    if arr_dev is not None:
        # Device grid mode: sampling AND estimation stay on device — nothing but the final
        # per-bin tables crosses the host boundary (the f32 raster stays on the device: a
        # 400 MB pull at the 10k^2 uncertainty config, and the bool mask a round trip per
        # call).
        arr = None
    else:
        arr = np.squeeze(arr)

    if subsample_method not in ("cdist_equidistant", "cdist_point", "pdist_point", "pdist_disk", "pdist_ring"):
        raise TypeError(
            'The subsampling method must be one of "cdist_equidistant, "cdist_point", "pdist_point", '
            '"pdist_disk" or "pdist_ring".'
        )
    ndim = 2 if arr_dev is not None else arr.ndim
    if ndim == 1 and coords is None:
        raise ValueError("Coordinates must be provided for 1D value arrays.")
    if ndim == 2 and gsd is None:
        raise ValueError("The ground sampling distance must be defined when passing a 2D values array.")

    grid_valid: np.ndarray | None = None
    if arr_dev is not None:
        nx, ny = arr_dev.shape
        shape = (nx, ny)
        grid_valid = None  # device path: the validity mask never leaves the device
        extent = (0.0, (nx - 1) * gsd, 0.0, (ny - 1) * gsd)
        coords_v = vals_v = None
    elif arr.ndim == 2:
        # Grid mode: keep the 2-D structure (coordinates are analytic), never materialize an
        # O(N) coordinate array — at 1e8 pixels that alone is gigabytes.
        nx, ny = arr.shape
        shape = (nx, ny)
        grid_valid = np.isfinite(arr)
        extent = (0.0, (nx - 1) * gsd, 0.0, (ny - 1) * gsd)
        if subsample_method != "cdist_equidistant":
            x, y = np.meshgrid(np.arange(nx) * gsd, np.arange(ny) * gsd, indexing="ij")
            coords_all = np.column_stack([x.ravel(), y.ravel()])
            vals_all = arr.ravel()
            valid = np.isfinite(vals_all)
            coords_v = coords_all[valid]
            vals_v = vals_all[valid]
        else:
            coords_v = vals_v = None
    else:
        coords_all = np.asarray(coords, dtype=np.float64)
        if coords_all.shape[0] == 2 and coords_all.shape[1] != 2:
            coords_all = coords_all.T
        vals_all = arr
        shape = (int(np.sqrt(len(vals_all))),) * 2
        extent = (coords_all[:, 0].min(), coords_all[:, 0].max(), coords_all[:, 1].min(), coords_all[:, 1].max())
        valid = np.isfinite(vals_all)
        coords_v = coords_all[valid]
        vals_v = vals_all[valid]
        if gsd is None:
            gsd = float(np.sqrt(np.median(np.diff(np.sort(np.unique(coords_v[:, 0]))) ** 2)))
        grid_valid = None

    if maxlag is None:
        maxlag = float(np.hypot(extent[1] - extent[0], extent[3] - extent[2]))

    # sqrt(2)-geometric lag bins (reference :1439-1449)
    if bin_func is None:
        edges = [0.0]
        right = np.sqrt(2) * gsd
        while right < maxlag:
            edges.append(right)
            right *= np.sqrt(2)
        edges.append(maxlag)
    else:
        edges = [0.0] + list(bin_func)
    bin_edges = np.asarray(edges, dtype=np.float64)

    rng_master = np.random.default_rng(random_state)

    def one_variogram(rng: np.random.Generator) -> tuple[np.ndarray, np.ndarray]:
        if subsample_method == "cdist_equidistant":
            if runs is None or samples is None:
                runs_, samples_, _ratio = _choose_cdist_equidistant_sampling_parameters(
                    extent, shape, subsample, nb_rings
                )
            else:
                runs_, samples_ = runs, samples
            maxdist = np.hypot(extent[1] - extent[0], extent[3] - extent[2])
            radius0 = maxdist / np.sqrt(2) ** nb_rings

            ija = ijb = None
            if arr_dev is not None:
                # Fully-device sampling: the annuli draw, validity selection, gather and
                # estimator all run in-graph (one jitted sampler + one estimator dispatch)
                nx_g, ny_g = arr_dev.shape
                n_rings1 = nb_rings + 1
                m = 8 * samples_
                ija, ijb = _draw_rings_from_arr(
                    np.uint32(rng.integers(2**31)), arr_dev, runs_, samples_, nb_rings,
                    nx_g, ny_g, np.float32(radius0 / gsd), m,
                )
            elif grid_valid is not None:
                # Grid fast path: sample disks/annuli analytically by pixel offsets —
                # O(runs * samples) instead of scanning all coordinates per run (essential
                # at 1e8-pixel dDEMs, the 10k^2 uncertainty config).
                nx_g, ny_g = grid_valid.shape
                rr_v, cc_v = np.nonzero(grid_valid)

                # All (run, ring) annuli sampled in one vectorized batch: draw 8x candidates
                # per slot, keep the first `samples_` landing on valid pixels (a stable
                # argsort on the invalid mask moves hits to the front of each slot).
                n_rings1 = nb_rings + 1
                m = 8 * samples_
                ci = rng.integers(0, len(rr_v), runs_)
                centers = np.stack([rr_v[ci], cc_v[ci]], axis=1).astype(np.float64)
                ring_hi = radius0 * np.sqrt(2.0) ** np.arange(n_rings1)  # ring k max radius
                ring_lo = np.concatenate([[0.0], ring_hi[:-1]])          # ring 0 is the disk
                theta = rng.uniform(0, 2 * np.pi, (runs_, n_rings1, m))
                r = np.sqrt(rng.uniform(ring_lo[:, None] ** 2, ring_hi[:, None] ** 2,
                                        (runs_, n_rings1, m))) / gsd
                ii = np.round(centers[:, None, None, 0] + r * np.cos(theta)).astype(np.int64)
                jj = np.round(centers[:, None, None, 1] + r * np.sin(theta)).astype(np.int64)
                okm = (ii >= 0) & (ii < nx_g) & (jj >= 0) & (jj < ny_g)
                okm &= grid_valid[np.clip(ii, 0, nx_g - 1), np.clip(jj, 0, ny_g - 1)]
                order = np.argsort(~okm, axis=-1, kind="stable")[..., :samples_]
                n_ok = okm.sum(axis=-1, keepdims=True)
                keep = np.arange(samples_) < n_ok  # slots past the hit count stay empty
                rings = np.full((runs_, n_rings1, samples_, 2), -1, dtype=np.int64)
                rings[..., 0] = np.where(keep, np.take_along_axis(ii, order, -1), -1)
                rings[..., 1] = np.where(keep, np.take_along_axis(jj, order, -1), -1)
                ija = rings[:, 0]
                ijb = rings.reshape(runs_, n_rings1 * samples_, 2)
            else:
                idx_a = []  # center disk samples per run
                idx_b = []  # disk + ring samples per run
                for _r in range(runs_):
                    center = coords_v[rng.integers(0, len(coords_v))]
                    dist_c = np.hypot(coords_v[:, 0] - center[0], coords_v[:, 1] - center[1])
                    disk = np.flatnonzero(dist_c <= radius0)
                    ia = _sample_with_pad(rng, disk, samples_)
                    ib = [ia]
                    for k in range(1, nb_rings + 1):
                        ring = np.flatnonzero(
                            (dist_c > radius0 * np.sqrt(2) ** (k - 1)) & (dist_c <= radius0 * np.sqrt(2) ** k)
                        )
                        ib.append(_sample_with_pad(rng, ring, samples_))
                    idx_a.append(ia)
                    idx_b.append(np.concatenate(ib))
                ia = np.asarray(idx_a)  # (R, N)
                ib = np.asarray(idx_b)  # (R, N*(X+1))

                za = np.where(ia >= 0, vals_v[np.clip(ia, 0, None)], np.nan)
                zb = np.where(ib >= 0, vals_v[np.clip(ib, 0, None)], np.nan)
                ca = np.where(ia[..., None] >= 0, coords_v[np.clip(ia, 0, None)], np.nan)
                cb = np.where(ib[..., None] >= 0, coords_v[np.clip(ib, 0, None)], np.nan)


            if ija is not None:

                total_pairs = ija.shape[0] * ija.shape[1] * ijb.shape[1]
                _check_pair_count(total_pairs)
                if mesh is None and arr_dev is not None and estimator != "genton":
                    if total_pairs > _PAIR_CHUNK_BUDGET:
                        # Billions of pairs OOM the flat sort: scan run chunks instead
                        ija = np.asarray(ija)  # host pad (device draw yields jax arrays)
                        ijb = np.asarray(ijb)
                        per_run = ija.shape[1] * ijb.shape[1]
                        chunk = max(1, _PAIR_CHUNK_BUDGET // (8 * per_run))
                        pad_r = (-ija.shape[0]) % chunk
                        ija_p = np.pad(ija, ((0, pad_r), (0, 0), (0, 0)), constant_values=-1)
                        ijb_p = np.pad(ijb, ((0, pad_r), (0, 0), (0, 0)), constant_values=-1)
                        packed_d = _grid_variogram_packed_chunked(
                            arr_dev, jnp.asarray(ija_p.astype(np.int32)),
                            jnp.asarray(ijb_p.astype(np.int32)), np.float32(gsd),
                            bin_edges.astype(np.float32), estimator,
                            len(bin_edges) - 1, chunk,
                        )
                    else:
                        # Gather + pairwise + binned estimator + counts pack as ONE dispatch
                        # (np.float32 scalars / pre-cast numpy edges enter the program as
                        # plain transfers — jnp conversions here each cost a device launch)
                        def _as_i32(a):
                            return a if isinstance(a, jax.Array) else jnp.asarray(
                                np.asarray(a, np.int32))

                        packed_d = _grid_variogram_packed(
                            arr_dev, _as_i32(ija), _as_i32(ijb), np.float32(gsd),
                            bin_edges.astype(np.float32), estimator, len(bin_edges) - 1,
                        )
                    packed = np.asarray(packed_d, dtype=np.float32)
                    nb = len(bin_edges) - 1
                    return (packed[:nb].astype(np.float64),
                            packed[nb:].view(np.int32).astype(np.int64))

                def gather(ij):
                    ij = np.asarray(ij)  # device-draw indices: a small explicit download
                    ok_ij = ij[..., 0] >= 0
                    ii = np.clip(ij[..., 0], 0, nx_g - 1)
                    jj = np.clip(ij[..., 1], 0, ny_g - 1)
                    if arr_dev is not None:
                        # Device gather: only (runs x samples) values cross the boundary
                        z_g = np.asarray(arr_dev[jnp.asarray(ii), jnp.asarray(jj)], np.float64)
                    else:
                        z_g = arr[ii, jj]
                    z = np.where(ok_ij, z_g, np.nan)
                    co = np.stack([np.where(ok_ij, ii * gsd, np.nan),
                                   np.where(ok_ij, jj * gsd, np.nan)], axis=-1)
                    return z, co

                za, ca = gather(ija)
                zb, cb = gather(ijb)

            total_pairs = za.shape[0] * za.shape[1] * zb.shape[1]
            _check_pair_count(total_pairs)
            if mesh is not None:
                # Runs sharded across the device mesh with psum'd bin reductions —
                # mesh-invariant-exact for all estimators (parallel/variogram.py)
                from xdem_tpu.parallel.mesh import as_mesh_1d
                from xdem_tpu.parallel.variogram import sharded_variogram_bins

                gamma_s, counts_s = sharded_variogram_bins(
                    za, zb, ca, cb, bin_edges, as_mesh_1d(mesh), estimator=estimator
                )
                return gamma_s, counts_s.astype(np.int64)
            if total_pairs > _PAIR_CHUNK_BUDGET:
                per_run = za.shape[1] * zb.shape[1]
                chunk = max(1, _PAIR_CHUNK_BUDGET // (8 * per_run))
                pad_r = (-za.shape[0]) % chunk

                def padnan(a):
                    return np.pad(a, ((0, pad_r),) + ((0, 0),) * (a.ndim - 1),
                                  constant_values=np.nan)

                args_dev = (jnp.asarray(padnan(za), jnp.float32),
                            jnp.asarray(padnan(zb), jnp.float32),
                            jnp.asarray(padnan(ca), jnp.float32),
                            jnp.asarray(padnan(cb), jnp.float32),
                            jnp.asarray(bin_edges, jnp.float32))
                if estimator == "genton":
                    res, counts_d = _pairs_genton_reservoir_chunked(
                        *args_dev, len(bin_edges) - 1, chunk)
                    gamma = _genton_qn_from_reservoir(np.asarray(res, np.float64),
                                                      np.asarray(counts_d))
                    return gamma, np.asarray(counts_d, dtype=np.int64)
                gamma_d, counts_d = _pairs_variogram_device_chunked(
                    *args_dev, estimator, len(bin_edges) - 1, chunk,
                )
                return (np.asarray(gamma_d, dtype=np.float64),
                        np.asarray(counts_d, dtype=np.int64))
            za_j, zb_j = jnp.asarray(za, jnp.float32), jnp.asarray(zb, jnp.float32)
            ca_j, cb_j = jnp.asarray(ca, jnp.float32), jnp.asarray(cb, jnp.float32)
            # Batched pairwise over runs: (R, N, M)
            diffs = za_j[:, :, None] - zb_j[:, None, :]
            dists = jnp.sqrt(
                jnp.sum((ca_j[:, :, None, :] - cb_j[:, None, :, :]) ** 2, axis=-1)
            )
            # Remove self-pairs (zero distance from the duplicated disk block)
            dists = jnp.where(dists <= 0, jnp.nan, dists)
            return _binned_pair_estimator(diffs, dists, bin_edges, estimator)

        if subsample_method in ("cdist_point", "pdist_point"):
            n = min(subsample, len(vals_v))
            _check_pair_count(n * n, chunked_available=False)
            i1 = rng.choice(len(vals_v), n, replace=False)
            if subsample_method == "cdist_point":
                i2 = rng.choice(len(vals_v), n, replace=False)
            else:
                i2 = i1
            z1, z2 = jnp.asarray(vals_v[i1], jnp.float32), jnp.asarray(vals_v[i2], jnp.float32)
            c1, c2 = jnp.asarray(coords_v[i1], jnp.float32), jnp.asarray(coords_v[i2], jnp.float32)
            diffs = z1[:, None] - z2[None, :]
            dists = jnp.sqrt(jnp.sum((c1[:, None, :] - c2[None, :, :]) ** 2, axis=-1))
            dists = jnp.where(dists <= 0, jnp.nan, dists)
            if subsample_method == "pdist_point":
                # Only the upper triangle (each pair once)
                triu = jnp.triu(jnp.ones((n, n), bool), k=1)
                dists = jnp.where(triu, dists, jnp.nan)
            return _binned_pair_estimator(diffs, dists, bin_edges, estimator)

        # pdist_disk / pdist_ring: subsample within a disk or ring footprint around a center
        center = coords_v[rng.integers(0, len(coords_v))]
        dist_c = np.hypot(coords_v[:, 0] - center[0], coords_v[:, 1] - center[1])
        maxdist = np.hypot(extent[1] - extent[0], extent[3] - extent[2])
        if subsample_method == "pdist_disk":
            sel = np.flatnonzero(dist_c <= maxdist / 4)
        else:
            sel = np.flatnonzero((dist_c > maxdist / 8) & (dist_c <= maxdist / 4))
        n = min(subsample, len(sel))
        if n < 2:
            raise ValueError("Not enough valid points in the disk/ring for subsampling.")
        _check_pair_count(n * n, chunked_available=False)
        ii = rng.choice(sel, n, replace=False)
        z1 = jnp.asarray(vals_v[ii], jnp.float32)
        c1 = jnp.asarray(coords_v[ii], jnp.float32)
        diffs = z1[:, None] - z1[None, :]
        dists = jnp.sqrt(jnp.sum((c1[:, None, :] - c1[None, :, :]) ** 2, axis=-1))
        triu = jnp.triu(jnp.ones((n, n), bool), k=1)
        dists = jnp.where(triu, dists, jnp.nan)
        return _binned_pair_estimator(diffs, dists, bin_edges, estimator)

    gammas = []
    counts = []
    for i in range(n_variograms):
        child = np.random.default_rng(rng_master.integers(0, 2**31 - 1))
        g, c = one_variogram(child)
        gammas.append(g)
        counts.append(c)
    gammas_arr = np.asarray(gammas)
    counts_arr = np.asarray(counts)

    lags = bin_edges[1:]
    if n_variograms == 1:
        df = pd.DataFrame({"exp": gammas_arr[0], "lags": lags, "count": counts_arr[0]})
        df["err_exp"] = np.nan
    else:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            df = pd.DataFrame(
                {
                    "exp": np.nanmean(gammas_arr, axis=0),
                    "lags": lags,
                    "count": counts_arr.sum(axis=0),
                    "err_exp": np.nanstd(gammas_arr, axis=0) / np.sqrt(n_variograms),
                }
            )
    # Drop the last, always undersampled lag bin (reference :1541)
    df = df.iloc[:-1]
    return df.astype({"exp": "float64", "lags": "float64", "count": "int64"}).reset_index(drop=True)


def fit_sum_model_variogram(
    list_models: Sequence[str],
    empirical_variogram: pd.DataFrame,
    bounds: Sequence[tuple[float, float]] | None = None,
    p0: Sequence[float] | None = None,
    maxfev: int | None = None,
) -> tuple[Callable[[np.ndarray], np.ndarray], pd.DataFrame]:
    """Weighted bounded fit of a sum of variogram models to an empirical variogram
    (reference :1680): trf curve_fit, p0 from the moving-average sill."""
    pd = import_optional("pandas")
    from scipy.optimize import curve_fit

    model_names = [_get_variogram_model_name(m) for m in list_models]

    def variogram_sum(h, *args):
        out = np.zeros(np.shape(h))
        i = 0
        for name in model_names:
            out = out + _model_gamma(h, name, args[i], args[i + 1])
            i += 2
        return out

    emp = empirical_variogram[np.isfinite(empirical_variogram["exp"].values)]
    if maxfev is None:
        # Near-flat empirical variograms (noise-dominated dh) can exhaust scipy's default
        # budget; a generous ceiling keeps the trf fit deterministic and convergent.
        maxfev = 20000
    n_average = int(np.ceil(len(emp) / 10))
    exp_movaverage = np.convolve(emp["exp"].values, np.ones(max(n_average, 1)) / max(n_average, 1), mode="valid")
    max_var = np.max(exp_movaverage)

    if bounds is None:
        bounds = [(0, emp["lags"].values[-1]), (0, max_var)] * len(model_names)
    if p0 is None:
        p0 = []
        for i in range(len(model_names)):
            p0 += [((i + 1) / len(model_names)) * emp["lags"].values[-1],
                   ((i + 1) / len(model_names)) * max_var]

    final_bounds = np.transpose(np.asarray(bounds))
    err = emp["err_exp"].values
    use_weights = not (np.all(np.isnan(err)) or np.all(err == 0))
    if use_weights:
        ok = np.isfinite(err) & (err > 0)
        cof, _ = curve_fit(variogram_sum, emp["lags"].values[ok], emp["exp"].values[ok], method="trf",
                           p0=p0, bounds=final_bounds, sigma=err[ok], maxfev=maxfev)
    else:
        cof, _ = curve_fit(variogram_sum, emp["lags"].values, emp["exp"].values, method="trf",
                           p0=p0, bounds=final_bounds, maxfev=maxfev)

    params = pd.DataFrame({
        "model": model_names,
        "range": [cof[2 * i] for i in range(len(model_names))],
        "psill": [cof[2 * i + 1] for i in range(len(model_names))],
    })
    return get_variogram_model_func(params), params


def _estimate_model_spatial_correlation(
    dvalues: np.ndarray,
    list_models: Sequence[str],
    estimator: str = "dowd",
    gsd: float | None = None,
    coords: np.ndarray | None = None,
    subsample: int = 1000,
    subsample_method: str = "cdist_equidistant",
    n_variograms: int = 1,
    n_jobs: int = 1,
    random_state: int | None = None,
    bounds: Any = None,
    p0: Any = None,
    mesh: Any = None,
    **kwargs: Any,
) -> tuple[pd.DataFrame, pd.DataFrame, Callable[[np.ndarray], np.ndarray]]:
    """Empirical variogram + sum-of-models fit + correlation function (reference :1838)."""
    emp = sample_empirical_variogram(
        values=dvalues, gsd=gsd, coords=coords, subsample=subsample, subsample_method=subsample_method,
        n_variograms=n_variograms, n_jobs=n_jobs, random_state=random_state, estimator=estimator,
        mesh=mesh, **kwargs,
    )
    _, params = fit_sum_model_variogram(list_models, emp, bounds=bounds, p0=p0)
    return emp, params, correlation_from_variogram(params)


def infer_spatial_correlation_from_stable(
    dvalues: Any,
    list_models: Sequence[str],
    stable_mask: Any = None,
    unstable_mask: Any = None,
    errors: Any = None,
    estimator: str = "dowd",
    gsd: float | None = None,
    coords: np.ndarray | None = None,
    subsample: int = 1000,
    subsample_method: str = "cdist_equidistant",
    n_variograms: int = 1,
    n_jobs: int = 1,
    bounds: Any = None,
    p0: Any = None,
    random_state: int | None = None,
    mesh: Any = None,
    **kwargs: Any,
) -> tuple[pd.DataFrame, pd.DataFrame, Callable[[np.ndarray], np.ndarray]]:
    """Infer the spatial correlation of dh errors from stable terrain (reference :1876).

    `mesh` shards the variogram sampling runs across a jax device mesh (mesh-invariant-exact;
    see :func:`sample_empirical_variogram`)."""
    if isinstance(dvalues, Raster) and isinstance(errors, Raster):
        # Standardize on device and cross the host boundary once: dh / sigma with the stable
        # mask applied is ONE fused kernel launch, vs an eager divide + where chain (one
        # dispatch per op). Masks upload bit-packed (device-resident pass
        # straight through).
        inc = _device_mask_of(stable_mask, dvalues)
        exc = _device_mask_of(unstable_mask, dvalues)
        dummy = _dummy_mask()
        d_stable = _standardize_masked_device(
            jnp.asarray(dvalues.data), jnp.asarray(errors.data),
            inc if inc is not None else dummy, exc if exc is not None else dummy,
            inc is not None, exc is not None,
        )
        if gsd is None:
            gsd = dvalues.res[0]
    else:
        d_stable, gsd = _preprocess_values_with_mask_to_array(
            values=dvalues, include_mask=stable_mask, exclude_mask=unstable_mask, gsd=gsd
        )
        if errors is not None:
            err_arr = errors.get_nanarray() if isinstance(errors, Raster) else np.asarray(unmask(errors))
            d_stable = d_stable / err_arr
    return _estimate_model_spatial_correlation(
        dvalues=d_stable, list_models=list_models, estimator=estimator, gsd=gsd, coords=coords,
        subsample=subsample, subsample_method=subsample_method, n_variograms=n_variograms,
        n_jobs=n_jobs, random_state=random_state, bounds=bounds, p0=p0, mesh=mesh, **kwargs,
    )


# ---------------------------------------------------------------------- effective samples


def neff_circular_approx_theoretical(area: float, params_variogram_model: pd.DataFrame) -> float:
    """Closed-form disk-integral n_eff per model (Rolstad et al. 2009 generalization;
    reference :2011)."""
    _check_validity_params_variogram(params_variogram_model)
    l_equiv = np.sqrt(area / np.pi)

    def spherical_i(a1, c1, L):
        if l_equiv <= a1:
            return c1 * (1 - L / a1 + 1 / 5 * (L / a1) ** 3)
        return c1 / 5 * (a1 / L) ** 2

    def exponential_i(a1, c1, L):
        a = a1 / 3
        return 2 * c1 * (a / L) ** 2 * (1 - np.exp(-L / a) * (1 + L / a))

    def gaussian_i(a1, c1, L):
        a = a1 / 2
        return c1 * (a / L) ** 2 * (1 - np.exp(-(L**2) / a**2))

    def cubic_i(a1, c1, L):
        if l_equiv <= a1:
            return c1 * (6 * a1**7 - 21 * a1**5 * L**2 + 21 * a1**4 * L**3 - 6 * a1**2 * L**5 + L**7) / (6 * a1**7)
        return 1 / 6 * c1 * a1**2 / L**2

    table = {"spherical": spherical_i, "exponential": exponential_i, "gaussian": gaussian_i, "cubic": cubic_i}
    squared_se = 0.0
    for _, row in params_variogram_model.iterrows():
        name = _get_variogram_model_name(row["model"])
        if name in table:
            squared_se += table[name](row["range"], row["psill"], l_equiv)
    total_sill = np.nansum(params_variogram_model["psill"].values)
    return float(total_sill / squared_se)


def neff_circular_approx_numerical(area: float, params_variogram_model: pd.DataFrame) -> float:
    """Numerical disk-integral n_eff for any model forms (reference :2129)."""
    from scipy import integrate

    _check_validity_params_variogram(params_variogram_model)
    cov = covariance_from_variogram(params_variogram_model)
    total_sill = np.nansum(params_variogram_model["psill"].values)
    l_equiv = np.sqrt(area / np.pi)

    def hcov(h):
        return h * cov(h)

    full_int = integrate.quad(hcov, 0, l_equiv)[0]
    squared_se = 2 * full_int / l_equiv**2
    return float(total_sill / squared_se)


@partial(jax.jit, static_argnames=())
@pin_f32_matmuls
def _pairwise_sq_dists(c1: jnp.ndarray, c2: jnp.ndarray) -> jnp.ndarray:
    """(N, M) squared euclidean distances by direct per-coordinate differences.

    Elementwise work deliberately, NOT a matmul: at K=2-3 coordinates the
    ``|a|^2 + |b|^2 - 2 a.b`` expansion wastes a matrix unit on a tiny contraction, forces
    the (N, M) product through device memory before the caller's elementwise rho/reduce can
    fuse, needs a full-f32 precision pin against reduced-precision matmul defaults, and is
    catastrophically ill-conditioned at raw UTM magnitudes (|c|~8e6 squares to ~6e13,
    where f32 rounding is ~4e6 m^2). Direct differences fuse straight into the consumer,
    never square an absolute coordinate, and are exactly translation-invariant — same
    design as coreg.affine._nn_planes_scan (measured 3.5x there). Callers still
    mean-center in f64 for f32 representation headroom (see neff_exact)."""
    d2 = None
    for k in range(c1.shape[1]):
        d = c1[:, k][:, None] - c2[:, k][None, :]
        d2 = d * d if d2 is None else d2 + d * d
    return d2


def _rho_device(h: jnp.ndarray, params_variogram_model: pd.DataFrame) -> jnp.ndarray:
    """Correlation function evaluated on device (models without Bessel terms)."""
    total_sill = float(np.sum(params_variogram_model["psill"].values))
    gamma = jnp.zeros_like(h)
    for _, row in params_variogram_model.iterrows():
        name = _get_variogram_model_name(row["model"])
        if name == "matern":
            raise NotImplementedError("Matern n_eff on device not supported; use host path.")
        gamma = gamma + _model_gamma(h, name, float(row["range"]), float(row["psill"]),
                                     row.get("smooth"), xp=jnp)
    return (total_sill - gamma) / total_sill


def _chunked_weighted_rho_sum(
    c1: np.ndarray,
    e1: np.ndarray,
    c2: np.ndarray,
    e2: np.ndarray,
    params_variogram_model: pd.DataFrame,
    target_elems: int = 1 << 26,
) -> float:
    """sum_ij e1_i e2_j rho(|c1_i - c2_j|) without materializing the full (N, M) matrix.

    Rows are processed in fixed-size chunks inside one lax.scan, so peak memory is bounded by
    chunk x M (~target_elems f32, default 256 MB) regardless of N — the same pattern as
    coreg.affine._brute_nearest. Distances come from direct per-coordinate differences
    (_pairwise_sq_dists), not a matmul expansion.
    """
    if any(_get_variogram_model_name(m_) == "matern"
           for m_ in params_variogram_model["model"]):
        # Matern needs Bessel K_v (no jax primitive): chunked HOST accumulation with the
        # f64 numpy model — still memory-bounded, just not device-resident
        total_sill = float(np.sum(params_variogram_model["psill"].values))
        m = len(e2)
        chunk = int(min(max(64, target_elems // max(m, 1)), max(len(e1), 1)))
        acc = 0.0
        for i0 in range(0, len(e1), chunk):
            cc = np.asarray(c1[i0:i0 + chunk], np.float64)
            d = np.sqrt(((cc[:, None, :] - np.asarray(c2, np.float64)[None, :, :]) ** 2).sum(-1))
            gamma = np.zeros_like(d)
            for _, row in params_variogram_model.iterrows():
                gamma += _model_gamma(d, _get_variogram_model_name(row["model"]),
                                      float(row["range"]), float(row["psill"]),
                                      row.get("smooth"), xp=np)
            rho = (total_sill - gamma) / total_sill
            acc += float(np.sum(np.asarray(e1[i0:i0 + chunk])[:, None] * np.asarray(e2)[None, :] * rho))
        return acc

    c2_j = jnp.asarray(c2, jnp.float32)
    e2_j = jnp.asarray(e2, jnp.float32)
    m = c2_j.shape[0]
    chunk = int(min(max(64, target_elems // max(m, 1)), max(len(e1), 1)))
    n = len(e1)
    n_pad = int(np.ceil(n / chunk)) * chunk
    c1p = np.zeros((n_pad, c1.shape[1]), np.float32)
    c1p[:n] = c1
    e1p = np.zeros(n_pad, np.float32)  # zero weights kill the padded rows' contributions
    e1p[:n] = e1
    c1r = jnp.asarray(c1p.reshape(-1, chunk, c1.shape[1]))
    e1r = jnp.asarray(e1p.reshape(-1, chunk))

    def body(carry, xe):
        acc, comp = carry
        cc, ee = xe
        d = jnp.sqrt(_pairwise_sq_dists(cc, c2_j))
        rho = _rho_device(d, params_variogram_model)
        # Kahan-compensated: thousands of sequential f32 adds of large partial sums drift
        # ~1e-4 relative otherwise (same pattern as _chunked_pair_reduce)
        y = jnp.sum(ee[:, None] * e2_j[None, :] * rho, dtype=jnp.float32) - comp
        t = acc + y
        return (t, (t - acc) - y), None

    (acc, _comp), _ = jax.lax.scan(body, (jnp.float32(0.0), jnp.float32(0.0)), (c1r, e1r))
    return float(acc)


def neff_exact(
    coords: np.ndarray, errors: np.ndarray, params_variogram_model: pd.DataFrame,
    vectorized: bool = True, mesh: Any = None,
) -> float:
    """Exact double covariance sum over all pixel pairs (reference :2175), as a tiled device
    kernel: sum_ij err_i err_j rho(d_ij) — chunked matmul-shaped distances + elementwise rho,
    memory bounded by the chunk size (not N^2). Pass `mesh` (jax.sharding.Mesh) to shard the
    row axis across devices (xdem_tpu.parallel.neff). ``vectorized`` is kept for signature
    parity with the reference's loop/vectorized switch; both map to the same device kernel
    (numerically identical)."""
    _check_validity_params_variogram(params_variogram_model)
    # Distances are translation-invariant: mean-center in f64 BEFORE the f32 cast so the
    # matmul distance expansion stays conditioned at UTM-scale coordinates (see
    # _pairwise_sq_dists).
    coords = np.asarray(coords, np.float64)
    coords = np.asarray(coords - coords.mean(axis=0), np.float32)
    errors = np.asarray(unmask(errors), np.float32)
    has_matern = any(_get_variogram_model_name(m_) == "matern"
                     for m_ in params_variogram_model["model"])
    if mesh is not None and not has_matern:
        from xdem_tpu.parallel.neff import weighted_rho_sum_sharded

        var = weighted_rho_sum_sharded(coords, errors, coords, errors, params_variogram_model, mesh)
    else:
        if mesh is not None:
            logging.debug("matern n_eff runs on the host path (no Bessel-K jax primitive); "
                          "mesh= ignored for this model")
        var = _chunked_weighted_rho_sum(coords, errors, coords, errors, params_variogram_model)
    n = len(errors)
    squared_se = var / n**2
    return float(np.mean(errors)) ** 2 / squared_se


def neff_hugonnet_approx(
    coords: np.ndarray,
    errors: np.ndarray,
    params_variogram_model: pd.DataFrame,
    subsample: int = 1000,
    vectorized: bool = True,
    random_state: int | None = None,
    mesh: Any = None,
) -> float:
    """Hugonnet et al. (2022) approximation: one sum subsetted randomly (reference :2239).
    Chunked accumulation bounds memory at chunk x subsample instead of N x subsample. Pass
    `mesh` to shard the row axis across devices. ``vectorized`` is kept for signature parity
    with the reference's loop/vectorized switch; both map to the same device kernel."""
    _check_validity_params_variogram(params_variogram_model)
    rng = np.random.default_rng(random_state)
    n = len(coords)
    subsample = min(subsample, n)
    sel = rng.choice(n, size=subsample, replace=False)
    # f64 mean-centering before the f32 cast — see neff_exact / _pairwise_sq_dists.
    coords = np.asarray(coords, np.float64)
    coords = np.asarray(coords - coords.mean(axis=0), np.float32)
    errors = np.asarray(unmask(errors), np.float32)
    if mesh is not None:
        from xdem_tpu.parallel.neff import weighted_rho_sum_sharded

        var = weighted_rho_sum_sharded(
            coords, errors, coords[sel], errors[sel], params_variogram_model, mesh
        )
    else:
        var = _chunked_weighted_rho_sum(
            coords, errors, coords[sel], errors[sel], params_variogram_model
        )
    squared_se = var / (n * subsample)
    return float(np.mean(errors)) ** 2 / squared_se


def number_effective_samples(
    area: Any,
    params_variogram_model: pd.DataFrame,
    rasterize_resolution: Any = None,
    **kwargs: Any,
) -> float:
    """n_eff in an area: continuous disk integral for numeric areas, discretized Hugonnet
    approximation for vector areas (reference :2311)."""
    from xdem_tpu.vector import Vector
    from xdem_tpu.georef import Affine

    _check_validity_params_variogram(params_variogram_model)
    if isinstance(area, (float, int, np.floating, np.integer)):
        return neff_circular_approx_numerical(area=float(area), params_variogram_model=params_variogram_model)
    if isinstance(area, Vector):
        if rasterize_resolution is None:
            rasterize_resolution = float(np.min(params_variogram_model["range"].values) / 5.0)
            warnings.warn(
                "No rasterization resolution given; defaulting to one fifth of the shortest "
                "correlation range. Long-range models then produce very large grids — pass "
                "rasterize_resolution to bound memory.",
                UserWarning,
            )
        if isinstance(rasterize_resolution, (float, int, np.floating, np.integer)):
            res = float(rasterize_resolution)
            left, bottom, right, top = area.bounds
            w = max(int(np.ceil((right - left) / res)), 1)
            h = max(int(np.ceil((top - bottom) / res)), 1)
            transform = Affine.from_origin(left, top, res, res)
            mask = area.create_mask(transform=transform, shape=(h, w), crs=area.crs)
            rr, cc = np.nonzero(mask)
            xs, ys = transform.xy(rr, cc)
            coords_on_mask = np.column_stack([xs, ys])
        else:
            # Raster-like input with .transform/.shape
            mask = area.create_mask(rasterize_resolution)
            rr, cc = np.nonzero(mask)
            xs, ys = rasterize_resolution.transform.xy(rr, cc)
            coords_on_mask = np.column_stack([xs, ys])
        errors_on_mask = np.ones(len(coords_on_mask))
        return neff_hugonnet_approx(
            coords=coords_on_mask, errors=errors_on_mask, params_variogram_model=params_variogram_model, **kwargs
        )
    raise ValueError("Area must be a float, integer, or Vector subclass.")


def spatial_error_propagation(
    areas: Sequence[Any],
    errors: Any,
    params_variogram_model: pd.DataFrame,
    **kwargs: Any,
) -> list[float]:
    """Propagate per-pixel errors to areal standard errors: SE = mean(sigma) / sqrt(n_eff)
    per area (reference :2405)."""
    from xdem_tpu.vector import Vector
    from xdem_tpu.raster import Raster as _Raster

    standardized_errors = []
    for area in areas:
        # Mean error in the area
        if isinstance(errors, _Raster):
            err_arr = errors.get_nanarray()
            if isinstance(area, Vector):
                mask = area.create_mask(errors)
                mean_err = np.nanmean(err_arr[mask])
                area_arg: Any = area
            else:
                mean_err = np.nanmean(err_arr)
                area_arg = area
        else:
            mean_err = float(np.nanmean(np.asarray(unmask(errors))))
            area_arg = area
        neff = number_effective_samples(area_arg, params_variogram_model, **kwargs)
        standardized_errors.append(float(mean_err / np.sqrt(neff)))
    return standardized_errors


# ---------------------------------------------------------------------- patches method


def _patches_kernel_size(area: float, gsd: float, patch_shape: str) -> int:
    """Kernel pixels matching ``area``: diameter for circular patches, side for square."""
    if patch_shape.lower() == "circular":
        k = int(np.round(2 * np.sqrt(area / np.pi) / gsd, decimals=0))
    elif patch_shape.lower() == "square":
        k = int(np.round(np.sqrt(area) / gsd, decimals=0))
    else:
        raise ValueError('Patch shape should be "square" or "circular".')
    return max(k, 1)


def _patches_convolution(
    values: np.ndarray,
    gsd: float,
    area: float,
    perc_min_valid: float = 80.0,
    patch_shape: str = "circular",
    method: str = "scipy",
    statistic_between_patches: Callable[[np.ndarray], float] = _stat_nmad,
    return_in_patch_statistics: bool = False,
    verbose: bool = False,
) -> tuple[float, float, float] | tuple[float, float, float, pd.DataFrame]:
    """Patches method by convolution (reference :2658): NaN-aware mean filter, then the
    spread statistic averaged over ALL kernel-strided independent offset grids (convolved
    patches overlap, so only same-stride samples are independent; averaging the kernel^2
    offset estimates is the reference's robustification, :2712-2731).

    Returns (statistic between patches, mean independent-patch count, exact discretized
    patch area[, per-patch dataframe])."""
    pd = import_optional("pandas")
    kernel_size = _patches_kernel_size(area, gsd, patch_shape)
    mean, counts, nb_per_kernel = mean_filter_nan(values, kernel_size,
                                                  kernel_shape=patch_shape.lower(), method=method)
    mean[counts < nb_per_kernel * perc_min_valid / 100] = np.nan
    stats: list[float] = []
    nbs: list[int] = []
    for i in range(kernel_size):
        for j in range(kernel_size):
            s = mean[i::kernel_size, j::kernel_size].ravel()
            fin = np.isfinite(s)
            stats.append(float(statistic_between_patches(s)) if fin.any() else np.nan)
            nbs.append(int(fin.sum()))
    stats_arr = np.asarray(stats)
    stat = float(np.mean(stats_arr[np.isfinite(stats_arr)])) if np.isfinite(stats_arr).any() else np.nan
    nb_indep = float(np.mean(nbs))
    exact_area = float(nb_per_kernel) * gsd**2
    if return_in_patch_statistics:
        df = pd.DataFrame({
            "nanmean": mean[::kernel_size, ::kernel_size].ravel(),
            "count": counts[::kernel_size, ::kernel_size].ravel(),
        })
        return stat, nb_indep, exact_area, df
    return stat, nb_indep, exact_area


def _patches_loop_quadrants(
    values: np.ndarray,
    gsd: float,
    area: float,
    patch_shape: str = "circular",
    n_patches: int = 1000,
    perc_min_valid: float = 80.0,
    statistics_in_patch: Sequence[Callable | str] = (np.nanmean,),
    statistic_between_patches: Callable[[np.ndarray], float] = _stat_nmad,
    random_state: int | None = None,
    verbose: bool = False,
) -> tuple[pd.DataFrame, float]:
    """Patches method by quadrant sampling (reference :2740): draw random non-overlapping
    quadrants of the right area, compute per-patch statistics.

    Returns (per-patch dataframe, exact discretized patch area). The exact area counts the
    footprint pixels actually reduced per patch — NOT the reference's square-shape formula
    (reference :2795-2797 uses the quadrant-grid dimensions there, which also makes its
    square+loop combination reject every patch; a documented upstream bug we don't copy)."""
    pd = import_optional("pandas")
    rng = np.random.default_rng(random_state)
    values = np.asarray(unmask(values), dtype=np.float64)
    side = int(np.round(np.sqrt(area) / gsd))
    side = max(side, 1)
    h, w = values.shape
    nx = h // side
    ny = w // side
    if nx == 0 or ny == 0:
        raise ValueError("Patch area larger than the array extent.")
    all_quadrants = [(i, j) for i in range(nx) for j in range(ny)]
    rng.shuffle(all_quadrants)

    if patch_shape.lower() == "circular":
        yy, xx = np.mgrid[0:side, 0:side] - (side - 1) / 2
        footprint = (xx**2 + yy**2) <= ((side - 1) / 2) ** 2 if side > 1 else np.ones((1, 1), bool)
    else:
        footprint = np.ones((side, side), bool)

    rows = []
    for (i, j) in all_quadrants[: n_patches]:
        patch = values[i * side : (i + 1) * side, j * side : (j + 1) * side]
        vals = patch[footprint]
        frac_valid = np.isfinite(vals).mean() * 100
        if verbose:
            logging.info("Working on patch (%d, %d): %.0f%% valid", i, j, frac_valid)
        if frac_valid < perc_min_valid:
            continue
        rec: dict[str, Any] = {"tile": f"{i}_{j}"}
        for stat in statistics_in_patch:
            if callable(stat):
                fn, name = stat, getattr(stat, "__name__", str(stat))
            else:  # string statistic keeps ITS name ("count" used to become "<lambda>")
                fn, name = {"count": lambda v: np.isfinite(v).sum()}[stat], stat
            rec[name] = fn(vals)
        rows.append(rec)
    return pd.DataFrame(rows), float(footprint.sum()) * gsd**2


def patches_method(
    values: Any,
    areas: Sequence[float] | float | None = None,
    gsd: float | None = None,
    stable_mask: Any = None,
    unstable_mask: Any = None,
    statistics_in_patch: Sequence[Any] = (np.nanmean,),
    statistic_between_patches: Callable[[np.ndarray], float] = _stat_nmad,
    perc_min_valid: float = 80.0,
    patch_shape: str = "circular",
    vectorized: bool = True,
    convolution_method: str = "scipy",
    n_patches: int = 1000,
    return_in_patch_statistics: bool = False,
    verbose: bool = False,
    random_state: int | None = None,
    area: float | None = None,
) -> pd.DataFrame | tuple[pd.DataFrame, pd.DataFrame] | tuple[float, float]:
    """Empirical estimation of the standard error in averaged areas (reference :2920).

    Pass ``areas`` as a LIST for the reference behavior: one row per area in a dataframe
    with columns [<statistic name>, nb_indep_patches, exact_areas, areas];
    ``return_in_patch_statistics=True`` additionally returns the concatenated per-patch
    dataframe. ``convolution_method`` is the reference's scipy/numba backend switch (both
    run the same XLA convolution here; validated in :func:`mean_filter_nan`).

    Passing a single number (``areas=1e4`` or the legacy keyword ``area=``) keeps this
    project's original compact returns: (spread between patches, independent-patch count)
    for the vectorized variant, the per-patch dataframe for the loop variant.
    """
    pd = import_optional("pandas")
    if areas is None and area is not None:
        areas = area
    if areas is None:
        areas = 10000.0

    arr, gsd_out = _preprocess_values_with_mask_to_array(
        values, include_mask=stable_mask, exclude_mask=unstable_mask, gsd=gsd
    )
    gsd = gsd_out if gsd is None else gsd
    if gsd is None:
        raise ValueError("A ground sampling distance is required (pass gsd or a Raster).")
    arr = np.asarray(arr, np.float64)

    def one_area(a: float) -> tuple[float, float, float, pd.DataFrame | None]:
        """(statistic, nb independent patches, exact area, per-patch df or None)."""
        if vectorized:
            if verbose:
                k = _patches_kernel_size(a, gsd, patch_shape)
                logging.info("Patches (convolution variant): %d x %d px kernel over a %s grid",
                             k, k, "x".join(map(str, arr.shape)))
            out = _patches_convolution(
                arr, gsd, a, perc_min_valid=perc_min_valid, patch_shape=patch_shape,
                method=convolution_method, statistic_between_patches=statistic_between_patches,
                return_in_patch_statistics=return_in_patch_statistics,
            )
            return out[0], out[1], out[2], (out[3] if return_in_patch_statistics else None)
        df, exact = _patches_loop_quadrants(
            arr, gsd, a, patch_shape=patch_shape, n_patches=n_patches,
            perc_min_valid=perc_min_valid, statistics_in_patch=statistics_in_patch,
            statistic_between_patches=statistic_between_patches, random_state=random_state,
            verbose=verbose,
        )
        first = statistics_in_patch[0]
        first_name = first if isinstance(first, str) else getattr(first, "__name__", str(first))
        if len(df):
            stat = float(statistic_between_patches(df[first_name].values.astype(np.float64)))
            nb = int(np.isfinite(df[first_name].values.astype(np.float64)).sum())
        else:
            stat, nb = np.nan, 0
            warnings.warn("No valid patch found covering this area size, returning NaN "
                          "for statistic.", UserWarning)
        return stat, float(nb), exact, (df if return_in_patch_statistics else None)

    # Legacy single-area mode: keep this project's original compact returns
    if np.ndim(areas) == 0:
        a = float(areas)
        if vectorized:
            stat, nb, _exact, _df = one_area(a)
            return stat, nb
        df, _exact = _patches_loop_quadrants(
            arr, gsd, a, patch_shape=patch_shape, n_patches=n_patches,
            perc_min_valid=perc_min_valid, statistics_in_patch=statistics_in_patch,
            statistic_between_patches=statistic_between_patches, random_state=random_state,
            verbose=verbose,
        )
        return df

    # Reference mode: one dataframe row per area
    stats, nbs, exacts, dfs = [], [], [], []
    for a in areas:
        stat, nb, exact, df = one_area(float(a))
        stats.append(stat)
        nbs.append(nb)
        exacts.append(exact)
        if return_in_patch_statistics and df is not None:
            df = df.copy()
            df["areas"] = float(a)
            df["exact_areas"] = exact
            dfs.append(df)
    df_statistic = pd.DataFrame({
        getattr(statistic_between_patches, "__name__", "statistic"): stats,
        "nb_indep_patches": nbs,
        "exact_areas": exacts,
        "areas": list(areas),
    })
    if return_in_patch_statistics:
        return df_statistic, pd.concat(dfs) if dfs else pd.DataFrame()
    return df_statistic


# ---------------------------------------------------------------------- plotting


def plot_variogram(
    df: pd.DataFrame,
    list_fit_fun: Sequence[Callable[[np.ndarray], np.ndarray]] | None = None,
    list_fit_fun_label: Sequence[str] | None = None,
    ax: Any = None,
    xscale: str = "linear",
    xscale_range_split: Sequence[float] | None = None,
    xlabel: str | None = None,
    ylabel: str | None = None,
    xlim: Any = None,
    ylim: Any = None,
    out_fname: str | None = None,
) -> Any:
    """Plot an empirical variogram (hist of counts + variance points) with optional fitted
    models (reference :3050).

    ``xscale_range_split`` splits the lag axis into side-by-side panels at the given
    distances (reference :3112-3150) so short-range structure stays readable next to the
    long-range lags; each panel carries its own pair-count histogram on top.
    """
    matplotlib = import_optional("matplotlib")

    if out_fname is not None:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if xscale_range_split is not None:
        return _plot_variogram_split(
            df, list_fit_fun=list_fit_fun, list_fit_fun_label=list_fit_fun_label, ax=ax,
            xscale=xscale, xscale_range_split=list(xscale_range_split), xlabel=xlabel,
            ylabel=ylabel, xlim=xlim, ylim=ylim, out_fname=out_fname,
        )

    if ax is None:
        fig, ax = plt.subplots(figsize=(8, 5))
    else:
        fig = ax.figure

    lags = df["lags"].values
    exp = df["exp"].values
    counts = df["count"].values

    ax2 = ax.twinx() if hasattr(ax, "twinx") else None
    if ax2 is not None:
        ax2.bar(lags, counts, width=np.r_[lags[0], np.diff(lags)] * 0.9, alpha=0.2,
                color="grey", label="pair count")
        ax2.set_ylabel("pairwise sample count")
    if "err_exp" in df.columns and np.isfinite(df["err_exp"].values).any():
        ax.errorbar(lags, exp, yerr=df["err_exp"].values, fmt="o", ms=4, label="empirical")
    else:
        ax.plot(lags, exp, "o", ms=4, label="empirical")

    if list_fit_fun is not None:
        h = np.linspace(0, np.nanmax(lags), 500)
        for i, fn in enumerate(list_fit_fun):
            label = list_fit_fun_label[i] if list_fit_fun_label else f"model {i+1}"
            ax.plot(h, fn(h), "-", label=label)

    ax.set_xscale(xscale)
    ax.set_xlabel(xlabel or "spatial lag")
    ax.set_ylabel(ylabel or "variance")
    if xlim is not None:
        ax.set_xlim(xlim)
    if ylim is not None:
        ax.set_ylim(ylim)
    ax.legend(loc="lower right")
    if out_fname is not None:
        fig.savefig(out_fname, dpi=120, bbox_inches="tight")
        plt.close(fig)
    return ax


def _plot_variogram_split(
    df: pd.DataFrame,
    list_fit_fun: Sequence[Callable[[np.ndarray], np.ndarray]] | None,
    list_fit_fun_label: Sequence[str] | None,
    ax: Any,
    xscale: str,
    xscale_range_split: list[float],
    xlabel: str | None,
    ylabel: str | None,
    xlim: Any,
    ylim: Any,
    out_fname: str | None,
) -> Any:
    """Multi-panel variogram: one sub-axis per lag range, pair-count histogram on top."""
    import matplotlib.pyplot as plt

    lags = df["lags"].values.astype(float)
    exp = df["exp"].values.astype(float)
    counts = df["count"].values.astype(float)
    err = df["err_exp"].values.astype(float) if "err_exp" in df.columns else np.full_like(exp, np.nan)
    edges = np.r_[0.0, lags]
    centers = 0.5 * (edges[:-1] + edges[1:])

    # Panel boundaries (reference :3126-3135): prepend the axis origin only when the first
    # user split is nonzero, append the max lag when absent
    first = float(np.min(lags)) / 2 if xscale == "log" else 0.0
    splits = list(xscale_range_split)
    if splits[0] == 0.0 and xscale == "log":
        splits[0] = first  # a log axis cannot start at 0
    elif splits[0] != 0.0 and splits[0] != first:
        splits = [first] + splits
    if splits[-1] < float(np.max(lags)):
        splits.append(float(np.max(lags)))
    n_panels = len(splits) - 1

    if ax is None:
        fig = plt.figure(figsize=(3.0 * n_panels + 2.0, 5.0))
        make_axes = lambda rect: fig.add_axes(rect)  # noqa: E731
    else:
        fig = ax.figure
        ax.axis("off")
        make_axes = ax.inset_axes

    ymax = float(np.nanmax(exp)) * 1.05 if np.all(np.isnan(err)) else float(np.nanmax(exp) + np.nanmean(err[np.isfinite(err)]))
    axes = []
    for k in range(n_panels):
        x0, x1 = splits[k], splits[k + 1]
        left, width = 0.08 + 0.92 * k / n_panels, 0.92 / n_panels * 0.94
        ax_hist = make_axes([left, 0.78, width, 0.20])
        ax_stat = make_axes([left, 0.10, width, 0.64])
        in_panel = (edges[1:] > x0) & (edges[:-1] < x1)
        for i in np.flatnonzero(in_panel):
            ax_hist.fill_between([edges[i], edges[i + 1]], 0, counts[i],
                                 facecolor="grey", alpha=0.6, edgecolor="white", linewidth=0.5)
        ax_hist.set_xscale(xscale)
        ax_hist.set_xlim(x0, x1)
        ax_hist.set_xticks([])
        sel = (centers >= x0) & (centers <= x1)
        if np.all(np.isnan(err)):
            ax_stat.plot(centers[sel], exp[sel], "x", color="tab:blue", label="empirical")
        else:
            ax_stat.errorbar(centers[sel], exp[sel], yerr=err[sel], fmt="x", label="empirical")
        if list_fit_fun is not None:
            h = np.linspace(max(x0, 1e-9), x1, 300)
            for i, fn in enumerate(list_fit_fun):
                label = list_fit_fun_label[i] if list_fit_fun_label else f"model {i + 1}"
                ax_stat.plot(h, fn(h), "--", label=label)
        ax_stat.set_xscale(xscale)
        ax_stat.set_xlim(xlim if xlim is not None else (x0, x1))
        ax_stat.set_ylim(ylim if ylim is not None else (0, ymax))
        if k == 0:
            ax_hist.set_ylabel("pair count")
            ax_stat.set_ylabel(ylabel or "variance")
        else:
            ax_hist.set_yticks([])
            ax_stat.set_yticks([])
        if k == n_panels // 2:
            ax_stat.set_xlabel(xlabel or "spatial lag")
        if k == n_panels - 1:
            ax_stat.legend(loc="lower right", fontsize=8)
        axes.append(ax_stat)

    if out_fname is not None:
        fig.savefig(out_fname, dpi=120, bbox_inches="tight")
        plt.close(fig)
    return axes


def plot_1d_binning(
    df: pd.DataFrame,
    var_name: str,
    statistic_name: str,
    label_var: str | None = None,
    label_statistic: str | None = None,
    min_count: int = 30,
    ax: Any = None,
    out_fname: str | None = None,
) -> Any:
    """Plot a 1-D binned statistic with per-bin histogram (reference :3241)."""
    pd = import_optional("pandas")
    matplotlib = import_optional("matplotlib")

    if out_fname is not None:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    sub = df[df["nd"] == 1].copy()
    sub[var_name] = sub[var_name].apply(_pandas_str_to_interval)
    sub = sub[sub[var_name].apply(lambda v: isinstance(v, pd.Interval))]
    mids = np.array([iv.mid for iv in sub[var_name]])
    vals = sub[statistic_name].values.astype(float)
    counts = sub["count"].values
    vals = np.where(counts >= min_count, vals, np.nan)

    if ax is None:
        fig, (ax_hist, ax) = plt.subplots(
            2, 1, figsize=(7, 6), sharex=True, gridspec_kw={"height_ratios": [1, 3]}
        )
        ax_hist.bar(mids, counts, width=np.median(np.diff(mids)) * 0.9, alpha=0.4, color="grey")
        ax_hist.set_ylabel("count")
    else:
        fig = ax.figure
    ax.plot(mids, vals, "o-", ms=4)
    ax.set_xlabel(label_var or var_name)
    ax.set_ylabel(label_statistic or statistic_name)
    if out_fname is not None:
        fig.savefig(out_fname, dpi=120, bbox_inches="tight")
        plt.close(fig)
    return ax


def plot_2d_binning(
    df: pd.DataFrame,
    var_name_1: str,
    var_name_2: str,
    statistic_name: str,
    label_var_name_1: str | None = None,
    label_var_name_2: str | None = None,
    label_statistic: str | None = None,
    cmap: str = "Reds",
    min_count: int = 30,
    scale_var_1: str = "linear",
    scale_var_2: str = "linear",
    vmin: float | None = None,
    vmax: float | None = None,
    nodata_color: Any = "yellow",
    ax: Any = None,
    out_fname: str | None = None,
) -> Any:
    """Plot a 2-D binned statistic as a colored mesh (reference :3359).

    ``scale_var_1/2`` set the axis scales ("linear"/"log"), ``vmin/vmax`` clamp the color
    range, and ``nodata_color`` paints bins masked by ``min_count``."""
    pd = import_optional("pandas")
    matplotlib = import_optional("matplotlib")

    if out_fname is not None:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    sub = df[df["nd"] == 2].copy()
    for name in (var_name_1, var_name_2):
        sub[name] = sub[name].apply(_pandas_str_to_interval)
    sub = sub[sub[var_name_1].apply(lambda v: isinstance(v, pd.Interval))
              & sub[var_name_2].apply(lambda v: isinstance(v, pd.Interval))]
    if len(sub) == 0:
        raise ValueError(f"No 2-D binning of ({var_name_1}, {var_name_2}) in the dataframe.")
    m1 = sorted({iv.mid for iv in sub[var_name_1]})
    m2 = sorted({iv.mid for iv in sub[var_name_2]})
    grid = np.full((len(m2), len(m1)), np.nan)
    for _, row in sub.iterrows():
        i = m2.index(row[var_name_2].mid)
        j = m1.index(row[var_name_1].mid)
        if row["count"] >= min_count:
            grid[i, j] = row[statistic_name]
    if ax is None:
        fig, ax = plt.subplots(figsize=(7, 5))
    else:
        fig = ax.figure
    try:
        cmap_obj = matplotlib.colormaps[cmap].copy()
    except (AttributeError, KeyError, TypeError):  # older matplotlib
        import copy as _c

        import matplotlib.cm as mcm

        # get_cmap returns the globally registered instance: copy before set_bad mutates it
        cmap_obj = _c.copy(mcm.get_cmap(cmap))
    cmap_obj.set_bad(nodata_color)
    im = ax.pcolormesh(m1, m2, np.ma.masked_invalid(grid), cmap=cmap_obj, shading="nearest",
                       vmin=vmin, vmax=vmax)
    fig.colorbar(im, ax=ax, label=label_statistic or statistic_name)
    ax.set_xscale(scale_var_1)
    ax.set_yscale(scale_var_2)
    ax.set_xlabel(label_var_name_1 or var_name_1)
    ax.set_ylabel(label_var_name_2 or var_name_2)
    if out_fname is not None:
        fig.savefig(out_fname, dpi=120, bbox_inches="tight")
        plt.close(fig)
    return ax
