"""Host-side point cloud container — standalone substitute for geoutils.PointCloud."""

from __future__ import annotations

import copy as _copy
from typing import Any, Dict, Tuple

import numpy as np

from xdem_tpu._misc import import_optional
from xdem_tpu.georef import CRS, transform_points


class PointCloud:
    """A set of (x, y, <data_column>) points with a CRS and optional auxiliary columns."""

    def __init__(
        self,
        x: Any,
        y: Any,
        z: Any,
        crs: CRS | int | str,
        data_column: str = "z",
        aux_columns: Dict[str, np.ndarray] | None = None,
    ):
        self.x = np.asarray(x, dtype=np.float64)
        self.y = np.asarray(y, dtype=np.float64)
        self.z = np.asarray(z, dtype=np.float64)
        if not (self.x.shape == self.y.shape == self.z.shape):
            raise ValueError("x, y, z must have the same shape.")
        self.crs = CRS(crs)
        self.data_column = data_column
        self.aux_columns = dict(aux_columns or {})

    def __len__(self) -> int:
        return int(self.x.size)

    @property
    def nb_points(self) -> int:
        return len(self)

    @property
    def ds(self) -> np.ndarray:
        """(N, 3) array of coordinates + data."""
        return np.column_stack([self.x, self.y, self.z])

    @property
    def bounds(self) -> Tuple[float, float, float, float]:
        return (float(self.x.min()), float(self.y.min()), float(self.x.max()), float(self.y.max()))

    def copy(self, new_array: np.ndarray | None = None) -> "PointCloud":
        """Copy the point cloud, optionally replacing the elevation values with
        ``new_array`` (the reference's copy(new_array=) slot, epc/epc.py:112)."""
        out = _copy.copy(self)
        out.x, out.y = self.x.copy(), self.y.copy()
        if new_array is not None:
            new_array = np.asarray(new_array)
            if new_array.shape != self.z.shape:
                raise ValueError(
                    f"new_array must have shape {self.z.shape}, got {new_array.shape}."
                )
            out.z = new_array.copy()
        else:
            out.z = self.z.copy()
        out.aux_columns = {k: v.copy() for k, v in self.aux_columns.items()}
        return out

    def subset(self, index: np.ndarray) -> "PointCloud":
        out = _copy.copy(self)
        out.x, out.y, out.z = self.x[index], self.y[index], self.z[index]
        out.aux_columns = {k: v[index] for k, v in self.aux_columns.items()}
        return out

    def subsample(self, subsample: int | float, random_state: int | None = None) -> "PointCloud":
        n = len(self)
        count = int(subsample * n) if isinstance(subsample, float) and subsample <= 1 else int(subsample)
        count = min(count, n)
        rng = np.random.default_rng(random_state)
        return self.subset(rng.choice(n, count, replace=False))

    def to_crs(self, crs: CRS | int | str) -> "PointCloud":
        crs = CRS(crs)
        nx, ny = transform_points(self.crs, crs, self.x, self.y)
        out = self.copy()
        out.x, out.y = np.asarray(nx), np.asarray(ny)
        out.crs = crs
        return out

    def translate(self, xoff: float = 0.0, yoff: float = 0.0, zoff: float = 0.0) -> "PointCloud":
        out = self.copy()
        out.x = out.x + xoff
        out.y = out.y + yoff
        out.z = out.z + zoff
        return out

    def grid(self, ref=None, transform=None, shape=None, crs=None, resampling: str = "linear"):
        """Grid the point cloud onto a raster grid.

        resampling="linear" (default) interpolates on the Delaunay triangulation of the
        points, NaN outside the convex hull — matching the reference's geoutils
        `_grid_pointcloud`. resampling="mean" uses two-pass binned averaging (mean per cell,
        then 3x3-neighborhood gap fill), much faster for dense clouds.
        """
        from xdem_tpu.raster import Raster

        if ref is not None:
            transform, shape, crs = ref.transform, ref.shape, ref.crs

        if resampling == "linear":
            from scipy.interpolate import LinearNDInterpolator
            from scipy.spatial import QhullError

            h, w = shape
            ok = np.isfinite(self.z)
            try:
                interp = LinearNDInterpolator(np.column_stack([self.x[ok], self.y[ok]]),
                                              self.z[ok], fill_value=np.nan)
            except (QhullError, ValueError):
                # Fewer than 3 non-collinear points: no triangulation exists; fall back to
                # the binned-mean gridding rather than crashing on degenerate clouds.
                return self.grid(transform=transform, shape=shape, crs=crs, resampling="mean")
            rr, cc = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
            gx, gy = transform.xy(rr.ravel(), cc.ravel())
            grid = interp(np.column_stack([gx, gy])).reshape(h, w).astype(np.float32)
            return Raster(grid, transform, crs if crs is not None else self.crs)
        if resampling != "mean":
            raise ValueError(f"resampling must be 'linear' or 'mean', got {resampling!r}.")
        h, w = shape
        rows, cols = transform.rowcol(self.x, self.y)
        ri = np.round(rows).astype(int)
        ci = np.round(cols).astype(int)
        ok = (ri >= 0) & (ri < h) & (ci >= 0) & (ci < w) & np.isfinite(self.z)
        flat = ri[ok] * w + ci[ok]
        sums = np.bincount(flat, weights=self.z[ok], minlength=h * w)
        counts = np.bincount(flat, minlength=h * w)
        with np.errstate(invalid="ignore"):
            grid = (sums / counts).reshape(h, w)
        grid = grid.astype(np.float32)

        # Second pass: fill cells that received no points from the 3x3 neighborhood mean of
        # populated cells, so isolated gaps inside a dense cloud don't punch NaN holes.
        empty = ~np.isfinite(grid)
        if empty.any() and not empty.all():
            vals = np.where(empty, 0.0, grid)
            valid = (~empty).astype(np.float32)
            pv = np.pad(vals, 1)
            pc = np.pad(valid, 1)
            nsum = sum(pv[i : i + h, j : j + w] for i in range(3) for j in range(3))
            ncnt = sum(pc[i : i + h, j : j + w] for i in range(3) for j in range(3))
            with np.errstate(invalid="ignore"):
                neigh = nsum / ncnt
            grid = np.where(empty & (ncnt > 0), neigh, grid).astype(np.float32)
        return Raster(grid, transform, crs if crs is not None else self.crs)

    # ------------------------------------------------------- geoutils.PointCloud parity

    point_count = nb_points  # reference name (geoutils PointCloud.point_count)

    @classmethod
    def from_xyz(cls, x: Any, y: Any, z: Any, crs: CRS | int | str,
                 data_column: str = "z") -> "PointCloud":
        """Build from separate coordinate arrays (geoutils PointCloud.from_xyz)."""
        return cls(x=x, y=y, z=z, crs=crs, data_column=data_column)

    @classmethod
    def from_array(cls, array: Any, crs: CRS | int | str,
                   data_column: str = "z") -> "PointCloud":
        """Build from an (N, 3) or (3, N) array of x, y, z (geoutils PointCloud.from_array)."""
        arr = np.asarray(array, dtype=np.float64)
        if arr.ndim != 2 or 3 not in arr.shape:
            raise ValueError(f"Expected an (N, 3) or (3, N) array, got shape {arr.shape}.")
        if arr.shape[0] == 3 and arr.shape[1] != 3:
            arr = arr.T
        return cls(x=arr[:, 0], y=arr[:, 1], z=arr[:, 2], crs=crs, data_column=data_column)

    @classmethod
    def from_tuples(cls, tuples: Any, crs: CRS | int | str,
                    data_column: str = "z") -> "PointCloud":
        """Build from an iterable of (x, y, z) tuples (geoutils PointCloud.from_tuples)."""
        return cls.from_array(np.asarray(list(tuples), dtype=np.float64), crs,
                              data_column=data_column)

    def crop(self, bbox: Any) -> "PointCloud":
        """Keep points inside (left, bottom, right, top) — a raster/vector with `.bounds`
        also works (geoutils PointCloud.crop)."""
        b = getattr(bbox, "bounds", bbox)
        left, bottom, right, top = (float(v) for v in tuple(b))
        keep = (self.x >= left) & (self.x <= right) & (self.y >= bottom) & (self.y <= top)
        return self.subset(keep)

    def reproject(self, crs: CRS | int | str) -> "PointCloud":
        """Transform coordinates to another CRS (alias of to_crs; reference name)."""
        return self.to_crs(crs)

    def rasterize(self, ref=None, transform=None, shape=None, crs=None,
                  statistic: str = "mean") -> Any:
        """Bin points onto a raster grid with a per-cell statistic (mean/count/min/max);
        unlike :meth:`grid` there is no interpolation — empty cells stay NaN."""
        from xdem_tpu.raster import Raster

        if ref is not None:
            transform, shape, crs = ref.transform, ref.shape, ref.crs
        h, w = shape
        rows, cols = transform.rowcol(self.x, self.y)
        # rowcol returns center-convention fractional indices (integer AT the pixel center),
        # so the containing cell is the nearest integer — like grid(), not floor()
        ri = np.round(np.asarray(rows)).astype(int)
        ci = np.round(np.asarray(cols)).astype(int)
        ok = (ri >= 0) & (ri < h) & (ci >= 0) & (ci < w) & np.isfinite(self.z)
        flat = ri[ok] * w + ci[ok]
        counts = np.bincount(flat, minlength=h * w).astype(np.float64)
        if statistic == "count":
            grid = counts
            grid[counts == 0] = np.nan
        elif statistic == "mean":
            sums = np.bincount(flat, weights=self.z[ok], minlength=h * w)
            with np.errstate(invalid="ignore"):
                grid = sums / counts
        elif statistic in ("min", "max"):
            grid = np.full(h * w, np.inf if statistic == "min" else -np.inf)
            reduce = np.minimum if statistic == "min" else np.maximum
            reduce.at(grid, flat, self.z[ok])
            grid[counts == 0] = np.nan
        else:
            raise ValueError(f"statistic must be mean/count/min/max, got {statistic!r}.")
        return Raster(grid.reshape(h, w).astype(np.float32), transform,
                      crs if crs is not None else self.crs)

    def get_stats(self, stats: Any = None) -> Dict[str, float]:
        """Statistics of the data column over valid points (geoutils PointCloud.get_stats);
        `stats` accepts the reference's alias set incl. LE90/90thpercentile/sumofsquares."""
        from xdem_tpu.raster import select_stats, stats_from_values

        valid = self.z[np.isfinite(self.z)]
        out = stats_from_values(valid, int(self.z.size))
        if stats is None:
            return out
        if isinstance(stats, str):
            return select_stats(out, valid, [stats])[stats]
        return select_stats(out, valid, stats)

    def info(self) -> str:
        """Human-readable summary (printed by geoutils PointCloud.info)."""
        b = self.bounds
        lines = [
            f"{type(self).__name__} with {len(self)} points",
            f"CRS: {self.crs}",
            f"Bounds: left={b[0]:.3f} bottom={b[1]:.3f} right={b[2]:.3f} top={b[3]:.3f}",
            f"Data column: {self.data_column!r}"
            + (f" (+aux: {sorted(self.aux_columns)})" if self.aux_columns else ""),
        ]
        return "\n".join(lines)

    def to_file(self, path: str) -> None:
        """Write to .npz or delimited text (see xdem_tpu.epc.write_epc)."""
        from xdem_tpu.epc import write_epc

        write_epc(path, self)

    def plot(self, ax: Any = None, cmap: str = "viridis", marker_size: float = 2.0,
             add_cbar: bool = True, **kwargs: Any):
        """Scatter the points colored by the data column; returns the axes."""
        plt = import_optional("matplotlib.pyplot", package_name="matplotlib")

        if ax is None:
            ax = plt.gca()
        sc = ax.scatter(self.x, self.y, c=self.z, s=marker_size, cmap=cmap, **kwargs)
        if add_cbar:
            plt.colorbar(sc, ax=ax).set_label(self.data_column)
        return ax
