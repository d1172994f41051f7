"""DEMCollection: a timestamped series of DEMs with dh/dv series extraction.

Reference parity: /root/reference/xdem/demcollection.py (subtract_dems :104,
interpolate_ddems :138, get_ddem_mask :150, get_dh_series :193, get_dv_series :231,
get_cumulative_series :249).
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Any, Literal, Sequence

import numpy as np

from xdem_tpu._misc import import_optional
from xdem_tpu.ddem import dDEM
from xdem_tpu.dem import DEM
from xdem_tpu.vector import Vector

if TYPE_CHECKING:
    import pandas as pd


class DEMCollection:
    """A temporal collection of DEMs sharing a grid, with optional outlines per date."""

    def __init__(
        self,
        dems: Sequence[DEM],
        timestamps: Sequence[Any] | None = None,
        outlines: Vector | dict[Any, Vector] | None = None,
        reference_dem: DEM | int = 0,
    ):
        pd = import_optional("pandas")
        if timestamps is None:
            raise ValueError("Timestamps must be provided.")
        if len(timestamps) != len(dems):
            raise ValueError("The 'timestamps' len differs from the 'dems' len.")
        order = np.argsort([pd.Timestamp(t).value for t in timestamps])
        self.dems = [dems[i] for i in order]
        self.timestamps = [timestamps[i] for i in order]
        if isinstance(reference_dem, int):
            reference_dem = dems[reference_dem]
        self.reference_dem = reference_dem
        if isinstance(outlines, Vector):
            outlines = {self.timestamps[0]: outlines}
        self.outlines: dict[Any, Vector] = outlines or {}
        self.ddems: list[dDEM] = []
        self.ddems_are_intervalwise = False

    @property
    def reference_index(self) -> int:
        # Identity scan: raster == raster is ELEMENTWISE (a mask raster), so list.index
        # would compare by truthiness instead of identity
        return next(i for i, d in enumerate(self.dems) if d is self.reference_dem)

    @property
    def reference_timestamp(self) -> Any:
        """Timestamp of the reference DEM (reference demcollection.py:100)."""
        return self.timestamps[self.reference_index]

    def subtract_dems(self, resampling_method: str = "cubic_spline") -> list[dDEM]:
        """dDEMs between the reference DEM and every DEM (reference demcollection.py:104).

        Like the reference, the reference DEM itself yields an all-zero dDEM so the list
        stays index-aligned with `dems` (statistics methods skip it via `time == 0`).
        """
        pd = import_optional("pandas")
        ddems = []
        ref = self.reference_dem
        ref_time = self.timestamps[self.reference_index]
        for dem, ts in zip(self.dems, self.timestamps):
            if dem is ref:
                from xdem_tpu.raster import Raster

                zero = Raster(np.zeros(ref.shape, dtype=np.float32), ref.transform, ref.crs)
                ddems.append(dDEM(zero, start_time=ref_time, end_time=ref_time, error=0))
                continue
            reproj = dem if _same_grid(dem, ref) else dem.reproject(ref, resampling=resampling_method)
            diff = _subtract_on_grid(ref, reproj)
            start, end = (ts, ref_time) if pd.Timestamp(ts) < pd.Timestamp(ref_time) else (ref_time, ts)
            ddems.append(dDEM(diff, start_time=start, end_time=end))
        self.ddems = ddems
        self.ddems_are_intervalwise = False
        return ddems

    def subtract_dems_intervalwise(self, resampling_method: str = "cubic_spline") -> list[dDEM]:
        """Consecutive-interval dDEMs (later - earlier)."""
        ddems = []
        for i in range(len(self.dems) - 1):
            early, late = self.dems[i], self.dems[i + 1]
            reproj = early if _same_grid(early, late) else early.reproject(late, resampling=resampling_method)
            diff = _subtract_on_grid(late, reproj)
            ddems.append(dDEM(diff, start_time=self.timestamps[i], end_time=self.timestamps[i + 1]))
        self.ddems = ddems
        self.ddems_are_intervalwise = True
        return ddems

    def interpolate_ddems(self, method: str = "idw") -> list[np.ndarray]:
        """Gap-fill every dDEM (reference demcollection.py:138)."""
        return [d.interpolate(method=method, reference_elevation=self.reference_dem,
                              mask=self.get_ddem_mask(d) if self.outlines else None)
                for d in self.ddems]

    def get_ddem_mask(self, ddem: dDEM, outlines_filter: str | None = None) -> np.ndarray:
        """Rasterized outline mask for a dDEM, reference cascade (demcollection.py:150-191):
        start+end outline union if both exist, else start-time outlines, else the single
        outline set, else all-True. `outlines_filter` is a pandas query over the outlines'
        feature properties (e.g. ``"name == 'some glacier'"``)."""
        if not any(ddem is d for d in self.ddems):
            raise ValueError("Given dDEM must be a part of the DEMCollection object.")
        outlines = self.outlines
        if outlines_filter is not None:
            outlines = {key: out.query(outlines_filter) for key, out in outlines.items()}

        if ddem.start_time in outlines and ddem.end_time in outlines:
            mask = np.logical_or(
                outlines[ddem.start_time].create_mask(ddem),
                outlines[ddem.end_time].create_mask(ddem),
            )
        elif ddem.start_time in outlines:
            mask = outlines[ddem.start_time].create_mask(ddem)
        elif len(outlines) == 1:
            mask = next(iter(outlines.values())).create_mask(ddem)
        else:
            mask = np.ones(ddem.shape, dtype=bool)
        return mask.reshape(ddem.shape)

    def get_dh_series(self, outlines_filter: str | None = None, mask: Any = None,
                      nans_ok: bool = False) -> pd.DataFrame:
        """Weighted mean dh and area within the outlines per interval (demcollection.py:193)."""
        pd = import_optional("pandas")
        if len(self.ddems) == 0:
            raise ValueError("dDEMs have not yet been calculated")
        rows = []
        index = []
        for d in self.ddems:
            if d.time is not None and pd.Timedelta(d.time).value == 0:
                continue  # self-comparison zero dDEM of the reference timestamp
            if mask is not None:
                m = np.asarray(mask, bool)
            else:
                m = self.get_ddem_mask(d, outlines_filter=outlines_filter)
            data = d.filled_data if d.filled_data is not None else d.get_nanarray()
            if not nans_ok and d.filled_data is None and np.any(~np.isfinite(data[m])):
                raise ValueError("Unfilled NaNs in dDEM; interpolate first or pass nans_ok=True.")
            vals = data[m]
            mean_dh = float(np.nanmean(vals)) if vals.size else np.nan
            px_area = d.res[0] * d.res[1]
            rows.append({"dh": mean_dh, "area": float(m.sum() * px_area)})
            index.append(pd.Interval(pd.Timestamp(d.start_time), pd.Timestamp(d.end_time)))
        return pd.DataFrame(rows, index=index)

    def get_dv_series(self, outlines_filter: str | None = None, mask: Any = None,
                      nans_ok: bool = False) -> pd.Series:
        """Volume change series: dh * area per interval (demcollection.py:231)."""
        dhs = self.get_dh_series(outlines_filter=outlines_filter, mask=mask, nans_ok=nans_ok)
        return dhs["area"] * dhs["dh"]

    def get_cumulative_series(
        self,
        kind: Literal["dh", "dv"] = "dh",
        outlines_filter: str | None = None,
        mask: Any = None,
        nans_ok: bool = False,
    ) -> pd.Series:
        """Cumulative dh or dv since the first timestamp (reference demcollection.py:249).

        Reference-mode dDEM values are (reference - DEM) over [year, reference_year]
        intervals: the value at each non-reference year is their negation anchored to zero
        at the reference, then the whole series is shifted so it starts at zero — exactly
        the reference's algorithm (demcollection.py:276-290). Interval-wise dDEM chains
        (this implementation's extension) chain-cumsum (later - earlier) values instead.
        """
        pd = import_optional("pandas")
        if kind not in ("dh", "dv"):
            raise ValueError(f"Invalid kind: {kind}. Choices: ['dh', 'dv'].")
        if kind == "dh":
            series = self.get_dh_series(outlines_filter=outlines_filter, mask=mask, nans_ok=nans_ok)["dh"]
        else:
            series = self.get_dv_series(outlines_filter=outlines_filter, mask=mask, nans_ok=nans_ok)

        if self.ddems_are_intervalwise:
            cumulative = series.cumsum()
            return pd.Series(
                data=np.r_[0.0, cumulative.values],
                index=np.r_[[series.index[0].left], [iv.right for iv in series.index]],
            )

        ref_time = pd.Timestamp(self.reference_timestamp)
        cumulative = pd.Series(dtype=float)
        cumulative[ref_time] = 0.0
        for interval, value in zip(series.index, series.values):
            non_ref_year = [t for t in (interval.left, interval.right) if t != ref_time][0]
            cumulative.loc[non_ref_year] = -value
        cumulative.sort_index(inplace=True)
        return cumulative - cumulative.iloc[0]


def _same_grid(a, b) -> bool:
    """True when two rasters share shape, transform, and CRS (no resampling needed)."""
    return (a.shape == b.shape and a.transform.almost_equals(b.transform) and a.crs == b.crs)


def _subtract_on_grid(a, b):
    """Difference of two grid-identical rasters as a plain Raster."""
    from xdem_tpu.raster import Raster

    if not _same_grid(a, b):
        raise ValueError(
            "Rasters share a shape but not a grid (transform/CRS differ); reproject first."
        )
    return Raster(a.data - b.data, a.transform, a.crs)
