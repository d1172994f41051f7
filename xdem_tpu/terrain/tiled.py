"""Out-of-core tiled terrain attributes: stream row bands through the device kernels.

The reference processes rasters larger than memory with tiled map-overlap multiprocessing,
writing per-tile GeoTIFFs (reference terrain.py:412-466, geoutils map_overlap_multiproc_save).
The device equivalent streams fixed-shape row bands (one XLA compilation total) through
the same fused kernels and writes each attribute straight into a pre-laid-out uncompressed
GeoTIFF (io.StreamingRasterWriter), so peak host memory is one row band per attribute — the
20k x 20k full-suite attribute stack (~22 GB) never exists in memory.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Sequence

import numpy as np

from xdem_tpu.georef import Affine
from xdem_tpu.terrain.terrain import (
    ALL_ATTRS,
    FRACTAL_ATTRS,
    FREQUENCY_ATTRS,
    SURFACE_FIT_ATTRS,
    WINDOWED_ATTRS,
    get_terrain_attribute,
)


@dataclass
class TilingConfig:
    """Out-of-core tiling parameters (analog of the reference's MultiprocConfig)."""

    tile_rows: int = 1024
    outdir: str | None = None
    out_paths: dict[str, str] = field(default_factory=dict)

    def path_for(self, attr: str) -> str:
        if attr in self.out_paths:
            return self.out_paths[attr]
        if self.outdir is None:
            raise ValueError("TilingConfig needs `outdir` or per-attribute `out_paths`.")
        Path(self.outdir).mkdir(parents=True, exist_ok=True)
        return str(Path(self.outdir) / f"{attr}.tif")


def _halo_for(attrs: Sequence[str], surface_fit: str, window_size: int, window_size_fractal: int) -> int:
    halo = 0
    if any(a in SURFACE_FIT_ATTRS for a in attrs):
        halo = max(halo, 2 if surface_fit.lower() == "florinsky" else 1)
    if any(a in WINDOWED_ATTRS for a in attrs):
        halo = max(halo, window_size // 2)
    if any(a in FRACTAL_ATTRS for a in attrs):
        halo = max(halo, window_size_fractal // 2)
    return halo


class _RowSource:
    """Row-band access to the input DEM: in-memory array/Raster, or windowed file reads."""

    def __init__(self, dem: Any):
        from xdem_tpu.raster import Raster

        self.transform: Affine | None = None
        self.crs = None
        self._arr: np.ndarray | None = None
        self._path: str | None = None
        if isinstance(dem, (str, Path)):
            import ctypes

            from xdem_tpu.io import _GtInfo, _lib, read_rows

            info = _GtInfo()
            if _lib().gt_info(str(dem).encode(), ctypes.byref(info)) != 0:
                raise OSError(f"Cannot read GeoTIFF '{dem}'.")
            self.shape = (int(info.height), int(info.width))
            self.transform = Affine(*info.transform)
            self.crs = int(info.epsg) if info.epsg else None
            try:  # windowed reads need an uncompressed striped float32 layout
                read_rows(str(dem), 0, 1)
                self._path = str(dem)
            except OSError:
                from xdem_tpu.io import read_raster

                self._arr = np.asarray(read_raster(str(dem)).data)
        elif isinstance(dem, Raster):
            self._arr = np.asarray(dem.data)
            self.shape = self._arr.shape
            self.transform = dem.transform
            self.crs = dem.crs
        else:
            self._arr = np.asarray(dem)
            self.shape = self._arr.shape

    def rows(self, r0: int, nrows: int) -> np.ndarray:
        if self._arr is not None:
            return np.asarray(self._arr[r0: r0 + nrows], dtype=np.float32)
        from xdem_tpu.io import read_rows

        return read_rows(self._path, r0, nrows)


def tiled_terrain_attribute(
    dem: Any,
    attribute: str | Sequence[str],
    tiling: TilingConfig,
    resolution: float | tuple[float, float] | None = None,
    transform: Affine | None = None,
    crs: Any = None,
    nodata: float = -99999.0,
    **kwargs: Any,
) -> list[str]:
    """Compute terrain attributes tile-by-tile, streaming results to GeoTIFFs.

    Row bands of `tiling.tile_rows` rows (plus stencil halo) are processed at ONE fixed device
    shape — a single XLA compilation covers every band — and each attribute is written to
    `tiling.path_for(attr)` as soon as its band completes. Frequency-domain attributes
    (texture shading) are global FFTs and cannot be tiled. Returns the output paths.

    :param dem: Raster, 2-D array, or path to a GeoTIFF (uncompressed striped files are
        windowed from disk; compressed ones are decoded once into memory).
    """
    attrs = [attribute] if isinstance(attribute, str) else list(attribute)
    for a in attrs:
        if a in FREQUENCY_ATTRS:
            raise ValueError(f"'{a}' is a global frequency-domain attribute and cannot be tiled.")
        if a not in ALL_ATTRS:
            raise ValueError(f"Attribute '{a}' is not supported. Choices: {list(ALL_ATTRS)}")

    # The streaming GeoTIFF writer lays out float32 strips; refuse other out_dtypes rather
    # than silently writing a narrower type than requested.
    out_dtype = kwargs.pop("out_dtype", None)
    if out_dtype is not None and np.dtype(out_dtype) != np.float32:
        raise ValueError(
            f"tiled= streams float32 GeoTIFFs; out_dtype={np.dtype(out_dtype)} is not supported "
            f"out of core. Use the in-memory path for other output dtypes."
        )

    src = _RowSource(dem)
    if transform is None:
        transform = src.transform
    if crs is None:
        crs = src.crs
    if resolution is None and transform is not None:
        resolution = (abs(transform.xres), abs(transform.yres))

    surface_fit = kwargs.get("surface_fit", "Florinsky")
    window_size = int(kwargs.get("window_size", 3))
    window_size_fractal = int(kwargs.get("window_size_fractal", 13))
    halo = _halo_for(attrs, surface_fit, window_size, window_size_fractal)

    h, w = src.shape
    tile_rows = int(tiling.tile_rows)
    if transform is None:
        transform = Affine(1.0, 0.0, 0.0, 0.0, -1.0, float(h))

    from xdem_tpu.io import StreamingRasterWriter

    writers = {
        a: StreamingRasterWriter(tiling.path_for(a), (h, w), transform, crs=crs, nodata=nodata)
        for a in attrs
    }
    band_shape = (tile_rows + 2 * halo, w)
    try:
        for r0 in range(0, h, tile_rows):
            nrows = min(tile_rows, h - r0)
            lo = max(0, r0 - halo)
            hi = min(h, r0 + nrows + halo)
            band = np.full(band_shape, np.nan, dtype=np.float32)
            # Real rows land so the first output row is always at index `halo`
            band[halo - (r0 - lo): halo - (r0 - lo) + (hi - lo)] = src.rows(lo, hi - lo)
            out = get_terrain_attribute(band, attrs, resolution=resolution, **kwargs)
            out = out if isinstance(out, list) else [out]
            for a, res_arr in zip(attrs, out):
                writers[a].write_rows(r0, np.asarray(res_arr)[halo: halo + nrows])
    finally:
        for wtr in writers.values():
            wtr.close()
    return [tiling.path_for(a) for a in attrs]
