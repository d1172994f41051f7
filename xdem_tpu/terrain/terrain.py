"""Terrain attribute dispatcher: validation, family split, device dispatch, raster wrapping.

Mirrors the reference dispatcher (/root/reference/xdem/terrain/terrain.py:176-666): splits the
requested attributes into surface-fit / windowed / windowed-fractal / frequency families,
validates inputs identically (Horn-curvature error, resolution requirements, hillshade ranges),
converts slope/aspect to degrees, clips hillshade to [0, 255], and restores request order.

Instead of the reference's tiled multiprocessing (terrain.py:412-466), large rasters can be
sharded across a device mesh via `xdem_tpu.parallel` halo-exchange stencils.
"""

from __future__ import annotations

import logging
import warnings
from typing import Any, Literal, Sequence

import jax.numpy as jnp
import numpy as np

from xdem_tpu.ops.transfer import unmask
from xdem_tpu.profiler import profile as _profile
from xdem_tpu.raster import Raster
from xdem_tpu.terrain.freq import texture_shading as _texture_shading_fn
from xdem_tpu.terrain.surfit import SURFACE_FIT_ATTRS, surface_attributes
from xdem_tpu.terrain.window import FRACTAL_ATTRS, WINDOWED_ATTRS, windowed_indexes
from xdem_tpu.terrain.window import fractal_roughness as _fractal_roughness_fn

FREQUENCY_ATTRS = ("texture_shading",)

ALL_ATTRS = tuple(SURFACE_FIT_ATTRS) + WINDOWED_ATTRS + FRACTAL_ATTRS + FREQUENCY_ATTRS


def _terrain_epilog(sources, spec, out_hw, dtype_name):
    """All per-attribute post ops as ONE jitted launch: plane slice from each kernel stack,
    degree conversion, hillshade clip, bucket-padding crop and the output dtype cast.
    `spec` is a tuple of (source_index, plane_or_-1, rad2deg?, clip?) per attribute.
    Module-level jit: a per-call jit closure would retrace on EVERY dispatch."""
    return _terrain_epilog_run(sources, spec_=spec, out_hw_=out_hw, dtype_=dtype_name)


def _terrain_epilog_jit():
    from functools import partial

    import jax

    @partial(jax.jit, static_argnames=("spec_", "out_hw_", "dtype_"))
    def run(sources_, spec_, out_hw_, dtype_):
        out = []
        for k, idx, deg, clip in spec_:
            v = sources_[k] if idx < 0 else sources_[k][idx]
            if deg:
                v = jnp.rad2deg(v)
            if clip:
                v = jnp.clip(v, 0, 255)
            out.append(v[: out_hw_[0], : out_hw_[1]].astype(jnp.dtype(dtype_)))
        return tuple(out)

    return run


_terrain_epilog_run = _terrain_epilog_jit()

_CURVATURES = (
    "curvature",
    "profile_curvature",
    "tangential_curvature",
    "planform_curvature",
    "flowline_curvature",
    "max_curvature",
    "min_curvature",
)


@_profile("xdem_tpu.terrain.get_terrain_attribute", memprof=True)
def get_terrain_attribute(
    dem: Any,
    attribute: str | Sequence[str],
    resolution: float | tuple[float, float] | None = None,
    degrees: bool = True,
    hillshade_altitude: float = 45.0,
    hillshade_azimuth: float = 315.0,
    hillshade_z_factor: float = 1.0,
    slope_method: Literal["Horn", "ZevenbergThorne"] | None = None,
    surface_fit: Literal["Horn", "ZevenbergThorne", "Florinsky"] = "Florinsky",
    curv_method: Literal["geometric", "directional"] = "geometric",
    tri_method: Literal["Riley", "Wilson"] = "Riley",
    window_size: int = 3,
    window_size_fractal: int = 13,
    texture_alpha: float = 0.8,
    out_dtype: Any = None,
    mesh: Any = None,
    engine: Literal["xla", "scipy", "numba"] = "xla",
    tiled: Any = None,
    mp_config: Any = None,
) -> Any:
    """Derive one or multiple terrain attributes from a DEM (array or Raster).

    See the reference docstring (terrain.py:195-281) for attribute definitions; numerics and
    defaults are identical. `mesh` optionally shards the stencil computation over a JAX device
    mesh with halo exchange instead of the reference's tiled multiprocessing. `tiled` (a
    terrain.TilingConfig, the analog of the reference's mp_config) streams out-of-core row
    bands into per-attribute GeoTIFFs and returns their paths instead of arrays. `mp_config`
    is accepted for reference-signature parity: a TilingConfig routes to `tiled=`; the
    reference's process-pool MultiprocConfig has no meaning on this backend and raises.
    `engine` accepts "xla" and the reference's "scipy"/"numba" names, which all select the
    one XLA path.
    """
    from xdem_tpu.terrain.window import normalize_engine

    normalize_engine(engine)
    if mp_config is not None:
        if not hasattr(mp_config, "tile_rows"):
            raise ValueError(
                "mp_config process-pool tiling does not exist on this backend (one device "
                "streams fixed-shape row bands): pass tiled=terrain.TilingConfig(...) for "
                "out-of-core streaming, or mesh= to shard across devices."
            )
        if tiled is not None:
            raise ValueError("Pass only one of mp_config= and tiled= (they are aliases here).")
        tiled = mp_config
    # Deprecated alias (must run before any dispatch so tiled= sees the resolved fit)
    if slope_method is not None:
        warnings.warn("'slope_method' is deprecated, use 'surface_fit' instead.", DeprecationWarning, stacklevel=2)
        surface_fit = slope_method

    if tiled is not None:
        if mesh is not None:
            raise ValueError("tiled= (out-of-core streaming) and mesh= (device sharding) are exclusive.")
        from xdem_tpu.terrain.tiled import tiled_terrain_attribute

        return tiled_terrain_attribute(
            dem, attribute, tiled, resolution=resolution,
            surface_fit=surface_fit, curv_method=curv_method, tri_method=tri_method,
            window_size=window_size, window_size_fractal=window_size_fractal,
            degrees=degrees, hillshade_altitude=hillshade_altitude,
            hillshade_azimuth=hillshade_azimuth, hillshade_z_factor=hillshade_z_factor,
            out_dtype=out_dtype,
        )

    single = isinstance(attribute, str)
    attrs = [attribute] if single else list(attribute)

    # --- validation, matching reference terrain.py:283-409
    if surface_fit == "Horn" and any(a in _CURVATURES for a in attrs):
        raise ValueError(
            "'Horn' surface fit method cannot be used for to calculate curvatures. "
            "Use 'ZevenbergThorne' or 'Florinsky' instead."
        )
    for a in attrs:
        if a not in ALL_ATTRS:
            raise ValueError(f"Attribute '{a}' is not supported. Choices: {list(ALL_ATTRS)}")
    if surface_fit.lower() not in ("horn", "zevenbergthorne", "florinsky"):
        raise ValueError(f"Surface fit '{surface_fit}' is not supported.")
    if curv_method.lower() not in ("geometric", "directional"):
        raise ValueError(f"Curvature method '{curv_method}' is not supported.")
    if tri_method.lower() not in ("riley", "wilson"):
        raise ValueError(f"TRI method '{tri_method}' is not supported.")
    if not 0.0 <= hillshade_azimuth <= 360.0:
        raise ValueError(f"Azimuth must be a value between 0 and 360 degrees (given value: {hillshade_azimuth})")
    if not 0.0 <= hillshade_altitude <= 90.0:
        raise ValueError(f"Altitude must be a value between 0 and 90 degrees (given value: {hillshade_altitude})")
    if hillshade_z_factor < 0 or not np.isfinite(hillshade_z_factor):
        raise ValueError(f"z_factor must be a non-negative finite value (given value: {hillshade_z_factor})")
    if "fractal_roughness" in attrs:
        if window_size_fractal < 5:
            warnings.warn("Fractal roughness can only be computed on window sizes larger or equal to 5.", UserWarning)
        elif window_size_fractal < 13:
            warnings.warn("Fractal roughness results with window size of less than 13 can be inaccurate.", UserWarning)

    is_raster = isinstance(dem, Raster)
    if is_raster and resolution is None:
        resolution = dem.res

    sf_attrs = [a for a in attrs if a in SURFACE_FIT_ATTRS]
    win_attrs = [a for a in attrs if a in WINDOWED_ATTRS]
    frac_attrs = [a for a in attrs if a in FRACTAL_ATTRS]
    freq_attrs = [a for a in attrs if a in FREQUENCY_ATTRS]

    needing_res = sf_attrs + (["rugosity"] if "rugosity" in attrs else [])
    if needing_res:
        if resolution is None:
            raise ValueError(f"Attributes {needing_res} need the pixel size: pass resolution=.")
        if isinstance(resolution, (tuple, list)):
            if resolution[0] != resolution[1]:
                raise ValueError(
                    f"Attributes {needing_res} assume square pixels, but resolution {resolution} has "
                    f"different X and Y steps. Resample to a square grid first."
                )
    if resolution is None:
        resolution = 1.0
    if isinstance(resolution, (tuple, list)):
        resolution = float(resolution[0])

    if is_raster and not dem.crs.is_projected and sf_attrs:
        warnings.warn(
            f"DEM is not in a projected CRS, the following surface fit attributes might be wrong: {sf_attrs}. "
            f"Use DEM.reproject(crs=DEM.get_metric_crs()) to reproject in a projected CRS.",
            UserWarning,
        )

    arr = dem.data if is_raster else jnp.asarray(unmask(dem))
    if not jnp.issubdtype(arr.dtype, jnp.floating):
        arr = arr.astype(jnp.float32)
    if out_dtype is None:
        out_dtype = arr.dtype

    # Shape bucketing (config["shape_bucketing"] = N): NaN-pad to the next multiple of N so
    # rasters of many slightly-different sizes share one compiled program per bucket instead
    # of one compile each. NaN padding reproduces the unpadded result up to
    # small f32 fusion-order differences: the stencils' edge semantics already treat
    # beyond-edge as NaN. Sharded (mesh=) runs pad via their own halo logic.
    from xdem_tpu.config import config as _pkg_config
    from xdem_tpu.ops.transfer import pad_to_bucket

    arr_unpadded = arr  # frequency-domain attributes must NOT see the NaN pad band: the FFT
    # path mean-fills NaN, which would replace its symmetric-reflection boundary handling
    (arr,), orig_hw = pad_to_bucket(
        int(_pkg_config["shape_bucketing"]) if mesh is None else 0, (arr, jnp.nan)
    )

    results: dict[str, jnp.ndarray] = {}

    if sf_attrs:
        kwargs = dict(
            attrs=tuple(sf_attrs),
            surface_fit=surface_fit,
            curv_method=curv_method,
            hillshade_altitude=float(hillshade_altitude),
            hillshade_azimuth=float(hillshade_azimuth),
            hillshade_z_factor=float(hillshade_z_factor),
        )
        if mesh is not None:
            from xdem_tpu.parallel.halo import sharded_surface_attributes

            stack = sharded_surface_attributes(arr, resolution, mesh=mesh, **kwargs)
        else:
            stack = surface_attributes(arr, resolution, **kwargs)
        # Deferred: the per-attribute post ops (plane slice, degree conversion, hillshade
        # clip, bucket crop, dtype cast) all fuse into ONE jitted epilog below — issued
        # eagerly they cost ~5 extra device launches.
        for i, a in enumerate(sf_attrs):
            results[a] = (stack, i)

    # Rugosity is defined on a 3x3 window ONLY (Jenness 2004); the reference computes it on
    # a fixed 3x3 regardless of window_size= (its scipy wrapper hardcodes size=3,
    # reference window.py:700). Route it through its own 3x3 dispatch when window_size != 3
    # so e.g. [roughness@5x5, rugosity@3x3] matches the reference.
    def _win_dispatch(attrs_t: tuple[str, ...], wsize: int) -> jnp.ndarray:
        if mesh is not None:
            from xdem_tpu.parallel.halo import sharded_stencil

            return sharded_stencil(
                lambda padded: windowed_indexes(padded, resolution, attrs_t,
                                                window_size=wsize, tri_method=tri_method),
                arr, halo=wsize // 2, mesh=mesh, out_leading=len(attrs_t),
            )
        return windowed_indexes(arr, resolution, attrs_t, window_size=wsize,
                                tri_method=tri_method)

    if win_attrs:
        shared_attrs = [a for a in win_attrs if not (a == "rugosity" and window_size != 3)]
        if shared_attrs:
            stack_w = _win_dispatch(tuple(shared_attrs), window_size)
            for i, a in enumerate(shared_attrs):
                results[a] = (stack_w, i)
        if "rugosity" in win_attrs and window_size != 3:
            results["rugosity"] = (_win_dispatch(("rugosity",), 3), 0)

    if frac_attrs:
        if mesh is not None:
            from xdem_tpu.parallel.halo import sharded_stencil

            results["fractal_roughness"] = (sharded_stencil(
                lambda padded: _fractal_roughness_fn(padded, window_size=window_size_fractal)[None],
                arr, halo=window_size_fractal // 2, mesh=mesh, out_leading=1,
            ), 0)
        else:
            results["fractal_roughness"] = (
                _fractal_roughness_fn(arr, window_size=window_size_fractal), None)

    for a in freq_attrs:
        results[a] = (_texture_shading_fn(arr_unpadded, alpha=texture_alpha), None)

    # ONE fused epilog launch: plane slices, degree conversion, hillshade clip, bucket
    # crop and the dtype cast for every attribute (freq planes are already unpadded; the
    # crop inside is a no-op slice for them).
    sources: list = []
    spec = []
    for a in attrs:
        src, idx = results[a]
        for k, sdone in enumerate(sources):
            if sdone is src:
                break
        else:
            sources.append(src)
            k = len(sources) - 1
        spec.append((k, -1 if idx is None else int(idx),
                     bool(degrees and a in ("slope", "aspect") and a in sf_attrs),
                     a == "hillshade"))
    ordered = list(_terrain_epilog(tuple(sources), tuple(spec), tuple(orig_hw),
                                   jnp.dtype(out_dtype).name))

    if is_raster:
        ordered = [
            Raster(o, transform=dem.transform, crs=dem.crs, nodata=-99999, area_or_point=dem.area_or_point)
            for o in ordered
        ]
    return ordered[0] if single else ordered


def _resolve_deprecated_method(method: Any, surface_fit: str) -> str:
    """The reference deprecates `method=` as an alias of `surface_fit=` for the surface-fit
    attributes (slope/aspect/hillshade, reference terrain.py:437-446)."""
    if method is not None:
        warnings.warn("'method' is deprecated, use 'surface_fit' instead.", DeprecationWarning, stacklevel=3)
        return method
    return surface_fit


def slope(
    dem: Any,
    method: Literal["Horn", "ZevenbergThorne"] | None = None,
    surface_fit: Literal["Horn", "ZevenbergThorne", "Florinsky"] = "Florinsky",
    degrees: bool = True,
    resolution: float | tuple[float, float] | None = None,
    **kwargs: Any,
) -> Any:
    """Slope in degrees (default) or radians, from a local surface fit (Horn 1981 /
    Zevenbergen & Thorne 1987 / Florinsky 2009). Reference terrain.py:694.

    Extra keyword arguments (mesh=, tiled=, mp_config=, engine=, ...) forward to
    :func:`get_terrain_attribute`.

    A unit ramp has a 45-degree slope (the reference's own docstring example,
    terrain.py:268-279):

    >>> import numpy as np
    >>> ramp = np.repeat(np.arange(5, dtype=float)[None, :], 5, axis=0)
    >>> round(float(slope(ramp, surface_fit="ZevenbergThorne", resolution=1.0)[2, 2]), 4)
    45.0
    """
    surface_fit = _resolve_deprecated_method(method, surface_fit)
    return get_terrain_attribute(dem, attribute="slope", surface_fit=surface_fit,
                                 degrees=degrees, resolution=resolution, **kwargs)


def aspect(
    dem: Any,
    method: Literal["Horn", "ZevenbergThorne"] | None = None,
    surface_fit: Literal["Horn", "ZevenbergThorne", "Florinsky"] = "Florinsky",
    degrees: bool = True,
    **kwargs: Any,
) -> Any:
    """Aspect (0=N, 90=E, clockwise) in degrees or radians. Reference terrain.py:773.

    A ramp rising eastward faces west:

    >>> import numpy as np
    >>> ramp = np.repeat(np.arange(5, dtype=float)[None, :], 5, axis=0)
    >>> round(float(aspect(ramp, surface_fit="ZevenbergThorne", resolution=1.0)[2, 2]), 4)
    270.0
    """
    surface_fit = _resolve_deprecated_method(method, surface_fit)
    return get_terrain_attribute(dem, attribute="aspect", surface_fit=surface_fit,
                                 degrees=degrees, **kwargs)


def hillshade(
    dem: Any,
    method: Literal["Horn", "ZevenbergThorne"] | None = None,
    surface_fit: Literal["Horn", "ZevenbergThorne", "Florinsky"] = "Florinsky",
    azimuth: float = 315.0,
    altitude: float = 45.0,
    z_factor: float = 1.0,
    resolution: float | tuple[float, float] | None = None,
    **kwargs: Any,
) -> Any:
    """GDAL-matching hillshade in [0, 255] (Horn 1981). Reference terrain.py:867.

    A flat surface under the default 45-degree sun shades to 1.5 + 254*sin(45deg):

    >>> import numpy as np
    >>> round(float(hillshade(np.zeros((5, 5)), resolution=1.0)[2, 2]), 2)
    181.11
    """
    surface_fit = _resolve_deprecated_method(method, surface_fit)
    return get_terrain_attribute(dem, attribute="hillshade", surface_fit=surface_fit,
                                 hillshade_azimuth=azimuth, hillshade_altitude=altitude,
                                 hillshade_z_factor=z_factor, resolution=resolution, **kwargs)


def _curvature_fn(attr: str, refline: int, blurb: str):
    def fn(
        dem: Any,
        resolution: float | tuple[float, float] | None = None,
        surface_fit: Literal["ZevenbergThorne", "Florinsky"] = "Florinsky",
        curv_method: Literal["geometric", "directional"] = "geometric",
        **kwargs: Any,
    ) -> Any:
        return get_terrain_attribute(dem, attribute=attr, resolution=resolution,
                                     surface_fit=surface_fit, curv_method=curv_method, **kwargs)

    fn.__name__ = fn.__qualname__ = attr
    fn.__doc__ = (f"{blurb} (100 m-1); `curv_method` picks the geometric (Minár 2020) or "
                  f"directional-derivative (Zevenbergen & Thorne 1987) variant. "
                  f"Reference terrain.py:{refline}.")
    return fn


profile_curvature = _curvature_fn("profile_curvature", 1016, "Profile curvature")
tangential_curvature = _curvature_fn("tangential_curvature", 1092, "Tangential curvature")
planform_curvature = _curvature_fn("planform_curvature", 1169, "Planform curvature")
flowline_curvature = _curvature_fn("flowline_curvature", 1244, "Flowline curvature")
max_curvature = _curvature_fn("max_curvature", 1320, "Maximal curvature")
min_curvature = _curvature_fn("min_curvature", 1396, "Minimal curvature")


def topographic_position_index(dem: Any, window_size: int = 3, **kwargs: Any) -> Any:
    """TPI (Weiss 2001): difference to the window mean of neighbours. Reference terrain.py:1468.

    A unit bump on a flat plane sits one unit above its (all-zero) neighbours:

    >>> import numpy as np
    >>> bump = np.zeros((5, 5)); bump[2, 2] = 1.0
    >>> float(topographic_position_index(bump)[2, 2])
    1.0
    """
    return get_terrain_attribute(dem, attribute="topographic_position_index",
                                 window_size=window_size, **kwargs)


def terrain_ruggedness_index(
    dem: Any,
    method: Literal["Riley", "Wilson"] = "Riley",
    window_size: int = 3,
    **kwargs: Any,
) -> Any:
    """TRI: cumulated differences to neighbouring pixels — Riley 1999 (sqrt of squared diffs,
    topography) or Wilson 2007 (mean absolute diff, bathymetry). Here `method` selects the
    TRI variant, NOT the deprecated surface-fit alias (reference terrain.py:1531-1546).

    Riley on a unit bump: sqrt of eight squared unit differences = 2*sqrt(2):

    >>> import numpy as np
    >>> bump = np.zeros((5, 5)); bump[2, 2] = 1.0
    >>> round(float(terrain_ruggedness_index(bump)[2, 2]), 4)
    2.8284
    """
    return get_terrain_attribute(dem, attribute="terrain_ruggedness_index",
                                 tri_method=method, window_size=window_size, **kwargs)


def roughness(dem: Any, window_size: int = 3, **kwargs: Any) -> Any:
    """Roughness (Dartnell 2000): window max - min. Reference terrain.py:1600.

    >>> import numpy as np
    >>> bump = np.zeros((5, 5)); bump[2, 2] = 1.0
    >>> float(roughness(bump)[2, 2])
    1.0
    """
    return get_terrain_attribute(dem, attribute="roughness", window_size=window_size, **kwargs)


def rugosity(dem: Any, resolution: float | tuple[float, float] | None = None, **kwargs: Any) -> Any:
    """Rugosity (Jenness 2004): real-to-planimetric area ratio, 3x3 only. Reference terrain.py:1661."""
    return get_terrain_attribute(dem, attribute="rugosity", resolution=resolution, **kwargs)


def fractal_roughness(dem: Any, window_size_fractal: int = 13, **kwargs: Any) -> Any:
    """Fractal roughness (Taud & Parrot 2005): local 3-D fractal dimension in [1, 3] by voxel
    box-counting; window >= 5. Reference terrain.py:1722."""
    return get_terrain_attribute(dem, attribute="fractal_roughness",
                                 window_size_fractal=window_size_fractal, **kwargs)


def texture_shading(dem: Any, alpha: float = 0.8, **kwargs: Any) -> Any:
    """Texture shading (Brown 2010): fractional-Laplacian relief. Reference terrain.py:1783.

    Matches the reference's user-facing signature: `alpha` is the fractional-Laplacian
    exponent (get_terrain_attribute calls it `texture_alpha` to avoid colliding with other
    attributes' parameters).
    """
    return get_terrain_attribute(dem, attribute="texture_shading", texture_alpha=alpha, **kwargs)


def curvature(
    dem: Any,
    resolution: float | tuple[float, float] | None = None,
    surface_fit: Literal["ZevenbergThorne", "Florinsky"] = "Florinsky",
    **kwargs: Any,
) -> Any:
    """Legacy total curvature -2(D+E)*100 (Moore et al. 1991). Deprecated in the reference
    (terrain.py:944, default surface_fit Florinsky); kept for parity."""
    warnings.warn(
        "The curvature attribute is deprecated, refer to docs for specific curvature functions.",
        DeprecationWarning,
        stacklevel=2,
    )
    return get_terrain_attribute(dem, attribute="curvature", resolution=resolution,
                                 surface_fit=surface_fit, **kwargs)
