"""Package-level behavior configuration.

The reference inherits two user-facing knobs from geoutils' config (reference
doc/source/config.md:60-66): the default resampling algorithm applied by reprojection /
gridded interpolation, and the behavior around raster pixel interpretation
(Area vs Point) during raster-point comparison. Here they live in a plain dict with a
context-manager override:

>>> from xdem_tpu.config import config, config_context
>>> config["resampling"]
'bilinear'
>>> with config_context(resampling="nearest"):
...     config["resampling"]
'nearest'
>>> config["resampling"]
'bilinear'
>>> config["resampling"] = "sinc"
Traceback (most recent call last):
    ...
ValueError: resampling must be one of ('nearest', 'linear', 'bilinear', 'cubic'), got 'sinc'.

Keys
----
resampling : {"nearest", "linear", "bilinear", "cubic"}
    Default resampling for Raster.reproject and Coreg.apply when the call does not pass
    one explicitly (resampling=None).
warn_area_or_point : bool
    Warn when a raster pair mixes Area and Point pixel interpretations (the reference's
    geoutils warns likewise before casting to undefined).
shift_area_or_point : bool
    Shift coordinates by half a pixel when interpolating a raster tagged "Point" (whose
    samples sit at pixel corners, not centers) — geoutils' shift_area_or_point behavior.
shape_bucketing : int
    When > 0, terrain attributes and the fused raster-raster coreg paths (NuthKaab,
    VerticalShift) NaN-pad inputs to the next multiple of this bucket size so rasters of
    many slightly-different shapes share one compiled XLA program per bucket (each new
    shape otherwise costs a fresh compile). 0 disables. Terrain results match the unpadded
    run to small f32 fusion-order differences (~1e-4 relative); VerticalShift is exactly unchanged;
    NuthKaab loses only the former outer border's one-sided gradients from the valid set.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Any, Iterator

_DEFAULTS: dict[str, Any] = {
    "resampling": "bilinear",
    "warn_area_or_point": True,
    "shift_area_or_point": True,
    "shape_bucketing": 0,
}

_VALID_RESAMPLING = ("nearest", "linear", "bilinear", "cubic")


class _Config(dict):
    """Validating dict: unknown keys and invalid values fail fast."""

    def __setitem__(self, key: str, value: Any) -> None:
        if key not in _DEFAULTS:
            raise KeyError(f"Unknown config key {key!r}; valid keys: {sorted(_DEFAULTS)}.")
        if key == "resampling" and value not in _VALID_RESAMPLING:
            raise ValueError(f"resampling must be one of {_VALID_RESAMPLING}, got {value!r}.")
        if key in ("warn_area_or_point", "shift_area_or_point"):
            value = bool(value)
        if key == "shape_bucketing":
            value = int(value)
            if value < 0:
                raise ValueError(f"shape_bucketing must be >= 0, got {value}.")
        super().__setitem__(key, value)

    # Route every bulk-set API through the validating __setitem__
    def update(self, *args: Any, **kwargs: Any) -> None:  # type: ignore[override]
        for k, v in dict(*args, **kwargs).items():
            self[k] = v

    def setdefault(self, key: str, default: Any = None) -> Any:  # type: ignore[override]
        if key not in self:
            self[key] = default
        return self[key]

    def __ior__(self, other: Any) -> "_Config":
        self.update(other)
        return self

    def reset(self) -> None:
        for k, v in _DEFAULTS.items():
            dict.__setitem__(self, k, v)


config = _Config(_DEFAULTS)


@contextmanager
def config_context(**overrides: Any) -> Iterator[_Config]:
    """Temporarily override package config keys within a `with` block."""
    previous = {k: config[k] for k in overrides}
    try:
        for k, v in overrides.items():
            config[k] = v
        yield config
    finally:
        for k, v in previous.items():
            config[k] = v
