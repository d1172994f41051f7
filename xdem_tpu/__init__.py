"""xdem_tpu: a JAX/XLA framework for DEM and elevation point-cloud analysis on accelerators.

Re-designed from scratch with the capability surface of GlacioHack/xdem: elevation objects
(DEM/EPC), terrain attributes as fused stencil kernels, 3-D coregistration as jit-compiled
iterative solvers, uncertainty analysis (heteroscedasticity, variograms, error propagation) as
sharded pairwise kernels, and volume change / workflows / CLI on top.
"""

from __future__ import annotations

__version__ = "0.1.0"

import os as _os

import jax as _jax

# Persistent compilation cache: every new raster shape otherwise costs a fresh XLA compile.
# Where JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and the package sets nothing.
# Otherwise the cache lives at one fixed path inside the checkout (a directory that moved
# between runs would never be found again). CPU-forced runs skip it: their
# compiles are fast and reloading CPU entries logs machine-feature mismatch noise.
_platforms = _jax.config.jax_platforms or _os.environ.get("JAX_PLATFORMS", "") or ""
_cpu_forced = _platforms.split(",")[0].strip().lower() == "cpu"
if not _os.environ.get("JAX_COMPILATION_CACHE_DIR") and not _cpu_forced:
    _jax.config.update(
        "jax_compilation_cache_dir",
        _os.path.join(_os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))), ".jax_cache"),
    )
    _jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    _jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)

from xdem_tpu import examples, fit, georef, ops, spatialstats, terrain, vcrs, volume  # noqa: F401
from xdem_tpu.ddem import dDEM  # noqa: F401
from xdem_tpu.dem import DEM  # noqa: F401
from xdem_tpu.demcollection import DEMCollection  # noqa: F401
from xdem_tpu.epc import EPC  # noqa: F401
from xdem_tpu.georef import CRS, Affine  # noqa: F401
from xdem_tpu.pointcloud import PointCloud  # noqa: F401
from xdem_tpu.raster import Raster  # noqa: F401
from xdem_tpu.vector import Vector  # noqa: F401
from xdem_tpu.config import config, config_context  # noqa: F401

def __getattr__(name: str):
    # Lazy submodule imports (coreg pulls in the full solver stack; workflows pulls in reporting)
    if name in ("coreg", "workflows", "uncertainty", "parallel", "io"):
        import importlib

        mod = importlib.import_module(f"xdem_tpu.{name}")
        globals()[name] = mod
        return mod
    raise AttributeError(f"module 'xdem_tpu' has no attribute {name!r}")


def __dir__():
    # Surface the lazy submodules in dir()/tab completion (PEP 562)
    return sorted(set(globals()) | {"coreg", "workflows", "uncertainty", "parallel", "io"})


__all__ = [
    "DEM",
    "dDEM",
    "DEMCollection",
    "EPC",
    "Raster",
    "PointCloud",
    "Vector",
    "CRS",
    "Affine",
    "config",
    "config_context",
    "coreg",
    "terrain",
    "spatialstats",
    "volume",
    "fit",
    "examples",
    "georef",
    "vcrs",
    "ops",
]
