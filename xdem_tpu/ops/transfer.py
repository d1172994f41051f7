"""Host->device transfer helpers.

Boolean masks are the one full-raster input that must cross the host boundary on every coreg
fit (rasters stay device-resident): uploading them as packed bits cuts the transfer 8x.
Whether that still pays on a fast host link is an open measurement.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


@partial(jax.jit, static_argnames=("n", "shape"))
def _unpack_bits(packed: jnp.ndarray, n: int, shape: tuple[int, ...] | None = None) -> jnp.ndarray:
    # np.packbits packs MSB-first ('big' bitorder). The final reshape happens IN the same
    # program (an eager .reshape on the result costs a second device launch per upload).
    bits = (packed[:, None] >> (7 - jnp.arange(8, dtype=jnp.uint8))) & jnp.uint8(1)
    flat = bits.reshape(-1)[:n].astype(bool)
    return flat if shape is None else flat.reshape(shape)


def unmask(a):
    """Normalize a numpy masked array to a NaN-filled float array (NaN is nodata on device
    everywhere); any other input passes through. The reference's array idiom is
    np.ma.MaskedArray (geoutils Raster.data), so user code migrating from it passes masked
    arrays directly into functions."""
    if isinstance(a, np.ma.MaskedArray):
        return a.filled(np.nan) if np.issubdtype(a.dtype, np.floating) \
            else a.astype(np.float32).filled(np.nan)
    return a


def pad_to_bucket(bucket: int, *arrays_with_fill):
    """Pad same-shape 2-D arrays to the next `bucket` multiple along both axes.

    Args are (array, fill_value) pairs; returns (padded_arrays, original_shape). A no-op
    (same objects) when bucket <= 0 or the shape already sits on the bucket grid. One
    helper serves all shape-bucketing call sites (terrain dispatcher, fused coreg paths)
    so the padding semantics can never drift between them.
    """
    arrs = [a for a, _f in arrays_with_fill]
    h, w = arrs[0].shape
    if bucket <= 0 or (h % bucket == 0 and w % bucket == 0):
        return arrs, (h, w)
    ph, pw = (-h) % bucket, (-w) % bucket
    return ([jnp.pad(a, ((0, ph), (0, pw)), constant_values=f) for a, f in arrays_with_fill],
            (h, w))


def device_mask(mask, shape: tuple[int, int] | None = None) -> jnp.ndarray:
    """Return `mask` as a device bool array, uploading host arrays bit-packed (8x smaller).

    Device-resident arrays pass through untouched; `mask=None` with a `shape` gives all-True
    without any transfer (jnp.ones is created on device).
    """
    if mask is None:
        if shape is None:
            raise ValueError("device_mask(None) needs an explicit shape.")
        return jnp.ones(shape, bool)
    if isinstance(mask, np.ndarray):
        m = np.ascontiguousarray(mask, dtype=bool)
        packed = np.packbits(m.ravel())
        return _unpack_bits(jnp.asarray(packed), m.size, tuple(m.shape))
    return jnp.asarray(mask, bool)
