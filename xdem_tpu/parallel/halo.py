"""Halo-exchange sharded stencils: shard_map spatial decomposition with ppermute.

Device replacement for the reference's tiled map-overlap multiprocessing
(/root/reference/xdem/terrain/terrain.py:412-466, geoutils map_overlap_multiproc_save): the
raster is sharded (block, block) over a 2-D device mesh; each device exchanges `halo` rows/cols
with its mesh neighbors through jax.lax.ppermute (device-to-device, no host round-trip),
then applies the stencil kernel to its halo-padded block. Global boundaries are NaN-padded,
matching the single-device NaN-pad semantics exactly.
"""

from __future__ import annotations

from functools import partial
from typing import Any, Callable

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map


def _exchange_halo_2d(block: jnp.ndarray, halo: int, row_axis: str, col_axis: str) -> jnp.ndarray:
    """Pad a local block with `halo` rows/cols from mesh neighbors (NaN at global boundaries).

    Two-phase exchange: rows first, then columns of the row-padded block (corners ride along).
    """
    n_ry = jax.lax.axis_size(row_axis)
    n_rx = jax.lax.axis_size(col_axis)
    iy = jax.lax.axis_index(row_axis)
    ix = jax.lax.axis_index(col_axis)

    nanval = jnp.asarray(jnp.nan, dtype=block.dtype)

    # --- rows: receive the bottom rows of the device above, the top rows of the device below
    if n_ry > 1:
        from_above = jax.lax.ppermute(block[-halo:, :], row_axis, [(i, i + 1) for i in range(n_ry - 1)])
        from_below = jax.lax.ppermute(block[:halo, :], row_axis, [(i + 1, i) for i in range(n_ry - 1)])
        from_above = jnp.where(iy == 0, nanval, from_above)
        from_below = jnp.where(iy == n_ry - 1, nanval, from_below)
    else:
        from_above = jnp.full((halo, block.shape[1]), nanval, dtype=block.dtype)
        from_below = from_above
    rows_padded = jnp.concatenate([from_above, block, from_below], axis=0)

    # --- cols on the row-padded block (carries corner halos)
    if n_rx > 1:
        from_left = jax.lax.ppermute(rows_padded[:, -halo:], col_axis, [(i, i + 1) for i in range(n_rx - 1)])
        from_right = jax.lax.ppermute(rows_padded[:, :halo], col_axis, [(i + 1, i) for i in range(n_rx - 1)])
        from_left = jnp.where(ix == 0, nanval, from_left)
        from_right = jnp.where(ix == n_rx - 1, nanval, from_right)
    else:
        from_left = jnp.full((rows_padded.shape[0], halo), nanval, dtype=block.dtype)
        from_right = from_left
    return jnp.concatenate([from_left, rows_padded, from_right], axis=1)


def sharded_stencil(
    fn: Callable[[jnp.ndarray], jnp.ndarray],
    arr: jnp.ndarray,
    halo: int,
    mesh: Mesh,
    out_leading: int | None = None,
) -> jnp.ndarray:
    """Apply a stencil function over a 2-D array sharded on `mesh` with halo exchange.

    :param fn: Maps a halo-padded (h+2*halo, w+2*halo) block to (..., h+2*halo, w+2*halo)
        outputs computed with NaN-pad edge semantics; the interior is extracted here.
    :param arr: Global (H, W) array (replicated or sharded; resharded as needed).
    :param halo: Stencil radius.
    :param mesh: 2-D device mesh with axes (row, col).
    :param out_leading: If fn returns a stacked (A, h, w) output, the leading size A.
    """
    if len(mesh.axis_names) != 2:
        from xdem_tpu.parallel.mesh import as_mesh_2d

        mesh = as_mesh_2d(mesh)
    row_axis, col_axis = mesh.axis_names
    n_ry, n_rx = mesh.devices.shape
    h, w = arr.shape
    # Pad to a multiple of the mesh shape
    ph = (-h) % n_ry
    pw = (-w) % n_rx
    if (h + ph) // n_ry < halo or (w + pw) // n_rx < halo:
        raise ValueError(
            f"Raster of shape {(h, w)} is too small to halo-shard with radius {halo} over a "
            f"{n_ry}x{n_rx} mesh: each device block must be at least {halo} px per axis "
            f"(need >= {halo * n_ry}x{halo * n_rx}). Use fewer devices or a 1-D mesh."
        )
    if ph or pw:
        arr = jnp.pad(arr, ((0, ph), (0, pw)), constant_values=jnp.nan)

    out_spec = P(None, row_axis, col_axis) if out_leading is not None else P(row_axis, col_axis)

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=P(row_axis, col_axis),
        out_specs=out_spec,
    )
    def run(block: jnp.ndarray) -> jnp.ndarray:
        padded = _exchange_halo_2d(block, halo, row_axis, col_axis)
        out = fn(padded)
        return out[..., halo:-halo, halo:-halo]

    out = run(arr)
    if ph or pw:
        out = out[..., : h, : w]
    return out


def sharded_surface_attributes(
    arr: jnp.ndarray,
    resolution: float,
    mesh: Mesh,
    attrs: tuple[str, ...],
    surface_fit: str = "Florinsky",
    **kwargs: Any,
) -> jnp.ndarray:
    """Surface-fit attributes over a mesh-sharded DEM with halo exchange."""
    from xdem_tpu.terrain.surfit import surface_attributes

    halo = 2 if surface_fit.lower() == "florinsky" else 1

    # Global mean-center computed BEFORE sharding: every block then removes the same
    # constant, making the sharded result bitwise equal to the unsharded stencil pass.
    arr = jnp.asarray(arr)
    valid = jnp.isfinite(arr)
    center = jnp.where(jnp.any(valid), jnp.nanmean(jnp.where(valid, arr, jnp.nan)), 0.0)

    def fn(padded: jnp.ndarray) -> jnp.ndarray:
        return surface_attributes(padded, resolution, attrs=attrs, surface_fit=surface_fit,
                                  center=center, **kwargs)

    return sharded_stencil(fn, arr, halo=halo, mesh=mesh, out_leading=len(attrs))
