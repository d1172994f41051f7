"""Windowed terrain indexes: sliding-window reducers with NaN-poisoning semantics.

Reference parity (/root/reference/xdem/terrain/window.py): NaN-constant padding, any NaN in the
window poisons the output; formulas:
  * TRI (Riley 1999): sqrt(sum (z_i - z_c)^2) — reference window.py:67-118
  * TRI (Wilson 2007): sum |z_i - z_c| / (w^2 - 1) — reference window.py:127-185
  * TPI (Weiss 2001): z_c - mean(neighbors) — reference window.py:194-252
  * Roughness (Dartnell 2000): max - min — reference window.py:261-308
  * Fractal roughness (Taud & Parrot 2005): voxel box-counting log-log slope —
    reference window.py:317-496
  * Rugosity (Jenness 2004): 8-triangle Heron surface-area ratio, 3x3 only —
    reference window.py:505-713

Implementation: exact shifted-slice accumulation (no gather, no dynamic shapes; XLA fuses
each attribute into one elementwise loop). Fractal roughness exploits monotonicity of
clip(z - c, 0, w) to precompute per-q block maxima with separable reduce_window passes instead
of materializing per-pixel windows.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Literal

import jax
import jax.numpy as jnp

WINDOWED_ATTRS = ("topographic_position_index", "terrain_ruggedness_index", "roughness", "rugosity")
FRACTAL_ATTRS = ("fractal_roughness",)


def _shifts(demp: jnp.ndarray, w: int, h: int, width: int):
    """Yield ((u, v), slice) for each window offset over a padded array."""
    for u in range(w):
        for v in range(w):
            yield (u, v), jax.lax.dynamic_slice(demp, (u, v), (h, width))


@partial(jax.jit, static_argnames=("attrs", "window_size", "tri_method"))
def windowed_indexes(
    dem: jnp.ndarray,
    resolution: jnp.ndarray | float,
    attrs: tuple[str, ...],
    window_size: int = 3,
    tri_method: Literal["Riley", "Wilson"] = "Riley",
) -> jnp.ndarray:
    """Compute windowed indexes; returns a (len(attrs), H, W) stack. NaN-pad edge semantics."""
    dem = jnp.asarray(dem)
    h, width = dem.shape
    w = window_size
    pad = w // 2
    # Materialize the NaN-padded raster (and slice the center from it, not from the
    # separate input buffer): left fusible, XLA can inline the pad into every shifted read
    # as per-element selects and split the tap chain into device-memory round trips — see
    # the fusion notes on fractal_roughness.
    demp = jax.lax.optimization_barrier(jnp.pad(dem, pad, constant_values=jnp.nan))
    res = jnp.asarray(resolution, dtype=dem.dtype)

    center = jax.lax.dynamic_slice(demp, (pad, pad), (h, width))
    need_sum = "topographic_position_index" in attrs
    need_tri = "terrain_ruggedness_index" in attrs
    need_rough = "roughness" in attrs
    need_rug = "rugosity" in attrs

    if need_rug and w != 3:
        raise ValueError("Rugosity is only defined on a 3x3 window.")

    acc_sum = jnp.zeros_like(dem) if need_sum else None
    acc_tri = jnp.zeros_like(dem) if need_tri else None
    acc_max = jnp.full_like(dem, -jnp.inf) if need_rough else None
    acc_min = jnp.full_like(dem, jnp.inf) if need_rough else None
    nan_seen = jnp.zeros_like(dem, dtype=bool) if need_rough else None

    riley = tri_method.lower() == "riley"

    if need_sum or need_tri or need_rough:
        for (u, v), sl in _shifts(demp, w, h, width):
            if need_sum:
                acc_sum = acc_sum + sl
            if need_tri:
                d = sl - center
                acc_tri = acc_tri + (d * d if riley else jnp.abs(d))
            if need_rough:
                acc_max = jnp.maximum(acc_max, sl)
                acc_min = jnp.minimum(acc_min, sl)
                nan_seen = nan_seen | jnp.isnan(sl)

    out = []
    for a in attrs:
        if a == "topographic_position_index":
            val = center - (acc_sum - center) / (w * w - 1)
        elif a == "terrain_ruggedness_index":
            val = jnp.sqrt(acc_tri) if riley else acc_tri / (w * w - 1)
        elif a == "roughness":
            val = jnp.where(nan_seen, jnp.nan, acc_max - acc_min)
        elif a == "rugosity":
            val = _rugosity(demp, h, width, res)
        else:
            raise ValueError(f"Unknown windowed attribute: {a}")
        out.append(val.astype(dem.dtype))
    return jnp.stack(out, axis=0)


# Jenness (2004) 3x3 rugosity geometry.
# 8 center-to-neighbor segments: (window position, planimetric length factor)
RUGOSITY_CENTER_SEGS = (
    ((0, 0), math.sqrt(2.0)), ((0, 1), 1.0), ((0, 2), math.sqrt(2.0)), ((1, 0), 1.0),
    ((1, 2), 1.0), ((2, 0), math.sqrt(2.0)), ((2, 1), 1.0), ((2, 2), math.sqrt(2.0)),
)
# 8 neighbor-to-neighbor segments (all planimetric length L)
RUGOSITY_EDGE_SEGS = (
    ((0, 0), (0, 1)), ((0, 1), (0, 2)), ((2, 0), (2, 1)), ((2, 1), (2, 2)),
    ((0, 0), (1, 0)), ((1, 0), (2, 0)), ((0, 2), (1, 2)), ((1, 2), (2, 2)),
)
# Triangles: (center-seg, center-seg, edge-seg) index triplets into the 16 half-lengths
RUGOSITY_TRIS = (
    (3, 0, 12), (0, 1, 8), (1, 2, 9), (2, 4, 14), (4, 7, 15), (7, 6, 11), (6, 5, 10), (5, 3, 13),
)


def _rugosity(demp: jnp.ndarray, h: int, width: int, res: jnp.ndarray) -> jnp.ndarray:
    """Jenness (2004) rugosity on a 3x3 window from a NaN-padded DEM."""
    Z = {
        (u, v): jax.lax.dynamic_slice(demp, (u, v), (h, width))
        for u in range(3)
        for v in range(3)
    }
    L = res
    zc = Z[(1, 1)]

    hsl = []
    for (pos, lfac) in RUGOSITY_CENTER_SEGS:
        dz = zc - Z[pos]
        hsl.append(jnp.sqrt(dz * dz + (lfac * L) ** 2) / 2)
    for (p0, p1) in RUGOSITY_EDGE_SEGS:
        dz = Z[p0] - Z[p1]
        hsl.append(jnp.sqrt(dz * dz + L * L) / 2)

    area = jnp.zeros_like(zc)
    for (ia, ib, ic) in RUGOSITY_TRIS:
        a, b, c = hsl[ia], hsl[ib], hsl[ic]
        s = (a + b + c) / 2
        # jnp.maximum propagates NaN, so NaN poisoning survives the Heron guard.
        area = area + jnp.sqrt(jnp.maximum(s * (s - a) * (s - b) * (s - c), 0.0))
    return area / (L * L)


#: The reference's engine names select host libraries there (terrain.py engine="scipy" /
#: "numba"); here every name runs the one XLA path.
_ENGINES = ("xla", "scipy", "numba")


def normalize_engine(engine: str | None) -> str:
    """Validate an ``engine=`` value; every accepted name selects the XLA path.

    Raises ValueError for anything else, so a typo cannot pass silently.
    """
    if engine is None or engine in _ENGINES:
        return "xla"
    if engine == "pallas":
        raise ValueError(
            "engine='pallas' was removed: every terrain attribute runs on the XLA path "
            "(engine='xla', the default)."
        )
    raise ValueError(
        f"Unknown engine {engine!r}: choose 'xla' (the reference's 'scipy'/'numba' are "
        "accepted as aliases of 'xla')."
    )


@partial(jax.jit, static_argnames=("window_size",))
def fractal_roughness(dem: jnp.ndarray, window_size: int = 13) -> jnp.ndarray:
    """Taud & Parrot (2005) fractal roughness via box counting, window >= 5.

    For each divisor q of w//2, the per-window voxel count is
      Ns(q) = sum over ((w-1)//q)^2 blocks of clip(max_block(z) - z_center, 0, w) / q,
    and the fractal dimension is minus the log-log regression slope of Ns against q.
    Because clip(. - c, 0, w) is monotonic, block maxima are precomputed once per q
    (doubled up from the largest cached divisor) — O(sum n_q^2) shifted adds instead of
    per-pixel windows.

    Fusion notes: the padded raster and every block-max plane sit behind
    `optimization_barrier`, so the ~200 shifted clip-add taps each read one flat
    materialized buffer. Left fusible, XLA may inline the NaN pad into every tap
    (per-element selects) and split the tap chain into several device-memory round trips.
    The center is sliced from the same padded buffer rather than passed as a separate
    operand. Regression sums accumulate inline (no (n_scales, h, w) stack to materialize).
    Whether each barrier still pays under GPU fusion is an open measurement.
    """
    w = window_size
    if w < 3:
        raise ValueError("Fractal roughness requires window size >= 3.")
    # w in {3, 4} matches the reference's warn-and-continue: hw has a single divisor, the
    # log-log regression is degenerate (ss_xx == 0) and the result is NaN, not an error.
    dem = jnp.asarray(dem)
    h, width = dem.shape
    hw = w // 2
    demp = jax.lax.optimization_barrier(jnp.pad(dem, hw, constant_values=jnp.nan))
    c = jax.lax.dynamic_slice(demp, (hw, hw), (h, width))

    qs = [q for q in range(1, hw + 1) if hw % q == 0]
    log_q = jnp.log(jnp.asarray(qs, dtype=dem.dtype))
    n = len(qs)
    mx = jnp.mean(log_q)
    ss_xx = jnp.sum(log_q * log_q) - n * mx * mx

    # Sliding block maxima M_q[i, j] = max(demp[i:i+q, j:j+q]), built separably from the
    # largest already-built divisor of q (q=6 reuses q=3). jnp.maximum propagates NaN, so
    # poisoning matches the former reduce_window(-inf, lax.max) formulation bitwise.
    maxima = {1: demp}

    def build_m(q: int) -> jnp.ndarray:
        src = max(p for p in maxima if q % p == 0)
        m = maxima[src]
        f = q // src
        hm, wm = m.shape
        oh, ow = hm - (f - 1) * src, wm - (f - 1) * src
        rows = m[:oh, :]
        for t in range(1, f):
            rows = jnp.maximum(rows, m[t * src: t * src + oh, :])
        out = rows[:, :ow]
        for t in range(1, f):
            out = jnp.maximum(out, rows[:, t * src: t * src + ow])
        return jax.lax.optimization_barrier(out)

    sy = jnp.zeros_like(dem)
    sxy = jnp.zeros_like(dem)
    for i, q in enumerate(qs):
        if q > 1:
            maxima[q] = build_m(q)
        mq = maxima[q]
        nq = (w - 1) // q
        ns = jnp.zeros_like(dem)
        for j in range(nq):
            for k in range(nq):
                blk = jax.lax.dynamic_slice(mq, (j * q, k * q), (h, width))
                ns = ns + jnp.clip(blk - c, 0.0, float(w))
        yq = jnp.log(ns / q)
        sy = sy + yq
        sxy = sxy + log_q[i] * yq

    my = sy / n
    ss_xy = sxy - n * my * mx
    return (-(ss_xy / ss_xx)).astype(dem.dtype)
