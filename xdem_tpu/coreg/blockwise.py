"""Blockwise (tiled) coregistration with RANSAC shift-plane aggregation.

Reference parity (/root/reference/xdem/coreg/blockwise.py): per-tile translation fits
(_coreg_wrapper :117, NaN on failure), RANSAC plane fit per shift axis (_ransac :225-289),
apply by warping with the interpolated shift field (:291-407).

Device re-design: tiles are fitted sequentially with the jitted solvers (uniform tile shape
=> a single XLA compilation shared by all tiles; the per-tile solves batch naturally), and the
apply is one device-wide gather warp with the per-pixel plane shift field, instead of per-tile
point-cloud regridding through multiprocessing.
"""

from __future__ import annotations

import itertools
import logging
import os
from pathlib import Path
from typing import Any

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from xdem_tpu._misc import import_optional
from xdem_tpu.coreg.base import Coreg
from xdem_tpu.georef import Affine
from xdem_tpu.ops.interp import interp_rowcol
from xdem_tpu.ops.transfer import device_mask
from xdem_tpu.raster import Raster


class MultiprocConfig:
    """Tiling-size + output-destination configuration for blockwise processing.

    API parity with the reference's geoutils ``MultiprocConfig`` (used at
    /root/reference/xdem/coreg/blockwise.py:60-112): ``chunk_size`` is the fit/apply tile
    size and ``outfile`` the streamed-output destination. The reference's object also
    carries a process-pool ``cluster``; on this backend tiles are solved in one vmapped
    device dispatch, so a cluster has no meaning and raises.
    """

    def __init__(self, chunk_size: int = 500, outfile: str | Path = "aligned_dem.tif",
                 driver: str = "GTiff", cluster: Any = None):
        if cluster is not None:
            raise ValueError(
                "Process-pool clusters do not exist on this backend: blockwise tiles are "
                "batched into a single device dispatch. Leave cluster=None."
            )
        self.chunk_size = int(chunk_size)
        self.outfile = str(outfile)
        self.driver = driver


def _gate_diverged_tiles(shifts_x: np.ndarray, shifts_y: np.ndarray, shifts_z: np.ndarray,
                         block_size: int, res_x: float, res_y: float,
                         shape: tuple[int, int] | None = None,
                         tiling: tuple[int, int] | None = None) -> np.ndarray:
    """NaN-out tiles whose fitted shift exceeds the tile's own extent.

    A tile cannot evidence a translation larger than itself — such fits are divergent
    solves on ill-posed tiles (flat / single-aspect crops), and their values differ
    arbitrarily between backends (observed km-scale 'shifts' on a 10 m-shift pair that
    disagreed accelerator-vs-CPU by 30%+). The reference NaN-fills per-tile FAILURES
    (blockwise.py:139-154) and relies on RANSAC to reject the rest; gating divergence the
    same way keeps meta['outputs'] honest and backend-independent. Mutates in place and
    returns the diverged mask.

    When ``shape`` (raster H, W) and ``tiling`` (n_rows, n_cols) are given, edge tiles are
    gated against their ACTUAL (clipped) extent instead of the full block size. A warning
    names the gated count, because an out-of-range TRUE displacement (shift larger than one
    tile) trips the same gate as a divergent solve and the user must be able to tell."""
    if shape is not None and tiling is not None:
        n_rows, n_cols = tiling
        h, w = shape
        ti, tj = np.divmod(np.arange(n_rows * n_cols), n_cols)
        tile_h = np.minimum((ti + 1) * block_size, h) - ti * block_size
        tile_w = np.minimum((tj + 1) * block_size, w) - tj * block_size
    else:
        tile_h = tile_w = block_size  # type: ignore[assignment]
    lim_x = tile_w * abs(res_x)
    lim_y = tile_h * abs(res_y)
    with np.errstate(invalid="ignore"):
        diverged = (np.abs(shifts_x) > lim_x) | (np.abs(shifts_y) > lim_y)
    for s in (shifts_x, shifts_y, shifts_z):
        s[diverged] = np.nan
    if diverged.any():
        logging.warning(
            "NaN-gated %d/%d blockwise tile(s) whose fitted shift exceeds the tile's own "
            "extent (~%.0f x %.0f m) — divergent solves on ill-posed tiles. If the TRUE "
            "displacement between the elevations is larger than one tile, enlarge "
            "block_size_fit or pre-align with a global coregistration first.",
            int(diverged.sum()), diverged.size,
            float(block_size * abs(res_x)), float(block_size * abs(res_y)),
        )
    return diverged


class BlockwiseCoreg:
    """Tile-parallel coregistration: fit an affine step per tile, aggregate with RANSAC planes.

    ``mp_config`` / ``parent_path`` configure the streamed-output destination exactly like
    the reference (blockwise.py:75-112: at most one of the two; ``mp_config.chunk_size``
    sets the tile sizes; the output path feeds :meth:`apply_tiled`). Unlike the reference,
    both may be omitted: the default is the purely in-memory :meth:`apply`, which needs no
    output file.
    """

    def __init__(
        self,
        step: Coreg,
        block_size_fit: int = 500,
        block_size_apply: int = 500,
        mp_config: MultiprocConfig | None = None,
        parent_path: str | None = None,
    ):
        if mp_config is not None and parent_path is not None:
            raise ValueError("Pass at most one of 'mp_config' and 'parent_path'.")
        if isinstance(step, type):
            raise ValueError(
                "The 'step' argument must be an instantiated Coreg subclass. Hint: write e.g. ICP() instead of ICP"
            )
        if not step.is_affine:
            raise ValueError("The blockwise coregistration only supports affine coregistration methods.")
        inputs = step.meta.get("inputs", {})
        only_translation = inputs.get("specific", {}).get(
            "only_translation", inputs.get("affine", {}).get("only_translation", True)
        )
        if not only_translation:
            raise ValueError(
                "Blockwise aggregation fits planes through per-tile translations, so the step "
                "must be translation-only. Construct it with only_translation=True."
            )
        self.procstep = step
        self.block_size_fit = block_size_fit
        self.block_size_apply = block_size_apply
        from xdem_tpu.coreg.affine import NuthKaab

        self.apply_z_correction = step.vertical_shift if isinstance(step, NuthKaab) else True

        self.mp_config: MultiprocConfig | None = None
        self.parent_path: Path | None = None
        self.output_path_aligned: Path | None = None
        if mp_config is not None:
            if not hasattr(mp_config, "outfile"):
                raise TypeError(
                    "mp_config must provide an 'outfile' attribute (and optionally "
                    "'chunk_size') — use xdem_tpu.coreg.MultiprocConfig."
                )
            self.mp_config = mp_config
            chunk = getattr(mp_config, "chunk_size", None)
            if chunk:
                self.block_size_fit = self.block_size_apply = int(chunk)
            self.parent_path = Path(mp_config.outfile).parent
            self.output_path_aligned = Path(mp_config.outfile)
        elif parent_path is not None:
            self.parent_path = Path(parent_path)
            self.output_path_aligned = self.parent_path / "aligned_dem.tif"
        if self.parent_path is not None:
            os.makedirs(self.parent_path, exist_ok=True)

        self.meta: dict[str, Any] = {"inputs": {}, "outputs": {}}
        self.shape_tiling_grid = (0, 0)


    def fit(
        self,
        reference_elev: Raster,
        to_be_aligned_elev: Raster,
        inlier_mask: np.ndarray | None = None,
    ) -> "BlockwiseCoreg":
        """Fit the per-tile shifts on a tiling of the reference grid."""
        self.meta["inputs"] = self.procstep.meta["inputs"]
        ref = reference_elev
        tba = to_be_aligned_elev
        if tba.shape != ref.shape or not tba.transform.almost_equals(ref.transform):
            tba = tba.reproject(ref)

        h, w = ref.shape
        bs = self.block_size_fit
        n_rows = int(np.ceil(h / bs))
        n_cols = int(np.ceil(w / bs))
        self.shape_tiling_grid = (n_rows, n_cols)

        xs, ys, sxs, sys_, szs = [], [], [], [], []
        for ti, tj in itertools.product(range(n_rows), range(n_cols)):
            r0, r1 = ti * bs, min((ti + 1) * bs, h)
            c0, c1 = tj * bs, min((tj + 1) * bs, w)
            ref_tile = ref.icrop((r0, r1), (c0, c1))
            tba_tile = tba.icrop((r0, r1), (c0, c1))
            mask_tile = inlier_mask[r0:r1, c0:c1] if inlier_mask is not None else None

            shift = (np.nan, np.nan, np.nan)
            ref_arr = np.asarray(ref_tile.data)
            tba_arr = np.asarray(tba_tile.data)
            if np.isfinite(ref_arr).any() and np.isfinite(tba_arr).any():
                step = self.procstep.copy()
                try:
                    step.fit(ref_tile, tba_tile, inlier_mask=mask_tile)
                    aff = step.meta["outputs"]["affine"]
                    shift = (aff.get("shift_x", np.nan), aff.get("shift_y", np.nan), aff.get("shift_z", np.nan))
                except (ValueError, TypeError) as e:
                    logging.error("Failed to fit tile (%d, %d): %s", ti, tj, e)

            # Tile center in world coordinates
            x, y = ref.transform.xy(r0 + bs / 2, c0 + bs / 2, offset="ul")
            xs.append(x)
            ys.append(y)
            sxs.append(shift[0])
            sys_.append(shift[1])
            szs.append(shift[2])
            self.meta["outputs"][f"{ti}_{tj}"] = {"shift_x": shift[0], "shift_y": shift[1], "shift_z": shift[2]}

        self.x_coords = np.asarray(xs)
        self.y_coords = np.asarray(ys)
        self.shifts_x = np.asarray(sxs)
        self.shifts_y = np.asarray(sys_)
        self.shifts_z = np.asarray(szs)
        diverged = _gate_diverged_tiles(self.shifts_x, self.shifts_y, self.shifts_z,
                                        bs, ref.transform.xres, ref.transform.yres,
                                        shape=(h, w), tiling=(n_rows, n_cols))
        for t, bad in enumerate(diverged):
            if bad:
                ti, tj = t // n_cols, t % n_cols
                self.meta["outputs"][f"{ti}_{tj}"] = {
                    "shift_x": np.nan, "shift_y": np.nan, "shift_z": np.nan}
        self.meta["outputs"]["n_diverged"] = int(diverged.sum())
        return self

    @staticmethod
    def _ransac(
        x_coords: np.ndarray,
        y_coords: np.ndarray,
        shifts: np.ndarray,
        threshold: float = 0.01,
        max_iterations: int = 2000,
        random_state: int = 42,
    ) -> tuple[float, float, float]:
        """RANSAC plane fit shift = a*x + b*y + c (reference blockwise.py:225-289).

        Seeded: an unseeded consensus search makes apply() nondeterministic run-to-run.
        """
        linear_model = import_optional("sklearn.linear_model", package_name="scikit-learn")
        LinearRegression, RANSACRegressor = linear_model.LinearRegression, linear_model.RANSACRegressor

        if np.isnan(shifts).all():
            shifts = np.zeros_like(shifts)
        points = np.column_stack([x_coords, y_coords, shifts])
        points = points[~np.isnan(points).any(axis=1)]
        if points.size == 0:
            raise ValueError("No valid points after removing NaNs.")
        # Robust pre-filter: reject gross per-tile outliers by MAD before plane fitting
        med = np.median(points[:, 2])
        nmad = 1.4826 * np.median(np.abs(points[:, 2] - med))
        keep = np.abs(points[:, 2] - med) <= max(3 * nmad, threshold, 1e-9)
        if keep.sum() >= 2:
            points = points[keep]
        # With few tiles a plane is overfit: use the robust constant shift
        if points.shape[0] < 6:
            return 0.0, 0.0, float(np.median(points[:, 2]))
        threshold = max(threshold, nmad)
        if points.shape[0] < 3 or np.allclose(points[:, 1], points[0, 1]):
            if points.shape[0] == 1:
                return 0.0, 0.0, float(points[0, 2])
            a, c = np.polyfit(points[:, 0], points[:, 2], 1)
            return float(a), 0.0, float(c)
        if np.allclose(points[:, 0], points[0, 0]):
            b, c = np.polyfit(points[:, 1], points[:, 2], 1)
            return 0.0, float(b), float(c)
        ransac = RANSACRegressor(
            estimator=LinearRegression(), residual_threshold=threshold, max_trials=max_iterations,
            random_state=random_state,
        )
        ransac.fit(points[:, :2], points[:, 2])
        a, b = ransac.estimator_.coef_
        c = ransac.estimator_.intercept_
        return float(a), float(b), float(c)

    def ransac_all(self, threshold: float = 0.01,
                   max_iterations: int = 2000) -> tuple[tuple[float, float, float], ...]:
        coeff_x = self._ransac(self.x_coords, self.y_coords, self.shifts_x, threshold, max_iterations)
        coeff_y = self._ransac(self.x_coords, self.y_coords, self.shifts_y, threshold, max_iterations)
        coeff_z = self._ransac(self.x_coords, self.y_coords, self.shifts_z, threshold, max_iterations)
        return coeff_x, coeff_y, coeff_z

    def apply(self, to_be_aligned_elev: Raster, resampling: str = "linear",
              threshold_ransac: float = 0.01, max_iterations_ransac: int = 2000) -> Raster:
        """Warp with the interpolated (plane) shift field: one device gather pass.

        ``threshold_ransac`` / ``max_iterations_ransac`` tune the RANSAC plane consensus
        (reference blockwise.py:351-356)."""
        elev = to_be_aligned_elev
        coeff_x, coeff_y, coeff_z = self.ransac_all(threshold_ransac, max_iterations_ransac)
        h, w = elev.shape
        a, b, c, d, e, f = (float(v) for v in tuple(elev.transform))
        cols = jnp.arange(w, dtype=jnp.float32) + 0.5
        rows = jnp.arange(h, dtype=jnp.float32) + 0.5
        cgrid, rgrid = jnp.meshgrid(cols, rows)
        X = a * cgrid + b * rgrid + c
        Y = d * cgrid + e * rgrid + f
        sx = coeff_x[0] * X + coeff_x[1] * Y + coeff_x[2]
        sy = coeff_y[0] * X + coeff_y[1] * Y + coeff_y[2]
        sz = coeff_z[0] * X + coeff_z[1] * Y + coeff_z[2]
        # The shift field moves the terrain by (+sx, +sy, +sz): sample source at (X - sx, Y - sy)
        src_x = X - sx
        src_y = Y - sy
        inv = elev.transform.invert()
        src_c = inv.a * src_x + inv.b * src_y + inv.c - 0.5
        src_r = inv.d * src_x + inv.e * src_y + inv.f - 0.5
        out = interp_rowcol(elev.data, src_r, src_c, method=resampling)
        if self.apply_z_correction:
            out = out + sz
        return elev.copy(new_array=out)

    def fit_and_apply(self, reference_elev: Raster, to_be_aligned_elev: Raster,
                      inlier_mask: np.ndarray | None = None) -> Raster:
        self.fit(reference_elev, to_be_aligned_elev, inlier_mask=inlier_mask)
        return self.apply(to_be_aligned_elev)

    def apply_tiled(self, elev: Raster, out_path: str | None = None, tile_rows: int = 1024,
                    resampling: str = "linear", nodata: float = -9999.0) -> str:
        """Out-of-core apply: warp row bands and stream them into a GeoTIFF.

        ``out_path`` defaults to the destination configured at construction via
        ``mp_config``/``parent_path`` (reference blockwise.py:112 ``output_path_aligned``).

        The whole-array apply materializes ~7 full-raster intermediates; here each output
        band samples only its source band plus a halo bounded by the plane shift field's
        extremes (evaluated at the raster corners), so memory stays O(band) at any raster
        size — the blockwise counterpart of terrain.tiled_terrain_attribute.
        """
        import numpy as np

        from xdem_tpu.io import StreamingRasterWriter

        if out_path is None:
            if self.output_path_aligned is None:
                raise ValueError(
                    "No output destination: pass out_path=, or construct the BlockwiseCoreg "
                    "with mp_config=/parent_path=."
                )
            out_path = str(self.output_path_aligned)

        coeff_x, coeff_y, coeff_z = self.ransac_all()
        h, w = elev.shape
        t = elev.transform
        # The shift planes are linear, so their extrema over the raster are at the corners
        corners_x, corners_y = zip(*(t.xy(r, c) for r in (0, h) for c in (0, w)))
        cx = np.asarray(corners_x, np.float64)
        cy = np.asarray(corners_y, np.float64)
        max_sy = float(np.max(np.abs(coeff_y[0] * cx + coeff_y[1] * cy + coeff_y[2])))
        halo = int(np.ceil(max_sy / abs(t.yres))) + 2

        a, b, c_, d, e, f = (float(v) for v in tuple(t))
        inv = t.invert()
        data_np = np.asarray(elev.data)
        writer = StreamingRasterWriter(out_path, (h, w), t, crs=elev.crs, nodata=nodata)
        try:
            for r0 in range(0, h, tile_rows):
                nrows = min(tile_rows, h - r0)
                lo = max(0, r0 - halo)
                hi = min(h, r0 + nrows + halo)
                band = jnp.asarray(data_np[lo:hi])
                cols = jnp.arange(w, dtype=jnp.float32) + 0.5
                rows = jnp.arange(r0, r0 + nrows, dtype=jnp.float32) + 0.5
                cgrid, rgrid = jnp.meshgrid(cols, rows)
                X = a * cgrid + b * rgrid + c_
                Y = d * cgrid + e * rgrid + f
                sx = coeff_x[0] * X + coeff_x[1] * Y + coeff_x[2]
                sy = coeff_y[0] * X + coeff_y[1] * Y + coeff_y[2]
                src_x = X - sx
                src_y = Y - sy
                src_c = inv.a * src_x + inv.b * src_y + inv.c - 0.5
                src_r = inv.d * src_x + inv.e * src_y + inv.f - 0.5 - lo
                out = interp_rowcol(band, src_r, src_c, method=resampling)
                if self.apply_z_correction:
                    out = out + (coeff_z[0] * X + coeff_z[1] * Y + coeff_z[2])
                writer.write_rows(r0, np.asarray(out))
        finally:
            writer.close()
        return out_path


@partial(jax.jit, static_argnames=("bs", "n_rows", "n_cols", "K", "max_iterations", "mesh"))
def _blockwise_nuth_kaab_device(
    ref, tba, inlier, seed, bs: int, n_rows: int, n_cols: int, K: int,
    res_x, res_y, tolerance, max_iterations: int, mesh=None,
):
    """The ENTIRE blockwise fit as one device program: gradients, per-tile seeded
    subsampling (top_k over uniform scores, as the fused single-tile path), and every tile's
    NuthKaab while_loop vmapped — a single dispatch + one small readback.

    Returns (sx, sy, vshift, n_valid) per tile, tiles in row-major order.
    """
    from xdem_tpu.coreg.affine import _nk_slope_aspect_valid, _nuth_kaab_solve, _topk_subsample

    n_tiles = n_rows * n_cols
    slope_tan, aspect, valid = _nk_slope_aspect_valid(ref, tba, inlier)

    def tiled(a):
        return (
            a[: n_rows * bs, : n_cols * bs]
            .reshape(n_rows, bs, n_cols, bs)
            .transpose(0, 2, 1, 3)
            .reshape(n_tiles, bs, bs)
        )

    vt = tiled(valid)
    rt = tiled(ref)
    tt = tiled(tba)
    st_t = tiled(slope_tan).reshape(n_tiles, -1)
    at = tiled(aspect).reshape(n_tiles, -1)
    n_valid_t = vt.reshape(n_tiles, -1).sum(axis=1)

    keys = jax.random.split(jax.random.PRNGKey(seed), n_tiles)
    idxs, ok = jax.vmap(lambda k, v: _topk_subsample(k, v, K))(keys, vt.reshape(n_tiles, -1))
    rr = (idxs // bs).astype(jnp.float32)
    cc = (idxs % bs).astype(jnp.float32)
    # NaN-poison slots whose pick fell outside the valid mask (tiles with < K valid pixels)
    # so neither the vshift median nor the cosine fit sees them.
    pts_z = jnp.where(ok, jnp.take_along_axis(rt.reshape(n_tiles, -1), idxs, axis=1), jnp.nan)
    st = jnp.where(ok, jnp.take_along_axis(st_t, idxs, axis=1), jnp.nan)
    asp = jnp.take_along_axis(at, idxs, axis=1)

    solve = jax.vmap(
        lambda z, r, c, rast, s, a: _nuth_kaab_solve(
            z, r, c, rast, s, a, res_x, res_y, tolerance,
            max_iterations=max_iterations, invert=False,
        )
    )
    args = [pts_z, rr, cc, tt, st, asp]
    pad = 0
    if mesh is not None:
        # SURVEY 2.7 P3: tile solves sharded across the mesh — the vmapped while_loop
        # partitions on the (padded) tile axis with zero collectives
        from jax.sharding import NamedSharding, PartitionSpec

        from xdem_tpu.parallel.mesh import as_mesh_1d

        m1 = as_mesh_1d(mesh)
        pad = (-n_tiles) % m1.devices.size
        if pad:
            args = [jnp.pad(a, ((0, pad),) + ((0, 0),) * (a.ndim - 1),
                            constant_values=jnp.nan) for a in args]
        args = [jax.lax.with_sharding_constraint(
            a, NamedSharding(m1, PartitionSpec(m1.axis_names[0], *([None] * (a.ndim - 1)))))
            for a in args]
    sx, sy, vs, _stat, _it = solve(*args)
    if pad:
        sx, sy, vs = sx[:n_tiles], sy[:n_tiles], vs[:n_tiles]
    return jnp.stack([sx, sy, vs, n_valid_t.astype(jnp.float32)])


class BlockwiseNuthKaab(BlockwiseCoreg):
    """Blockwise NuthKaab with ALL tile solves batched in a single vmapped device program.

    Batched device variant of the per-tile fitting (SURVEY §2.7 P3): instead of looping tiles
    through independent fits, the raster is cut into uniform tiles, a fixed-size subsample is
    drawn per tile, and `_nuth_kaab_solve` is vmapped over the tile batch — one XLA program,
    one device dispatch for every tile. Aggregation and apply are inherited (robust RANSAC
    shift planes + one-pass warp).
    """

    def __init__(self, block_size_fit: int = 500, block_size_apply: int = 500,
                 subsample_per_tile: int = 20000, max_iterations: int = 10,
                 tolerance: float = 0.001, random_state: int | None = None,
                 mesh=None, mp_config: MultiprocConfig | None = None,
                 parent_path: str | None = None):
        from xdem_tpu.coreg.affine import NuthKaab

        super().__init__(NuthKaab(max_iterations=max_iterations, offset_threshold=tolerance),
                         block_size_fit=block_size_fit, block_size_apply=block_size_apply,
                         mp_config=mp_config, parent_path=parent_path)
        self.subsample_per_tile = subsample_per_tile
        self.random_state = random_state
        self.mesh = mesh  # jax.sharding.Mesh: shard tile solves across devices

    def fit(self, reference_elev: Raster, to_be_aligned_elev: Raster,
            inlier_mask: np.ndarray | None = None) -> "BlockwiseNuthKaab":
        ref = reference_elev
        tba = to_be_aligned_elev
        if tba.shape != ref.shape or not tba.transform.almost_equals(ref.transform):
            tba = tba.reproject(ref)

        h, w = ref.shape
        bs = self.block_size_fit
        n_rows, n_cols = h // bs, w // bs  # uniform full tiles only (edges folded into RANSAC)
        if n_rows == 0 or n_cols == 0:
            raise ValueError(f"Raster {ref.shape} smaller than block_size_fit={bs}.")
        self.shape_tiling_grid = (n_rows, n_cols)

        K = self.subsample_per_tile
        n_tiles = n_rows * n_cols

        xs, ys = [], []
        for ti in range(n_rows):
            for tj in range(n_cols):
                x, y = ref.transform.xy(ti * bs + bs / 2, tj * bs + bs / 2, offset="ul")
                xs.append(x)
                ys.append(y)

        res_x, res_y = ref.transform.xres, ref.transform.yres
        it_cfg = self.procstep.meta["inputs"]["iterative"]
        seed = (int(self.random_state) if isinstance(self.random_state, (int, np.integer))
                else int(np.random.default_rng(self.random_state).integers(2**31)))
        inlier = device_mask(inlier_mask, (h, w))
        # One dispatch for the whole fit: gradients, per-tile device sampling, vmapped solves
        out = np.asarray(_blockwise_nuth_kaab_device(
            jnp.asarray(ref.data, jnp.float32), jnp.asarray(tba.data, jnp.float32), inlier,
            np.uint32(seed), bs, n_rows, n_cols, min(K, bs * bs),
            res_x, res_y, it_cfg["tolerance"], max_iterations=int(it_cfg["max_iterations"]),
            mesh=self.mesh,
        ), dtype=np.float64)
        sx, sy, vs, n_valid_t = out
        # NuthKaab sampling offsets -> apply translations (sign flip), like the single-tile class
        self.x_coords = np.asarray(xs)
        self.y_coords = np.asarray(ys)
        self.shifts_x = -sx
        self.shifts_y = -sy
        self.shifts_z = vs.copy()
        empty = n_valid_t < 100  # same sparse-tile gate as the host path
        self.shifts_x[empty] = np.nan
        self.shifts_y[empty] = np.nan
        self.shifts_z[empty] = np.nan
        # Tiles are uniform full blocks on this path (edges are dropped above), so the
        # full block_size limit is every tile's actual extent.
        diverged = _gate_diverged_tiles(self.shifts_x, self.shifts_y, self.shifts_z,
                                        bs, res_x, res_y)
        self.meta["inputs"] = self.procstep.meta["inputs"]
        self.meta["outputs"]["n_diverged"] = int(diverged.sum())
        for t in range(n_tiles):
            self.meta["outputs"][f"{t // n_cols}_{t % n_cols}"] = {
                "shift_x": self.shifts_x[t], "shift_y": self.shifts_y[t], "shift_z": self.shifts_z[t],
            }
        return self
