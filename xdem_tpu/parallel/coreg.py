"""Multi-chip coregistration: point-sharded iterative fits with MEDIAN-EXACT collectives.

The single-chip solvers (xdem_tpu/coreg/affine.py) keep all subsampled points on one device.
Here the subsample is sharded across a 1-D mesh: each device evaluates dh on its point shard
against the replicated raster, and every statistic the solver consumes — the vertical-shift
median and the per-aspect-bin medians (reference affine.py:358-377, 477-536 uses medians for
both) — is computed EXACTLY across shards with the bit-space radix selection of
parallel/selection.py. Medians are order statistics, not sums, so there is no f32
reassociation error: the sharded fit matches the single-device fit BITWISE (asserted in
tests/test_coreg.py). Only the bin_before_fit=False mode reduces point sums with psum and
carries a documented f32-reassociation tolerance instead.

The raster (and its slope/aspect prepare + the seeded top_k subsample) is replicated on every
device: NuthKaab's cost at scale is the per-iteration work over the point population, which is
what shards. The prepare runs once, the iterations run >=3 times over all points.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from xdem_tpu.ops.interp import interp_rowcol
from xdem_tpu.ops.precision import pin_f32_matmuls
from xdem_tpu.parallel.selection import masked_median_distributed, signed_median_by_bin


def _nk_iterations(z_s, rr_s, cc_s, st_s, asp_s, raster, res_x, res_y, tolerance,
                   max_iterations: int, n_bins: int, bin_before_fit: bool, invert: bool,
                   axis: str):
    """The Nuth & Kaab iterative solver over ONE point shard, statistics reduced across the
    mesh: mirrors the single-device `_nuth_kaab_solve` (coreg/affine.py) op-for-op, with the
    vertical-shift median and per-aspect-bin medians computed as exact distributed order
    statistics (bitwise equal to the single-device fit in the default bin_before_fit mode).
    `invert` follows `_dh_device`: True when the gridded side is the reference.

    Returns (shift_x_m, shift_y_m, vshift, stat, iterations)."""
    bin_width = 2 * jnp.pi / n_bins
    bin_centers = (jnp.arange(n_bins) + 0.5) * bin_width
    G = jnp.stack([jnp.cos(bin_centers), jnp.sin(bin_centers), jnp.ones(n_bins)], axis=1)
    sgn = -1.0 if invert else 1.0

    def step(carry):
        sx, sy, _vs, _stat, it = carry
        dh = z_s - interp_rowcol(raster, rr_s - sgn * sy, cc_s + sgn * sx, method="linear")
        if invert:
            dh = -dh
        vshift, _n = masked_median_distributed(dh, jnp.isfinite(dh), axis)
        dh = dh - vshift
        y = dh / st_s
        valid_pt = jnp.isfinite(y)

        if bin_before_fit:
            bin_idx = jnp.clip((asp_s / bin_width).astype(jnp.int32), 0, n_bins - 1)
            parked = jnp.where(valid_pt, bin_idx, n_bins)
            counts = jax.lax.psum(
                jnp.bincount(parked, length=n_bins + 1)[:n_bins], axis
            )
            med = signed_median_by_bin(y, parked, counts, n_bins, axis)
            bin_ok = jnp.isfinite(med)
            w_b = bin_ok.astype(jnp.float32)
            A_mat = (G * w_b[:, None]).T @ G
            b_vec = (G * w_b[:, None]).T @ jnp.where(bin_ok, med, 0.0)
        else:
            # Point-sum mode: psum of per-shard partial sums — f32 reassociation differs
            # from the single-device reduction order (documented ~1e-4 relative bound)
            Gf = jnp.stack([jnp.cos(asp_s), jnp.sin(asp_s), jnp.ones_like(asp_s)], axis=1)
            w_p = valid_pt.astype(jnp.float32)
            A_mat = jax.lax.psum((Gf * w_p[:, None]).T @ Gf, axis)
            b_vec = jax.lax.psum((Gf * w_p[:, None]).T @ jnp.where(valid_pt, y, 0.0), axis)
        p = jnp.linalg.solve(A_mat + 1e-12 * jnp.eye(3), b_vec)

        north_px = p[0]  # a*cos(b)
        east_px = p[1]  # a*sin(b)
        stat = jnp.hypot(east_px, north_px)
        return sx + east_px, sy + north_px, vshift, stat, it + 1

    def cond(carry):
        _sx, _sy, _vs, stat, it = carry
        return (it < max_iterations) & ~((it >= 3) & (stat < tolerance))

    init = (jnp.asarray(0.0, jnp.float32), jnp.asarray(0.0, jnp.float32),
            jnp.asarray(0.0, jnp.float32), jnp.asarray(jnp.inf, jnp.float32),
            jnp.asarray(0))
    sx, sy, vshift, stat, it = jax.lax.while_loop(cond, step, init)
    return sx * res_x, sy * res_y, vshift, stat, it


def _pad_pts_1d(n_dev: int, *arrays_fills):
    """NaN/zero-pad 1-D point arrays to a device-count multiple (shard-inert padding)."""
    n = arrays_fills[0][0].shape[0]
    pad = -n % n_dev
    if pad == 0:
        return [a for a, _f in arrays_fills]
    return [jnp.pad(a, (0, pad), constant_values=f) for a, f in arrays_fills]


@partial(
    jax.jit,
    static_argnames=("count", "max_iterations", "n_bins", "bin_before_fit", "mesh"),
)
@pin_f32_matmuls
def nuth_kaab_rst_rst_sharded(
    ref: jnp.ndarray,
    tba: jnp.ndarray,
    inlier: jnp.ndarray,
    seed: jnp.ndarray,
    count: int,
    res_x: float,
    res_y: float,
    tolerance: float,
    mesh: Mesh,
    max_iterations: int = 10,
    n_bins: int = 72,
    bin_before_fit: bool = True,
) -> jnp.ndarray:
    """The fused raster-raster Nuth & Kaab program on a 1-D point-sharded mesh.

    Same contract as the single-device `_nuth_kaab_rst_rst_device` (coreg/affine.py) — one
    dispatch returning f32 [shift_x_m, shift_y_m, vshift, stat, iterations, n_valid,
    populated_bins] — and, in the default bin_before_fit mode, the SAME bits: the prepare
    (slope/aspect stencils, seeded top_k subsample) replays identically on every device, and
    the per-iteration medians come from exact distributed order-statistic selection.
    """
    from xdem_tpu.coreg.affine import _nk_slope_aspect_valid, _topk_subsample

    axis = mesh.axis_names[0]
    n_dev = int(mesh.devices.size)
    h, w = ref.shape
    count_p = -(-count // n_dev) * n_dev  # NaN-pad the subsample to a shard multiple
    shard = count_p // n_dev

    bin_width = 2 * jnp.pi / n_bins

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(None, None), P(None, None), P(None, None), P()),
        out_specs=P(None),
    )
    def run(refl, tbal, inl, sd):
        # --- Replicated prepare: op-for-op the single-device fused program's prepare, so the
        # subsample (indices, NaN poisoning, diagnostics) is bit-identical to the mesh=None fit
        slope_tan, aspect, valid = _nk_slope_aspect_valid(refl, tbal, inl)
        n_valid = valid.sum()
        idx, picked_ok = _topk_subsample(jax.random.PRNGKey(sd), valid.ravel(), count)
        rr = (idx // w).astype(jnp.float32)
        cc = (idx % w).astype(jnp.float32)
        pts_z = jnp.where(picked_ok, refl.ravel()[idx], jnp.nan)
        st = jnp.where(picked_ok, slope_tan.ravel()[idx], jnp.nan)
        asp = aspect.ravel()[idx]

        sub_ok = jnp.isfinite(st)
        bin_idx_all = jnp.clip((asp / bin_width).astype(jnp.int32), 0, n_bins - 1)
        hist = jnp.bincount(jnp.where(sub_ok, bin_idx_all, n_bins), length=n_bins + 1)[:n_bins]
        populated = (hist > 10).sum()

        # --- Shard slice: NaN pads are invalid in every statistic, so count_p > count is inert
        pad = count_p - count
        i = jax.lax.axis_index(axis)
        sl = lambda a, fill: jax.lax.dynamic_slice_in_dim(  # noqa: E731
            jnp.pad(a, (0, pad), constant_values=fill), i * shard, shard
        )
        z_s, rr_s, cc_s = sl(pts_z, jnp.nan), sl(rr, 0.0), sl(cc, 0.0)
        st_s, asp_s = sl(st, jnp.nan), sl(asp, 0.0)

        # --- The iterative solver: mirrors _nuth_kaab_solve with distributed exact medians
        sx, sy, vshift, stat, it = _nk_iterations(
            z_s, rr_s, cc_s, st_s, asp_s, tbal, res_x, res_y, tolerance,
            max_iterations, n_bins, bin_before_fit, invert=False, axis=axis,
        )
        return jnp.stack([
            sx, sy, vshift, stat,
            it.astype(jnp.float32), n_valid.astype(jnp.float32), populated.astype(jnp.float32),
        ])

    return run(ref, tba, inlier, seed)


@partial(jax.jit, static_argnames=("mesh",))
def masked_median_diff_sharded(
    ref: jnp.ndarray, tba: jnp.ndarray, inlier: jnp.ndarray, mesh: Mesh
):
    """The full-raster VerticalShift fit on a row-sharded mesh: exact distributed median of
    (ref - tba) over inlier+finite pixels, plus the valid count. Matches the single-device
    `_masked_median_diff` bitwise (same per-pixel dh, same two-order-statistic formula)."""
    axis = mesh.axis_names[0]
    n_dev = int(mesh.devices.size)
    h, w = ref.shape
    pad = -(-h // n_dev) * n_dev - h  # NaN-pad rows to a shard multiple (median-inert)
    ref_p = jnp.pad(ref, ((0, pad), (0, 0)), constant_values=jnp.nan)
    tba_p = jnp.pad(tba, ((0, pad), (0, 0)), constant_values=jnp.nan)
    inl_p = jnp.pad(inlier, ((0, pad), (0, 0)), constant_values=False)

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(axis, None), P(axis, None), P(axis, None)),
        out_specs=(P(), P()),
    )
    def run(r, t, m):
        dh = jnp.where(m, r - t, jnp.nan).ravel()
        return masked_median_distributed(dh, jnp.isfinite(dh), axis)

    return run(ref_p, tba_p, inl_p)


# ======================================================================================
# Host-subsampled point paths: the SAME host subsample machinery feeds every method with
# or without mesh= (reference base.py:576-709 is likewise method-agnostic); mesh= only
# changes WHERE the solver's reductions run.
# ======================================================================================


@partial(jax.jit, static_argnames=("mesh", "max_iterations", "n_bins", "bin_before_fit",
                                   "invert"))
@pin_f32_matmuls
def nuth_kaab_points_sharded(
    pts_z: jnp.ndarray,
    rows: jnp.ndarray,
    cols: jnp.ndarray,
    raster: jnp.ndarray,
    slope_tan: jnp.ndarray,
    aspect: jnp.ndarray,
    res_x: float,
    res_y: float,
    tolerance: float,
    mesh: Mesh,
    max_iterations: int = 10,
    n_bins: int = 72,
    bin_before_fit: bool = True,
    invert: bool = False,
) -> jnp.ndarray:
    """Nuth & Kaab iterations over HOST-SUBSAMPLED points (point-cloud inputs, fractional
    subsamples) on a 1-D point-sharded mesh: the identical subsample the single-device
    `_nuth_kaab_solve` consumes, with every per-iteration median computed as an exact
    distributed order statistic (zero reassociation error in the statistics themselves).
    The residual difference vs the single-device fit is the last-ulp rounding of the tiny
    replicated 72x3 cosine-fit contraction, whose fusion order XLA may choose differently
    between the two program lowerings: measured <= ~1e-6 relative on the shifts (tested at
    1e-4), far below the method's 0.001-px convergence tolerance. Returns f32
    [shift_x_m, shift_y_m, vshift, stat, iterations]."""
    axis = mesh.axis_names[0]
    n_dev = int(mesh.devices.size)
    pz, rr, cc, st, asp = _pad_pts_1d(
        n_dev, (pts_z, jnp.nan), (rows, 0.0), (cols, 0.0), (slope_tan, jnp.nan), (aspect, 0.0)
    )

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(axis), P(axis), P(None, None)),
        out_specs=P(None),
    )
    def run(z_s, rr_s, cc_s, st_s, asp_s, rst):
        sx, sy, vshift, stat, it = _nk_iterations(
            z_s, rr_s, cc_s, st_s, asp_s, rst, res_x, res_y, tolerance,
            max_iterations, n_bins, bin_before_fit, invert=invert, axis=axis,
        )
        return jnp.stack([sx, sy, vshift, stat, it.astype(jnp.float32)])

    return run(pz, rr, cc, st, asp, raster)


@partial(jax.jit, static_argnames=("mesh", "invert"))
def dh_points_sharded(
    pts_z: jnp.ndarray,
    rows: jnp.ndarray,
    cols: jnp.ndarray,
    raster: jnp.ndarray,
    mesh: Mesh,
    invert: bool = False,
) -> jnp.ndarray:
    """Zero-shift elevation differences at host-subsampled points with the bilinear gathers
    sharded across the mesh. The per-point values are independent scalar interpolations, so
    the result equals the single-device `_dh_device(..., 0, 0)` exactly; callers apply an
    arbitrary host-side reductor (VerticalShift's vshift_reduc_func) to identical values."""
    axis = mesh.axis_names[0]
    n_dev = int(mesh.devices.size)
    n = pts_z.shape[0]
    pz, rr, cc = _pad_pts_1d(n_dev, (pts_z, jnp.nan), (rows, 0.0), (cols, 0.0))

    @partial(shard_map, mesh=mesh,
             in_specs=(P(axis), P(axis), P(axis), P(None, None)), out_specs=P(axis))
    def run(z_s, rr_s, cc_s, rst):
        dh = z_s - interp_rowcol(rst, rr_s, cc_s, method="linear")
        return -dh if invert else dh

    return run(pz, rr, cc, raster)[:n]


@partial(jax.jit, static_argnames=("mesh", "invert"))
def dh_shifted_points_sharded(
    pts_z: jnp.ndarray,
    rows: jnp.ndarray,
    cols: jnp.ndarray,
    raster: jnp.ndarray,
    sx_px,
    sy_px,
    mesh: Mesh,
    invert: bool = False,
) -> jnp.ndarray:
    """`_dh_device` (dh at points with the raster shifted by pixel offsets) with the bilinear
    gathers sharded across the mesh — per-point values identical to the single-device ones.
    Feeds host-minimizer DhMinimize paths under mesh=."""
    axis = mesh.axis_names[0]
    n_dev = int(mesh.devices.size)
    n = pts_z.shape[0]
    pz, rr, cc = _pad_pts_1d(n_dev, (pts_z, jnp.nan), (rows, 0.0), (cols, 0.0))
    sgn = -1.0 if invert else 1.0

    @partial(shard_map, mesh=mesh,
             in_specs=(P(axis), P(axis), P(axis), P(None, None), P(), P()),
             out_specs=P(axis))
    def run(z_s, rr_s, cc_s, rst, sx, sy):
        dh = z_s - interp_rowcol(rst, rr_s - sgn * sy, cc_s + sgn * sx, method="linear")
        return -dh if invert else dh

    return run(pz, rr, cc, raster, jnp.asarray(sx_px, jnp.float32),
               jnp.asarray(sy_px, jnp.float32))[:n]


@partial(jax.jit, static_argnames=("mesh", "invert"))
def dh_median_points_sharded(
    pts_z: jnp.ndarray,
    rows: jnp.ndarray,
    cols: jnp.ndarray,
    raster: jnp.ndarray,
    mesh: Mesh,
    invert: bool = False,
):
    """VerticalShift's median path over host-subsampled points: sharded gathers + the exact
    distributed median (two-order-statistic formula). Only two scalars leave the device.
    Returns (median, finite_count)."""
    axis = mesh.axis_names[0]
    n_dev = int(mesh.devices.size)
    pz, rr, cc = _pad_pts_1d(n_dev, (pts_z, jnp.nan), (rows, 0.0), (cols, 0.0))

    @partial(shard_map, mesh=mesh,
             in_specs=(P(axis), P(axis), P(axis), P(None, None)), out_specs=(P(), P()))
    def run(z_s, rr_s, cc_s, rst):
        dh = z_s - interp_rowcol(rst, rr_s, cc_s, method="linear")
        if invert:
            dh = -dh
        return masked_median_distributed(dh, jnp.isfinite(dh), axis)

    return run(pz, rr, cc, raster)


@partial(jax.jit, static_argnames=("mesh", "invert"))
def dh_minimize_nm_sharded(
    pts_z: jnp.ndarray,
    rows: jnp.ndarray,
    cols: jnp.ndarray,
    raster: jnp.ndarray,
    res_x: float,
    res_y: float,
    mesh: Mesh,
    invert: bool = False,
):
    """DhMinimize's whole Nelder-Mead as one sharded program: points sharded, the NMAD
    objective reduced with exact distributed medians. The NM trajectory is replicated scalar
    algebra over psum-identical medians, so the fit matches the single-device
    `_dh_minimize_nm_device` BITWISE (both use the two-order-statistic median formula).
    Returns (x_best (2,), f_best, iterations, vshift)."""
    from xdem_tpu.coreg.affine import _nelder_mead_2d

    axis = mesh.axis_names[0]
    n_dev = int(mesh.devices.size)
    pz, rr, cc = _pad_pts_1d(n_dev, (pts_z, jnp.nan), (rows, 0.0), (cols, 0.0))
    res = jnp.asarray([res_x, res_y], jnp.float32)
    sgn = -1.0 if invert else 1.0

    @partial(shard_map, mesh=mesh,
             in_specs=(P(axis), P(axis), P(axis), P(None, None)),
             out_specs=(P(None), P(), P(), P()))
    def run(z_s, rr_s, cc_s, rst):
        def dh_at(sx_px, sy_px):
            dh = z_s - interp_rowcol(rst, rr_s - sgn * sy_px, cc_s + sgn * sx_px,
                                     method="linear")
            return -dh if invert else dh

        def med(x):
            return masked_median_distributed(x, jnp.isfinite(x), axis)[0]

        def f(v):
            dh = dh_at(v[0] / res[0], v[1] / res[1])
            m = med(dh)
            return 1.4826 * med(jnp.abs(dh - m))

        x_best, f_best, it = _nelder_mead_2d(f)
        vshift = med(dh_at(x_best[0] / res[0], x_best[1] / res[1]))
        return x_best, f_best, it, vshift

    return run(pz, rr, cc, raster)


@partial(jax.jit, static_argnames=("mesh", "max_iterations", "method", "picky",
                                   "only_translation", "chunk"))
@pin_f32_matmuls
def icp_solve_sharded(
    ref: jnp.ndarray,
    tba: jnp.ndarray,
    norms: jnp.ndarray,
    tolerance,
    mesh: Mesh,
    max_iterations: int,
    method: str = "point-to-plane",
    picky: bool = True,
    only_translation: bool = False,
    chunk: int = 2048,
):
    """The brute-force ICP registration with the REFERENCE cloud sharded across the mesh:
    each device runs the blocked distance argmin against its reference shard only
    (the O(N*M) hot loop, memory and FLOPs / n_devices), then the per-shard winners merge
    with two pmin collectives: the global minimum distance, then the lowest global
    reference index among the points achieving it. Single-device jnp.argmin over the full
    cloud keeps the first (lowest-index) minimum — the identical tie-break — and each
    squared distance is the same independent 3-term expansion, so the merged neighbor set
    and therefore the whole registration match the single-device `_icp_solve_device`
    bitwise. The post-search Picky dedup and 6-parameter solve are O(M) and run replicated
    (pmin outputs are replicated, keeping the while_loop carry mesh-invariant).

    Returns (matrix (4,4), iterations, stat) like `_icp_solve_device`."""
    from xdem_tpu.coreg.affine import _icp_while_loop

    axis = mesh.axis_names[0]
    n_dev = int(mesh.devices.size)
    n = ref.shape[0]
    m = tba.shape[0]
    n_pad = -(-n // n_dev) * n_dev
    shard = n_pad // n_dev
    # Sentinel-pad the reference cloud to a shard multiple: _NN_PAD_COORD coordinates
    # square to ~3e30 (finite, no inf-inf=NaN) yet never win an argmin against any real
    # point, so padded indices are unreachable. Same sentinel as _nn_planes_scan's own
    # block padding, so per-pair d2 values match the single-device program exactly.
    if n_pad > n:
        from xdem_tpu.coreg.affine import _NN_PAD_COORD

        ref_p = jnp.concatenate([ref, jnp.full((n_pad - n, 3), _NN_PAD_COORD, ref.dtype)])
        norms_p = jnp.concatenate([norms, jnp.zeros((n_pad - n, 3), norms.dtype)])
    else:
        ref_p, norms_p = ref, norms

    @partial(shard_map, mesh=mesh,
             in_specs=(P(None, None), P(None, None), P(None, None)),
             out_specs=(P(None, None), P(), P()))
    def run(refl, tbal, normsl):
        from xdem_tpu.coreg.affine import _nn_planes_scan

        i = jax.lax.axis_index(axis)
        ref_shard = jax.lax.dynamic_slice_in_dim(refl, i * shard, shard)
        nn_local = _nn_planes_scan(ref_shard, rblk=min(chunk, shard))

        def nn(q):
            idxs, d2s = nn_local(q)
            li = idxs + i * shard  # global reference indices
            d2g = jax.lax.pmin(d2s, axis)  # global nearest distance per query
            # Lowest global index among the (possibly tied) global minima — the identical
            # tie-break to a single-device argmin over the full cloud
            ind = jax.lax.pmin(jnp.where(d2s == d2g, li, n_pad), axis)
            return ind, d2g

        return _icp_while_loop(refl, tbal, normsl, nn, tolerance, max_iterations, method,
                               picky, only_translation, n_segments=n_pad)

    return run(ref_p, tba, norms_p)


@partial(jax.jit, static_argnames=("mesh", "max_iterations", "only_translation"))
@pin_f32_matmuls
def lzd_solve_sharded(
    raster: jnp.ndarray,
    gradx: jnp.ndarray,
    grady: jnp.ndarray,
    xc0: jnp.ndarray,
    yc0: jnp.ndarray,
    zc0: jnp.ndarray,
    cz,
    inv_transform: jnp.ndarray,
    tolerance,
    mesh: Mesh,
    max_iterations: int,
    only_translation: bool = False,
):
    """The LZD iteration with the subsampled points sharded across the mesh: per-shard
    gather interpolation and partial 6x6 normal equations, psum'd into the replicated solve
    (see _lzd_while_loop's axis= contract). Shard-sum reassociation carries a documented
    ~1e-4 relative f32 tolerance on the fitted parameters vs the single-device program.
    Returns (matrix, iterations, stat, n_valid) like `_lzd_solve_device`."""
    from xdem_tpu.coreg.affine import _lzd_while_loop

    axis = mesh.axis_names[0]
    n_dev = int(mesh.devices.size)
    xs, ys, zs = _pad_pts_1d(n_dev, (xc0, 0.0), (yc0, 0.0), (zc0, jnp.nan))
    n_total = int(xs.shape[0])

    @partial(shard_map, mesh=mesh,
             in_specs=(P(None, None), P(None, None), P(None, None),
                       P(axis), P(axis), P(axis), P(None)),
             out_specs=(P(None, None), P(), P(), P()))
    def run(rst, gx, gy, x_s, y_s, z_s, invt):
        return _lzd_while_loop(rst, gx, gy, x_s, y_s, z_s, cz, invt, tolerance,
                               max_iterations, only_translation=only_translation,
                               axis=axis, n_total=n_total)

    return run(raster, gradx, grady, xs, ys, zs, inv_transform)
