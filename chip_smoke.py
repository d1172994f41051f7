"""Smoke test of xdem_tpu's main path on one GPU, through the public entry points.

    python chip_smoke.py               # six phases on one card
    python chip_smoke.py --four-cards  # the mesh= (sharded) path on four cards, and nothing else

Each phase drives a user-facing call at a size xdem users process, times its first call
(compilation included) and one warm call, and compares its result with the same code on the
CPU backend of this same process (``jax.devices("cpu")`` under ``jax.default_device``).
Every tolerance is printed beside its figure, with its reason. Data is generated from a seed:
spectral terrain made on the device, and the bundled ``xdem_tpu.examples`` rasters.

The script refuses to run (non-zero exit, no result line) unless JAX's default backend is a
GPU, and it never falls back to the CPU. Any failure, a parity figure outside its tolerance
included, ends the run with a non-zero exit. The last line of a passing run is one JSON
object: ``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.

Each phase is a plain function taking its sizes, so the tests rehearse it on the CPU at tiny
sizes.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from functools import partial

import jax
import numpy as np

RES = 20.0
#: Georeferencing of the generated rasters: UTM 33N, 20 m pixels, like the example DEMs (the
#: examples.TBA_SHIFT move is then under half a pixel, as NuthKaab's linearisation assumes).
TRANSFORM = (RES, 0.0, 4.0e5, 0.0, -RES, 9.0e6)
CRS = 32633
SURFACE_ATTRS = ("slope", "aspect", "hillshade", "profile_curvature", "tangential_curvature",
                 "planform_curvature", "flowline_curvature", "max_curvature", "min_curvature")
WINDOW_ATTRS = ("topographic_position_index", "terrain_ruggedness_index", "roughness",
                "rugosity", "fractal_roughness")
SUITE = SURFACE_ATTRS + WINDOW_ATTRS
#: Attributes compared at the 99th percentile instead of the maximum: curvatures divide by
#: powers of the gradient and aspect is undefined on flat pixels, so float32 rounding that
#: differs between backends is amplified on near-flat pixels. The reference's own tests
#: compare such attributes with RichDEM at a percentile for the same reason.
PERCENTILE_ATTRS = SURFACE_ATTRS[3:] + ("aspect",)

TERRAIN_TOL = (1e-3, "reference oracle model: terrain |diff| <= 1e-3 x mean |attr|")
SHIFT_TOL = (1e-2, "reference oracle model: coregistration shifts within 1 %")

CARD = "card not read"  # set by main() from nvidia-smi


class SmokeFailure(RuntimeError):
    """A phase's result is outside its tolerance."""


def card_line() -> str:
    """The card's name and power limit, read by nvidia-smi in a child that stays off JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def _log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def _ready(x):
    """Wait for every device array in ``x`` (Rasters, lists, tuples, arrays)."""
    if isinstance(x, (list, tuple)):
        for v in x:
            _ready(v)
    elif hasattr(x, "data") and hasattr(x, "transform"):
        _ready(x.data)
    elif hasattr(x, "block_until_ready"):
        jax.block_until_ready(x)
    return x


def _timed(phase: str, what: str, fn):
    """Run ``fn`` twice (first call with compilation, then warm), each waited for."""
    t0 = time.perf_counter()
    _ready(fn())
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = _ready(fn())
    warm = time.perf_counter() - t0
    _log(phase, f"{what}: first call {first:.3f} s (compile included), warm {warm:.3f} s "
                f"| {CARD}")
    return out, first, warm


def _peak(phase: str) -> int | None:
    stats = jax.devices()[0].memory_stats() or {}
    peak = stats.get("peak_bytes_in_use")
    _log(phase, f"device peak_bytes_in_use so far: {peak} | {CARD}")
    return peak


class _Parity:
    """Collects a phase's parity figures; `check` raises once all are printed."""

    def __init__(self, phase: str):
        self.phase, self.failed, self.figures = phase, [], {}

    def add(self, name: str, value: float, tol: float, reason: str) -> None:
        ok = bool(np.isfinite(value) and value <= tol)
        self.figures[name] = float(value)
        _log(self.phase, f"parity {name}: {value:.3e} (tolerance {tol:g}: {reason}) "
                         f"{'ok' if ok else 'FAIL'}")
        if not ok:
            self.failed.append(name)

    def check(self) -> dict:
        if self.failed:
            raise SmokeFailure(f"{self.phase}: outside tolerance: {', '.join(self.failed)}")
        return self.figures


def _cpu():
    return jax.default_device(jax.devices("cpu")[0])


@partial(jax.jit, static_argnums=(0, 2))
def _spectral(n: int, seed, shift_px=(0.0, 0.0)):
    """Power-law (|f|^-2) spectral terrain on an n x n grid, 0-1000 m, made on the device.

    Returns (terrain, shifted terrain): the second is the first translated by ``shift_px``
    = (columns, rows) pixels, exactly, through a phase ramp on the same spectrum. The field
    is the real part of a complex inverse FFT: a real inverse FFT of random phases would
    need Hermitian symmetry, which each FFT library enforces in its own way, so the ramp
    would not be a pure shift on every backend.

    The exponent 2 keeps the relief between neighbouring pixels realistic at any grid size.
    The steeper |f|^-2.7 of bench.synthetic_dem makes a 10 000^2 grid so smooth from pixel
    to pixel that float32 planform and flowline curvature lose their third digit on any
    backend (p99 error ~3e-3 against a float64 oracle, on the CPU too).
    """
    import jax.numpy as jnp

    m = 1 << int(np.ceil(np.log2(max(n, 2))))
    fy = jnp.fft.fftfreq(m)[:, None]
    fx = jnp.fft.fftfreq(m)[None, :]
    f = jnp.hypot(fx, fy).at[0, 0].set(1.0)
    amp = (f ** -2.0).at[0, 0].set(0.0)
    ph = jax.random.uniform(jax.random.PRNGKey(seed), amp.shape, maxval=2.0 * np.pi)
    spec = amp * jnp.exp(1j * ph)
    ramp = jnp.exp(-2j * np.pi * (fx * shift_px[0] + fy * shift_px[1]))
    z = jnp.fft.ifft2(spec).real[:n, :n]
    zs = jnp.fft.ifft2(spec * ramp).real[:n, :n]
    lo, hi = z.min(), z.max()
    return ((z - lo) / (hi - lo) * 1000.0).astype(jnp.float32), \
        ((zs - lo) / (hi - lo) * 1000.0).astype(jnp.float32)


def _dem(arr):
    from xdem_tpu.dem import DEM
    from xdem_tpu.georef import Affine

    return DEM.from_array(arr, transform=Affine(*TRANSFORM), crs=CRS)


def _shifted_pair(n: int, seed: int):
    """A DEM and its copy moved by examples.TBA_SHIFT (east, north, up), as DEMs."""
    from xdem_tpu import examples

    dx, dy, dz = examples.TBA_SHIFT
    # Moving the terrain east moves it to higher columns; north, to lower rows.
    ref, tba = _spectral(n, seed, (dx / RES, -dy / RES))
    return _dem(ref), _dem(tba + np.float32(dz))


def _error_pair(n: int):
    """A DEM and a second DEM of the same terrain with a smooth 0-4 m error field added."""
    z = _spectral(n, 4)[0]
    return _dem(z), _dem(z + _spectral(n, 7)[0] * np.float32(0.004))


# ---------------------------------------------------------------------------------- phases


def phase_io(n: int = 10_000) -> dict:
    """DEM.save then DEM.open of an n x n float32 DEM through the native GeoTIFF codec."""
    from xdem_tpu import io
    from xdem_tpu.dem import DEM

    z = np.array(_spectral(n, 1)[0])
    z[n // 3: n // 3 + 50, n // 2: n // 2 + 70] = np.nan  # a nodata hole
    dem = _dem(z)
    t0 = time.perf_counter()
    lib = io._build_library()
    _log("io", f"size {n}x{n} float32; native codec {lib.name} from geotiff.cpp ready in "
               f"{time.perf_counter() - t0:.3f} s (a build when not cached for this compiler)")
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/dem.tif"

        def roundtrip():
            dem.save(path)
            return DEM.open(path)

        back, first, warm = _timed("io", f"save+open {n}x{n}", roundtrip)
    peak = _peak("io")
    par = _Parity("io")
    back = np.asarray(back.data)
    diff = np.count_nonzero(~((back == z) | (np.isnan(z) & np.isnan(back))))
    par.add("pixels differing from the array written", diff, 0, "a lossless codec: exact")
    return {"size": n, "first_s": first, "warm_s": warm, "peak_bytes": peak, **par.check()}


def _terrain_errors(par: _Parity, got: list, want: list, attrs, prefix: str = "") -> None:
    tol, reason = TERRAIN_TOL
    for a, g, w in zip(attrs, got, want):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        par.add(f"{prefix}{a} NaN pixels differing", np.count_nonzero(np.isnan(g) != np.isnan(w)),
                0, "equal footprints")
        both = np.isfinite(g) & np.isfinite(w)
        d = np.abs(g[both] - w[both])
        if a == "aspect":
            d = np.minimum(d, 360.0 - d)  # circular, degrees
        scale = float(np.mean(np.abs(w[both]))) or 1.0
        if a in PERCENTILE_ATTRS:
            _log(par.phase, f"{prefix}{a}: max |diff| / mean |attr| = {d.max() / scale:.3e} "
                            "(informative; compared at p99)")
            par.add(f"{prefix}{a} p99 |diff| / mean |attr|", np.percentile(d, 99) / scale, tol,
                    reason + ", at p99 on near-flat-sensitive attributes")
        else:
            par.add(f"{prefix}{a} max |diff| / mean |attr|", d.max() / scale, tol, reason)


def phase_terrain(n: int = 10_000, crop: int = 2048) -> dict:
    """DEM.get_terrain_attribute with the 14-attribute suite on n x n; then the same call on
    a crop x crop window of that DEM, on the card and on the CPU backend, compared.

    The full-size result is checked for shape and for the NaN footprint of a nodata hole;
    values are compared on the crop, where both backends see the same input. (The surface
    fit removes the DEM's mean before differencing, so a crop and the full raster round
    differently in float32, whatever the backend.)
    """
    z = np.array(_spectral(n, 2)[0])
    r0 = (n - crop) // 2
    rc, cc = r0 + crop // 2, r0 + crop // 3
    z[rc: rc + crop // 64 + 2, cc: cc + crop // 48 + 2] = np.nan  # a nodata hole
    _log("terrain", f"size {n}x{n}, {len(SUITE)} attributes (9 Florinsky surface-fit, then "
                    f"TPI, TRI, roughness, rugosity w=3, fractal roughness w=13)")
    dem = _dem(z)
    out, first, warm = _timed("terrain", f"get_terrain_attribute {n}x{n}",
                              lambda: dem.get_terrain_attribute(list(SUITE)))
    peak = _peak("terrain")
    b = 13 // 2 + 2  # beyond the widest window's reach from the crop's edges
    inner = (slice(r0 + b, r0 + crop - b),) * 2
    full_nan = [np.isnan(np.asarray(r.data[inner])) for r in out]
    shapes = {tuple(r.shape) for r in out}
    del out
    z_crop = z[r0: r0 + crop, r0: r0 + crop]
    got = [np.asarray(r.data) for r in _dem(z_crop).get_terrain_attribute(list(SUITE))]
    with _cpu():
        want = [np.asarray(r.data) for r in _dem(z_crop).get_terrain_attribute(list(SUITE))]
    par = _Parity("terrain")
    par.add(f"{n}x{n} outputs of another shape", len(shapes - {(n, n)}), 0, "exact")
    par.add(f"{n}x{n} NaN pixels differing from the CPU crop's, inside the crop",
            sum(np.count_nonzero(f != np.isnan(w[b:-b, b:-b])) for f, w in zip(full_nan, want)),
            0, "NaN poisoning is exact")
    _terrain_errors(par, got, want, SUITE, prefix=f"crop {crop}^2: ")
    return {"size": n, "first_s": first, "warm_s": warm, "peak_bytes": peak, **par.check()}


def _nk_shifts(ref, tba):
    from xdem_tpu.coreg import NuthKaab

    c = NuthKaab()
    aligned = c.fit_and_apply(ref, tba, random_state=42)
    o = c.meta["outputs"]["affine"]
    return np.array([o["shift_x"], o["shift_y"], o["shift_z"]]), aligned


def phase_nuthkaab(n: int = 10_000, n_cpu: int = 4096) -> dict:
    """NuthKaab().fit_and_apply (reference default subsample 5e5) on an n x n pair moved by
    examples.TBA_SHIFT, against the same fit on the CPU backend on an n_cpu x n_cpu pair."""
    from xdem_tpu import examples

    ref, tba = _shifted_pair(n, 3)
    _log("nuthkaab", f"size {n}x{n} pair moved by {examples.TBA_SHIFT} m, subsample 5e5")
    (shifts, aligned), first, warm = _timed("nuthkaab", f"NuthKaab().fit_and_apply {n}x{n}",
                                            lambda: _nk_shifts(ref, tba))
    peak = _peak("nuthkaab")
    if aligned.shape != (n, n):
        raise SmokeFailure(f"nuthkaab: aligned DEM has shape {aligned.shape}")
    with _cpu():
        cpu_shifts, _ = _nk_shifts(*_shifted_pair(n_cpu, 3))
    _log("nuthkaab", f"shifts card {n}^2 {shifts.tolist()}, CPU {n_cpu}^2 {cpu_shifts.tolist()}")
    par = _Parity("nuthkaab")
    par.add("max |shift - CPU shift| / |CPU shift|",
            np.max(np.abs(shifts - cpu_shifts) / np.abs(cpu_shifts)), *SHIFT_TOL)
    truth = -np.asarray(examples.TBA_SHIFT)  # the fit undoes the applied move
    for k, name in enumerate(("x", "y")):
        par.add(f"|shift_{name} - applied| (m)", abs(shifts[k] - truth[k]), 1.5,
                "the workflow tests' recovery bound")
    return {"size": n, "first_s": first, "warm_s": warm, "peak_bytes": peak, **par.check()}


def _icp_params(ref, epc, **kw):
    from xdem_tpu.coreg import ICP
    from xdem_tpu.coreg.base import translations_rotations_from_matrix

    c = ICP(**kw).fit(ref, epc, random_state=42)
    return np.asarray(translations_rotations_from_matrix(c.to_matrix()), np.float64)


def phase_icp(n_points: int = 1_000_000, subsample_brute: int = 50_000) -> dict:
    """ICP().fit of the example DEM against an n_points EPC moved by examples.TBA_SHIFT at
    defaults, then nn_method="brute" (the device nearest-neighbour loop) at subsample_brute,
    against the default host KD-tree fit on the CPU backend at the same subsample."""
    from xdem_tpu import examples

    ref = examples.get_ref_dem()
    epc = examples.get_epc(n_points=n_points).translate(*examples.TBA_SHIFT)
    _log("icp", f"DEM {ref.shape[0]}x{ref.shape[1]} vs EPC of {n_points} points, defaults")
    default, first, warm = _timed("icp", "ICP().fit", lambda: _icp_params(ref, epc))
    _log("icp", f"default fit (tx, ty, tz, rx, ry, rz): {default.tolist()}")
    brute, bfirst, bwarm = _timed("icp", f"ICP(nn_method='brute', subsample={subsample_brute}).fit",
                                  lambda: _icp_params(ref, epc, nn_method="brute",
                                                      subsample=subsample_brute))
    peak = _peak("icp")
    with _cpu():
        kd = _icp_params(ref, epc, nn_method="kdtree", subsample=subsample_brute)
    _log("icp", f"brute (card) {brute.tolist()}, kdtree (CPU) {kd.tolist()}")
    par = _Parity("icp")
    par.add("max |params - CPU KD-tree params| / max(|translation|, 1)",
            np.max(np.abs(brute - kd)) / max(np.max(np.abs(kd[:3])), 1.0), *SHIFT_TOL)
    return {"size": n_points, "first_s": first, "warm_s": warm, "brute_first_s": bfirst,
            "brute_warm_s": bwarm, "peak_bytes": peak, **par.check()}


def _uncertainty(ref, other, subsample=10_000, **kw):
    sig, rho = ref.estimate_uncertainty(other, random_state=42, subsample=subsample, **kw)
    return np.asarray(sig.data), rho(np.array([20.0, 200.0, 2000.0]))


def phase_uncertainty(n: int = 10_000, example_crop: tuple | None = None,
                      conv_size: int = 2048, subsample: int = 10_000) -> dict:
    """DEM.estimate_uncertainty (H2022, ``subsample`` variogram samples) on an n x n pair,
    against the CPU backend on the example pair (985 x 1332, or ``example_crop`` =
    (r0, r1, c0, c1) of it); then the patches-method convolution on conv_size^2, against
    the CPU backend."""
    from xdem_tpu import examples, spatialstats

    ref, other = _error_pair(n)
    _log("uncertainty", f"size {n}x{n} pair, H2022, subsample {subsample}")
    (sig, rho), first, warm = _timed("uncertainty", f"estimate_uncertainty {n}x{n}",
                                     lambda: _uncertainty(ref, other, subsample))
    peak = _peak("uncertainty")
    if sig.shape != (n, n) or not np.isfinite(sig).mean() > 0.9 or not np.isfinite(rho).all():
        raise SmokeFailure(f"uncertainty: sigma {sig.shape}, finite share "
                           f"{np.isfinite(sig).mean()}, rho {rho}")
    del sig
    eref, etba = examples.get_ref_dem(), examples.get_tba_dem()
    mask = ~examples.get_glacier_mask()
    if example_crop is not None:
        r0, r1, c0, c1 = example_crop
        eref, etba, mask = eref.icrop((r0, r1), (c0, c1)), etba.icrop((r0, r1), (c0, c1)), \
            mask[r0:r1, c0:c1]
    sig_d, rho_d = _uncertainty(eref, etba, subsample, stable_terrain=mask)
    with _cpu():
        sig_c, rho_c = _uncertainty(eref, etba, subsample, stable_terrain=mask)
    par = _Parity("uncertainty")
    # Binned-NMAD tables are order statistics of f32 values: a value within f32 eps of a bin
    # edge can take the neighbouring bin on one backend, moving that entry by ~1/bin count.
    d = np.abs(sig_d - sig_c) / (np.nanmean(np.abs(sig_c)) or 1.0)
    par.add("sigma p99.9 |diff| / mean sigma", np.nanpercentile(d, 99.9), 5e-3,
            "above the binned-median quantization of the heteroscedasticity tables")
    par.add("sigma max |diff| / mean sigma", np.nanmax(d), 1e-2, "no real numeric drift")
    par.add("rho max |diff| at 20, 200, 2000 m", np.max(np.abs(rho_d - rho_c)), 5e-3,
            "variogram fit from the same sampled pairs")
    img = np.asarray(_spectral(conv_size, 5)[0])
    mean_d = spatialstats.mean_filter_nan(img, 21)[0]
    with _cpu():
        mean_c = spatialstats.mean_filter_nan(img, 21)[0]
    par.add(f"patches convolution {conv_size}^2 max |diff| / mean",
            np.nanmax(np.abs(mean_d - mean_c)) / np.nanmean(np.abs(mean_c)), 1e-5,
            "full float32 convolution (TF32 would be ~1e-3)")
    return {"size": n, "first_s": first, "warm_s": warm, "peak_bytes": peak, **par.check()}


def phase_volume(n: int = 4096) -> dict:
    """volume.hypsometric_binning then interpolate_hypsometric_bins on an n x n dDEM inside
    a glacier mask, the dDEM resident on the device (the device path), against the same
    calls on the CPU backend."""
    import jax.numpy as jnp

    from xdem_tpu import volume

    ref = np.asarray(_spectral(n, 5)[0])
    dh = np.asarray(_spectral(n, 6)[0]) * 0.01 - 5.0
    yy, xx = np.mgrid[0:n, 0:n] / n
    mask = ((yy - 0.5) / 0.4) ** 2 + ((xx - 0.45) / 0.35) ** 2 < 1.0  # a glacier outline
    dh_g, ref_g = dh[mask], ref[mask]
    _log("volume", f"size {n}x{n} dDEM, {int(mask.sum())} glacier pixels")

    def run():
        bins = volume.hypsometric_binning(jnp.asarray(dh_g), jnp.asarray(ref_g), bins=50.0)
        return bins, volume.interpolate_hypsometric_bins(bins)

    (bins, interp), first, warm = _timed("volume", "hypsometric_binning + interpolate", run)
    peak = _peak("volume")
    with _cpu():
        bins_c, interp_c = run()
    par = _Parity("volume")
    scale = float(np.nanmean(np.abs(bins_c["value"]))) or 1.0
    par.add("bins max |diff| / mean |value|",
            np.nanmax(np.abs(bins["value"].to_numpy() - bins_c["value"].to_numpy())) / scale, 1e-4,
            "binned medians of the same values")
    par.add("bin counts differing", np.count_nonzero(bins["count"].to_numpy()
                                                     != bins_c["count"].to_numpy()), 0, "exact")
    par.add("interpolated bins max |diff| / mean |value|",
            np.nanmax(np.abs(interp["value"].to_numpy() - interp_c["value"].to_numpy())) / scale,
            1e-4, "interpolation of the same bins")
    return {"size": n, "first_s": first, "warm_s": warm, "peak_bytes": peak, **par.check()}


def phase_four_cards(n: int = 10_000, n_points: int = 1_000_000,
                     icp_subsample: int = 50_000, unc_subsample: int = 10_000) -> dict:
    """The mesh= path on four devices, each against its single-device twin."""
    from jax.sharding import Mesh

    from xdem_tpu import examples
    from xdem_tpu.parallel.mesh import make_mesh

    devices = jax.devices()
    if len(devices) < 4:
        raise SmokeFailure(f"four_cards: needs 4 devices, found {len(devices)}")
    mesh2d = make_mesh(4, shape=(2, 2), devices=devices)
    mesh1d = Mesh(np.asarray(devices[:4]), axis_names=("p",))
    mesh_one = Mesh(np.asarray(devices[:1]), axis_names=("p",))
    par = _Parity("four_cards")
    res: dict = {"size": n}

    z = np.asarray(_spectral(n, 2)[0])
    dem = _dem(z)
    sharded, res["terrain_first_s"], res["terrain_warm_s"] = _timed(
        "four_cards", f"get_terrain_attribute {n}x{n} on a 2x2 mesh",
        lambda: dem.get_terrain_attribute(list(SUITE), mesh=mesh2d))
    sharded = [np.asarray(r.data) for r in sharded]
    single = [np.asarray(r.data) for r in dem.get_terrain_attribute(list(SUITE))]
    _terrain_errors(par, sharded, single, SUITE, prefix="2x2 mesh vs one card: ")
    del sharded, single

    ref, tba = _shifted_pair(n, 3)
    s_mesh, res["nuthkaab_first_s"], res["nuthkaab_warm_s"] = _timed(
        "four_cards", f"NuthKaab(mesh=4 devices) {n}x{n}",
        lambda: _nk_mesh(ref, tba, mesh1d))
    s_one = _nk_mesh(ref, tba, None)
    par.add("NuthKaab mesh vs one card: max |diff| / (1e-4 + 1e-4 |shift|)",
            float(np.max(np.abs(s_mesh - s_one) / (1e-4 + 1e-4 * np.abs(s_one)))), 1.0,
            "exact distributed medians: agreement to the last float32 digits")

    eref = examples.get_ref_dem()
    epc = examples.get_epc(n_points=n_points).translate(*examples.TBA_SHIFT)
    m_mesh, res["icp_first_s"], res["icp_warm_s"] = _timed(
        "four_cards", f"ICP(mesh=4 devices, subsample={icp_subsample})",
        lambda: _icp_matrix(eref, epc, icp_subsample, mesh1d))
    m_one = _icp_matrix(eref, epc, icp_subsample, None)
    par.add("ICP mesh vs one-card brute: matrix entries differing",
            np.count_nonzero(m_mesh != m_one), 0, "bitwise (pmin-merged blocked argmin)")

    uref, uother = _error_pair(n)
    (sig_m, rho_m), res["uncertainty_first_s"], res["uncertainty_warm_s"] = _timed(
        "four_cards", f"estimate_uncertainty(mesh=4 devices) {n}x{n}",
        lambda: _uncertainty(uref, uother, unc_subsample, mesh=mesh1d))
    sig_1, rho_1 = _uncertainty(uref, uother, unc_subsample, mesh=mesh_one)
    par.add("uncertainty 4-device vs 1-device mesh: sigma pixels differing",
            np.count_nonzero(~((sig_m == sig_1) | (np.isnan(sig_m) & np.isnan(sig_1)))), 0,
            "bitwise (mesh-invariant pipeline)")
    par.add("uncertainty 4-device vs 1-device mesh: rho values differing",
            np.count_nonzero(rho_m != rho_1), 0, "bitwise (mesh-invariant pipeline)")
    res["peak_bytes"] = _peak("four_cards")
    return {**res, **par.check()}


def _nk_mesh(ref, tba, mesh):
    from xdem_tpu.coreg import NuthKaab

    c = NuthKaab().fit(ref, tba, random_state=42, mesh=mesh)
    o = c.meta["outputs"]["affine"]
    return np.array([o["shift_x"], o["shift_y"], o["shift_z"]])


def _icp_matrix(ref, epc, subsample, mesh):
    from xdem_tpu.coreg import ICP

    if mesh is None:
        return ICP(subsample=subsample, nn_method="brute").fit(ref, epc, random_state=42).to_matrix()
    return ICP(subsample=subsample).fit(ref, epc, random_state=42, mesh=mesh).to_matrix()


PHASES = {
    "io": phase_io,
    "terrain": phase_terrain,
    "nuthkaab": phase_nuthkaab,
    "icp": phase_icp,
    "uncertainty": phase_uncertainty,
    "volume": phase_volume,
}


def main(argv: list[str] | None = None) -> int:
    global CARD
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the mesh= path on four cards and its single-card twins")
    args = ap.parse_args(argv)

    if jax.default_backend() != "gpu":
        print(f"chip_smoke: JAX's default backend is {jax.default_backend()!r}, not 'gpu'; "
              "this script runs only on a GPU.", file=sys.stderr)
        return 2
    CARD = card_line()
    print(CARD, flush=True)

    import importlib

    pkgs = {}
    for name in ("pandas", "matplotlib", "yaml", "sklearn", "tqdm"):
        try:
            importlib.import_module(name)
            pkgs[name] = "yes"
        except ImportError:
            pkgs[name] = "no"
    dev = jax.devices()[0]
    print(f"device_kind {dev.device_kind}; jax {jax.__version__}; devices {len(jax.devices())}; "
          f"optional packages importable: {pkgs}", flush=True)

    import xdem_tpu  # noqa: F401  (fails here, before any phase, outside a checkout)

    t0 = time.perf_counter()
    phases = {"four_cards": phase_four_cards} if args.four_cards else PHASES
    for name, fn in phases.items():
        t = time.perf_counter()
        fn()
        print(f"[{name}] done in {time.perf_counter() - t:.1f} s", flush=True)
    print(f"all phases passed in {time.perf_counter() - t0:.1f} s | {CARD}", flush=True)
    print(json.dumps({"ok": True, "device": {"platform": dev.platform, "kind": dev.device_kind,
                                             "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
