"""Benchmark: terrain-attribute throughput vs the reference's scipy engine.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"}.

Headline: terrain-attribute throughput in Mcells/s — Horn slope + aspect +
hillshade on an 8192x8192 synthetic DEM, steady-state (best of N runs after compile) on the
available accelerator. The baseline is the reference's own compute path: its scipy engine
(_get_surface_attributes with stacked scipy.ndimage convolutions) loaded standalone from
/root/reference with its geo-I/O dependencies stubbed, on a smaller grid and scaled by cell
count (the scipy path is O(cells)).

Extra diagnostics (NuthKaab wall time, per-run timings) go to stderr.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

BENCH_SIZE = int(os.environ.get("BENCH_SIZE", 8192))
BASELINE_SIZE = int(os.environ.get("BENCH_BASELINE_SIZE", 2048))
ATTRS = ["slope", "aspect", "hillshade"]
RES = 20.0


def log(*args):
    print(*args, file=sys.stderr, flush=True)


def synthetic_dem(n: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    m = 1 << int(np.ceil(np.log2(n)))
    fy = np.fft.fftfreq(m)[:, None]
    fx = np.fft.rfftfreq(m)[None, :]
    f = np.hypot(fx, fy)
    f[0, 0] = 1.0
    amp = f**-2.7
    amp[0, 0] = 0
    spec = amp * np.exp(1j * rng.uniform(0, 2 * np.pi, amp.shape))
    z = np.fft.irfft2(spec, s=(m, m))[:n, :n]
    z = (z - z.min()) / (z.max() - z.min()) * 1000.0
    return np.ascontiguousarray(z, dtype=np.float32)


def bench_ours(dem_np: np.ndarray, n_warmup: int = 1, n_runs: int = 5) -> float:
    import jax
    import jax.numpy as jnp

    from xdem_tpu.terrain.surfit import surface_attributes

    dem = jnp.asarray(dem_np)
    attrs = tuple(ATTRS)
    K = int(os.environ.get("BENCH_INNER_ITERS", 10))

    # Amortize the per-dispatch overhead by looping
    # K kernel invocations inside ONE jitted program; each iteration perturbs the input so XLA
    # cannot hoist or reuse results.
    @jax.jit
    def run_k(d):
        def body(i, acc):
            out = surface_attributes(d + i.astype(d.dtype), RES, attrs=attrs, surface_fit="Horn")
            return acc + out[0, 100, 100] + out[2, 200, 200]
        return jax.lax.fori_loop(0, K, body, jnp.float32(0.0))

    t0 = time.perf_counter()
    _ = float(run_k(dem))  # value readback forces completion
    log(f"ours: first call (with compile): {time.perf_counter() - t0:.2f}s on {jax.devices()[0]}")
    times = []
    for _i in range(n_runs):
        t0 = time.perf_counter()
        _ = float(run_k(dem))
        times.append((time.perf_counter() - t0) / K)
    best = min(times)
    log(f"ours: steady-state per-kernel times (K={K} amortized): {[f'{t*1000:.1f}ms' for t in times]}")
    return best


def bench_reference(dem_np: np.ndarray) -> float:
    """Time the reference's scipy engine, loaded standalone with geo deps stubbed."""
    import importlib.util
    import types

    import scipy.ndimage

    xdem_pkg = types.ModuleType("xdem")
    xdem_pkg.__path__ = ["/root/reference/xdem"]
    sys.modules.setdefault("xdem", xdem_pkg)

    def load(name, path):
        if name in sys.modules:
            return sys.modules[name]
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
        return mod

    load("xdem._typing", "/root/reference/xdem/_typing.py")
    load("xdem._misc", "/root/reference/xdem/_misc.py")

    # Faithful stand-in for the reference's spatialstats.convolution scipy path
    # (/root/reference/xdem/spatialstats.py:2558-2597): loop of scipy.ndimage.convolve.
    stats_stub = types.ModuleType("xdem.spatialstats")

    def convolution(imgs, filters, method="scipy"):
        n, h, w = imgs.shape
        m = filters.shape[0]
        out = np.empty((n, m, h, w), dtype=np.float64)
        for i in range(n):
            for j in range(m):
                out[i, j] = scipy.ndimage.convolve(imgs[i].astype(np.float64), filters[j])
        return out

    stats_stub.convolution = convolution
    sys.modules["xdem.spatialstats"] = stats_stub

    surfit = load("xdem.terrain.surfit", "/root/reference/xdem/terrain/surfit.py")

    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        out = surfit._get_surface_attributes(dem_np, RES, list(ATTRS), surface_fit="Horn")
        times.append(time.perf_counter() - t0)
    del out
    best = min(times)
    log(f"reference scipy engine on {dem_np.shape[0]}^2: {best:.2f}s")
    return best


def main() -> None:
    dem = synthetic_dem(BENCH_SIZE)
    t_ours = bench_ours(dem)
    cells = dem.size
    mcells_ours = cells / t_ours / 1e6

    dem_base = dem[:BASELINE_SIZE, :BASELINE_SIZE]
    t_ref = bench_reference(dem_base)
    mcells_ref = dem_base.size / t_ref / 1e6

    log(f"throughput: ours {mcells_ours:.1f} Mcells/s vs reference {mcells_ref:.1f} Mcells/s")
    headline = {
        "metric": f"terrain_horn_sah_{BENCH_SIZE}x{BENCH_SIZE}_Mcells_per_s",
        "value": round(mcells_ours, 2),
        "unit": "Mcells/s",
        "vs_baseline": round(mcells_ours / mcells_ref, 2),
    }

    # Roofline accounting for the headline: minimum device-memory traffic of the fused
    # 3-attribute kernel (1 read + 3 writes of n^2 f32) vs the measured effective bandwidth
    bw = _roofline_bw()
    model_bytes = 4 * cells * 4
    headline["model_bytes"] = model_bytes
    headline["achieved_GBps"] = round(model_bytes / t_ours / 1e9, 1)
    headline["pct_roofline"] = round(100.0 * model_bytes / t_ours / 1e9 / bw, 1) if bw else None
    log(f"roofline: measured BW {bw:.0f} GB/s; headline at {headline['achieved_GBps']} GB/s "
        f"({headline['pct_roofline']}% of speed-of-light)")

    # Full north-star table — JSON lines on stderr + bench_table.json,
    # so regressions in the non-headline configs are visible every round. BENCH_QUICK=1 skips.
    rows = [headline]
    if not os.environ.get("BENCH_QUICK"):
        rows += bench_table(bw)
        rows += bench_parity()
        rows += bench_10k(bw)
    _apply_measured_baselines(rows)
    for row in rows[1:]:
        log(json.dumps(row))
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "bench_table.json"), "w") as f:
        json.dump(rows, f, indent=1)

    print(json.dumps(headline))


def _apply_measured_baselines(rows: list[dict]) -> None:
    """Populate vs_baseline from the committed reference-core measurements
    (baseline_measured.json, produced by bench_baselines.py — SURVEY §6's mandate).

    Seconds rows get vs_baseline = ref_seconds / ours_seconds (speedup x); Mcells/s rows
    get ours / ref. Rows whose reference stages only partially load offline carry
    baseline_partial=True and the measured lower bound (the true speedup is HIGHER)."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "baseline_measured.json")
    try:
        with open(path) as f:
            base = json.load(f)
    except OSError:
        log("baseline_measured.json missing: run bench_baselines.py to populate vs_baseline")
        return
    for row in rows:
        b = base.get(row.get("metric"))
        if not b or row.get("vs_baseline") is not None or row.get("value") in (None, 0):
            continue
        if row.get("unit") == "s" and b.get("ref_seconds"):
            row["vs_baseline"] = round(b["ref_seconds"] / row["value"], 2)
        elif b.get("ref_value"):
            row["vs_baseline"] = round(row["value"] / b["ref_value"], 2)
        else:
            continue
        row["baseline_method"] = b.get("method")
        if b.get("partial"):
            row["baseline_partial"] = True  # the reference number is a LOWER bound


def _roofline_bw() -> float:
    """Measured effective device-memory bandwidth (GB/s) of the default device: in-graph
    elementwise read+write loop at 4096^2 (2 x n^2 f32 of traffic per iteration), so the
    %-of-roofline figures reported per metric are against the device's measured rate, not
    its datasheet."""
    import jax
    import jax.numpy as jnp

    n = 4096
    k = 16
    x = jnp.ones((n, n), jnp.float32)

    @jax.jit
    def loop(a):
        def body(i, acc):
            return acc * 0.999 + i.astype(jnp.float32) * 1e-9
        return jax.lax.fori_loop(0, k, body, a)[17, 23]

    float(loop(x))  # compile
    best = np.inf
    for _ in range(3):
        t0 = time.perf_counter()
        float(loop(x))
        best = min(best, time.perf_counter() - t0)
    return 2 * n * n * 4 * k / best / 1e9


def _timed(fn, *args, n=3, **kwargs):
    """Best wall time of n calls (first call separately = compile)."""
    t0 = time.perf_counter()
    fn(*args, **kwargs)
    first = time.perf_counter() - t0
    best = np.inf
    for _ in range(n):
        t0 = time.perf_counter()
        fn(*args, **kwargs)
        best = min(best, time.perf_counter() - t0)
    return first, best


def _dispatches(fn, *args) -> int:
    """Compiled-program launches of one call (profiler.count_device_dispatches)."""
    from xdem_tpu.profiler import count_device_dispatches

    return count_device_dispatches(fn, *args)[1]["executions"]


def _annot(row: dict, model_bytes: float, secs: float, bw: float) -> dict:
    """Attach roofline accounting: minimum-traffic model, achieved GB/s, % of measured BW.

    The models are documented lower bounds (perfect fusion, no re-reads); the pct_roofline
    figure is how close the measured wall time gets to streaming that minimum traffic at the
    chip's measured bandwidth — visibility for regressions and remaining headroom, not an
    exact flop count."""
    row["model_bytes"] = int(model_bytes)
    row["achieved_GBps"] = round(model_bytes / secs / 1e9, 2)
    row["pct_roofline"] = round(100.0 * model_bytes / secs / 1e9 / bw, 1) if bw else None
    return row


def bench_table(bw: float = 0.0) -> list[dict]:
    """North-star configs beyond the headline."""
    import jax
    import jax.numpy as jnp

    from xdem_tpu.terrain.surfit import surface_attributes
    from xdem_tpu.terrain.window import fractal_roughness, windowed_indexes

    rows: list[dict] = []

    # Config 2: full terrain suite (14 attributes) on 4k^2
    n = 4096
    dem = jnp.asarray(synthetic_dem(n, seed=1))
    sf_attrs = ("slope", "aspect", "hillshade", "profile_curvature", "tangential_curvature",
                "planform_curvature", "flowline_curvature", "max_curvature", "min_curvature")
    win_attrs = ("topographic_position_index", "terrain_ruggedness_index", "roughness", "rugosity")

    @jax.jit
    def full_suite(d):
        a = surface_attributes(d, RES, attrs=sf_attrs, surface_fit="Florinsky")
        b = windowed_indexes(d, RES, win_attrs, window_size=3)
        c = fractal_roughness(d, window_size=13)
        return a[0, 50, 50] + b[0, 60, 60] + c[70, 70]

    # Dispatch floor: a trivial single-dispatch program on the same input, timed the same
    # way. The suite and fractal rows below are SINGLE dispatches, so their roofline columns
    # are computed from compute_seconds = wall - floor (each row records both).
    @jax.jit
    def _trivial(d):
        return d[3, 5] * 2.0

    _, floor = _timed(lambda d: float(_trivial(d)), dem)
    log(f"dispatch floor (trivial single-dispatch program): {floor*1000:.1f} ms")

    def _net(best: float) -> float:
        return max(best - floor, 1e-4)

    first, best = _timed(lambda d: float(full_suite(d)), dem)
    log(f"full terrain suite {n}^2: first {first:.1f}s, steady {best*1000:.0f} ms "
        f"({best - floor:.4f}s net of dispatch)")
    rows.append(_annot(
        {"metric": f"terrain_full_suite_{n}x{n}_Mcells_per_s",
         "value": round(n * n / best / 1e6, 1), "unit": "Mcells/s", "vs_baseline": None,
         "dispatch_floor_s": round(floor, 4), "compute_seconds": round(_net(best), 4),
         "compute_Mcells_per_s": round(n * n / _net(best) / 1e6, 1)},
        (1 + 14) * n * n * 4, _net(best), bw))

    # Config 2b: the fractal box-count kernel alone — the suite's compute-bound member
    # (VERDICT r3 weak #2: prove the roofline claim). Bytes-only roofline makes it look
    # idle; the tap-rate bound (pct_window_roofline) is the honest one for window kernels.
    @jax.jit
    def fractal_only(d):
        return fractal_roughness(d, window_size=13)[70, 70]

    first, best = _timed(lambda d: float(fractal_only(d)), dem)
    log(f"fractal roughness {n}^2 (w=13): first {first:.1f}s, steady {best*1000:.1f} ms "
        f"({best - floor:.4f}s net of dispatch)")
    row_f = _annot(
        {"metric": f"fractal_roughness_{n}x{n}_seconds",
         "value": round(best, 4), "unit": "s", "vs_baseline": None,
         "dispatch_floor_s": round(floor, 4), "compute_seconds": round(_net(best), 4)},
        2 * n * n * 4, _net(best), bw)
    # The kernel's time is genuinely split between taps and the device-memory traffic of its
    # materialized planes (the padded raster + per-scale block maxima behind
    # optimization_barrier — the fusion-cliff fix documented on window.fractal_roughness).
    # model_bytes above is the 2-pass minimum; model_bytes_algo charges the algorithm's
    # actual mandatory traffic.
    hw = 13 // 2
    planes = [(n + 2 * hw) ** 2] + [(n + 2 * hw - q + 1) ** 2
                                    for q in range(2, hw + 1) if hw % q == 0]
    algo_bytes = (2 * sum(planes) + 2 * n * n) * 4  # write+read each plane, read in, write out
    row_f["model_bytes_algo"] = int(algo_bytes)
    row_f["pct_roofline_algo"] = (
        round(100.0 * algo_bytes / _net(best) / 1e9 / bw, 1) if bw else None)
    rows.append(row_f)

    # Config 3: NuthKaab fit on the bundled pair (fused device path)
    from xdem_tpu import coreg, examples

    ref = examples.get_ref_dem()
    tba = examples.get_tba_dem()
    mask = ~examples.get_glacier_mask()

    def nk_fit(seed):
        c = coreg.NuthKaab()
        c.fit(ref, tba, inlier_mask=mask, random_state=seed)
        return c

    first, best = _timed(nk_fit, 42, n=2)
    log(f"NuthKaab fit: first {first:.1f}s (compile), steady {best:.2f}s")
    n_px = ref.data.size
    # Model: read pair + write slope/aspect aux (4 rasters) + 10 iterations of 5e5-point
    # bilinear gathers (4 taps, 2 arrays) + the bit-packed mask upload
    nk_bytes = 6 * n_px * 4 + 10 * 5e5 * 4 * 2 * 4 + n_px / 8
    row_nk = _annot({"metric": "nuth_kaab_fit_985x1332_seconds",
                     "value": round(best, 3), "unit": "s", "vs_baseline": None},
                    nk_bytes, best, bw)
    disp_nk = _dispatches(nk_fit, 45)
    log(f"NuthKaab fit dispatches: {disp_nk}")
    row_nk["dispatches"] = disp_nk
    rows.append(row_nk)

    # Config 4: ICP rigid alignment, DEM vs 1e6-point EPC
    from xdem_tpu.raster import Raster
    from xdem_tpu.georef import Affine

    n_icp = 2048
    dem_icp = synthetic_dem(n_icp, seed=3)
    t = Affine(20.0, 0.0, 5e5, 0.0, -20.0, 8.8e6)
    rst = Raster(dem_icp, t, 32633)
    epc = rst.to_pointcloud(subsample=1_000_000, random_state=1).translate(15.0, -8.0, 3.0)

    def icp_fit():
        c = coreg.ICP(subsample=50000)
        c.fit(rst, epc, random_state=42)
        return c

    first, best = _timed(icp_fit, n=2)
    disp_icp = _dispatches(icp_fit)
    log(f"ICP vs 1e6-pt EPC: first {first:.1f}s, steady {best:.2f}s, dispatches {disp_icp}")
    # Model: read DEM + write 3 normal/gradient rasters once + 20 iterations of 5e4-pt
    # NN/interp gathers (brute pairs excluded: the kdtree path gathers, not matmuls)
    icp_bytes = 4 * n_icp * n_icp * 4 + 20 * 5e4 * 8 * 4
    rows.append(_annot({"metric": "icp_dem_vs_1e6pt_epc_seconds",
                 "value": round(best, 3), "unit": "s", "vs_baseline": None,
                 "dispatches": disp_icp}, icp_bytes, best, bw))

    # Config 4b: BlockwiseNuthKaab — the whole tiled fit as one device program
    from xdem_tpu.coreg import BlockwiseNuthKaab

    def bw_fit(seed):
        return BlockwiseNuthKaab(block_size_fit=256, subsample_per_tile=4000,
                                 random_state=seed).fit(ref, tba)

    first, best = _timed(bw_fit, 42, n=2)
    disp_bw = _dispatches(bw_fit, 45)
    log(f"BlockwiseNuthKaab fit (15 tiles): first {first:.1f}s, steady {best:.3f}s, "
        f"dispatches {disp_bw}")
    rows.append(_annot({"metric": "blockwise_nuth_kaab_fit_985x1332_seconds",
                 "value": round(best, 3), "unit": "s", "vs_baseline": None,
                 "dispatches": disp_bw},
                 6 * n_px * 4 + 15 * 4000 * 4 * 2 * 4, best, bw))

    # Config 5: uncertainty pipeline (heteroscedasticity + variogram) on the bundled pair
    @jax.jit
    def _decimate10(a):
        # One launch: eager strided indexing on a device array lowers to a 13-op
        # iota/multiply/gather chain — measured as ~40% of the whole pipeline's dispatches
        return jnp.nanmedian(a[::10, ::10])

    def uncert(seed):
        dem_r = examples.get_ref_dem()
        sig, rho = dem_r.estimate_uncertainty(
            examples.get_tba_dem(), stable_terrain=~examples.get_glacier_mask(),
            random_state=seed, subsample=10000,
        )
        return float(_decimate10(sig.data))

    t0 = time.perf_counter()
    uncert(42)
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    uncert(43)
    steady = time.perf_counter() - t0
    log(f"uncertainty pipeline 985x1332: first {first:.1f}s, steady {steady:.1f}s")
    # Dispatch-count probe: for small-shape pipelines the executable-launch count is a
    # latency model (each launch pays a fixed cost).
    disp = _dispatches(uncert, 44)
    log(f"uncertainty pipeline dispatches: {disp}")
    # Model: terrain 2 attrs (1 read + 2 writes) + sigma evaluation (2 reads + 1 write)
    row_u = _annot({"metric": "uncertainty_pipeline_985x1332_seconds",
                    "value": round(steady, 2), "unit": "s", "vs_baseline": None},
                   6 * n_px * 4, steady, bw)
    row_u["dispatches"] = disp
    rows.append(row_u)

    # Config 6: device hypsometric binning of a 4096^2 device-resident dDEM (VERDICT r2
    # task 6; the reference's host loop scans the raster once per bin)
    from xdem_tpu import volume

    nh = 4096
    ref_h = jnp.asarray(synthetic_dem(nh, seed=5))
    dh_h = jnp.asarray(synthetic_dem(nh, seed=6) * 0.01 - 5.0)

    def hypso():
        return volume.hypsometric_binning(dh_h, ref_h, bins=50.0)

    first, best = _timed(hypso, n=2)
    log(f"hypsometric binning {nh}^2 (device): first {first:.1f}s, steady {best:.2f}s")
    # Model: ids + two-key segment sort ~ 4 passes over (dh, z)
    rows.append(_annot({"metric": f"hypsometric_binning_{nh}x{nh}_seconds",
                 "value": round(best, 3), "unit": "s", "vs_baseline": None},
                 8 * nh * nh * 4, best, bw))

    return rows







def bench_10k(bw: float = 0.0) -> list[dict]:
    """The uncertainty pipeline at 10k^2 (1e8 px) on a device-resident synthetic pair."""
    from functools import partial

    import jax
    import jax.numpy as jnp

    from xdem_tpu.dem import DEM
    from xdem_tpu.georef import Affine as _Aff

    n10 = 10_000

    @partial(jax.jit, static_argnums=0)
    def synth_device(n, seed):
        # Device-side twin of synthetic_dem: the spectrum is synthesized at 4096^2 and
        # bilinearly upsampled, so the pair never crosses the host link.
        m = 4096
        fy = jnp.fft.fftfreq(m)[:, None]
        fx = jnp.fft.rfftfreq(m)[None, :]
        f = jnp.hypot(fx, fy).at[0, 0].set(1.0)
        amp = (f ** -2.7).at[0, 0].set(0.0)
        ph = jax.random.uniform(jax.random.PRNGKey(seed), amp.shape, minval=0.0,
                                maxval=2.0 * np.pi)
        z = jnp.fft.irfft2(amp * jnp.exp(1j * ph), s=(m, m)).astype(jnp.float32)
        z = jax.image.resize(z, (n, n), method="linear")
        return ((z - z.min()) / (z.max() - z.min()) * 1000.0).astype(jnp.float32)

    @partial(jax.jit, static_argnums=0)
    def synth_pair(n, seed_a, seed_b):
        za = synth_device(n, seed_a)
        return za, za + synth_device(n, seed_b) * 0.004

    z10, z10b = synth_pair(n10, 11, 12)
    dem10 = DEM.from_array(z10, transform=_Aff(20.0, 0.0, 4e5, 0.0, -20.0, 9e6), crs=32633)
    other10 = DEM.from_array(z10b, transform=dem10.transform, crs=dem10.crs)

    @jax.jit
    def _decimate100(a):
        return jnp.nanmedian(a[::100, ::100])

    def uncert10(seed):
        sig, rho = dem10.estimate_uncertainty(other10, random_state=seed, subsample=10000)
        return float(_decimate100(sig.data))

    t0 = time.perf_counter()
    uncert10(42)
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    uncert10(43)
    steady10 = time.perf_counter() - t0
    log(f"uncertainty pipeline 10000^2: first {first:.1f}s, steady {steady10:.1f}s")
    row10 = _annot({"metric": "uncertainty_pipeline_10000x10000_seconds",
                    "value": round(steady10, 2), "unit": "s", "vs_baseline": None},
                   6 * n10 * n10 * 4, steady10, bw)
    row10["times_what"] = (
        "second estimate_uncertainty(other10, subsample=10000) call wall time: terrain "
        "attrs + heteroscedasticity + variogram sampling/fit on the device-resident "
        "1e8-px pair + sigma-map median readback; EXCLUDES the synthetic-pair "
        "generation and all first-call compiles"
    )
    row10["first_call_seconds"] = round(first, 1)
    return [row10]


def bench_parity() -> list[dict]:
    """Accelerator value parity: each north-star kernel family computed on the default
    device AND on the host CPU backend, values compared (the correctness tests all run on
    the CPU, so the accelerator's numerics are otherwise unverified). Tolerances follow the reference's own oracle model (SURVEY 4.1):
    terrain <= 1e-3 x mean attribute magnitude, coreg shifts <= 1%, variogram <= 1e-3 rel."""
    import jax
    import jax.numpy as jnp

    rows: list[dict] = []
    cpu = jax.devices("cpu")[0]
    if jax.default_backend() == "cpu":
        raise RuntimeError("bench_parity compares an accelerator with the CPU backend, but "
                           "JAX's default backend is the CPU.")

    def row(name, rel, tol):
        ok = bool(np.isfinite(rel) and rel <= tol)
        log(f"parity {name}: max rel diff {rel:.2e} (tol {tol:g}) -> {'ok' if ok else 'FAIL'}")
        return {"metric": f"parity_{name}", "value": float(round(rel, 10)), "unit": "max_rel_diff",
                "vs_baseline": None, "parity": "ok" if ok else "FAIL", "tol": tol}

    from xdem_tpu.terrain.surfit import surface_attributes
    from xdem_tpu.terrain.window import fractal_roughness, windowed_indexes

    dem_np = synthetic_dem(512, seed=7)

    # --- terrain: Horn S/A/H + Florinsky curvatures + windowed + fractal ---
    def terrain_stack():
        a = surface_attributes(jnp.asarray(dem_np), RES,
                               attrs=("slope", "aspect", "hillshade", "max_curvature"),
                               surface_fit="Florinsky")
        b = windowed_indexes(jnp.asarray(dem_np), RES,
                             ("topographic_position_index", "roughness"), window_size=3)
        c = fractal_roughness(jnp.asarray(dem_np), window_size=13)
        return [np.asarray(x) for x in (a, b, c)]

    dev_vals = terrain_stack()
    with jax.default_device(cpu):
        cpu_vals = terrain_stack()
    rel = 0.0
    for d, c in zip(dev_vals, cpu_vals):
        scale = np.nanmean(np.abs(c)) or 1.0
        rel = max(rel, float(np.nanmax(np.abs(d - c)) / scale))
    rows.append(row("terrain_suite_512", rel, 1e-3))

    # --- coreg: NuthKaab shifts on the bundled pair (same shapes as bench_table: warm) ---
    from xdem_tpu import coreg, examples

    ref = examples.get_ref_dem()
    tba = examples.get_tba_dem()
    mask = ~examples.get_glacier_mask()

    def nk_shifts():
        c = coreg.NuthKaab()
        c.fit(ref, tba, inlier_mask=mask, random_state=42)
        o = c.meta["outputs"]["affine"]
        return np.array([o["shift_x"], o["shift_y"], o["shift_z"]])

    s_dev = nk_shifts()
    with jax.default_device(cpu):
        s_cpu = nk_shifts()
    rel = float(np.max(np.abs(s_dev - s_cpu) / np.maximum(np.abs(s_cpu), 1e-9)))
    rows.append(row("nuth_kaab_shifts", rel, 0.01))

    # --- uncertainty: variogram bins + sigma raster on the test crop ---
    r0, r1, c0, c1 = examples._TEST_ICROP
    ref_t = examples.get_ref_dem_test()
    tba_t = examples.get_tba_dem_test()
    mask_t = ~examples.get_glacier_mask()[r0:r1, c0:c1]

    def unc_vals():
        # subsample sized so binned-median quantization (~spread/n per element flip) sits
        # well under the 1e-3 tolerance — at n=200 a single order-statistic flip in the
        # standardization scale moves the whole sigma raster by ~1.4e-3
        sig, rho = ref_t.estimate_uncertainty(tba_t, stable_terrain=mask_t,
                                              subsample=3000, random_state=42)
        return np.asarray(sig.data), rho(np.array([20.0, 200.0, 2000.0]))

    sig_dev, rho_dev = unc_vals()
    with jax.default_device(cpu):
        sig_cpu, rho_cpu = unc_vals()
    # Binned-NMAD tables are order statistics of f32 values: a slope/curvature value within
    # f32 eps of a bin edge takes the neighboring bin on one backend, moving that table
    # entry (and the standardization scale) by O(1/bin_count) ~ 1e-3. The tolerance is set
    # above that structural quantization; real numeric drift (1e-2+) still fails hard.
    d = np.abs(sig_dev - sig_cpu) / (np.nanmean(np.abs(sig_cpu)) or 1.0)
    rel_sig = float(np.nanpercentile(d, 99.9))
    rel_sig_max = float(np.nanmax(d))
    r = row("uncertainty_sigma", rel_sig, 5e-3)
    if rel_sig_max > 1e-2:
        r["parity"] = "FAIL"
    r["max_rel_diff"] = round(rel_sig_max, 10)
    rows.append(r)
    rel_rho = float(np.max(np.abs(rho_dev - rho_cpu)))
    rows.append(row("uncertainty_rho", rel_rho, 5e-3))

    # --- ICP: registration params (translations m / rotations deg) on a synthetic pair.
    # Small config keeps the CPU leg cheap. nn_method="auto" resolves to the brute device
    # while_loop on the accelerator leg and the host KD-tree on the CPU leg, so this row
    # guards BOTH the cross-method agreement and the device solver's matmul precision (an
    # unpinned reduced-precision dot once mis-registered by ~8 m here —
    # ops.precision.pin_f32_matmuls).
    from xdem_tpu.coreg.base import translations_rotations_from_matrix
    from xdem_tpu.georef import Affine
    from xdem_tpu.raster import Raster

    n_icp = 512
    rst = Raster(synthetic_dem(n_icp, seed=9), Affine(20.0, 0.0, 5e5, 0.0, -20.0, 8.8e6), 32633)
    epc = rst.to_pointcloud(subsample=100_000, random_state=1).translate(12.0, -6.0, 2.0)

    def icp_params():
        c = coreg.ICP(subsample=20000)
        c.fit(rst, epc, random_state=42)
        return np.asarray(translations_rotations_from_matrix(c.to_matrix()), np.float64)

    p_dev = icp_params()
    with jax.default_device(cpu):
        p_cpu = icp_params()
    # Relative to the recovered shift magnitude (~(12, -6, 2) m), the reference's own 1%
    # synthetic-recovery criterion
    rel = float(np.max(np.abs(p_dev - p_cpu)) / max(np.max(np.abs(p_cpu[:3])), 1.0))
    rows.append(row("icp_params", rel, 0.01))

    # --- Blockwise: per-tile NuthKaab shifts (the vmapped one-dispatch fit). Compared by
    # per-axis MEDIAN over tiles: ill-posed tiles (flat / single-aspect crops of the
    # synthetic terrain) produce meter-scale backend-dependent solves that the downstream
    # RANSAC rejects, exactly like the reference's NaN-failed tiles — the robust aggregate
    # is the product-facing value. Diverged (beyond-tile-extent) solves are NaN-gated in
    # the class itself.
    def bw_shifts():
        b = coreg.BlockwiseNuthKaab(block_size_fit=256, subsample_per_tile=4000, random_state=7)
        b.fit(ref, tba)
        return np.stack([b.shifts_x, b.shifts_y, b.shifts_z])

    s_dev2 = bw_shifts()
    with jax.default_device(cpu):
        s_cpu2 = bw_shifts()
    med_dev = np.nanmedian(s_dev2, axis=1)
    med_cpu = np.nanmedian(s_cpu2, axis=1)
    rel = float(np.max(np.abs(med_dev - med_cpu)) / max(np.max(np.abs(med_cpu)), 1.0))
    rows.append(row("blockwise_tile_shifts", rel, 0.01))

    # --- Hypsometric binning: device segment-sort bin table ---
    from xdem_tpu import volume

    nh_p = 1024
    ref_h = synthetic_dem(nh_p, seed=5)
    dh_h = synthetic_dem(nh_p, seed=6) * 0.01 - 5.0

    def hypso_vals():
        df = volume.hypsometric_binning(jnp.asarray(dh_h), jnp.asarray(ref_h), bins=50.0)
        return df["value"].to_numpy(np.float64), df["count"].to_numpy(np.float64)

    v_dev, c_dev = hypso_vals()
    with jax.default_device(cpu):
        v_cpu, c_cpu = hypso_vals()
    # Identical segment-sort program on both backends; medians are exact order statistics
    # of the same f32 set, so only bin-edge f32 rounding is tolerated
    bothv = np.isfinite(v_cpu) & np.isfinite(v_dev)
    rel = (float(np.max(np.abs(v_dev[bothv] - v_cpu[bothv])) / (np.mean(np.abs(v_cpu[bothv])) or 1.0))
           if bothv.any() else np.inf)
    if not ((np.isnan(v_dev) == np.isnan(v_cpu)).all() and np.array_equal(c_dev, c_cpu)):
        rel = np.inf
    rows.append(row("hypsometric_bins", rel, 1e-4))
    return rows


def bench_extras() -> None:
    """Extra north-star measurements, printed to stderr."""
    import jax
    import jax.numpy as jnp

    from xdem_tpu.terrain.surfit import surface_attributes
    from xdem_tpu.terrain.window import fractal_roughness, windowed_indexes

    # Config 2: full terrain suite on 4k^2
    n = 4096
    dem = jnp.asarray(synthetic_dem(n, seed=1))
    sf_attrs = ("slope", "aspect", "hillshade", "profile_curvature", "tangential_curvature",
                "planform_curvature", "flowline_curvature", "max_curvature", "min_curvature")
    win_attrs = ("topographic_position_index", "terrain_ruggedness_index", "roughness", "rugosity")

    @jax.jit
    def full_suite(d):
        a = surface_attributes(d, RES, attrs=sf_attrs, surface_fit="Florinsky")
        b = windowed_indexes(d, RES, win_attrs, window_size=3)
        c = fractal_roughness(d, window_size=13)
        return a[0, 50, 50] + b[0, 60, 60] + c[70, 70]

    t0 = time.perf_counter()
    _ = float(full_suite(dem))
    log(f"full terrain suite 4096^2 (14 attrs): first call {time.perf_counter() - t0:.1f}s")
    times = []
    for i in range(3):
        d = dem + np.float32(i)
        jax.block_until_ready(d)
        t0 = time.perf_counter()
        _ = float(full_suite(d))
        times.append(time.perf_counter() - t0)
    best = min(times)
    log(f"full terrain suite 4096^2: {best*1000:.0f} ms -> {n*n/best/1e6:.0f} Mcells/s")

    # Config 3: NuthKaab steady-state (compile excluded by re-fitting with fresh data)
    from xdem_tpu import coreg, examples

    ref = examples.get_ref_dem()
    tba = examples.get_tba_dem()
    mask = ~examples.get_glacier_mask()
    nk = coreg.NuthKaab()
    t0 = time.perf_counter()
    nk.fit(ref, tba, inlier_mask=mask, random_state=42)
    log(f"NuthKaab fit (incl. compile): {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    nk2 = coreg.NuthKaab()
    nk2.fit(ref, tba, inlier_mask=mask, random_state=43)
    log(f"NuthKaab fit (steady-state): {time.perf_counter() - t0:.2f}s "
        f"(shifts {nk2.meta['outputs']['affine']})")


if __name__ == "__main__":
    main()
    if os.environ.get("BENCH_EXTRAS"):
        bench_extras()
