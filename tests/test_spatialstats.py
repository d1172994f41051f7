"""Spatial statistics tests: binning, heteroscedasticity, variograms, n_eff, patches.

Mirrors the reference's statistical test strategy (tests/test_spatialstats.py): estimator
behavior verified on simulated fields with known properties.
"""

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
from scipy import ndimage

from xdem_tpu import spatialstats as ss


def _gaussian_field(shape=(200, 200), smooth_px=5.0, sigma=2.0, seed=0):
    """White noise smoothed by a Gaussian kernel: known Gaussian covariance with
    effective skgstat 'range' r = 4 * smooth_px * gsd and sill sigma^2."""
    rng = np.random.default_rng(seed)
    white = rng.normal(size=shape)
    f = ndimage.gaussian_filter(white, smooth_px)
    f = f / f.std() * sigma
    return f.astype(np.float64)


class TestNdBinning:
    def test_1d_median(self, rng):
        vals = rng.normal(size=2000)
        var = rng.uniform(0, 10, 2000)
        df = ss.nd_binning(vals, [var], ["v"], list_var_bins=5)
        assert len(df[df["nd"] == 1]) == 5
        # Manual check of one bin
        row = df[df["nd"] == 1].iloc[2]
        iv = row["v"]
        sel = (var >= iv.left) & (var < iv.right)
        assert row["count"] == sel.sum()
        assert row["nanmedian"] == pytest.approx(np.median(vals[sel]), abs=1e-10)

    def test_2d_combinations(self, rng):
        vals = rng.normal(size=3000)
        v1 = rng.uniform(0, 1, 3000)
        v2 = rng.uniform(0, 1, 3000)
        v3 = rng.uniform(0, 1, 3000)
        df = ss.nd_binning(vals, [v1, v2, v3], ["a", "b", "c"], list_var_bins=3)
        # 3x 1-D + 3x 2-D + 1x 3-D
        assert set(df["nd"].unique()) == {1, 2, 3}
        assert len(df[df["nd"] == 3]) == 27

    def test_nan_values_excluded(self):
        vals = np.array([1.0, np.nan, 3.0, 5.0])
        var = np.array([0.1, 0.2, 0.3, np.nan])
        df = ss.nd_binning(vals, [var], ["v"], list_var_bins=1)
        assert df.iloc[0]["count"] == 2


class TestInterpNdBinning:
    def test_linear_interp_1d(self, rng):
        vals = rng.normal(size=5000)
        var = rng.uniform(0, 10, 5000)
        vals = vals * (1 + var)  # spread grows linearly with var
        df = ss.nd_binning(vals, [var], ["v"], list_var_bins=10)
        fn = ss.interp_nd_binning(df, "v", statistic="nmad" if "nmad" in df.columns else ss._stat_nmad,
                                  min_count=10)
        # At bin midpoints the interpolator should match the binned statistic
        sub = df[df["nd"] == 1]
        mids = np.array([iv.mid for iv in sub["v"]])
        got = fn(mids)
        want = sub[ss._stat_nmad.__name__].values
        ok = np.isfinite(want)
        assert np.allclose(got[ok], want[ok], rtol=1e-6)

    def test_extrapolation_nearest(self, rng):
        vals = rng.normal(size=3000)
        var = rng.uniform(2, 8, 3000)
        df = ss.nd_binning(vals, [var], ["v"], list_var_bins=6)
        fn = ss.interp_nd_binning(df, "v", min_count=10)
        # Outside the hull: propagates edge values, no NaN
        assert np.isfinite(fn(np.array([-100.0]))[0])
        assert np.isfinite(fn(np.array([1000.0]))[0])


class TestHeteroscedasticity:
    def test_recover_linear_error_model(self, rng):
        n = 400
        var = np.tile(np.linspace(0, 10, n), (n, 1))
        sigma_true = 0.5 + 0.3 * var
        dh = rng.normal(size=(n, n)) * sigma_true
        err, df, err_fun = ss.infer_heteroscedasticity_from_stable(dh, [var], list_var_names=["v"])
        # Error function approximates the true sigma within 15% in the mid-range
        test_v = np.array([2.0, 5.0, 8.0])
        got = err_fun(test_v)
        want = 0.5 + 0.3 * test_v
        assert np.allclose(got, want, rtol=0.15)

    def test_two_step_standardization(self, rng):
        var = rng.uniform(0, 10, 50000)
        sigma_true = 1 + var
        dh = rng.normal(size=50000) * sigma_true
        z, err_fun = ss.two_step_standardization(dh, [var], lambda v: 1 + v)
        assert ss._stat_nmad(z) == pytest.approx(1.0, abs=0.01)


class TestVariogramModels:
    @pytest.mark.parametrize("model", ["spherical", "gaussian", "exponential", "cubic", "stable"])
    def test_model_limits(self, model):
        params = pd.DataFrame({"model": [model], "range": [100.0], "psill": [2.0], "smooth": [1.5]})
        gamma = ss.get_variogram_model_func(params)
        assert gamma(np.array([0.0]))[0] == pytest.approx(0.0, abs=1e-8)
        assert gamma(np.array([1e6]))[0] == pytest.approx(2.0, rel=1e-3)
        rho = ss.correlation_from_variogram(params)
        assert rho(np.array([0.0]))[0] == pytest.approx(1.0)
        assert rho(np.array([1e6]))[0] == pytest.approx(0.0, abs=1e-3)

    def test_sum_of_models(self):
        params = pd.DataFrame({"model": ["gaussian", "spherical"], "range": [10.0, 100.0],
                               "psill": [1.0, 3.0]})
        gamma = ss.get_variogram_model_func(params)
        assert gamma(np.array([1e6]))[0] == pytest.approx(4.0, rel=1e-3)

    def test_invalid_model_raises(self):
        params = pd.DataFrame({"model": ["bogus"], "range": [1.0], "psill": [1.0]})
        with pytest.raises(ValueError, match="not recognized"):
            ss.get_variogram_model_func(params)


class TestEmpiricalVariogram:
    def test_recover_gaussian_range(self):
        gsd = 10.0
        smooth_px = 5.0
        sigma = 2.0
        field = _gaussian_field(shape=(300, 300), smooth_px=smooth_px, sigma=sigma, seed=1)
        df = ss.sample_empirical_variogram(field, gsd=gsd, subsample=2000, random_state=42,
                                           estimator="dowd", n_variograms=2)
        assert {"exp", "lags", "count", "err_exp"} <= set(df.columns)
        _, params = ss.fit_sum_model_variogram(["gaussian"], df)
        # Rule-of-thumb effective range r ~ 4 * smooth_px * gsd = 200 m; the weighted fit on
        # this small (300 px) field systematically lands ~25% high (range 235-290 across
        # seeds for both sampling implementations), so bracket rather than center on 200.
        assert 120 < params["range"].iloc[0] < 330
        assert params["psill"].iloc[0] == pytest.approx(sigma**2, rel=0.35)

    @pytest.mark.parametrize("estimator", ["matheron", "cressie", "dowd"])
    def test_chunked_grid_variogram_matches_flat(self, estimator):
        """The memory-bounded scan path (used above ~2e8 pairs, where the flat sort needs
        ~4 GB of device memory) must reproduce the one-dispatch result exactly, incl. the radix-selected
        global Dowd median."""
        import jax.numpy as jnp

        from xdem_tpu.spatialstats import (_grid_variogram_device,
                                           _grid_variogram_device_chunked)

        rng = np.random.default_rng(1)
        arr = jnp.asarray(rng.normal(0, 5, (150, 220)).astype(np.float32))
        R, N, M = 9, 13, 40
        ija = np.stack([rng.integers(0, 150, (R, N)), rng.integers(0, 220, (R, N))], axis=-1)
        ijb = np.stack([rng.integers(0, 150, (R, M)), rng.integers(0, 220, (R, M))], axis=-1)
        ija[2, 5:] = -1
        ijb[7, 30:] = -1
        edges = jnp.asarray([0.0, 40.0, 110.0, 280.0, 700.0], jnp.float32)
        g1, c1 = _grid_variogram_device(arr, jnp.asarray(ija, jnp.int32),
                                        jnp.asarray(ijb, jnp.int32), jnp.float32(10.0),
                                        edges, estimator, 4)
        for chunk in (2, 9):
            pad = (-R) % chunk
            ija_p = np.pad(ija, ((0, pad), (0, 0), (0, 0)), constant_values=-1)
            ijb_p = np.pad(ijb, ((0, pad), (0, 0), (0, 0)), constant_values=-1)
            g2, c2 = _grid_variogram_device_chunked(
                arr, jnp.asarray(ija_p, jnp.int32), jnp.asarray(ijb_p, jnp.int32),
                jnp.float32(10.0), edges, estimator, 4, chunk)
            np.testing.assert_array_equal(np.asarray(c1), np.asarray(c2))
            np.testing.assert_allclose(np.asarray(g2), np.asarray(g1), rtol=1e-5, equal_nan=True)

    def test_dowd_sort_counts_match_bincount(self):
        """Dowd's per-bin counts come from the sorted bin keys (jnp.bincount is a costly
        scatter at 5e7 pairs); they must equal matheron's bincount counts exactly,
        including empty bins and the all-invalid case."""
        import jax.numpy as jnp

        from xdem_tpu.spatialstats import _binned_pair_estimator

        rng = np.random.default_rng(7)
        diffs = jnp.asarray(rng.normal(0, 2, (6, 11, 13)), jnp.float32)
        # Distances concentrated so that some bins are empty
        dists = jnp.asarray(rng.uniform(5.0, 40.0, (6, 11, 13)), jnp.float32)
        edges = np.array([0.0, 10.0, 50.0, 60.0, 70.0, 500.0])  # bins 2-4 mostly empty
        g_d, c_d = _binned_pair_estimator(diffs, dists, edges, "dowd")
        g_m, c_m = _binned_pair_estimator(diffs, dists, edges, "matheron")
        np.testing.assert_array_equal(np.asarray(c_d), np.asarray(c_m))
        assert (np.asarray(c_d) > 0).any() and (np.asarray(c_d) == 0).any()
        assert np.isnan(np.asarray(g_d)[np.asarray(c_d) == 0]).all()
        # all pairs invalid -> zero counts, NaN gammas
        g0, c0 = _binned_pair_estimator(jnp.full((2, 3, 4), jnp.nan), dists[:2, :3, :4],
                                        edges, "dowd")
        assert (np.asarray(c0) == 0).all() and np.isnan(np.asarray(g0)).all()

    def test_device_mask_of_passthrough_and_packing(self):
        """_device_mask_of: device bools pass through; host masks coerce + upload packed;
        None stays None (the uncertainty pipeline uploads the stable mask once)."""
        import jax
        import jax.numpy as jnp

        from xdem_tpu.spatialstats import _device_mask_of

        assert _device_mask_of(None) is None
        m_np = np.zeros((37, 53), bool)
        m_np[5:20, 7:40] = True
        out = _device_mask_of(m_np)
        assert isinstance(out, jax.Array) and out.dtype == bool
        np.testing.assert_array_equal(np.asarray(out), m_np)
        dev = jnp.asarray(m_np)
        assert _device_mask_of(dev) is dev or np.array_equal(np.asarray(_device_mask_of(dev)), m_np)
        # masked bool arrays: masked slots are excluded (False)
        mm = np.ma.MaskedArray(np.ones((4, 4), bool), mask=np.eye(4, dtype=bool))
        np.testing.assert_array_equal(np.asarray(_device_mask_of(mm)),
                                      np.ones((4, 4), bool) & ~np.eye(4, dtype=bool))

    @pytest.mark.parametrize("estimator", ["matheron", "cressie", "dowd"])
    def test_chunked_pairs_variogram_matches_flat(self, estimator):
        """Same memory-bounded reduction for the non-grid (point-cloud) path."""
        import jax.numpy as jnp

        from xdem_tpu.spatialstats import (_binned_pair_estimator,
                                           _pairs_variogram_device_chunked)

        rng = np.random.default_rng(2)
        R, N, M = 8, 15, 44
        za = rng.normal(0, 3, (R, N)); zb = rng.normal(0, 3, (R, M))
        ca = rng.uniform(0, 500, (R, N, 2)); cb = rng.uniform(0, 500, (R, M, 2))
        za[3, 8:] = np.nan
        cb[5, 30:] = np.nan
        edges = np.array([0.0, 80.0, 200.0, 450.0, 900.0])
        diffs = jnp.asarray(za, jnp.float32)[:, :, None] - jnp.asarray(zb, jnp.float32)[:, None, :]
        dists = jnp.sqrt(jnp.sum((jnp.asarray(ca, jnp.float32)[:, :, None, :]
                                  - jnp.asarray(cb, jnp.float32)[:, None, :, :]) ** 2, axis=-1))
        dists = jnp.where(dists <= 0, jnp.nan, dists)
        g1, c1 = _binned_pair_estimator(diffs, dists, edges, estimator)
        chunk = 3
        pad = (-R) % chunk

        def pn(a):
            return np.pad(a, ((0, pad),) + ((0, 0),) * (a.ndim - 1), constant_values=np.nan)

        g2, c2 = _pairs_variogram_device_chunked(
            jnp.asarray(pn(za), jnp.float32), jnp.asarray(pn(zb), jnp.float32),
            jnp.asarray(pn(ca), jnp.float32), jnp.asarray(pn(cb), jnp.float32),
            jnp.asarray(edges, jnp.float32), estimator, 4, chunk)
        np.testing.assert_array_equal(np.asarray(c1), np.asarray(c2))
        np.testing.assert_allclose(np.asarray(g2), g1, rtol=1e-5, equal_nan=True)

    @pytest.mark.parametrize("estimator", ["matheron", "cressie", "dowd", "genton"])
    def test_chunked_route_end_to_end(self, monkeypatch, estimator):
        """Force the big-pair chunked dispatch through the public API by shrinking the
        budget: the count-identical sampling must yield the same variogram (genton swaps
        its rng bin subsample for the deterministic reservoir, so it is compared on
        plausibility instead of equality)."""
        import xdem_tpu.spatialstats as ss_mod

        field = _gaussian_field(shape=(150, 150), smooth_px=3.0, sigma=2.0, seed=5)
        kwargs = dict(gsd=10.0, subsample=700, random_state=42, estimator=estimator)
        flat = ss_mod.sample_empirical_variogram(field, **kwargs)
        monkeypatch.setattr(ss_mod, "_PAIR_CHUNK_BUDGET", 5_000)
        chunked = ss_mod.sample_empirical_variogram(field, **kwargs)
        np.testing.assert_array_equal(chunked["count"].values, flat["count"].values)
        if estimator == "genton":
            ok = np.isfinite(flat["exp"].values) & np.isfinite(chunked["exp"].values)
            ratio = chunked["exp"].values[ok] / np.maximum(flat["exp"].values[ok], 1e-12)
            assert np.median(ratio) == pytest.approx(1.0, rel=0.5)
        else:
            np.testing.assert_allclose(chunked["exp"].values, flat["exp"].values,
                                       rtol=1e-4, equal_nan=True)

    def test_chunked_genton_matches_distributed(self):
        """The chunked Genton reservoir ranks pairs by the same deterministic global-index
        scores as the distributed version, so any chunking selects the identical 400-value
        sample and the identical Qn."""
        import jax.numpy as jnp

        from xdem_tpu.parallel import make_mesh
        from xdem_tpu.parallel.variogram import sharded_variogram_bins
        from xdem_tpu.spatialstats import (_genton_qn_from_reservoir,
                                           _pairs_genton_reservoir_chunked)

        rng = np.random.default_rng(3)
        R, N, M = 8, 20, 60
        za = rng.normal(0, 2, (R, N)); zb = rng.normal(0, 2, (R, M))
        ca = rng.uniform(0, 800, (R, N, 2)); cb = rng.uniform(0, 800, (R, M, 2))
        za[2, 10:] = np.nan
        edges = [0.0, 100.0, 300.0, 700.0, 1500.0]
        g_ref, c_ref = sharded_variogram_bins(za, zb, ca, cb, edges, make_mesh(1),
                                              estimator="genton")
        for chunk in (2, 8):
            pad = (-R) % chunk

            def pn(a):
                return np.pad(a, ((0, pad),) + ((0, 0),) * (a.ndim - 1),
                              constant_values=np.nan)

            res, cnt = _pairs_genton_reservoir_chunked(
                jnp.asarray(pn(za), jnp.float32), jnp.asarray(pn(zb), jnp.float32),
                jnp.asarray(pn(ca), jnp.float32), jnp.asarray(pn(cb), jnp.float32),
                jnp.asarray(edges, jnp.float32), 4, chunk)
            g = _genton_qn_from_reservoir(np.asarray(res, np.float64), np.asarray(cnt))
            np.testing.assert_array_equal(np.asarray(cnt), c_ref)
            np.testing.assert_allclose(g, g_ref, rtol=1e-5, equal_nan=True)

    @pytest.mark.parametrize("estimator", ["matheron", "dowd", "cressie", "genton"])
    def test_estimators_on_white_noise(self, estimator):
        # White noise: variogram flat at sill = variance for all lags
        rng = np.random.default_rng(3)
        field = rng.normal(0, 1.5, size=(150, 150))
        df = ss.sample_empirical_variogram(field, gsd=1.0, subsample=1500, random_state=42,
                                           estimator=estimator)
        valid = df[df["count"] > 200]
        assert np.nanmedian(valid["exp"]) == pytest.approx(1.5**2, rel=0.2)

    @pytest.mark.parametrize("method", ["pdist_point", "cdist_point", "pdist_disk", "pdist_ring"])
    def test_other_subsample_methods(self, method):
        field = _gaussian_field(shape=(150, 150), smooth_px=3, sigma=1.0, seed=2)
        df = ss.sample_empirical_variogram(field, gsd=10.0, subsample=500, random_state=42,
                                           subsample_method=method)
        assert len(df) > 3
        assert df["count"].sum() > 100

    def test_speed_budget(self):
        # Completes within a sane budget (analog of the reference's speed test)
        import time

        field = _gaussian_field(shape=(500, 500), smooth_px=4, sigma=1.0, seed=5)
        t0 = time.time()
        ss.sample_empirical_variogram(field, gsd=10.0, subsample=2000, random_state=42)
        assert time.time() - t0 < 60


class TestNeff:
    @pytest.fixture(scope="class")
    def params(self):
        return pd.DataFrame({"model": ["spherical"], "range": [100.0], "psill": [1.0]})

    def test_theoretical_vs_numerical(self, params):
        for area in [1e4, 1e6, 1e8]:
            t = ss.neff_circular_approx_theoretical(area, params)
            n = ss.neff_circular_approx_numerical(area, params)
            assert n == pytest.approx(t, rel=1e-3)

    def test_exact_vs_hugonnet(self, params):
        rng = np.random.default_rng(0)
        coords = rng.uniform(0, 500, size=(400, 2))
        errors = np.ones(400)
        exact = ss.neff_exact(coords, errors, params)
        approx = ss.neff_hugonnet_approx(coords, errors, params, subsample=300, random_state=42)
        assert approx == pytest.approx(exact, rel=0.1)

    def test_uncorrelated_limit(self):
        # Tiny range: all samples independent -> neff ~ N
        params = pd.DataFrame({"model": ["spherical"], "range": [1e-6], "psill": [1.0]})
        rng = np.random.default_rng(1)
        coords = rng.uniform(0, 1000, size=(300, 2))
        errors = np.ones(300)
        assert ss.neff_exact(coords, errors, params) == pytest.approx(300, rel=0.01)

    def test_number_effective_samples_vector_large(self, params):
        """Vector-area n_eff at >=1e5 rasterized cells: the chunked kernels must not
        materialize an N x M distance matrix (VERDICT r1, weak #3)."""
        from xdem_tpu.vector import Vector

        # 7 x 7 km square in a projected CRS -> at 20 m rasterization: 350^2 = 122 500 cells
        ring = np.array([[0.0, 0.0], [7000.0, 0.0], [7000.0, 7000.0], [0.0, 7000.0], [0.0, 0.0]])
        area = Vector([[ring]], crs=32633)
        n = ss.number_effective_samples(
            area, params, rasterize_resolution=20.0, subsample=500, random_state=42
        )
        assert np.isfinite(n) and n > 1
        # Cross-check against the circular approximation on the same area (loose: shape differs)
        n_circ = ss.number_effective_samples(7000.0 * 7000.0, params)
        assert n == pytest.approx(n_circ, rel=0.5)

    def test_neff_chunked_equals_unchunked(self, params):
        """Forcing a tiny chunk must reproduce the single-block result exactly-ish."""
        rng = np.random.default_rng(11)
        coords = rng.uniform(0, 500, (700, 2))
        errors = rng.uniform(0.5, 2.0, 700)
        big = ss._chunked_weighted_rho_sum(coords, errors, coords, errors, params,
                                           target_elems=1 << 30)
        small = ss._chunked_weighted_rho_sum(coords, errors, coords, errors, params,
                                             target_elems=64 * 700)
        assert small == pytest.approx(big, rel=1e-5)

    def test_number_effective_samples_numeric(self, params):
        n = ss.number_effective_samples(1e6, params)
        assert n > 1


class TestPatches:
    def test_white_noise_se(self):
        # White noise sigma: spread of patch means ~ sigma / sqrt(pixels per patch)
        rng = np.random.default_rng(7)
        sigma = 3.0
        gsd = 10.0
        field = rng.normal(0, sigma, size=(500, 500))
        area = (10 * gsd) ** 2  # 10x10-pixel patches
        stat, nb = ss.patches_method(field, gsd=gsd, area=area)
        assert nb > 100
        assert stat == pytest.approx(sigma / 10, rel=0.25)

    def test_loop_variant(self):
        rng = np.random.default_rng(8)
        field = rng.normal(0, 1, size=(200, 200))
        df = ss.patches_method(field, gsd=10.0, area=(50 * 10.0) ** 2 / 25, vectorized=False,
                               n_patches=50, random_state=42)
        assert isinstance(df, pd.DataFrame)
        assert len(df) > 5


class TestConvolutionUtils:
    def test_convolution_vs_scipy(self, rng):
        from scipy.ndimage import convolve

        img = rng.normal(size=(60, 70)).astype(np.float32)
        kern = rng.normal(size=(5, 5)).astype(np.float32)
        ours = ss.convolution(img[None], kern[None])[0, 0]
        want = convolve(img.astype(np.float64), kern.astype(np.float64), mode="constant")
        interior = np.s_[3:-3, 3:-3]
        assert np.allclose(ours[interior], want[interior], atol=1e-3)

    def test_mean_filter_nan(self, rng):
        img = rng.normal(size=(50, 50))
        img[10, 10] = np.nan
        mean, counts, nb = ss.mean_filter_nan(img, 5, kernel_shape="square")
        assert nb == 25
        assert np.isfinite(mean[10, 10])  # NaN-aware: uses the 24 valid neighbors
        assert counts[10, 10] == 24


class TestUncertaintyPipeline:
    def test_estimate_uncertainty_end_to_end(self):
        from xdem_tpu import examples

        ref = examples.get_ref_dem().icrop((100, 400), (200, 500))
        tba = examples.get_tba_dem().icrop((100, 400), (200, 500))
        mask = examples.get_glacier_mask()[100:400, 200:500]
        sig, rho = ref.estimate_uncertainty(tba, stable_terrain=~mask, random_state=42,
                                            subsample=300)
        arr = np.asarray(sig.data)
        assert np.isfinite(arr).mean() > 0.9
        assert np.nanmedian(arr) > 0  # positive errors
        assert rho(np.array([0.0]))[0] == pytest.approx(1.0)
        assert rho(np.array([1e7]))[0] == pytest.approx(0.0, abs=0.05)


class TestPlotting:
    def test_plot_variogram(self, tmp_path):
        field = _gaussian_field(shape=(100, 100), smooth_px=3, sigma=1.0, seed=9)
        df = ss.sample_empirical_variogram(field, gsd=10.0, subsample=400, random_state=42)
        fn, params = ss.fit_sum_model_variogram(["spherical"], df)
        out = str(tmp_path / "vario.png")
        ss.plot_variogram(df, list_fit_fun=[fn], out_fname=out)
        import os

        assert os.path.getsize(out) > 5000

    def test_plot_binnings(self, tmp_path, rng):
        vals = rng.normal(size=3000)
        v1 = rng.uniform(0, 10, 3000)
        v2 = rng.uniform(0, 5, 3000)
        df = ss.nd_binning(vals, [v1, v2], ["a", "b"], list_var_bins=6)
        out1 = str(tmp_path / "b1.png")
        out2 = str(tmp_path / "b2.png")
        ss.plot_1d_binning(df, "a", "nanmedian", min_count=5, out_fname=out1)
        ss.plot_2d_binning(df, "a", "b", "nanmedian", min_count=5, out_fname=out2)
        import os

        assert os.path.getsize(out1) > 5000 and os.path.getsize(out2) > 5000


class TestShardedVariogram:
    def test_sharded_matches_single_device(self):
        """Sharded matheron bins over an 8-device mesh equal the single-device computation."""
        import jax
        from jax.sharding import Mesh

        from xdem_tpu.parallel.variogram import sharded_variogram_bins
        from xdem_tpu.spatialstats import _binned_pair_estimator
        import jax.numpy as jnp

        rng = np.random.default_rng(11)
        R, N, M = 16, 40, 80
        za = rng.normal(0, 1.5, (R, N)).astype(np.float32)
        zb = rng.normal(0, 1.5, (R, M)).astype(np.float32)
        ca = rng.uniform(0, 1000, (R, N, 2)).astype(np.float32)
        cb = rng.uniform(0, 1000, (R, M, 2)).astype(np.float32)
        edges = [0.0, 50.0, 150.0, 400.0, 800.0, 1500.0]

        mesh = Mesh(np.asarray(jax.devices()[:8]), axis_names=("p",))
        g_sharded, c_sharded = sharded_variogram_bins(za, zb, ca, cb, edges, mesh, estimator="matheron")

        diffs = jnp.asarray(za)[:, :, None] - jnp.asarray(zb)[:, None, :]
        dists = jnp.sqrt(jnp.sum((jnp.asarray(ca)[:, :, None, :] - jnp.asarray(cb)[:, None, :, :]) ** 2, axis=-1))
        dists = jnp.where(dists <= 0, jnp.nan, dists)
        g_single, c_single = _binned_pair_estimator(diffs, dists, np.asarray(edges), "matheron")

        assert (c_sharded == c_single).all()
        both = np.isfinite(g_sharded) & np.isfinite(g_single)
        assert np.allclose(g_sharded[both], g_single[both], rtol=1e-5)

    def test_sharded_dowd_exact(self):
        """Sharded dowd equals the single-device global estimator EXACTLY: the per-bin median
        is computed by distributed bit-space selection, not by aggregating shard medians."""
        import jax
        from jax.sharding import Mesh

        from xdem_tpu.parallel.variogram import sharded_variogram_bins

        rng = np.random.default_rng(12)
        R, N, M = 8, 60, 120
        sigma = 2.0
        za = rng.normal(0, sigma, (R, N)).astype(np.float32)
        zb = rng.normal(0, sigma, (R, M)).astype(np.float32)
        ca = rng.uniform(0, 1000, (R, N, 2)).astype(np.float32)
        cb = rng.uniform(0, 1000, (R, M, 2)).astype(np.float32)
        edges = [0.0, 400.0, 900.0, 1500.0]
        mesh = Mesh(np.asarray(jax.devices()[:8]), axis_names=("p",))
        mesh1 = Mesh(np.asarray(jax.devices()[:1]), axis_names=("p",))
        gamma, counts = sharded_variogram_bins(za, zb, ca, cb, edges, mesh, estimator="dowd")
        gamma1, counts1 = sharded_variogram_bins(za, zb, ca, cb, edges, mesh1, estimator="dowd")
        np.testing.assert_array_equal(counts, counts1)
        np.testing.assert_allclose(gamma, gamma1, rtol=1e-7)

        # And against a numpy oracle: global median of |diffs| per lag bin
        diffs = np.abs(za[:, :, None] - zb[:, None, :]).ravel()
        dists = np.sqrt(((ca[:, :, None, :] - cb[:, None, :, :]) ** 2).sum(-1)).ravel()
        for b in range(3):
            sel = (dists > edges[b]) & (dists <= edges[b + 1]) if b else (
                (dists >= edges[0]) & (dists <= edges[1]) & (dists > 0))
            sel = (dists > 0) & (dists >= edges[b]) & (dists <= edges[-1])
            idx = np.clip(np.searchsorted(edges, dists[sel], side="right") - 1, 0, 2)
            vals = diffs[sel][idx == b]
            med = np.median(np.asarray(vals, np.float64))
            assert gamma[b] == pytest.approx(2.198 * med**2 / 2, rel=1e-6)

        # White noise sanity: gamma ~= sigma^2 in every well-populated bin
        ok = counts > 500
        assert np.allclose(gamma[ok], sigma**2, rtol=0.2)


class TestUncertaintyApproaches:
    @pytest.mark.parametrize("approach", ["R2009", "Basic"])
    def test_other_approaches(self, approach):
        from xdem_tpu import examples

        ref = examples.get_ref_dem().icrop((100, 300), (200, 400))
        tba = examples.get_tba_dem().icrop((100, 300), (200, 400))
        mask = ~examples.get_glacier_mask()[100:300, 200:400]
        # Basic is single-range: pass one model (several would warn, reference dem.py:762)
        models = ("gaussian", "spherical") if approach == "R2009" else ("spherical",)
        sig, rho = ref.estimate_uncertainty(tba, stable_terrain=mask, approach=approach,
                                            list_vario_models=models,
                                            random_state=42, subsample=300)
        arr = np.asarray(sig.data)
        # Constant-error approaches: a single positive sigma everywhere
        assert np.nanstd(arr) < 1e-6
        assert np.nanmean(arr) > 0
        assert rho(np.array([0.0]))[0] == pytest.approx(1.0)

    def test_same_precision_pair(self):
        from xdem_tpu import examples

        ref = examples.get_ref_dem().icrop((100, 300), (200, 400))
        tba = examples.get_tba_dem().icrop((100, 300), (200, 400))
        mask = ~examples.get_glacier_mask()[100:300, 200:400]
        sig_f, _ = ref.estimate_uncertainty(tba, stable_terrain=mask, approach="Basic",
                                            list_vario_models=("spherical",),
                                            precision_of_other="finer", random_state=42, subsample=300)
        sig_s, _ = ref.estimate_uncertainty(tba, stable_terrain=mask, approach="Basic",
                                            list_vario_models=("spherical",),
                                            precision_of_other="same", random_state=42, subsample=300)
        ratio = np.nanmean(np.asarray(sig_f.data)) / np.nanmean(np.asarray(sig_s.data))
        assert ratio == pytest.approx(np.sqrt(2), rel=1e-3)


class TestInterpNdBinning3D:
    def test_three_variable_interpolation(self):
        """N-D (3-var) interp_nd_binning: exact at bin centers of a separable function,
        linear in between, edge-propagating outside the hull (reference :237 semantics)."""
        rng = np.random.default_rng(21)
        n = 60000
        v1 = rng.uniform(0, 10, n)
        v2 = rng.uniform(-4, 4, n)
        v3 = rng.uniform(100, 200, n)
        vals = 2.0 * v1 + np.abs(v2) + 0.05 * (v3 - 100)
        df = ss.nd_binning(vals, [v1, v2, v3], ["a", "b", "c"], list_var_bins=[5, 4, 5],
                           statistics=("count", np.nanmedian))
        f = ss.interp_nd_binning(df, ["a", "b", "c"], statistic="nanmedian", min_count=10)
        # At interior bin centers the median of the (nearly linear) function is close to the
        # function of the center
        q1, q2, q3 = 5.0, 2.0, 150.0
        expect = 2.0 * q1 + abs(q2) + 0.05 * (q3 - 100)
        assert float(f((q1, q2, q3))) == pytest.approx(expect, abs=0.35)
        # Extrapolation: clamps to edge values (monotone, finite)
        far = float(f((50.0, 0.0, 150.0)))
        edge = float(f((9.0, 0.0, 150.0)))
        assert np.isfinite(far) and far == pytest.approx(edge, abs=1.5)
        # Vectorized query shape
        qs = (rng.uniform(0, 10, 7), rng.uniform(-4, 4, 7), rng.uniform(100, 200, 7))
        assert np.asarray(f(qs)).shape == (7,)
        assert np.isfinite(np.asarray(f(qs))).all()


class TestHeteroscedasticityDevicePath:
    def test_device_path_matches_host_path(self):
        """The device-resident fast path (top_k subsample + device sigma interpolation) must
        agree with the host path (np choice + scipy RGI) on the same Raster inputs."""
        from xdem_tpu.georef import Affine
        from xdem_tpu.raster import Raster

        rng = np.random.default_rng(9)
        n = 300
        slope = np.tile(np.linspace(0, 20, n), (n, 1)).astype(np.float32)
        sigma_true = 0.4 + 0.08 * slope
        dh = (rng.normal(size=(n, n)) * sigma_true).astype(np.float32)
        t = Affine(20.0, 0, 0, 0, -20.0, n * 20.0)
        dh_r = Raster(dh, t, 32633)
        slope_r = Raster(slope, t, 32633)

        # Device path (Raster inputs + subsample)
        sig_dev, _, fun_dev = ss.infer_heteroscedasticity_from_stable(
            dh_r, [slope_r], list_var_names=["slope"], subsample=60000, random_state=42
        )
        # Host path (plain arrays)
        sig_host, _, fun_host = ss.infer_heteroscedasticity_from_stable(
            dh, [slope.astype(np.float64)], list_var_names=["slope"],
            subsample=60000, random_state=42,
        )
        q = np.array([3.0, 10.0, 17.0])
        np.testing.assert_allclose(fun_dev(q), fun_host(q), rtol=0.1)
        np.testing.assert_allclose(fun_dev(q), 0.4 + 0.08 * q, rtol=0.15)
        # Device sigma raster == device error function evaluated over the grid
        d = np.asarray(sig_dev.data)
        h = fun_dev(slope)
        both = np.isfinite(d) & np.isfinite(h)
        np.testing.assert_allclose(d[both], h[both], rtol=5e-3, atol=5e-3)


class TestShardedGenton:
    def test_sharded_genton_mesh_invariant(self):
        """Genton on 8 devices equals 1 device exactly: the 400-sample reservoir is selected
        by deterministic global-index scores, so any mesh picks the identical sample."""
        import jax
        from jax.sharding import Mesh

        from xdem_tpu.parallel.variogram import sharded_variogram_bins

        rng = np.random.default_rng(14)
        R, N, M = 8, 50, 90
        sigma = 1.5
        za = rng.normal(0, sigma, (R, N)).astype(np.float32)
        zb = rng.normal(0, sigma, (R, M)).astype(np.float32)
        ca = rng.uniform(0, 1000, (R, N, 2)).astype(np.float32)
        cb = rng.uniform(0, 1000, (R, M, 2)).astype(np.float32)
        edges = [0.0, 400.0, 900.0, 1500.0]
        mesh8 = Mesh(np.asarray(jax.devices()[:8]), axis_names=("p",))
        mesh1 = Mesh(np.asarray(jax.devices()[:1]), axis_names=("p",))
        g8, c8 = sharded_variogram_bins(za, zb, ca, cb, edges, mesh8, estimator="genton")
        g1, c1 = sharded_variogram_bins(za, zb, ca, cb, edges, mesh1, estimator="genton")
        np.testing.assert_array_equal(c8, c1)
        np.testing.assert_allclose(g8, g1, rtol=1e-6, equal_nan=True)
        # White noise: Qn-based variogram sits near the sill = sigma^2
        ok = c8 > 500
        assert np.allclose(g8[ok], sigma**2, rtol=0.25)


class TestShardedNeff:
    """Sharded n_eff double sums match the single-device chunked kernel exactly."""

    def _params(self):
        return pd.DataFrame({"model": ["spherical"], "range": [300.0], "psill": [1.0],
                             "smooth": [None]})

    def test_exact_matches(self):
        import jax
        from jax.sharding import Mesh

        rng = np.random.default_rng(5)
        coords = rng.uniform(0, 1000, (700, 2)).astype(np.float32)  # 700: not 8-divisible
        errors = rng.uniform(0.5, 2.0, 700).astype(np.float32)
        params = self._params()
        mesh = Mesh(np.asarray(jax.devices()[:8]), axis_names=("p",))
        single = ss.neff_exact(coords, errors, params)
        sharded = ss.neff_exact(coords, errors, params, mesh=mesh)
        assert sharded == pytest.approx(single, rel=1e-4)

    def test_hugonnet_matches(self):
        import jax
        from jax.sharding import Mesh

        rng = np.random.default_rng(6)
        coords = rng.uniform(0, 1000, (1200, 2)).astype(np.float32)
        errors = rng.uniform(0.5, 2.0, 1200).astype(np.float32)
        params = self._params()
        mesh = Mesh(np.asarray(jax.devices()[:8]), axis_names=("p",))
        single = ss.neff_hugonnet_approx(coords, errors, params, subsample=300,
                                                   random_state=7)
        sharded = ss.neff_hugonnet_approx(coords, errors, params, subsample=300,
                                                    random_state=7, mesh=mesh)
        assert sharded == pytest.approx(single, rel=1e-4)


class TestMeshUncertaintyPipeline:
    """User-facing mesh= plumbing for the flagship sharded uncertainty pipeline
    (SURVEY 2.7 P4 / 7.6): sample_empirical_variogram -> infer_* -> DEM.estimate_uncertainty."""

    def _mesh(self, n):
        import jax
        from jax.sharding import Mesh

        return Mesh(np.array(jax.devices()[:n]), ("runs",))

    def _pair(self):
        from xdem_tpu import examples

        ref = examples.get_ref_dem_test()
        tba = examples.get_tba_dem_test()
        r0, r1, c0, c1 = examples._TEST_ICROP
        mask = ~examples.get_glacier_mask()[r0:r1, c0:c1]
        return ref, tba, mask

    def test_sample_empirical_variogram_mesh_invariant(self):
        from xdem_tpu import examples
        from xdem_tpu.spatialstats import sample_empirical_variogram

        dh = examples.get_ref_dem_test()
        dfs = [
            sample_empirical_variogram(dh, subsample=150, random_state=3, mesh=self._mesh(n))
            for n in (1, 8)
        ]
        pd.testing.assert_frame_equal(dfs[0], dfs[1])
        # Against the unsharded single-dispatch route: same pair populations to f32 binning
        df0 = sample_empirical_variogram(dh, subsample=150, random_state=3)
        np.testing.assert_allclose(dfs[0]["exp"], df0["exp"], rtol=1e-5)
        assert (dfs[0]["count"] == df0["count"]).mean() > 0.9  # bin-edge pairs may move 1 bin

    def test_estimate_uncertainty_mesh_invariant_exact(self):
        ref, tba, mask = self._pair()
        outs = []
        for n in (1, 8):
            sig, rho = ref.estimate_uncertainty(
                tba, stable_terrain=mask, subsample=150, random_state=42, mesh=self._mesh(n)
            )
            outs.append((np.asarray(sig.data), rho(np.array([10.0, 100.0, 1000.0]))))
        np.testing.assert_array_equal(outs[0][0], outs[1][0])
        np.testing.assert_array_equal(outs[0][1], outs[1][1])

    def test_estimate_uncertainty_mesh_matches_unsharded(self):
        ref, tba, mask = self._pair()
        sig1, rho1 = ref.estimate_uncertainty(tba, stable_terrain=mask, subsample=150,
                                              random_state=42)
        sig2, rho2 = ref.estimate_uncertainty(tba, stable_terrain=mask, subsample=150,
                                              random_state=42, mesh=self._mesh(8))
        # Terrain attrs + sigma are bitwise equal (global mean-centering in the halo path);
        # the variogram gamma may move bin-edge pairs between f32-equal routes -> tiny rho drift
        np.testing.assert_array_equal(np.asarray(sig1.data), np.asarray(sig2.data))
        lags = np.array([10.0, 100.0, 1000.0])
        np.testing.assert_allclose(rho1(lags), rho2(lags), atol=1e-5)

    def test_heteroscedasticity_mesh_exact(self):
        from xdem_tpu import terrain
        from xdem_tpu.raster import Raster
        from xdem_tpu.spatialstats import infer_heteroscedasticity_from_stable

        ref, tba, mask = self._pair()
        dh = Raster(tba.data - ref.data, ref.transform, ref.crs)
        attrs = terrain.get_terrain_attribute(ref, ["slope", "max_curvature"])
        args = dict(dvalues=dh, list_var=attrs, list_var_names=["slope", "max_curvature"],
                    stable_mask=mask, subsample=50_000, random_state=0)
        sig1, df1, _ = infer_heteroscedasticity_from_stable(**args)
        sig2, df2, _ = infer_heteroscedasticity_from_stable(**args, mesh=self._mesh(8))
        np.testing.assert_array_equal(np.asarray(sig1.data), np.asarray(sig2.data))
        pd.testing.assert_frame_equal(df1, df2)

    def test_heteroscedasticity_mesh_requires_device_path(self):
        from xdem_tpu.spatialstats import infer_heteroscedasticity_from_stable

        with pytest.raises(ValueError, match="device path"):
            infer_heteroscedasticity_from_stable(
                dvalues=np.ones((4, 4)), list_var=[np.ones((4, 4))], subsample=None,
                mesh=self._mesh(2),
            )

    def test_n_jobs_raises(self):
        from xdem_tpu import examples
        from xdem_tpu.spatialstats import sample_empirical_variogram

        with pytest.raises(NotImplementedError, match="mesh"):
            sample_empirical_variogram(examples.get_ref_dem_test(), subsample=10, n_jobs=4)

    def test_mesh_requires_equidistant(self):
        from xdem_tpu import examples
        from xdem_tpu.spatialstats import sample_empirical_variogram

        with pytest.raises(ValueError, match="cdist_equidistant"):
            sample_empirical_variogram(examples.get_ref_dem_test(), subsample=10,
                                       subsample_method="pdist_point", mesh=self._mesh(2))

    def test_sharded_terrain_bitwise_equals_unsharded(self):
        from xdem_tpu import examples, terrain

        ref = examples.get_ref_dem_test()
        a1 = terrain.get_terrain_attribute(ref, ["slope", "aspect", "hillshade", "max_curvature"])
        a2 = terrain.get_terrain_attribute(ref, ["slope", "aspect", "hillshade", "max_curvature"],
                                           mesh=self._mesh(8))
        for x, y in zip(a1, a2):
            np.testing.assert_array_equal(np.asarray(x.data), np.asarray(y.data))


class TestSpatialstatsReviewRegressions:
    """Round-3 spatialstats/parallel review fixes."""

    def test_interp_nd_binning_subset_of_3var(self):
        # A 2-var subset of a 3-variable binning used to crash on NaN rows from the
        # sibling same-nd combos (the reference filters them)
        rng = np.random.default_rng(0)
        v = rng.normal(size=2000)
        df = ss.nd_binning(v, [rng.uniform(0, 1, 2000) for _ in range(3)],
                           ["var1", "var2", "var3"])
        fn = ss.interp_nd_binning(df, ["var1", "var2"], statistic="nanmedian", min_count=0)
        out = fn(np.array([0.5]), np.array([0.5]))
        assert np.isfinite(out).all()
        arr = ss.get_perbin_nd_binning(df, [np.array([0.5]), np.array([0.5])],
                                       ["var1", "var2"], statistic="nanmedian")
        assert np.isfinite(arr).all()

    def test_interp_nd_binning_from_scratch_frame(self):
        """The reference accepts ad-hoc frames with numeric mid-value columns and no 'nd'
        column (its own doctest, reference spatialstats.py:268-289), with specific
        validation errors (:295-305)."""
        df = pd.DataFrame({"var1": [1, 2, 3, 1, 2, 3, 1, 2, 3],
                           "var2": [1, 1, 1, 2, 2, 2, 3, 3, 3],
                           "statistic": [1, 2, 3, 4, 5, 6, 7, 8, 9]})
        fn = ss.interp_nd_binning(df, ["var1", "var2"], statistic="statistic", min_count=None)
        assert float(fn((2, 2))) == pytest.approx(5.0)
        assert float(fn((1.5, 1.5))) == pytest.approx(3.0)
        assert float(fn((-1, 1))) == pytest.approx(1.0)  # flat extrapolation
        with pytest.raises(ValueError, match='Variable "nope" does not exist'):
            ss.interp_nd_binning(df, ["nope"], statistic="statistic", min_count=None)
        with pytest.raises(ValueError, match='Statistic "missing" does not exist'):
            ss.interp_nd_binning(df, ["var1"], statistic="missing", min_count=None)
        with pytest.raises(ValueError, match='"count" is not in the provided dataframe'):
            ss.interp_nd_binning(df, ["var1"], statistic="statistic", min_count=5)
        with pytest.raises(ValueError, match="empty"):
            ss.interp_nd_binning(pd.DataFrame({"var1": [], "statistic": []}),
                                 ["var1"], statistic="statistic", min_count=None)

    def test_convolution_even_kernel_matches_scipy(self):
        rng = np.random.default_rng(1)
        a = rng.normal(size=(1, 10, 12))
        for k in (2, 3, 4, 5):
            kern = rng.normal(size=(1, k, k))
            got = ss.convolution(a, kern)
            want = ndimage.convolve(a[0], kern[0], mode="constant", cval=0.0)
            assert got.shape == (1, 1, 10, 12), got.shape
            # constant-0 boundary here vs scipy's explicit constant mode: exact match
            np.testing.assert_allclose(got[0, 0], want, atol=1e-5)

    def test_neff_exact_matern_host_fallback(self):
        rng = np.random.default_rng(2)
        coords = rng.uniform(0, 500, (200, 2))
        errors = rng.uniform(0.5, 1.5, 200)
        params = pd.DataFrame({"model": ["matern"], "range": [100.0], "psill": [1.0],
                               "smooth": [0.5]})
        n_eff = ss.neff_exact(coords, errors, params)
        assert 1.0 < n_eff < 200.0

    def test_patches_quadrant_count_column(self):
        rng = np.random.default_rng(3)
        vals = rng.normal(size=(64, 64))
        df = ss.patches_method(vals, gsd=10.0, area=90000.0, vectorized=False,
                               statistics_in_patch=[np.nanmean, "count"], random_state=0)
        assert "count" in df.columns and "<lambda>" not in df.columns

    def test_halo_too_small_raises_clearly(self):
        import jax
        from jax.sharding import Mesh

        from xdem_tpu.parallel.halo import sharded_stencil

        mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("ry", "rx"))
        with pytest.raises(ValueError, match="too small to halo-shard"):
            sharded_stencil(lambda b: b, jnp.zeros((8, 8)), halo=3, mesh=mesh)

    def test_genton_global_pair_zero_kept(self):
        # Global pair index 0 used to hash to the invalid sentinel key 0 and was dropped by
        # the chunked reservoir (but kept by the distributed merge). With < CAP pairs per
        # bin the reservoir must hold ALL valid pairs, so gamma equals the full-sample Qn.
        import jax.numpy as jnp

        from xdem_tpu.parallel import make_mesh
        from xdem_tpu.parallel.variogram import sharded_variogram_bins
        from xdem_tpu.spatialstats import (_genton_qn_from_reservoir,
                                           _pairs_genton_reservoir_chunked)

        rng = np.random.default_rng(7)
        R, N, M = 2, 3, 3
        za = rng.normal(0, 1, (R, N))
        zb = rng.normal(0, 1, (R, M))
        ca = rng.uniform(0, 50, (R, N, 2))
        cb = rng.uniform(0, 50, (R, M, 2))
        edges = [0.0, 100.0]
        # numpy oracle: every pair is valid and lands in the single bin
        d = (za[:, :, None] - zb[:, None, :]).ravel()
        n = len(d)
        pair_diffs = np.abs(d[:, None] - d[None, :])[np.triu_indices(n, k=1)]
        k = int((n // 2 + 1) * (n // 2) / 2)
        qn = np.partition(pair_diffs, k - 1)[k - 1]
        g_true = (2.2191 * qn) ** 2 / 2

        res, cnt = _pairs_genton_reservoir_chunked(
            jnp.asarray(za, jnp.float32), jnp.asarray(zb, jnp.float32),
            jnp.asarray(ca, jnp.float32), jnp.asarray(cb, jnp.float32),
            jnp.asarray(edges, jnp.float32), 1, 1)
        assert int(cnt[0]) == n
        assert np.isfinite(np.asarray(res[0])).sum() == n  # ALL pairs kept, incl. pair 0
        g_chunked = _genton_qn_from_reservoir(np.asarray(res, np.float64), np.asarray(cnt))
        np.testing.assert_allclose(g_chunked[0], g_true, rtol=1e-5)

        g_sh, c_sh = sharded_variogram_bins(za, zb, ca, cb, edges, make_mesh(2),
                                            estimator="genton")
        assert int(c_sh[0]) == n
        np.testing.assert_allclose(g_sh[0], g_true, rtol=1e-5)

    def test_sharded_variogram_2d_mesh_matches_1d(self):
        # A 2-D mesh (make_mesh's default shape) used to mis-size the Genton run offsets
        # (devices.size vs the sharded axis size); sharded_variogram_bins now flattens any
        # mesh to 1-D internally.
        from xdem_tpu.parallel import make_mesh
        from xdem_tpu.parallel.mesh import as_mesh_1d
        from xdem_tpu.parallel.variogram import sharded_variogram_bins

        rng = np.random.default_rng(9)
        R, N, M = 8, 20, 40
        za = rng.normal(0, 1, (R, N))
        zb = rng.normal(0, 1, (R, M))
        ca = rng.uniform(0, 800, (R, N, 2))
        cb = rng.uniform(0, 800, (R, M, 2))
        edges = [0.0, 300.0, 800.0, 1500.0]
        mesh2d = make_mesh(8, shape=(2, 4))
        for est in ("matheron", "dowd", "genton"):
            g2, c2 = sharded_variogram_bins(za, zb, ca, cb, edges, mesh2d, estimator=est)
            g1, c1 = sharded_variogram_bins(za, zb, ca, cb, edges, as_mesh_1d(mesh2d),
                                            estimator=est)
            np.testing.assert_array_equal(c2, c1)
            np.testing.assert_allclose(g2, g1, rtol=1e-6, equal_nan=True, err_msg=est)


class TestUncertaintyEstimatorParams:
    """The spread/variogram estimator knobs of estimate_uncertainty (reference dem.py:700-702)
    and the Basic single-range model selection (reference dem.py:762-768)."""

    def _crop(self):
        from xdem_tpu import examples

        ref = examples.get_ref_dem().icrop((100, 300), (200, 400))
        tba = examples.get_tba_dem().icrop((100, 300), (200, 400))
        mask = ~examples.get_glacier_mask()[100:300, 200:400]
        return ref, tba, mask

    def test_basic_keeps_first_model_and_warns(self):
        ref, tba, mask = self._crop()
        with pytest.warns(UserWarning, match="single range"):
            sig, rho = ref.estimate_uncertainty(
                tba, stable_terrain=mask, approach="Basic",
                list_vario_models=("gaussian", "spherical"), random_state=42, subsample=300,
            )
        assert rho(np.array([0.0]))[0] == pytest.approx(1.0)

    def test_spread_estimator_threading(self):
        ref, tba, mask = self._crop()
        sig, _ = ref.estimate_uncertainty(
            tba, stable_terrain=mask, approach="Basic", list_vario_models=("spherical",),
            spread_estimator=np.nanstd, random_state=42, subsample=300,
        )
        dh = np.asarray(tba.data - ref.data)
        expected = np.nanstd(np.where(mask, dh, np.nan))
        assert np.nanmean(np.asarray(sig.data)) == pytest.approx(expected, rel=1e-5)

    def test_variogram_estimator_threading(self):
        ref, tba, mask = self._crop()
        _, rho_m = ref.estimate_uncertainty(
            tba, stable_terrain=mask, approach="Basic", list_vario_models=("spherical",),
            variogram_estimator="matheron", random_state=42, subsample=300,
        )
        assert rho_m(np.array([0.0]))[0] == pytest.approx(1.0)
        assert rho_m(np.array([1e7]))[0] == pytest.approx(0.0, abs=0.05)


class TestPointUncertainty:
    """estimate_uncertainty with an elevation point cloud (the reference's geodataframe
    branch, dem.py:725-731, designed for points end-to-end here)."""

    def _inputs(self, n=4000):
        from xdem_tpu import examples

        ref = examples.get_ref_dem().icrop((100, 400), (200, 500))
        tba = examples.get_tba_dem().icrop((100, 400), (200, 500))
        epc = tba.to_pointcloud(subsample=n, random_state=42)
        stable = ~examples.get_glacier_mask()[100:400, 200:500]
        return ref, epc, stable

    def test_point_basic_matches_point_dh_spread(self):
        ref, epc, stable = self._inputs()
        sig, rho = ref.estimate_uncertainty(
            epc, stable_terrain=stable, approach="Basic", list_vario_models=("spherical",),
            random_state=42, subsample=300,
        )
        # Oracle: NMAD of the point dh on stable terrain
        dh = np.asarray(epc.z) - np.asarray(ref.interp_points((epc.x, epc.y)))
        rows, cols = ref.transform.rowcol(epc.x, epc.y)
        pstable = stable[np.clip(np.round(rows).astype(int), 0, ref.height - 1),
                         np.clip(np.round(cols).astype(int), 0, ref.width - 1)]
        expected = ss._stat_nmad(np.where(pstable, dh, np.nan))
        assert sig.shape == ref.shape
        assert np.nanmean(np.asarray(sig.data)) == pytest.approx(expected, rel=1e-5)
        assert rho(np.array([0.0]))[0] == pytest.approx(1.0)

    def test_point_h2022_end_to_end(self):
        ref, epc, stable = self._inputs(n=8000)
        sig, rho = ref.estimate_uncertainty(
            epc, stable_terrain=stable, approach="H2022", random_state=42, subsample=300,
        )
        arr = np.asarray(sig.data)
        assert sig.shape == ref.shape
        assert np.isfinite(arr).mean() > 0.5
        assert np.nanmedian(arr) > 0
        assert rho(np.array([0.0]))[0] == pytest.approx(1.0)

    def test_point_dataframe_z_name(self):
        import pandas as pd

        ref, epc, stable = self._inputs()
        df = pd.DataFrame({"x": epc.x, "y": epc.y, "elev": epc.z})
        sig_df, _ = ref.estimate_uncertainty(
            df, stable_terrain=stable, approach="Basic", list_vario_models=("spherical",),
            z_name="elev", random_state=42, subsample=300,
        )
        sig_pc, _ = ref.estimate_uncertainty(
            epc, stable_terrain=stable, approach="Basic", list_vario_models=("spherical",),
            random_state=42, subsample=300,
        )
        np.testing.assert_allclose(np.asarray(sig_df.data), np.asarray(sig_pc.data))

    def test_point_mesh_raises(self):
        from xdem_tpu.parallel import make_mesh

        ref, epc, stable = self._inputs(n=500)
        with pytest.raises(ValueError, match="raster pipeline"):
            ref.estimate_uncertainty(epc, stable_terrain=stable, mesh=make_mesh(8))

    def test_point_missing_z_name_raises(self):
        import pandas as pd

        ref, epc, stable = self._inputs(n=500)
        df = pd.DataFrame({"x": epc.x, "y": epc.y, "elev": epc.z})
        with pytest.raises(ValueError, match="not found"):
            ref.estimate_uncertainty(df, stable_terrain=stable, z_name="zz")


class TestApiHonestySweep:
    """No accepted-but-ignored public parameter (VERDICT r2 item 8): the remaining
    signature-parity knobs either act or raise."""

    def test_convolution_method_validated(self, rng):
        img = rng.normal(size=(1, 10, 10))
        filt = np.ones((1, 3, 3), np.float32)
        with pytest.raises(ValueError, match="scipy' or 'numba"):
            ss.convolution(img, filt, method="cuda")
        np.testing.assert_allclose(ss.convolution(img, filt, method="numba"),
                                   ss.convolution(img, filt, method="scipy"))

    def test_mean_filter_method_validated(self, rng):
        img = rng.normal(size=(10, 10))
        with pytest.raises(ValueError, match="scipy' or 'numba"):
            ss.mean_filter_nan(img, 3, method="cuda")

    def test_patches_verbose_logs(self, rng, caplog):
        import logging as _logging

        vals = rng.normal(size=(60, 60))
        with caplog.at_level(_logging.INFO):
            ss.patches_method(vals, gsd=10.0, area=10000.0, vectorized=False,
                              n_patches=5, verbose=True, random_state=42)
        assert any("Working on patch" in r.message for r in caplog.records)

    def test_plot_variogram_range_split(self, tmp_path):
        field = _gaussian_field(shape=(100, 100), smooth_px=3, sigma=1.0, seed=9)
        df = ss.sample_empirical_variogram(field, gsd=10.0, subsample=400, random_state=42)
        fn, params = ss.fit_sum_model_variogram(["spherical"], df)
        out = str(tmp_path / "vario_split.png")
        axes = ss.plot_variogram(df, list_fit_fun=[fn], xscale_range_split=[100.0], out_fname=out)
        assert len(axes) == 2
        import os

        assert os.path.getsize(out) > 5000


class TestReviewFixesR3:
    """Regression tests for the round-3 review findings on the point-uncertainty /
    plot-split additions."""

    def test_plot_variogram_split_log_scale(self, tmp_path):
        field = _gaussian_field(shape=(100, 100), smooth_px=3, sigma=1.0, seed=9)
        df = ss.sample_empirical_variogram(field, gsd=10.0, subsample=400, random_state=42)
        axes = ss.plot_variogram(df, xscale="log", xscale_range_split=[100.0],
                                 out_fname=str(tmp_path / "v.png"))
        assert all(a.get_xscale() == "log" for a in axes)
        for a in axes:
            lo, hi = a.get_xlim()
            assert lo < hi  # no inverted panel

    def test_plot_variogram_split_leading_zero_log(self, tmp_path):
        field = _gaussian_field(shape=(100, 100), smooth_px=3, sigma=1.0, seed=9)
        df = ss.sample_empirical_variogram(field, gsd=10.0, subsample=400, random_state=42)
        axes = ss.plot_variogram(df, xscale="log", xscale_range_split=[0.0, 100.0],
                                 out_fname=str(tmp_path / "v0.png"))
        assert len(axes) == 2  # the leading 0 is the axis start, not an extra panel
        for a in axes:
            lo, hi = a.get_xlim()
            assert 0 < lo < hi

    def test_plot_variogram_split_xlim_forwarded(self, tmp_path):
        field = _gaussian_field(shape=(100, 100), smooth_px=3, sigma=1.0, seed=9)
        df = ss.sample_empirical_variogram(field, gsd=10.0, subsample=400, random_state=42)
        axes = ss.plot_variogram(df, xscale_range_split=[100.0], xlim=(0.0, 500.0),
                                 out_fname=str(tmp_path / "vx.png"))
        assert all(a.get_xlim() == (0.0, 500.0) for a in axes)

    def test_patches_vectorized_verbose_logs(self, rng, caplog):
        import logging as _logging

        vals = rng.normal(size=(60, 60))
        with caplog.at_level(_logging.INFO):
            ss.patches_method(vals, gsd=10.0, area=10000.0, verbose=True)
        assert any("convolution variant" in r.message for r in caplog.records)

    def test_point_stable_raster_off_grid_raises(self):
        from xdem_tpu import examples
        from xdem_tpu.raster import Raster

        ref = examples.get_ref_dem().icrop((100, 300), (200, 400))
        epc = ref.to_pointcloud(subsample=500, random_state=1)
        small = ref.icrop((0, 50), (0, 50))
        bad = Raster(np.ones(small.shape, np.float32), small.transform, small.crs)
        with pytest.raises(ValueError, match="DEM's grid"):
            ref.estimate_uncertainty(epc, stable_terrain=bad, approach="Basic",
                                     list_vario_models=("spherical",))

    def test_unsupported_other_elev_type_raises(self):
        from xdem_tpu import examples

        ref = examples.get_ref_dem().icrop((100, 300), (200, 400))
        with pytest.raises(TypeError, match="point cloud"):
            ref.estimate_uncertainty(np.ones(ref.shape, np.float32))


class TestPatchesReferenceMode:
    """patches_method(areas=[...]): the reference's per-area dataframe contract
    (reference :2920-3047)."""

    def test_areas_dataframe_and_scaling(self):
        rng = np.random.default_rng(7)
        sigma, gsd = 3.0, 10.0
        field = rng.normal(0, sigma, size=(400, 400))
        areas = [(5 * gsd) ** 2, (10 * gsd) ** 2, (20 * gsd) ** 2]
        df = ss.patches_method(field, areas=areas, gsd=gsd)
        assert list(df.columns) == ["nmad", "nb_indep_patches", "exact_areas", "areas"]
        assert len(df) == 3
        assert (df["areas"].values == np.asarray(areas)).all()
        # White noise: SE shrinks as 1/sqrt(patch pixels) -> strictly decreasing with area
        assert df["nmad"].is_monotonic_decreasing
        # Exact area counts the discretized circular footprint
        assert df["exact_areas"].iloc[0] == pytest.approx(areas[0], rel=0.35)
        se = df["nmad"].values
        npx = df["exact_areas"].values / gsd**2
        np.testing.assert_allclose(se, sigma / np.sqrt(npx), rtol=0.25)

    def test_return_in_patch_statistics(self):
        rng = np.random.default_rng(8)
        field = rng.normal(size=(200, 200))
        out = ss.patches_method(field, areas=[(10 * 10.0) ** 2], gsd=10.0,
                                return_in_patch_statistics=True)
        df_stat, df_all = out
        assert {"areas", "exact_areas", "nanmean", "count"} <= set(df_all.columns)
        assert len(df_all) > 10

    def test_loop_variant_areas_mode(self):
        rng = np.random.default_rng(9)
        field = rng.normal(size=(300, 300))
        df = ss.patches_method(field, areas=[(15 * 10.0) ** 2 / 4, (30 * 10.0) ** 2 / 4],
                               gsd=10.0, vectorized=False, n_patches=200, random_state=42)
        assert len(df) == 2 and (df["nb_indep_patches"] > 3).all()
        assert df["nmad"].iloc[1] < df["nmad"].iloc[0]

    def test_convolution_method_validated(self):
        rng = np.random.default_rng(10)
        field = rng.normal(size=(50, 50))
        with pytest.raises(ValueError, match="scipy' or 'numba"):
            ss.patches_method(field, areas=[1e4], gsd=10.0, convolution_method="gpu")

    def test_square_patch_shape(self):
        rng = np.random.default_rng(11)
        sigma, gsd = 2.0, 10.0
        field = rng.normal(0, sigma, size=(300, 300))
        df = ss.patches_method(field, areas=[(10 * gsd) ** 2], gsd=gsd, patch_shape="square")
        # Square 10x10 patches: exact area matches the request, SE ~ sigma/10
        assert df["exact_areas"].iloc[0] == pytest.approx((10 * gsd) ** 2)
        assert df["nmad"].iloc[0] == pytest.approx(sigma / 10, rel=0.25)


class TestParamParitySweep:
    """Round-3 parameter-level parity additions (reference kwargs that were missing)."""

    def test_interp_nd_binning_interpolate_method(self, rng):
        # A masked middle bin: "linear" infill = average of neighbors, "nearest" = a copy
        df = pd.DataFrame({
            "v": pd.arrays.IntervalArray.from_breaks([0.0, 1, 2, 3, 4, 5]),
            "nanmedian": [1.0, 2.0, np.nan, 8.0, 10.0],
            "count": [100, 100, 100, 100, 100],
            "nd": [1] * 5,
        })
        fn_lin = ss.interp_nd_binning(df, "v", statistic="nanmedian", min_count=None,
                                      interpolate_method="linear")
        fn_near = ss.interp_nd_binning(df, "v", statistic="nanmedian", min_count=None,
                                       interpolate_method="nearest")
        # Masked bin midpoint 2.5: linear infill -> (2 + 8) / 2 = 5; nearest -> 2 or 8
        assert fn_lin(np.array([2.5]))[0] == pytest.approx(5.0)
        assert fn_near(np.array([2.5]))[0] in (pytest.approx(2.0), pytest.approx(8.0))
        with pytest.raises(ValueError, match="interpolate_method"):
            ss.interp_nd_binning(df, "v", statistic="nanmedian", interpolate_method="cubic")

    def test_get_perbin_min_count(self, rng):
        vals = rng.normal(size=1000)
        var = rng.uniform(0, 10, 1000)
        df = ss.nd_binning(vals, [var], ["v"], list_var_bins=5)
        out0 = ss.get_perbin_nd_binning(df, [var], ["v"], statistic="nanmedian")
        out_hi = ss.get_perbin_nd_binning(df, [var], ["v"], statistic="nanmedian",
                                          min_count=10**9)
        assert np.isfinite(out0).sum() > 0
        assert np.isnan(out_hi).all()

    def test_plot_2d_binning_new_params(self, tmp_path, rng):
        vals = rng.normal(size=3000)
        v1 = rng.uniform(1, 10, 3000)
        v2 = rng.uniform(1, 5, 3000)
        df = ss.nd_binning(vals, [v1, v2], ["a", "b"], list_var_bins=6)
        out = str(tmp_path / "b2p.png")
        ax = ss.plot_2d_binning(df, "a", "b", "nanmedian", min_count=5, scale_var_1="log",
                                vmin=-1.0, vmax=1.0, nodata_color="grey", out_fname=out)
        import os

        assert os.path.getsize(out) > 5000


class TestReviewFixesR3b:
    """Regressions for the round-3 signature-parity review findings."""

    def test_interp_nd_binning_positional_order(self):
        # Reference positional order: (df, names, statistic, interpolate_method, min_count)
        df = pd.DataFrame({
            "v": pd.arrays.IntervalArray.from_breaks([0.0, 1, 2, 3]),
            "nanmedian": [1.0, 2.0, 3.0],
            "count": [100, 100, 100],
            "nd": [1] * 3,
        })
        fn = ss.interp_nd_binning(df, "v", "nanmedian", "nearest", None)
        assert np.isfinite(fn(np.array([1.5]))[0])

    def test_patches_zero_d_area(self):
        rng = np.random.default_rng(3)
        field = rng.normal(size=(80, 80))
        out = ss.patches_method(field, areas=np.array(1e4), gsd=10.0)
        assert isinstance(out, tuple) and len(out) == 2  # legacy compact return
