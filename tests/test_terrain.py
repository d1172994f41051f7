"""Terrain attribute tests: analytic cases, independent oracles, NaN semantics, sharding."""

import numpy as np
import pytest

import oracles
from xdem_tpu import examples, terrain
from xdem_tpu.dem import DEM


@pytest.fixture(scope="module")
def smooth_dem(rng=None):
    """A smooth synthetic DEM (f32) with ~1000 m relief at 20 m resolution."""
    return examples.synthetic_dem_array(shape=(80, 100), resolution=20.0, seed=3), 20.0


def _reltol(oracle_vals: np.ndarray, got: np.ndarray, tol_factor: float = 1e-3, pct: float = 100.0) -> None:
    """Assert |diff| <= tol_factor * mean |oracle| over jointly-finite pixels, at the max
    (GDAL criterion, reference tests/test_terrain/test_terrain.py:90-102) or at a percentile
    (RichDEM criterion, reference :180-191) for attributes sensitive to f32 rounding."""
    both = np.isfinite(oracle_vals) & np.isfinite(got)
    assert both.sum() > 0
    magn = np.nanmean(np.abs(oracle_vals[both]))
    diff = np.abs(oracle_vals[both] - got[both])
    stat = np.max(diff) if pct >= 100.0 else np.percentile(diff, pct)
    assert stat <= tol_factor * max(magn, 1e-6), f"diff p{pct} {stat} vs magn {magn}"


class TestAnalytic:
    def test_slope_aspect_plane_zt(self):
        # North-down unit ramp: slope 45 deg, aspect 180 (south-facing)
        dem = np.repeat(np.arange(3), 3)[::-1].reshape(3, 3).astype(np.float32)
        s, a = terrain.get_terrain_attribute(dem, ["slope", "aspect"], resolution=1, surface_fit="ZevenbergThorne")
        assert np.asarray(s)[1, 1] == pytest.approx(45.0, abs=1e-4)
        assert np.asarray(a)[1, 1] == pytest.approx(180.0, abs=1e-4)

    @pytest.mark.parametrize("fit", ["Horn", "ZevenbergThorne", "Florinsky"])
    def test_tilted_plane_all_methods(self, fit):
        # z = 0.2*x + 0.1*y on a 20 m grid; slope/aspect analytic, curvatures zero
        res = 20.0
        yy, xx = np.mgrid[0:30, 0:40].astype(np.float64)
        x = xx * res
        y = -(yy * res)  # y decreases with row
        dem = (0.2 * x + 0.1 * y).astype(np.float32)
        out = terrain.get_terrain_attribute(dem, ["slope", "aspect"], resolution=res, surface_fit=fit)
        slope_exp = np.rad2deg(np.arctan(np.hypot(0.2, 0.1)))
        # Aspect faces downslope (GDAL convention): the up-gradient (0.2 E, 0.1 N) + 180 deg
        aspect_exp = np.rad2deg((np.arctan2(0.2, 0.1) + np.pi) % (2 * np.pi))
        interior = np.asarray(out[0])[3:-3, 3:-3]
        assert np.allclose(interior, slope_exp, atol=1e-2)
        assert np.allclose(np.asarray(out[1])[3:-3, 3:-3], aspect_exp, atol=1e-2)
        if fit != "Horn":
            curv = terrain.get_terrain_attribute(dem, "profile_curvature", resolution=res, surface_fit=fit)
            assert np.allclose(np.asarray(curv)[3:-3, 3:-3], 0.0, atol=1e-4)

    def test_quadratic_curvature_zt(self):
        # z = 0.5*c*(x^2 + y^2): at any point z_xx = z_yy = c exactly under ZT stencils
        res = 10.0
        c = 1e-3
        yy, xx = np.mgrid[0:21, 0:21].astype(np.float64)
        x = (xx - 10) * res
        y = (10 - yy) * res
        dem = (0.5 * c * (x**2 + y**2)).astype(np.float32)
        curv = terrain.get_terrain_attribute(dem, "curvature", resolution=res, surface_fit="ZevenbergThorne")
        # curvature = -2(z_xx + z_yy)*100 = -2*(2c)*100
        assert np.asarray(curv)[10, 10] == pytest.approx(-2 * 2 * c * 100, rel=1e-3)


class TestOracleComparison:
    @pytest.mark.parametrize("fit", ["Horn", "ZevenbergThorne", "Florinsky"])
    @pytest.mark.parametrize("attr", ["slope", "aspect", "hillshade"])
    def test_slope_aspect_hillshade(self, smooth_dem, fit, attr):
        dem, res = smooth_dem
        got = np.asarray(terrain.get_terrain_attribute(dem, attr, resolution=res, surface_fit=fit))
        want = oracles.oracle_surface(dem, res, attr, fit=fit)
        if attr == "aspect":
            # Compare modulo 360
            both = np.isfinite(got) & np.isfinite(want)
            d = np.abs(got[both] - want[both])
            d = np.minimum(d, 360 - d)
            assert np.max(d) < 1e-2
        else:
            _reltol(want, got)

    @pytest.mark.parametrize("fit", ["ZevenbergThorne", "Florinsky"])
    @pytest.mark.parametrize("curv_method", ["geometric", "directional"])
    @pytest.mark.parametrize(
        "attr",
        ["profile_curvature", "tangential_curvature", "planform_curvature",
         "flowline_curvature", "max_curvature", "min_curvature"],
    )
    def test_curvatures(self, smooth_dem, fit, curv_method, attr):
        dem, res = smooth_dem
        got = np.asarray(
            terrain.get_terrain_attribute(dem, attr, resolution=res, surface_fit=fit, curv_method=curv_method)
        )
        want = oracles.oracle_surface(dem, res, attr, fit=fit, curv_method=curv_method)
        # Planform/flowline divide by grad^3: f32 rounding amplifies near flat pixels, so use
        # the 99th-percentile criterion there (as the reference does against RichDEM).
        pct = 99.0 if attr in ("planform_curvature", "flowline_curvature") else 100.0
        _reltol(want, got, tol_factor=2e-3, pct=pct)

    def test_legacy_curvature(self, smooth_dem):
        dem, res = smooth_dem
        got = np.asarray(terrain.get_terrain_attribute(dem, "curvature", resolution=res, surface_fit="ZevenbergThorne"))
        want = oracles.oracle_surface(dem, res, "curvature", fit="ZevenbergThorne")
        _reltol(want, got)

    @pytest.mark.parametrize("attr", ["topographic_position_index", "terrain_ruggedness_index", "roughness"])
    @pytest.mark.parametrize("window", [3, 5])
    def test_windowed(self, smooth_dem, attr, window):
        dem, res = smooth_dem
        got = np.asarray(terrain.get_terrain_attribute(dem, attr, resolution=res, window_size=window))
        want = oracles.oracle_windowed(dem, attr, window=window)
        _reltol(want, got)

    def test_tri_wilson(self, smooth_dem):
        dem, res = smooth_dem
        got = np.asarray(terrain.get_terrain_attribute(dem, "terrain_ruggedness_index", resolution=res,
                                                       tri_method="Wilson"))
        want = oracles.oracle_windowed(dem, "terrain_ruggedness_index", tri_method="Wilson")
        _reltol(want, got)

    def test_rugosity(self, smooth_dem):
        dem, res = smooth_dem
        got = np.asarray(terrain.get_terrain_attribute(dem[:30, :30], "rugosity", resolution=res))
        want = oracles.oracle_rugosity(dem[:30, :30], res)
        _reltol(want, got)

    def test_fractal_roughness(self):
        dem = examples.synthetic_dem_array(shape=(40, 40), seed=5, relief=100.0)
        got = np.asarray(terrain.get_terrain_attribute(dem, "fractal_roughness", resolution=10.0))
        want = oracles.oracle_fractal(dem, window=13)
        both = np.isfinite(got) & np.isfinite(want)
        assert both.sum() > 100
        assert np.max(np.abs(got[both] - want[both])) < 5e-3

    def test_texture_shading(self, smooth_dem):
        dem, res = smooth_dem
        got = np.asarray(terrain.get_terrain_attribute(dem, "texture_shading", resolution=res))
        # Oracle via scipy rfft2 with the same padding scheme
        import scipy.fft as fft

        from xdem_tpu.terrain.freq import next_fast_fft_size

        rows, cols = dem.shape
        fr, fc = next_fast_fft_size(rows), next_fast_fft_size(cols)
        pr, pc = (fr - rows) // 2, (fc - cols) // 2
        arr = np.pad(dem.astype(np.float64), ((pr, fr - rows - pr), (pc, fc - cols - pc)), mode="symmetric")
        fy = fft.fftfreq(fr)[:, None]
        fx = fft.rfftfreq(fc)[None, :]
        mag = np.hypot(fx, fy)
        mag[0, 0] = 1.0
        filt = mag**0.8
        filt[0, 0] = 0.0
        want = fft.irfft2(fft.rfft2(arr) * filt, s=(fr, fc))[pr : pr + rows, pc : pc + cols]
        assert np.nanmax(np.abs(got - want)) < 1e-2 * np.nanstd(want) + 1e-3


class TestTextureShadingProperties:
    """Analytic properties of the fractional-Laplacian operator (reference
    tests/test_terrain/test_freq.py:53-165): a pure |f|^alpha filter with zeroed DC must
    vanish on flat input, ignore vertical offsets, scale linearly, and move spectral power
    toward high frequencies as alpha grows."""

    def test_flat_surface_is_zero(self):
        dem = np.full((16, 16), 1000.0, dtype=np.float32)
        out = np.asarray(terrain.texture_shading(dem, alpha=0.8))
        assert np.allclose(out, 0.0, atol=1e-3)

    def test_offset_invariance_and_signed(self):
        rng = np.random.RandomState(0)
        dem = rng.randn(16, 16).astype(np.float32)
        out = np.asarray(terrain.texture_shading(dem, alpha=0.8))
        out_off = np.asarray(terrain.texture_shading(dem + 1234.5, alpha=0.8))
        # DC is zeroed, so only the (float32) mean handling can differ: compare demeaned.
        a = out - np.nanmean(out)
        b = out_off - np.nanmean(out_off)
        np.testing.assert_allclose(a, b, atol=2e-3, rtol=0)
        assert np.nanmin(out) < 0 < np.nanmax(out)

    def test_linear_scaling(self):
        rng = np.random.RandomState(1)
        dem = rng.randn(16, 16).astype(np.float32)
        scale = 3000.0
        out1 = np.asarray(terrain.texture_shading(dem, alpha=0.8))
        out2 = np.asarray(terrain.texture_shading(scale * dem, alpha=0.8))
        atol = 1e-3 * scale * np.max(np.abs(out1))
        np.testing.assert_allclose(out2, scale * out1, atol=atol, rtol=0)

    def test_spectral_shift_with_alpha(self):
        rng = np.random.RandomState(2)
        dem = rng.randn(16, 16).astype(np.float32)
        out_lo = np.asarray(terrain.texture_shading(dem, alpha=0.5))
        out_hi = np.asarray(terrain.texture_shading(dem, alpha=1.5))
        spec_lo = np.fft.fftshift(np.fft.fft2(out_lo))
        spec_hi = np.fft.fftshift(np.fft.fft2(out_hi))
        p_lo = np.abs(spec_lo) ** 2
        p_hi = np.abs(spec_hi) ** 2
        ky = np.fft.fftshift(np.fft.fftfreq(out_lo.shape[0]))[:, None]
        kx = np.fft.fftshift(np.fft.fftfreq(out_lo.shape[1]))[None, :]
        radius = np.hypot(kx, ky)
        cut = np.median(radius[radius > 0])
        assert p_hi[radius > cut].sum() / p_hi.sum() > p_lo[radius > cut].sum() / p_lo.sum()

    def test_nan_preserved_and_alpha_bounds(self):
        dem = np.array([[1, 1, 1], [1, 2, 1], [1, 1, 1]], dtype=np.float32)
        dem_nan = dem.copy()
        dem_nan[0, 0] = np.nan
        out = np.asarray(terrain.texture_shading(dem_nan, alpha=0.8))
        assert np.isnan(out[0, 0]) and np.isfinite(out[1:, 1:]).all()
        for bad in (-0.1, 2.1):
            with pytest.raises(ValueError, match="Alpha must be between 0 and 2"):
                terrain.texture_shading(dem, alpha=bad)

    def test_ramp_rows_constant_columns_monotonic(self):
        # A north-south ramp has no cross-slope structure: columns identical, row means
        # ordered with the ramp (reference test_freq.py:59-84).
        dem = np.tile(np.arange(16, dtype=np.float32)[:, None], (1, 16))
        out = np.asarray(terrain.texture_shading(dem, alpha=0.8))
        atol = 1e-3 * (np.max(np.abs(out)) + 1.0)
        assert np.allclose(np.diff(out, axis=1), 0.0, atol=atol)
        row_means = out.mean(axis=1)
        # Central rows (away from the symmetric-pad boundary) increase with elevation.
        assert np.all(np.diff(row_means[4:12]) >= -atol)


class TestNaNSemantics:
    def test_nan_poisoning_3x3(self, smooth_dem):
        dem, res = smooth_dem
        dem = dem.copy()
        dem[20, 30] = np.nan
        got = np.asarray(terrain.get_terrain_attribute(dem, "slope", resolution=res, surface_fit="Horn"))
        assert np.all(~np.isfinite(got[19:22, 29:32]))
        assert np.isfinite(got[18, 30]) and np.isfinite(got[23, 30])

    def test_nan_poisoning_5x5_florinsky(self, smooth_dem):
        dem, res = smooth_dem
        dem = dem.copy()
        dem[20, 30] = np.nan
        got = np.asarray(terrain.get_terrain_attribute(dem, "slope", resolution=res, surface_fit="Florinsky"))
        assert np.all(~np.isfinite(got[18:23, 28:33]))
        assert np.isfinite(got[17, 30])

    def test_edges_nan(self, smooth_dem):
        dem, res = smooth_dem
        got = np.asarray(terrain.get_terrain_attribute(dem, "slope", resolution=res, surface_fit="Horn"))
        assert np.all(~np.isfinite(got[0, :])) and np.all(~np.isfinite(got[:, -1]))

    def test_hillshade_range(self, smooth_dem):
        dem, res = smooth_dem
        hs = np.asarray(terrain.get_terrain_attribute(dem, "hillshade", resolution=res))
        finite = hs[np.isfinite(hs)]
        assert finite.min() >= 0 and finite.max() <= 255


class TestDispatcher:
    def test_multi_attribute_order(self, smooth_dem):
        dem, res = smooth_dem
        attrs = ["roughness", "slope", "texture_shading", "hillshade"]
        outs = terrain.get_terrain_attribute(dem, attrs, resolution=res)
        assert len(outs) == 4
        s = np.asarray(terrain.get_terrain_attribute(dem, "slope", resolution=res))
        both = np.isfinite(s) & np.isfinite(np.asarray(outs[1]))
        assert np.allclose(np.asarray(outs[1])[both], s[both])

    def test_horn_curvature_error(self, smooth_dem):
        dem, res = smooth_dem
        with pytest.raises(ValueError, match="'Horn' surface fit method cannot"):
            terrain.get_terrain_attribute(dem, "profile_curvature", resolution=res, surface_fit="Horn")

    def test_missing_resolution_error(self, smooth_dem):
        dem, _ = smooth_dem
        with pytest.raises(ValueError, match="resolution"):
            terrain.get_terrain_attribute(dem, "slope")

    def test_unknown_attribute_error(self, smooth_dem):
        dem, res = smooth_dem
        with pytest.raises(ValueError, match="not supported"):
            terrain.get_terrain_attribute(dem, "bogus", resolution=res)

    def test_raster_io(self, ref_dem_test):
        out = ref_dem_test.slope()
        assert isinstance(out, DEM.__mro__[1])  # a Raster
        assert out.transform.almost_equals(ref_dem_test.transform)
        assert out.crs == ref_dem_test.crs

    def test_dem_methods(self, ref_dem_test):
        for name in ["slope", "aspect", "hillshade", "profile_curvature", "topographic_position_index",
                     "terrain_ruggedness_index", "roughness", "rugosity"]:
            out = getattr(ref_dem_test, name)()
            arr = np.asarray(out.data)
            assert np.isfinite(arr).sum() > 0.5 * arr.size

    def test_engine_aliases_and_validation(self, smooth_dem):
        # The reference's engine="scipy"/"numba" (terrain.py host-library selectors) map to
        # the portable XLA path; unknown values raise instead of silently picking a path.
        dem, res = smooth_dem
        base = np.asarray(terrain.get_terrain_attribute(dem, "slope", resolution=res))
        for alias in ("scipy", "numba"):
            got = np.asarray(terrain.get_terrain_attribute(dem, "slope", resolution=res, engine=alias))
            both = np.isfinite(base) & np.isfinite(got)
            assert np.array_equal(got[both], base[both])
        with pytest.raises(ValueError, match="Unknown engine"):
            terrain.get_terrain_attribute(dem, "slope", resolution=res, engine="palas")
        with pytest.raises(ValueError, match="Unknown engine"):
            terrain.fractal_roughness(np.asarray(dem), engine="cuda")

    def test_pallas_engine_removed(self, smooth_dem):
        # The Pallas engine and its config switch are gone: asking for the engine must fail
        # loudly instead of silently running the XLA path, and the switch is no config key.
        from xdem_tpu.config import config

        dem, res = smooth_dem
        with pytest.raises(ValueError, match="engine='pallas' was removed"):
            terrain.get_terrain_attribute(dem, "slope", resolution=res, engine="pallas")
        with pytest.raises(ValueError, match="engine='pallas' was removed"):
            terrain.fractal_roughness(np.asarray(dem), engine="pallas")
        assert set(config) == {"resampling", "warn_area_or_point", "shift_area_or_point",
                               "shape_bucketing"}

    def test_degrees_radians(self, smooth_dem):
        dem, res = smooth_dem
        deg = np.asarray(terrain.get_terrain_attribute(dem, "slope", resolution=res, degrees=True))
        rad = np.asarray(terrain.get_terrain_attribute(dem, "slope", resolution=res, degrees=False))
        both = np.isfinite(deg) & np.isfinite(rad)
        assert np.allclose(deg[both], np.rad2deg(rad[both]), atol=1e-4)


class TestSharded:
    def test_sharded_matches_single_device(self, smooth_dem):
        import jax

        from xdem_tpu.parallel import make_mesh
        from xdem_tpu.parallel.halo import sharded_surface_attributes
        from xdem_tpu.terrain.surfit import surface_attributes

        dem, res = smooth_dem
        dem = dem.copy()
        dem[10, 13] = np.nan  # exercise NaN halos across shard boundaries
        mesh = make_mesh(8, shape=(4, 2))
        attrs = ("slope", "aspect", "hillshade")
        single = np.asarray(surface_attributes(dem, res, attrs=attrs, surface_fit="Florinsky"))
        sharded = np.asarray(sharded_surface_attributes(dem, res, mesh=mesh, attrs=attrs, surface_fit="Florinsky"))
        both = np.isfinite(single) & np.isfinite(sharded)
        assert (np.isfinite(single) == np.isfinite(sharded)).all()
        assert np.allclose(single[both], sharded[both], atol=1e-4)
        assert jax.devices()[0].platform == "cpu"


class TestShardedWindowed:
    def test_windowed_and_fractal_sharded(self, smooth_dem):
        from xdem_tpu.parallel import make_mesh

        dem, res = smooth_dem
        mesh = make_mesh(8, shape=(4, 2))
        attrs = ["topographic_position_index", "roughness", "fractal_roughness"]
        single = [np.asarray(terrain.get_terrain_attribute(dem, a, resolution=res,
                                                           window_size_fractal=13)) for a in attrs]
        sharded = terrain.get_terrain_attribute(dem, attrs, resolution=res, mesh=mesh,
                                                window_size_fractal=13)
        for i, a in enumerate(attrs):
            g = np.asarray(sharded[i])
            w = single[i]
            assert (np.isfinite(g) == np.isfinite(w)).all(), a
            both = np.isfinite(g)
            assert np.allclose(g[both], w[both], atol=1e-3), a


class TestTiledTerrain:
    """Out-of-core tiling (terrain/tiled.py): streamed row bands must equal the whole-array
    result, including at tile seams (halo) and raster edges (NaN padding)."""

    def test_tiled_equals_whole_array(self, tmp_path):
        from xdem_tpu.io import read_raster
        from xdem_tpu.terrain import TilingConfig, get_terrain_attribute, tiled_terrain_attribute

        rng = np.random.default_rng(8)
        dem = examples.synthetic_dem_array(shape=(257, 257), seed=8)  # odd: last band partial
        dem[40:45, 60:70] = np.nan
        attrs = ["slope", "aspect", "hillshade", "max_curvature",
                 "topographic_position_index", "roughness", "fractal_roughness"]
        paths = tiled_terrain_attribute(
            dem, attrs, TilingConfig(tile_rows=64, outdir=str(tmp_path)),
            resolution=20.0, surface_fit="Florinsky", window_size=5, window_size_fractal=13,
        )
        whole = get_terrain_attribute(dem, attrs, resolution=20.0, surface_fit="Florinsky",
                                      window_size=5, window_size_fractal=13)
        for p, a, ref in zip(paths, attrs, whole):
            got = np.asarray(read_raster(p).data)
            ref = np.asarray(ref)
            assert (np.isfinite(got) == np.isfinite(ref)).all(), f"{a}: NaN footprint differs"
            both = np.isfinite(got) & np.isfinite(ref)
            # Tiles are mean-centered per band, so f32 rounding differs slightly from the
            # whole-array pass; aspect additionally amplifies it on near-flat pixels.
            if a == "aspect":
                d = np.abs(got[both] - ref[both])
                assert np.minimum(d, 360 - d).max() < 0.1, "aspect"
            else:
                np.testing.assert_allclose(got[both], ref[both], rtol=1e-4, atol=1e-3, err_msg=a)

    def test_tiled_from_streamed_file(self, tmp_path):
        """Path input: windowed reads straight from an uncompressed striped GeoTIFF."""
        from xdem_tpu.georef import Affine
        from xdem_tpu.io import StreamingRasterWriter, read_raster
        from xdem_tpu.terrain import TilingConfig, get_terrain_attribute, tiled_terrain_attribute

        dem = examples.synthetic_dem_array(shape=(200, 200), seed=9)
        t = Affine(20.0, 0.0, 5e5, 0.0, -20.0, 8.67e6)
        src = str(tmp_path / "src.tif")
        with StreamingRasterWriter(src, dem.shape, t, crs=32633) as wtr:
            wtr.write_rows(0, dem)
        paths = tiled_terrain_attribute(
            src, "slope", TilingConfig(tile_rows=96, outdir=str(tmp_path / "out")),
        )
        got = read_raster(paths[0])
        assert got.crs.epsg == 32633 and tuple(got.transform) == tuple(t)
        ref = np.asarray(get_terrain_attribute(dem, "slope", resolution=20.0))
        both = np.isfinite(np.asarray(got.data)) & np.isfinite(ref)
        np.testing.assert_allclose(np.asarray(got.data)[both], ref[both], rtol=1e-4, atol=1e-3)

    def test_frequency_attr_rejected(self, tmp_path):
        from xdem_tpu.terrain import TilingConfig, tiled_terrain_attribute

        with pytest.raises(ValueError, match="cannot be tiled"):
            tiled_terrain_attribute(np.zeros((32, 32), np.float32), "texture_shading",
                                    TilingConfig(outdir=str(tmp_path)))

    def test_tiled_composes_with_mesh(self, tmp_path):
        """Out-of-core streaming + multi-chip: each row band's stencil is halo-sharded
        across the mesh (mesh= flows through to get_terrain_attribute), so rasters larger
        than one device's memory scale over all devices."""
        from xdem_tpu.io import read_raster
        from xdem_tpu.parallel import make_mesh
        from xdem_tpu.terrain import TilingConfig, get_terrain_attribute, tiled_terrain_attribute

        dem = examples.synthetic_dem_array(shape=(200, 230), seed=11)
        dem[30:33, 40:50] = np.nan
        paths = tiled_terrain_attribute(
            dem, ["slope", "terrain_ruggedness_index"],
            TilingConfig(tile_rows=64, outdir=str(tmp_path)),
            resolution=20.0, mesh=make_mesh(8),
        )
        whole = get_terrain_attribute(dem, ["slope", "terrain_ruggedness_index"], resolution=20.0)
        for p, a, ref in zip(paths, ["slope", "terrain_ruggedness_index"], whole):
            got = np.asarray(read_raster(p).data)
            ref = np.asarray(ref)
            assert (np.isfinite(got) == np.isfinite(ref)).all(), f"{a}: NaN footprint differs"
            both = np.isfinite(got) & np.isfinite(ref)
            np.testing.assert_allclose(got[both], ref[both], rtol=1e-4, atol=1e-3, err_msg=a)


def test_tiled_kwarg_on_dispatcher(tmp_path):
    """get_terrain_attribute(tiled=TilingConfig) is the mp_config-analog entry point."""
    from xdem_tpu.io import read_raster
    from xdem_tpu.terrain import TilingConfig, get_terrain_attribute

    dem = examples.synthetic_dem_array(shape=(150, 130), seed=4)
    paths = get_terrain_attribute(dem, ["slope", "roughness"], resolution=20.0,
                                  tiled=TilingConfig(tile_rows=64, outdir=str(tmp_path)))
    whole = get_terrain_attribute(dem, ["slope", "roughness"], resolution=20.0)
    for p, w in zip(paths, whole):
        got = np.asarray(read_raster(p).data)
        ref = np.asarray(w)
        both = np.isfinite(got) & np.isfinite(ref)
        np.testing.assert_allclose(got[both], ref[both], rtol=1e-4, atol=1e-3)


class TestTerrainReviewRegressions:
    """Round-3 terrain-layer review fixes."""

    def test_rugosity_fixed_3x3_with_larger_window(self, smooth_dem):
        # The reference computes rugosity on a fixed 3x3 window regardless of window_size=
        # (its scipy wrapper hardcodes size=3, reference window.py:700); a 5x5 request used
        # to raise here.
        dem, res = smooth_dem
        r3 = np.asarray(terrain.get_terrain_attribute(dem, "rugosity", resolution=res))
        rug5, rough5 = terrain.get_terrain_attribute(
            dem, ["rugosity", "roughness"], resolution=res, window_size=5)
        both = np.isfinite(r3) & np.isfinite(np.asarray(rug5))
        assert both.sum() > 100
        np.testing.assert_allclose(np.asarray(rug5)[both], r3[both], rtol=1e-6)
        # ... while roughness really used the 5x5 window
        rough3 = np.asarray(terrain.get_terrain_attribute(dem, "roughness", resolution=res))
        assert not np.allclose(np.nan_to_num(np.asarray(rough5)), np.nan_to_num(rough3))

    def test_texture_shading_alpha_parameter(self, smooth_dem):
        # Reference signature is texture_shading(dem, alpha=0.8) (reference terrain.py:1783)
        dem, _res = smooth_dem
        a = np.asarray(terrain.texture_shading(dem, 0.5))
        b = np.asarray(terrain.get_terrain_attribute(dem, "texture_shading", texture_alpha=0.5))
        np.testing.assert_array_equal(a, b)

    def test_fractal_small_window_warns_and_computes(self):
        # Reference warns for window_size_fractal < 5 and still computes (a degenerate
        # one-point log-log regression -> NaN); this used to warn and then raise.
        dem = examples.synthetic_dem_array(shape=(32, 32), seed=3)
        with pytest.warns(UserWarning, match="larger or equal to 5"):
            out = np.asarray(terrain.get_terrain_attribute(
                dem, "fractal_roughness", resolution=10.0, window_size_fractal=3))
        assert out.shape == dem.shape
        assert np.isnan(out).all()

    def test_tiled_out_dtype_rejected(self, tmp_path):
        # out_dtype used to be silently dropped by the tiled= path (float32 writer)
        from xdem_tpu.terrain import TilingConfig

        with pytest.raises(ValueError, match="out_dtype"):
            terrain.get_terrain_attribute(
                np.zeros((64, 64), np.float32), "slope", resolution=1.0,
                tiled=TilingConfig(outdir=str(tmp_path)), out_dtype=np.float64)


class TestMpConfigBridge:
    def test_mp_config_tiling_bridge(self, tmp_path):
        """mp_config= (the reference's MultiprocConfig slot) accepts a TilingConfig and
        routes to the out-of-core path; anything else raises with a pointer."""
        from xdem_tpu.io import read_raster
        from xdem_tpu.terrain import TilingConfig, get_terrain_attribute

        dem = examples.synthetic_dem_array(shape=(96, 96), seed=3)
        paths = get_terrain_attribute(
            dem, "slope", resolution=20.0,
            mp_config=TilingConfig(tile_rows=32, outdir=str(tmp_path)),
        )
        got = np.asarray(read_raster(paths[0]).data)
        ref = np.asarray(get_terrain_attribute(dem, "slope", resolution=20.0))
        both = np.isfinite(got) & np.isfinite(ref)
        np.testing.assert_allclose(got[both], ref[both], rtol=1e-4, atol=1e-3)
        with pytest.raises(ValueError, match="TilingConfig"):
            get_terrain_attribute(dem, "slope", resolution=20.0, mp_config=object())

    def test_mp_config_and_tiled_conflict(self, tmp_path):
        from xdem_tpu.terrain import TilingConfig, get_terrain_attribute

        dem = examples.synthetic_dem_array(shape=(64, 64), seed=3)
        with pytest.raises(ValueError, match="only one of"):
            get_terrain_attribute(dem, "slope", resolution=20.0,
                                  tiled=TilingConfig(outdir=str(tmp_path)),
                                  mp_config=TilingConfig(outdir=str(tmp_path)))
