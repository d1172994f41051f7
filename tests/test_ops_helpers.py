"""Direct micro-tests for the small ops helpers that higher-level paths use internally
(masked reductions, shape bucketing, pixel-center coordinates, 2-D mesh adaptation)."""

import numpy as np
import pytest

from xdem_tpu.georef import Affine
from xdem_tpu.ops.interp import grid_coords
from xdem_tpu.ops.reductions import masked_median, masked_nmad, nmad
from xdem_tpu.ops.transfer import pad_to_bucket


class TestMaskedReductions:
    def test_masked_median_and_nmad_match_numpy(self):
        rng = np.random.default_rng(0)
        x = rng.normal(10, 3, 1000).astype(np.float32)
        valid = rng.random(1000) > 0.3
        assert float(masked_median(x, valid)) == pytest.approx(np.median(x[valid]), rel=1e-6)
        want_nmad = 1.4826 * np.median(np.abs(x[valid] - np.median(x[valid])))
        assert float(masked_nmad(x, valid)) == pytest.approx(want_nmad, rel=1e-5)

    def test_masked_equals_nan_poisoned(self):
        x = np.array([1.0, 2.0, 3.0, 4.0, 100.0], np.float32)
        valid = np.array([True, True, True, True, False])
        assert float(masked_nmad(x, valid)) == pytest.approx(float(nmad(np.where(valid, x, np.nan))))


class TestPadToBucket:
    def test_noop_on_bucket_grid(self):
        import jax.numpy as jnp

        a = jnp.ones((64, 128))
        (out,), shape = pad_to_bucket(64, (a, jnp.nan))
        assert out is a and shape == (64, 128)
        (out,), shape = pad_to_bucket(0, (a, jnp.nan))
        assert out is a

    def test_pads_with_fill_and_returns_shape(self):
        import jax.numpy as jnp

        a = jnp.ones((50, 70))
        b = jnp.zeros((50, 70), bool)
        (pa, pb), shape = pad_to_bucket(64, (a, jnp.nan), (b, False))
        assert shape == (50, 70)
        assert pa.shape == (64, 128) and pb.shape == (64, 128)
        assert bool(jnp.isnan(pa[55, 10])) and not bool(pb[55, 10])
        assert float(pa[10, 10]) == 1.0


class TestGridCoords:
    def test_pixel_centers(self):
        t = Affine.from_origin(100.0, 500.0, 10.0, 10.0)
        x, y = grid_coords((3, 4), t)
        assert float(x[0, 0]) == 105.0 and float(y[0, 0]) == 495.0
        assert float(x[0, 3]) == 135.0 and float(y[2, 0]) == 475.0


class TestMesh2D:
    def test_as_mesh_2d_adapts_shapes(self):
        import jax

        from xdem_tpu.parallel.mesh import as_mesh_1d, as_mesh_2d, make_mesh

        # A genuinely 1-D mesh must reshape to a near-square 2-D one
        m1d = as_mesh_1d(make_mesh(8))
        assert len(m1d.axis_names) == 1
        m2 = as_mesh_2d(m1d)
        assert len(m2.axis_names) == 2
        assert int(np.prod(list(m2.shape.values()))) == 8
        assert sorted(m2.shape.values()) == [2, 4]
        # Already-2D meshes pass through with both axes kept
        m3 = as_mesh_2d(make_mesh(8, shape=(4, 2)))
        assert sorted(m3.shape.values()) == [2, 4]
        assert jax.devices()[0].platform == "cpu"


class TestMatmulPrecisionPins:
    """At default precision an accelerator may run float32 dot_general in reduced precision
    (TF32 on a GPU); every coordinate-sensitive device solver must trace its matmuls at
    Precision.HIGHEST (ops.precision.pin_f32_matmuls). Numerically invisible on the CPU
    backend, so this asserts on the traced jaxpr — an un-pinned ICP brute path once
    mis-registered by ~8 m on an accelerator."""

    @staticmethod
    def _dot_precisions(jaxpr, acc=None, primitive="dot_general"):
        acc = [] if acc is None else acc
        for eqn in jaxpr.eqns:
            if eqn.primitive.name == primitive:
                acc.append(eqn.params.get("precision"))
            for v in eqn.params.values():
                for w in v if isinstance(v, (list, tuple)) else (v,):
                    if hasattr(w, "eqns"):  # raw Jaxpr (shard_map carries one directly)
                        TestMatmulPrecisionPins._dot_precisions(w, acc, primitive)
                    elif hasattr(w, "jaxpr"):  # ClosedJaxpr (jit/while/cond/scan)
                        TestMatmulPrecisionPins._dot_precisions(w.jaxpr, acc, primitive)
        return acc

    def _assert_all_highest(self, make_fn, *args, **kwargs):
        import jax as _jax
        from jax.lax import Precision

        jx = _jax.make_jaxpr(lambda *a: make_fn(*a, **kwargs))(*args)
        precs = self._dot_precisions(jx.jaxpr)
        assert precs, "expected at least one dot_general in the traced program"
        assert all(p == (Precision.HIGHEST, Precision.HIGHEST) for p in precs), precs

    def test_icp_brute_and_solver(self):
        import jax as _jax
        import jax.numpy as jnp
        from xdem_tpu.coreg.affine import _brute_nearest, _icp_solve_device

        ref = jnp.zeros((64, 3))
        q = jnp.zeros((32, 3))
        # The NN kernel is deliberately matmul-FREE (direct differences, like the
        # variogram kernels): no dot_general means no reduced-precision risk at all.
        jx = _jax.make_jaxpr(lambda r, qq: _brute_nearest(r, qq, chunk=16))(ref, q)
        assert not self._dot_precisions(jx.jaxpr), "NN kernel should not contain matmuls"
        norms = jnp.zeros((64, 3))
        self._assert_all_highest(
            lambda r, t, n: _icp_solve_device(r, t, n, 0.01, 3), ref, ref, norms
        )

    def test_cpd_and_lzd_solvers(self):
        import jax.numpy as jnp
        from xdem_tpu.coreg.affine import _cpd_solve

        X = jnp.zeros((32, 3))
        self._assert_all_highest(
            lambda x, y: _cpd_solve(x, y, 0.1, 1.0, 1e-6, 1e-4, 3, False), X, X
        )

    def test_nuth_kaab_solver(self):
        import jax.numpy as jnp
        from xdem_tpu.coreg.affine import _nuth_kaab_solve

        n = 64
        z = jnp.zeros(n)
        rc = jnp.zeros(n)
        raster = jnp.zeros((16, 16))
        self._assert_all_highest(
            lambda *a: _nuth_kaab_solve(*a, res_x=20.0, res_y=20.0, tolerance=0.01,
                                        max_iterations=2),
            z, rc, rc, raster, jnp.ones(n), jnp.zeros(n),
        )

    def test_conv2d_multi_precision(self):
        """The patches-method convolution pins full float32: a GPU may otherwise run a
        float32 convolution in TF32."""
        import jax as _jax
        import jax.numpy as jnp
        from jax.lax import Precision
        from xdem_tpu.spatialstats import _conv2d_multi

        jx = _jax.make_jaxpr(_conv2d_multi)(jnp.zeros((2, 16, 16)), jnp.zeros((3, 5, 5)))
        precs = self._dot_precisions(jx.jaxpr, primitive="conv_general_dilated")
        assert precs == [(Precision.HIGHEST, Precision.HIGHEST)], precs

    def test_pairwise_sq_dists_matmul_free(self):
        """The pairwise-distance kernel is deliberately matmul-free (direct differences):
        no dot_general means no reduced-precision risk and no (N, M) product in memory."""
        import jax as _jax
        import jax.numpy as jnp
        from xdem_tpu.spatialstats import _pairwise_sq_dists

        c = jnp.zeros((32, 2))
        jx = _jax.make_jaxpr(_pairwise_sq_dists)(c, c)
        assert not self._dot_precisions(jx.jaxpr)

    def test_lzd_solver(self):
        import jax.numpy as jnp
        from xdem_tpu.coreg.affine import _lzd_solve_device

        raster = jnp.zeros((16, 16))
        pts = jnp.zeros(32)
        inv_t = jnp.zeros(6)
        self._assert_all_highest(
            lambda r, x, y, z: _lzd_solve_device(
                r, r, r, x, y, z, jnp.float32(100.0), inv_t, 0.01, 2
            ),
            raster, pts, pts, pts,
        )

    def test_levenberg_marquardt_fits(self):
        import jax.numpy as jnp
        from xdem_tpu.fit import _lm_data, levenberg_marquardt

        x = jnp.linspace(0, 1, 32)
        y = jnp.zeros(32)
        w = jnp.ones(32)
        p0 = jnp.zeros(2)

        def model(xx, a, b):
            return a * xx + b

        self._assert_all_highest(
            lambda xx, yy, ww, pp: _lm_data(model, xx, yy, ww, pp, 2, 3), x, y, w, p0
        )

        def resid(p):
            return p[0] * x + p[1] - y

        self._assert_all_highest(lambda pp: levenberg_marquardt(resid, pp, 3), p0)

    def test_sharded_twins(self):
        """The mesh= solvers must pin precision too: their outputs are compared (sometimes
        bitwise) against the single-device programs, and the hot matmuls run per-shard
        inside shard_map (whose jaxpr rides as a raw param — see _dot_precisions)."""
        import jax.numpy as jnp
        from xdem_tpu.parallel.coreg import (icp_solve_sharded, lzd_solve_sharded,
                                             nuth_kaab_rst_rst_sharded)
        from xdem_tpu.parallel.cpd import cpd_solve_sharded
        from xdem_tpu.parallel.mesh import make_mesh

        mesh = make_mesh(8)
        ref = jnp.zeros((64, 3))
        tba = jnp.zeros((32, 3))
        self._assert_all_highest(
            lambda r, t, n: icp_solve_sharded(r, t, n, 0.01, mesh, 3, chunk=16),
            ref, tba, jnp.zeros((64, 3)),
        )
        raster = jnp.zeros((16, 16))
        pts = jnp.zeros(32)
        inv_t = jnp.zeros(6)
        self._assert_all_highest(
            lambda r, x, y, z: lzd_solve_sharded(
                r, r, r, x, y, z, jnp.float32(100.0), inv_t, 0.01, mesh, 2
            ),
            raster, pts, pts, pts,
        )
        X = jnp.zeros((32, 3))
        self._assert_all_highest(
            lambda a, b: cpd_solve_sharded(a, b, 0.1, jnp.float32(1.0), 1e-6, 1e-4,
                                           3, False, mesh),
            X, X,
        )
        rr = jnp.zeros((32, 32))
        self._assert_all_highest(
            lambda a, b, i: nuth_kaab_rst_rst_sharded(
                a, b, i, jnp.uint32(0), 64, 20.0, 20.0, 0.01, mesh, max_iterations=2
            ),
            rr, rr, jnp.ones((32, 32), bool),
        )

    def test_neff_centers_coordinates(self):
        """UTM-magnitude coords must give the same n_eff as the same cloud near the origin
        (the expansion is only conditioned after mean-centering)."""
        import numpy as np
        import pandas as pd
        from xdem_tpu import spatialstats as ss

        params = pd.DataFrame({"model": ["spherical"], "range": [100.0], "psill": [1.0]})
        rng = np.random.default_rng(0)
        coords = rng.uniform(0, 500, size=(300, 2))
        errors = np.ones(300)
        near = ss.neff_exact(coords, errors, params)
        far = ss.neff_exact(coords + np.array([5.0e5, 8.8e6]), errors, params)
        assert far == pytest.approx(near, rel=1e-4)
