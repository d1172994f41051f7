"""Device-dispatch budget regression tests (round 5).

Every compiled-program launch pays a fixed cost, so for small-shape pipelines the dispatch
count is a latency model (the uncertainty pipeline went 42 -> ~12 launches by eliminating
eager stragglers). These tests pin the launch counts on the CPU backend — the same jit
program boundaries an accelerator sees — with headroom, so an accidental eager op (jnp
scalar, un-jitted slice/astype chain, fancy indexing) fails loudly.

Budgets are ceilings with slack over the measured counts (NuthKaab fit: 2, ICP fit: 3,
estimate_uncertainty: 8 executions), not exact pins: minor XLA version drift in program
splitting shouldn't flake the suite.
"""

import warnings

import numpy as np
import pytest

from xdem_tpu import coreg, examples
from xdem_tpu.profiler import count_device_dispatches


@pytest.fixture(scope="module")
def pair():
    ref = examples.get_ref_dem_test()
    tba = examples.get_tba_dem_test()
    from xdem_tpu.examples import _TEST_ICROP

    r0, r1, c0, c1 = _TEST_ICROP
    inlier = ~examples.get_glacier_mask()[r0:r1, c0:c1]
    return ref, tba, inlier


class TestDispatchBudget:
    def test_nuth_kaab_fit_budget(self, pair):
        ref, tba, inlier = pair

        def fit():
            c = coreg.NuthKaab(subsample=20000)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                c.fit(ref, tba, inlier_mask=inlier, random_state=42)
            return c.meta["outputs"]["affine"]["shift_x"]

        _, counts = count_device_dispatches(fit)
        assert counts["executions"] <= 4, counts

    def test_icp_fit_budget(self, pair):
        ref, tba, inlier = pair

        def fit():
            c = coreg.ICP(subsample=5000)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                c.fit(ref, tba, inlier_mask=inlier, random_state=42)
            return c.meta["outputs"]["affine"]["matrix"]

        _, counts = count_device_dispatches(fit)
        assert counts["executions"] <= 6, counts

    def test_estimate_uncertainty_budget(self, pair):
        ref, tba, inlier = pair

        def run():
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                sig, rho = ref.estimate_uncertainty(
                    tba, stable_terrain=np.asarray(inlier), random_state=42, subsample=4000
                )
            return sig

        sig, counts = count_device_dispatches(run)
        assert counts["executions"] <= 12, counts
        assert np.isfinite(np.nanmedian(np.asarray(sig.data)))
