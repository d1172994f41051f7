"""chip_smoke.py on the CPU: it must refuse to run without a GPU, and every phase must run
end to end at a tiny size (the card runs them at full size)."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from xdem_tpu import examples  # noqa: E402

TINY = {
    "io": dict(n=64),
    "terrain": dict(n=96, crop=48),
    "nuthkaab": dict(n=256, n_cpu=256),
    "icp": dict(n_points=20_000, subsample_brute=2_000),
    "uncertainty": dict(n=256, example_crop=examples._TEST_ICROP, conv_size=64, subsample=3000),
    "volume": dict(n=128),
}


def test_refuses_to_run_without_a_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "not 'gpu'" in proc.stderr


@pytest.mark.parametrize("phase", sorted(chip_smoke.PHASES))
def test_phase_runs_at_tiny_size(phase):
    assert sorted(TINY) == sorted(chip_smoke.PHASES)
    figures = chip_smoke.PHASES[phase](**TINY[phase])
    assert figures["first_s"] > 0 and figures["warm_s"] > 0
    # On the CPU both sides of every comparison run the same backend
    assert all(v == 0 for k, v in figures.items() if "differing" in k)


def test_four_card_phase_on_virtual_devices():
    import jax

    assert len(jax.devices()) >= 4
    figures = chip_smoke.phase_four_cards(n=128, n_points=20_000, icp_subsample=2_000,
                                          unc_subsample=1_000)
    assert figures["ICP mesh vs one-card brute: matrix entries differing"] == 0
    assert figures["uncertainty 4-device vs 1-device mesh: sigma pixels differing"] == 0
