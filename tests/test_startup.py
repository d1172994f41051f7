"""Start-up behaviour: optional packages stay optional, the compile cache goes where the
environment or the checkout says, and multi-process start-up does not force a platform."""

import json
import os
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code: str, **env_over) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "JAX_COMPILATION_CACHE_DIR")}
    env.update({k: v for k, v in env_over.items() if v is not None})
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(code)], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return proc


def test_main_path_without_optional_packages():
    out = _run(
        """
        import sys
        for name in ("pandas", "matplotlib", "yaml", "sklearn", "tqdm"):
            sys.modules[name] = None  # any import of it raises ImportError
        import numpy as np
        import xdem_tpu
        from xdem_tpu import examples, io, terrain
        from xdem_tpu.coreg import CPD, ICP, LZD, DhMinimize, NuthKaab, VerticalShift
        ref, tba = examples.get_ref_dem(), examples.get_tba_dem()
        stable = ~examples.get_glacier_mask()
        slope = terrain.get_terrain_attribute(ref, "slope")
        fit = NuthKaab().fit(ref, tba, inlier_mask=stable, random_state=42)
        print(float(np.nanmean(np.asarray(slope.data))), fit.meta["outputs"]["affine"]["shift_x"])
        for call in (lambda: xdem_tpu.volume.hypsometric_binning(np.ones(4), np.arange(4.0)),
                     ref.plot):
            try:
                call()
            except ImportError as err:
                print("ImportError:", err)
        """,
        JAX_PLATFORMS="cpu",
    )
    slope, shift_x = (float(v) for v in out.stdout.split()[:2])
    assert 0 < slope < 90 and abs(shift_x - 9.2) < 1.5
    assert "Optional dependency 'pandas'" in out.stdout
    assert "Optional dependency 'matplotlib'" in out.stdout


_CACHE_DIR = "import jax, xdem_tpu; print(jax.config.jax_compilation_cache_dir)"


def test_compile_cache_honours_environment(tmp_path):
    # Platform not forced to the CPU: the package must leave JAX's own setting alone
    out = _run(_CACHE_DIR, JAX_COMPILATION_CACHE_DIR=str(tmp_path / "cache"))
    assert out.stdout.strip() == str(tmp_path / "cache")


def test_compile_cache_default_is_one_path_in_the_checkout():
    first = _run(_CACHE_DIR).stdout.strip()
    second = _run(_CACHE_DIR).stdout.strip()
    assert first == second == os.path.join(REPO, ".jax_cache")


@pytest.mark.parametrize("platform", ["cpu", "cuda"])
def test_initialize_multihost_keeps_the_platform(platform):
    out = _run(
        """
        import json
        import jax
        from xdem_tpu.parallel import distributed
        calls = []
        jax.distributed.initialize = lambda **kw: calls.append(["initialize", kw["num_processes"]])
        jax.config.update = lambda name, value: calls.append([name, value])
        distributed.initialize_multihost("localhost:1234", 2, 0, local_devices=3)
        print(json.dumps(calls))
        """,
        JAX_PLATFORMS=platform,
    )
    calls = json.loads(out.stdout.strip().splitlines()[-1])
    assert ["initialize", 2] in calls
    assert not any(c[0] == "jax_platforms" for c in calls)
    assert (["jax_num_cpu_devices", 3] in calls) == (platform == "cpu")
