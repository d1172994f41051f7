"""Entry-point tests: the multichip dryrun is a virtual-CPU rehearsal of the sharded path.

``dryrun_multichip(n)`` always runs in a child forced onto n virtual CPU devices, whatever
the calling process holds: a process with one device, or one that holds a card, must still
get the n-device rehearsal, and the child must never open an accelerator.
"""

import os
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_dryrun_multichip_in_process():
    """From the test env (8 virtual CPU devices) the rehearsal runs in its forced-CPU child."""
    sys.path.insert(0, REPO)
    try:
        import __graft_entry__ as g

        g.dryrun_multichip(8)
    finally:
        sys.path.remove(REPO)


def test_dryrun_multichip_reexecs_when_pinned_to_one_device():
    """A caller whose backends are already initialized with a single device."""
    code = textwrap.dedent(
        """
        import jax
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_num_cpu_devices", 1)
        assert len(jax.devices()) == 1  # backends now initialized, single device
        import __graft_entry__ as g
        g.dryrun_multichip(8)
        print("REEXEC-PATH-OK")
        """
    )
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=600,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "REEXEC-PATH-OK" in proc.stdout
    assert "dryrun_multichip OK on 8 devices" in proc.stdout


def test_multihost_distributed_cluster():
    """jax.distributed across 2 coordinated CPU processes: the cross-process psum'd
    variogram equals the single-device result exactly (SURVEY §2.7 multi-host path)."""
    from xdem_tpu.parallel.distributed import launch_local_cluster

    out = launch_local_cluster(num_processes=2, local_devices=2)
    assert "DISTRIBUTED OK" in out
    assert "4 global devices" in out
