"""Multi-host execution: jax.distributed initialization and cross-process meshes (multi-host path).

The reference is single-node (its only parallelism is multiprocessing.Pool). Here XLA
collectives span the devices of one host, and `jax.distributed` spans hosts. This module makes
that path executable — and testable on one machine by launching several coordinated CPU
processes:

    python -m xdem_tpu.parallel.distributed --coordinator 127.0.0.1:9876 \
        --num-processes 2 --process-id 0 --local-devices 4

Each process contributes its local shard of the sampling runs via
jax.make_array_from_process_local_data; the shard_map'd variogram kernel then psums per-bin
accumulators across every device of every process. `launch_local_cluster()` spawns such a
process group for tests/dryruns.
"""

from __future__ import annotations

import os
import subprocess
import sys
from typing import Sequence

import numpy as np


def initialize_multihost(coordinator: str, num_processes: int, process_id: int,
                         local_devices: int = 1) -> None:
    """Configure this process as one member of a multi-host JAX cluster.

    Must run before any JAX backend initialization. The platform is whatever JAX resolves
    (JAX_PLATFORMS or the default accelerator); only when it is the CPU does
    ``local_devices`` set the per-process virtual device count. Then joins the
    coordination service.
    """
    import jax

    platforms = jax.config.jax_platforms or os.environ.get("JAX_PLATFORMS", "")
    if platforms.split(",")[0].strip().lower() == "cpu":
        jax.config.update("jax_num_cpu_devices", local_devices)
    jax.distributed.initialize(
        coordinator_address=coordinator, num_processes=num_processes, process_id=process_id
    )


def global_mesh(axis_name: str = "p"):
    """A 1-D mesh over every device of every process in the cluster."""
    import jax
    from jax.sharding import Mesh

    return Mesh(np.asarray(jax.devices()), axis_names=(axis_name,))


def multihost_variogram_bins(
    za_local: np.ndarray,
    zb_local: np.ndarray,
    ca_local: np.ndarray,
    cb_local: np.ndarray,
    bin_edges: Sequence[float],
    mesh,
    estimator: str = "matheron",
):
    """Variogram bin accumulation across ALL processes: each passes its local runs only.

    The local (R_local, ...) shards are assembled into global arrays with
    jax.make_array_from_process_local_data, and the same shard_map + psum kernel as the
    single-host path reduces the per-lag bins over the full cluster. Returns (gamma, counts)
    replicated on every process.
    """
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from xdem_tpu.parallel.variogram import sharded_variogram_bins

    axis = mesh.axis_names[0]
    sharding = NamedSharding(mesh, P(axis))

    def globalize(arr):
        return jax.make_array_from_process_local_data(sharding, jnp.asarray(arr, jnp.float32))

    za_g = globalize(za_local)
    zb_g = globalize(zb_local)
    ca_g = globalize(ca_local)
    cb_g = globalize(cb_local)
    return sharded_variogram_bins(za_g, zb_g, ca_g, cb_g, bin_edges, mesh, estimator=estimator)


def multihost_surface_attributes(
    dem_local_rows: np.ndarray,
    mesh,
    resolution: float,
    attrs: tuple[str, ...],
    **kwargs,
):
    """Halo-exchange terrain stencil over a 2-D mesh spanning every process (multi-host path).

    Each process contributes its horizontal band of the raster; the ppermute halo exchange
    crosses process boundaries through the same collective path as across hosts. Returns
    the (len(attrs), H, W) result replicated on every process.
    """
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from xdem_tpu.parallel.halo import sharded_surface_attributes

    ry, rx = mesh.axis_names
    sharding = NamedSharding(mesh, P(ry, rx))
    global_arr = jax.make_array_from_process_local_data(
        sharding, jnp.asarray(dem_local_rows, jnp.float32)
    )
    out = sharded_surface_attributes(global_arr, resolution, mesh=mesh, attrs=attrs, **kwargs)
    # Replicate so every process can read the full result
    rep = jax.device_put(out, NamedSharding(mesh, P()))
    return np.asarray(rep)


def _make_run_data(seed: int, n_runs: int, n: int, m: int):
    rng = np.random.default_rng(seed)
    za = rng.normal(0, 2.0, (n_runs, n)).astype(np.float32)
    zb = rng.normal(0, 2.0, (n_runs, m)).astype(np.float32)
    ca = rng.uniform(0, 1000, (n_runs, n, 2)).astype(np.float32)
    cb = rng.uniform(0, 1000, (n_runs, m, 2)).astype(np.float32)
    return za, zb, ca, cb


def _worker_main(coordinator: str, num_processes: int, process_id: int, local_devices: int) -> None:
    initialize_multihost(coordinator, num_processes, process_id, local_devices)
    import jax
    import jax.numpy as jnp

    mesh = global_mesh()
    n_dev = mesh.devices.size
    runs_per_dev = 2
    n, m = 24, 40
    edges = [0.0, 250.0, 600.0, 1500.0]

    # Deterministic global dataset; each process holds only its slice of the runs
    za, zb, ca, cb = _make_run_data(7, runs_per_dev * n_dev, n, m)
    lo = process_id * (za.shape[0] // num_processes)
    hi = (process_id + 1) * (za.shape[0] // num_processes)
    gamma, counts = multihost_variogram_bins(
        za[lo:hi], zb[lo:hi], ca[lo:hi], cb[lo:hi], edges, mesh, estimator="dowd"
    )

    # Every process cross-checks against the single-device result on the full dataset
    from jax.sharding import Mesh

    mesh1 = Mesh(np.asarray(jax.local_devices()[:1]), axis_names=("q",))
    from xdem_tpu.parallel.variogram import sharded_variogram_bins

    g1, c1 = sharded_variogram_bins(za, zb, ca, cb, edges, mesh1, estimator="dowd")
    assert (np.asarray(counts) == np.asarray(c1)).all(), (counts, c1)
    assert np.allclose(np.asarray(gamma), np.asarray(g1), rtol=1e-6, equal_nan=True), (gamma, g1)

    # Spatial decomposition across processes: halo-exchange stencil on a 2-D mesh whose row
    # axis spans the process boundary (the multi-host large-raster path)
    from xdem_tpu.parallel.mesh import make_mesh
    from xdem_tpu.terrain.surfit import surface_attributes

    H = 16 * num_processes
    W = 128
    rng2 = np.random.default_rng(11)
    dem_full = np.cumsum(rng2.normal(0, 1, (H, W)), axis=0).astype(np.float32) * 3 + 500
    mesh2 = make_mesh(shape=(num_processes, local_devices), devices=list(jax.devices()))
    lo = process_id * (H // num_processes)
    local_rows = dem_full[lo: lo + H // num_processes]
    out2 = multihost_surface_attributes(local_rows, mesh2, 20.0,
                                        ("slope", "aspect", "hillshade"), surface_fit="Florinsky")
    want = np.asarray(surface_attributes(jnp.asarray(dem_full), 20.0,
                                         ("slope", "aspect", "hillshade"), surface_fit="Florinsky"))
    both = np.isfinite(out2) & np.isfinite(want)
    assert (np.isfinite(out2) == np.isfinite(want)).all()
    assert np.allclose(out2[both], want[both], atol=1e-3), np.abs(out2[both] - want[both]).max()

    if process_id == 0:
        print(
            f"DISTRIBUTED OK: {num_processes} processes x {local_devices} devices = "
            f"{n_dev} global devices; dowd bins {np.round(np.asarray(gamma), 4).tolist()} "
            f"counts {np.asarray(counts).tolist()}; cross-process halo stencil "
            f"{out2.shape} matches single-device",
            flush=True,
        )


def launch_local_cluster(num_processes: int = 2, local_devices: int = 4, timeout: float = 600.0) -> str:
    """Spawn a coordinated multi-process CPU cluster running the distributed check.

    Returns process 0's stdout (contains 'DISTRIBUTED OK'); raises on any failure.
    """
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    coordinator = f"127.0.0.1:{port}"
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"  # a CPU test harness: no child may open an accelerator
    env.pop("XLA_FLAGS", None)
    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen(
            [
                sys.executable, "-m", "xdem_tpu.parallel.distributed",
                "--coordinator", coordinator,
                "--num-processes", str(num_processes),
                "--process-id", str(i),
                "--local-devices", str(local_devices),
            ],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for i in range(num_processes)
    ]
    outs = []
    failed = []
    for i, p in enumerate(procs):
        try:
            out, err = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise RuntimeError(f"distributed worker {i} timed out")
        outs.append(out)
        if p.returncode != 0:
            failed.append((i, p.returncode, err[-2000:]))
    if failed:
        raise RuntimeError(f"distributed workers failed: {failed}")
    if "DISTRIBUTED OK" not in outs[0]:
        raise RuntimeError(f"process 0 did not report success: {outs[0][-500:]}")
    return outs[0]


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--local-devices", type=int, default=1)
    args = ap.parse_args()
    _worker_main(args.coordinator, args.num_processes, args.process_id, args.local_devices)
