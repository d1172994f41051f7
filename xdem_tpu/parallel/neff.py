"""Multi-device effective-sample-number kernels: the covariance double sum, sharded.

neff_exact / neff_hugonnet_approx reduce sum_ij e_i e_j rho(|c_i - c_j|) (reference
spatialstats.py:2175,2239). The single-chip kernel bounds memory by chunking rows
(xdem_tpu/spatialstats.py:_chunked_weighted_rho_sum); at SURVEY-scale areas (vector outlines
rasterized at range/5 — 1e5-1e6 cells) the remaining wall is compute, which is embarrassingly
row-parallel: shard the row axis across the mesh, run the same chunked matmul-shaped scan per
shard, and psum the partial sums.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P


def weighted_rho_sum_sharded(
    c1: np.ndarray,
    e1: np.ndarray,
    c2: np.ndarray,
    e2: np.ndarray,
    params_variogram_model,
    mesh: Mesh,
    axis: str | None = None,
    target_elems: int = 1 << 24,
) -> float:
    """sum_ij e1_i e2_j rho(|c1_i - c2_j|) with rows sharded across the mesh.

    Exact: zero-weight padding rows contribute nothing, so any row count shards. Matches
    _chunked_weighted_rho_sum (same distance expansion, same rho evaluation); peak memory per
    chip is chunk x M.
    """
    from xdem_tpu.spatialstats import _pairwise_sq_dists, _rho_device

    axis_name = axis or mesh.axis_names[0]
    n_dev = int(np.prod(mesh.devices.shape))
    c2_j = jnp.asarray(np.asarray(c2, np.float32))
    e2_j = jnp.asarray(np.asarray(e2, np.float32))
    m = c2_j.shape[0]
    chunk = int(min(max(64, target_elems // max(m, 1)), max(len(e1), 1)))
    n = len(e1)
    # Pad rows so every device gets the same whole number of chunks
    n_pad = int(np.ceil(n / (chunk * n_dev))) * chunk * n_dev
    c1p = np.zeros((n_pad, np.shape(c1)[1]), np.float32)
    c1p[:n] = c1
    e1p = np.zeros(n_pad, np.float32)  # zero weights kill the padded rows' contributions
    e1p[:n] = e1

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(axis_name, None), P(axis_name), P(None, None), P(None)),
        out_specs=P(),
    )
    def sharded_sum(c1s, e1s, c2f, e2f):
        c1r = c1s.reshape(-1, chunk, c1s.shape[1])
        e1r = e1s.reshape(-1, chunk)

        def body(acc, xe):
            cc, ee = xe
            d = jnp.sqrt(_pairwise_sq_dists(cc, c2f))
            rho = _rho_device(d, params_variogram_model)
            return acc + jnp.sum(ee[:, None] * e2f[None, :] * rho, dtype=jnp.float32), None

        # pvary: the scan carry must be marked device-varying to match the body's output
        acc0 = jax.lax.pvary(jnp.float32(0.0), axis_name)
        acc, _ = jax.lax.scan(body, acc0, (c1r, e1r))
        return jax.lax.psum(acc, axis_name)

    return float(sharded_sum(jnp.asarray(c1p), jnp.asarray(e1p), c2_j, e2_j))
