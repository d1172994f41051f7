"""Multi-chip CPD: the O(N*M) EM responsibility matrix tiled across devices.

The single-chip CPD step (xdem_tpu/coreg/affine.py:_cpd_em_step) materializes the full (M, N)
responsibility matrix in one device's memory — the memory wall the reference notes for its own
numpy implementation (reference affine.py:1190-1294, "O(N*M) memory!"). Here the REFERENCE
point axis (N) is sharded across the mesh: responsibilities normalize over the moving axis,
which is local to every shard, so the E-step is exact per shard, and the M-step moments
(P1, Np, the first moments, the cross-covariance, xPx) combine with jax.lax.psum.
Memory per device: M x N/n_devices.

`cpd_em_step_sharded` runs one EM step (building block); `cpd_solve_sharded` runs the FULL
EM iteration as one lax.while_loop inside one shard_map — the user-facing `CPD().fit(...,
mesh=)` path (reference affine.py:1190-1340 semantics, f32-reassociation tolerance vs the
single-device solve).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from xdem_tpu.ops.precision import pin_f32_matmuls


def _cpd_em_local(Xs, Yf, TYf, weight_cpd: float, s2, s2min, axis_name: str,
                  only_translation: bool, n_eff: float):
    """One CPD EM step on a reference-point shard; psum reductions over `axis_name`.

    Semantics match the single-device _cpd_em_step exactly (same responsibilities, same
    M-step solve): the per-reference-point normalization sums over the moving cloud, which
    every shard holds in full, so the E-step needs no collective. NaN rows of Xs (shard
    padding) get zero responsibility; `n_eff` is the UNPADDED reference count so the uniform
    outlier constant keeps the reference's M/N weighting.
    """
    M, D = Yf.shape
    finite = jnp.all(jnp.isfinite(Xs), axis=1)
    Xl = jnp.where(finite[:, None], Xs, 0.0)  # (N/n, D)
    x2 = jnp.sum(Xl * Xl, axis=1)[None, :]
    t2 = jnp.sum(TYf * TYf, axis=1)[:, None]
    Pl = t2 + x2 - 2.0 * TYf @ Xl.T  # (M, N/n) pairwise sq-dists via a matmul
    Pl = jnp.exp(-Pl / (2 * s2))
    Pl = jnp.where(finite[None, :], Pl, 0.0)
    # Normalization over the MOVING axis: local to the shard — exact, no collective
    Pden = jnp.sum(Pl, axis=0, keepdims=True)
    c = (2 * jnp.pi * s2) ** (D / 2) * weight_cpd / (1.0 - weight_cpd) * M / n_eff
    Pden = jnp.clip(Pden, jnp.finfo(Xl.dtype).eps, None) + c
    Pl = jnp.where(finite[None, :], Pl / Pden, 0.0)

    # Global first moments over the sharded reference axis
    Pt1 = jnp.sum(Pl, axis=0)  # (N/n,) stays shard-local
    P1 = jax.lax.psum(jnp.sum(Pl, axis=1), axis_name)  # (M,)
    Np = jnp.sum(P1)
    px_sum = jax.lax.psum(jnp.sum(Pl @ Xl, axis=0), axis_name)  # (D,) = sum_mn P X
    muX = px_sum / Np
    muY = P1 @ Yf / Np

    X_hat = Xl - muX[None, :]
    Y_hat = Yf - muY[None, :]
    # Cross-covariance A = X_hat^T P^T Y_hat and xPx reduce over the sharded axis
    A = jax.lax.psum(X_hat.T @ (Pl.T @ Y_hat), axis_name)  # (D, D)
    xPx = jax.lax.psum(
        Pt1 @ jnp.where(finite, jnp.sum(X_hat * X_hat, axis=1), 0.0), axis_name
    )
    YPY = P1 @ jnp.sum(Y_hat * Y_hat, axis=1)

    if not only_translation:
        U, _, Vt = jnp.linalg.svd(A, full_matrices=True)
        C = jnp.ones((D,)).at[D - 1].set(jnp.linalg.det(U @ Vt))
        R = (U @ jnp.diag(C) @ Vt).T
    else:
        R = jnp.eye(D, dtype=Xl.dtype)
    t = muX - R.T @ muY

    trAR = jnp.trace(A @ R)
    q = (xPx - 2 * trAR + YPY) / (2 * s2) + D * Np / 2 * jnp.log(s2)
    new_sigma2 = (xPx - trAR) / (Np * D)
    new_sigma2 = jnp.where(new_sigma2 <= 0, s2min, new_sigma2)
    return R, t, new_sigma2, q


@pin_f32_matmuls
def cpd_em_step_sharded(
    X: jnp.ndarray,
    Y: jnp.ndarray,
    TY: jnp.ndarray,
    weight_cpd: float,
    sigma2,
    sigma2_min: float,
    mesh: Mesh,
    only_translation: bool = False,
    axis: str | None = None,
    n_true: int | None = None,
):
    """One CPD EM step with the reference cloud X sharded over a 1-D mesh.

    X's length must divide by the mesh size — pad with NaN rows otherwise and pass the
    unpadded count as `n_true`. Returns (R, t, new_sigma2, q) replicated on every device.
    """
    axis_name = axis or mesh.axis_names[0]
    N, _D = X.shape
    n_eff = float(n_true if n_true is not None else N)

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(axis_name, None), P(None, None), P(None, None), P(), P()),
        out_specs=(P(None, None), P(None), P(), P()),
    )
    def step(Xs, Yf, TYf, s2, s2min):
        return _cpd_em_local(Xs, Yf, TYf, weight_cpd, s2, s2min, axis_name,
                             only_translation, n_eff)

    return step(
        X, Y, TY,
        jnp.asarray(sigma2, X.dtype), jnp.asarray(sigma2_min, X.dtype),
    )


@partial(jax.jit, static_argnames=("max_iterations", "only_translation", "mesh", "n_true"))
@pin_f32_matmuls
def cpd_solve_sharded(
    X: jnp.ndarray,
    Y: jnp.ndarray,
    weight_cpd: float,
    sigma2_init,
    sigma2_min: float,
    tolerance: float,
    max_iterations: int,
    only_translation: bool,
    mesh: Mesh,
    n_true: int | None = None,
):
    """The FULL CPD EM iteration as one lax.while_loop inside one shard_map — the multi-chip
    twin of `_cpd_solve` (coreg/affine.py): same cond/body, same degenerate-EM bailout, with
    the reference cloud X row-sharded and M-step moments psum'd. X must be NaN-row-padded to
    a multiple of the mesh size (pass the unpadded count as `n_true`).

    Returns (R, t, iterations, degenerate_flag) — all replicated.
    """
    axis_name = mesh.axis_names[0]
    N, _D = X.shape
    n_eff = float(n_true if n_true is not None else N)

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(axis_name, None), P(None, None), P(), P()),
        out_specs=(P(None, None), P(None), P(), P()),
    )
    def run(Xs, Yf, s2_0, s2min):
        def cond(c):
            R, t, s2, q, it, stat = c
            return (it < max_iterations) & ~((it > 2) & (stat < tolerance))

        def body(c):
            R, t, s2, q, it, _ = c
            TY = (Yf + t[None, :]) @ R
            Rn, tn, s2n, qn = _cpd_em_local(Xs, Yf, TY, weight_cpd, s2, s2min,
                                            axis_name, only_translation, n_eff)
            ok = jnp.all(jnp.isfinite(Rn)) & jnp.all(jnp.isfinite(tn))
            stat = jnp.abs(qn - q)
            # Degenerate EM (variance collapse): keep the previous estimate and force a stop
            return (jnp.where(ok, Rn, R), jnp.where(ok, tn, t), jnp.where(ok, s2n, s2),
                    jnp.where(ok, qn, q), it + 1, jnp.where(ok, stat, -jnp.inf))

        init = (jnp.eye(3, dtype=jnp.float32), jnp.zeros(3, jnp.float32),
                s2_0.astype(jnp.float32), jnp.asarray(jnp.inf, jnp.float32),
                jnp.asarray(0), jnp.asarray(jnp.inf, jnp.float32))
        R, t, s2, q, it, stat = jax.lax.while_loop(cond, body, init)
        return R, t, it, stat == -jnp.inf

    return run(X, Y, jnp.asarray(sigma2_init, jnp.float32),
               jnp.asarray(sigma2_min, jnp.float32))
