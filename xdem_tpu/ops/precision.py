"""Matmul-precision pinning for coordinate-sensitive device programs.

At DEFAULT precision an accelerator may run a float32 ``dot_general`` or convolution in a
reduced format: on an NVIDIA GPU, TF32 (10 explicit mantissa bits, about 3 decimal digits).
That is fine for bandwidth-bound raster kernels, but catastrophic for registration math —
nearest-neighbor distance expansions (``|a|^2+|b|^2-2ab``), rigid point transforms
(``pts @ R.T``) and cross-covariance accumulations lose ~3 decimal digits, which at
NMAD-standardized point clouds (std_fac ~2.5e3 m on a UTM raster) is meter-scale coordinate
error — observed on an earlier accelerator as a ~0.7 relative ICP parity failure between the
device brute path and the host KD-tree path.

``pin_f32_matmuls`` wraps a function so every matmul traced inside it uses full float32
precision. Apply it UNDER ``jax.jit`` (decorator order: ``@jax.jit`` above,
``@pin_f32_matmuls`` below) so the context is active while the program is traced. The
affected matmuls are O(subsample^2) at most — small next to the raster stages.

Must be applied to a sharded solver and its single-device twin TOGETHER: the mesh
invariants (e.g. ICP ``mesh=`` bitwise-equal to one-device brute) compare their outputs.
"""

from __future__ import annotations

import functools

import jax

__all__ = ["pin_f32_matmuls"]


def pin_f32_matmuls(fn):
    """Trace ``fn`` with full-f32 matmul precision (the GPU default may use TF32)."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with jax.default_matmul_precision("highest"):
            return fn(*args, **kwargs)

    return wrapped
