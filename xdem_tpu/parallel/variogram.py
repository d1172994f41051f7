"""Multi-chip empirical variogram: sampling runs sharded across devices with psum reduction.

The reference parallelizes independent variogram runs with multiprocessing.Pool
(/root/reference/xdem/spatialstats.py:1499-1509). Here the runs of the equidistant sampling
scheme are sharded over a 1-D device mesh: each device computes pairwise distances and local
per-lag-bin accumulators for its run shard, and the bins are combined with jax.lax.psum
before the estimator is finalized.

Exact for every estimator, including the median-based dowd: the global per-bin median of
|pair differences| is computed with a distributed selection — positive f32 values are
bitcast to monotone integers and the k-th order statistic is located by two rounds of psum'd
16-bit-radix histograms (no gather of the pair population, memory O(n_bins * 65536) per
device regardless of pair count).
"""

from __future__ import annotations

from functools import partial
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P


def _kth_by_bin_distributed(d, parked, counts, k, n_bins, axis):
    """Exact k_b-th smallest of {d_i : parked_i == b} for every bin b, across all shards.

    d must be non-negative f32. Positive IEEE-754 floats compare identically to their bit
    patterns read as integers, so selection runs in bit space: round 1 locates the high-16-bit
    bucket of the k-th element from a psum'd (n_bins, 32768) histogram, round 2 resolves the
    low 16 bits within that bucket. Two collectives, no pair gather.
    """
    bits = jax.lax.bitcast_convert_type(d.astype(jnp.float32), jnp.int32)
    bits = jnp.where(parked < n_bins, bits, 0)
    hi = bits >> 16  # in [0, 32768) for non-negative floats
    lo = bits & 0xFFFF

    flat_hi = jnp.where(parked < n_bins, parked * 32768 + hi, n_bins * 32768)
    hist_hi = jnp.bincount(flat_hi, length=n_bins * 32768 + 1)[:-1].reshape(n_bins, 32768)
    hist_hi = jax.lax.psum(hist_hi, axis)

    cum_hi = jnp.cumsum(hist_hi, axis=1)
    # First bucket whose cumulative count exceeds k (k is 0-based)
    sel_hi = jnp.argmax(cum_hi > k[:, None], axis=1)
    below_hi = jnp.where(sel_hi > 0, jnp.take_along_axis(cum_hi, jnp.maximum(sel_hi - 1, 0)[:, None],
                                                         axis=1)[:, 0], 0)

    in_sel = (parked < n_bins) & (hi == sel_hi[jnp.clip(parked, 0, n_bins - 1)])
    flat_lo = jnp.where(in_sel, parked * 65536 + lo, n_bins * 65536)
    hist_lo = jnp.bincount(flat_lo, length=n_bins * 65536 + 1)[:-1].reshape(n_bins, 65536)
    hist_lo = jax.lax.psum(hist_lo, axis)

    cum_lo = jnp.cumsum(hist_lo, axis=1)
    k_in = k - below_hi
    sel_lo = jnp.argmax(cum_lo > k_in[:, None], axis=1)

    kth_bits = (sel_hi << 16) | sel_lo
    kth = jax.lax.bitcast_convert_type(kth_bits.astype(jnp.int32), jnp.float32)
    return jnp.where(counts > 0, kth, jnp.nan)


def _median_by_bin_distributed(d, parked, counts, n_bins, axis):
    """Exact global per-bin median across shards (midpoint of the two middle elements)."""
    c = counts
    k_lo = jnp.maximum((c - 1) // 2, 0)
    k_hi = c // 2
    m_lo = _kth_by_bin_distributed(d, parked, c, k_lo, n_bins, axis)
    m_hi = _kth_by_bin_distributed(d, parked, c, k_hi, n_bins, axis)
    return 0.5 * (m_lo + m_hi)


_GENTON_CAP = 400  # single-chip _binned_genton subsamples each bin to 400 values


def _genton_pair_keys(run0, n_local_runs: int, n: int, m: int, parked, n_bins: int):
    """Deterministic ranking key per pair for the Genton reservoir.

    The key is the full 32-bit Knuth multiplicative hash of the GLOBAL pair index plus one.
    The multiplier is odd, so (gidx+1) -> (gidx+1)*golden (mod 2^32) is a bijection: unique
    pair indices give UNIQUE keys (pair counts are capped below 2^31, so gidx+1 never wraps
    to 0), and the top-CAP selection is tie-free — identical for any chunking, mesh size, or
    merge layout. The +1 keeps every VALID key non-zero: key 0 is reserved for invalid pairs
    and unfilled reservoir slots (sorts last in descending order), so the valid pair at
    global index 0 is never confused with padding.
    """
    local_run = jnp.arange(n_local_runs, dtype=jnp.uint32)[:, None, None]
    ii = jnp.arange(n, dtype=jnp.uint32)[None, :, None]
    jj = jnp.arange(m, dtype=jnp.uint32)[None, None, :]
    gidx = ((run0.astype(jnp.uint32) + local_run) * jnp.uint32(n * m)
            + ii * jnp.uint32(m) + jj).ravel()
    golden = jnp.uint32(2654435769)  # 2^32 / phi
    key = (gidx + jnp.uint32(1)) * golden
    return jnp.where(parked < n_bins, key, jnp.uint32(0))


def _genton_local_topcap(d, parked, key, n_bins: int):
    """Per-bin top-CAP (values, keys) by descending key: one lexsort + segment-head gather.
    Unfilled slots carry NaN values and key 0."""
    order = jnp.lexsort((~key, parked))  # parked asc primary; ~key asc == key desc
    d_s = d[order]
    key_s = key[order]
    counts_local = jnp.bincount(parked, length=n_bins + 1)[:n_bins]
    starts = jnp.cumsum(counts_local) - counts_local
    take = jnp.minimum(counts_local, _GENTON_CAP)
    offs = jnp.arange(_GENTON_CAP)[None, :]
    pos = jnp.clip(starts[:, None] + offs, 0, d.size - 1)
    loc_vals = jnp.where(offs < take[:, None], d_s[pos], jnp.nan)
    loc_keys = jnp.where(offs < take[:, None], key_s[pos], jnp.uint32(0))
    return loc_vals, loc_keys


def _genton_merge_topcap(merged_v, merged_k):
    """Global top-CAP per bin from concatenated (n_bins, K) candidate values/keys."""
    top = jnp.argsort(~merged_k, axis=1)[:, :_GENTON_CAP]  # descending key
    return jnp.take_along_axis(merged_v, top, axis=1), jnp.take_along_axis(merged_k, top, axis=1)


def _genton_distributed(d, parked, counts, run0, n_local_runs, n, m, n_bins, axis):
    """Genton (1998) Qn per lag bin with a distributed uniform reservoir.

    The single-chip estimator subsamples each bin to 400 values before the O(n^2) Qn; here
    every shard keeps its local top-400 per bin ranked by the tie-free deterministic pair
    keys (_genton_pair_keys), and an all_gather + merge takes the global top-400 — the same
    uniform-without-replacement sample regardless of mesh size or chunking.
    """
    key = _genton_pair_keys(run0, n_local_runs, n, m, parked, n_bins)
    loc_vals, loc_keys = _genton_local_topcap(d, parked, key, n_bins)

    # Merge across shards: global top-CAP by key per bin
    all_vals = jax.lax.all_gather(loc_vals, axis)      # (n_dev, n_bins, CAP)
    all_keys = jax.lax.all_gather(loc_keys, axis)
    n_dev = all_vals.shape[0]
    merged_v = jnp.transpose(all_vals, (1, 0, 2)).reshape(n_bins, n_dev * _GENTON_CAP)
    merged_k = jnp.transpose(all_keys, (1, 0, 2)).reshape(n_bins, n_dev * _GENTON_CAP)
    x, _k = _genton_merge_topcap(merged_v, merged_k)        # (n_bins, CAP), NaN-padded
    n_samp = jnp.minimum(counts, _GENTON_CAP)

    # Qn: k-th smallest of the upper-triangle pairwise |x_i - x_j|, k = C(h, 2), h = n//2 + 1
    diffs = jnp.abs(x[:, :, None] - x[:, None, :])
    iu = jnp.arange(_GENTON_CAP)
    upper = iu[None, :, None] < iu[None, None, :]
    valid_pair = jnp.isfinite(diffs) & upper
    flat = jnp.where(valid_pair, diffs, jnp.inf).reshape(n_bins, -1)
    flat = jnp.sort(flat, axis=1)
    h = n_samp // 2 + 1
    k = (h * (h - 1)) // 2
    n_pairs = (n_samp * (n_samp - 1)) // 2
    k = jnp.clip(jnp.maximum(k, 1), 1, jnp.maximum(n_pairs, 1))
    qn = jnp.take_along_axis(flat, (k - 1)[:, None].astype(jnp.int32), axis=1)[:, 0]
    gamma = (2.2191 * qn) ** 2 / 2
    return jnp.where(counts > 1, gamma, jnp.nan)


def _pair_bins(za, zb, ca, cb, edges, n_bins):
    """Flattened pair diffs (absolute and signed) and lag-bin index over batched
    (R_local, N, M) pairwise blocks."""
    diffs = (za[:, :, None] - zb[:, None, :]).ravel()
    d2 = jnp.sum((ca[:, :, None, :] - cb[:, None, :, :]) ** 2, axis=-1)
    dists = jnp.sqrt(d2)
    dists = jnp.where(dists <= 0, jnp.nan, dists)
    d = jnp.abs(diffs)
    h = dists.ravel()
    valid = jnp.isfinite(d) & jnp.isfinite(h) & (h >= edges[0]) & (h <= edges[-1])
    idx = jnp.clip(jnp.searchsorted(edges, h, side="right") - 1, 0, n_bins - 1)
    parked = jnp.where(valid, idx, n_bins)
    return d, diffs, parked, valid


def sharded_variogram_bins(
    za: np.ndarray,
    zb: np.ndarray,
    ca: np.ndarray,
    cb: np.ndarray,
    bin_edges: Sequence[float],
    mesh: Mesh,
    estimator: str = "matheron",
) -> tuple[np.ndarray, np.ndarray]:
    """Per-lag-bin variogram over (R, N) x (R, M) sampling runs sharded across `mesh`.

    :param za: (R, N) center-sample values per run (NaN-padded).
    :param zb: (R, M) comparison-sample values per run.
    :param ca: (R, N, 2) center coordinates.
    :param cb: (R, M, 2) comparison coordinates.
    :returns: (gamma per bin, pair count per bin), aggregated across all devices.

    Any mesh shape is accepted: an N-D mesh is flattened to 1-D over all its devices
    (run sharding is 1-D by nature — without this, P(axis0) would shard runs over only the
    first axis while run offsets assumed all devices, corrupting the Genton pair keys).
    """
    from xdem_tpu.parallel.mesh import as_mesh_1d

    mesh = as_mesh_1d(mesh)
    axis = mesh.axis_names[0]
    n_dev = mesh.devices.size
    R = za.shape[0]
    pad = (-R) % n_dev
    if pad:
        za = np.pad(za, ((0, pad), (0, 0)), constant_values=np.nan)
        zb = np.pad(zb, ((0, pad), (0, 0)), constant_values=np.nan)
        ca = np.pad(ca, ((0, pad), (0, 0), (0, 0)), constant_values=np.nan)
        cb = np.pad(cb, ((0, pad), (0, 0), (0, 0)), constant_values=np.nan)

    edges = jnp.asarray(np.asarray(bin_edges, dtype=np.float32))
    n_bins = len(bin_edges) - 1

    if estimator not in ("matheron", "cressie", "dowd", "genton"):
        raise ValueError(f"Estimator '{estimator}' not supported for the sharded variogram.")
    n_local_runs = (R + pad) // n_dev
    n_pts, m_pts = za.shape[1], zb.shape[1]

    # genton computes its result from an all_gather'd reservoir: the output IS replicated,
    # but shard_map's static replication checker cannot prove it — disable the check there.
    _smap_kwargs = {}
    if estimator == "genton":
        _smap_kwargs = {"check_vma": False}

    @jax.jit
    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(axis)),
        out_specs=(P(), P()),
        **_smap_kwargs,
    )
    def run(za_s, zb_s, ca_s, cb_s):
        d, d_signed, parked, valid = _pair_bins(za_s, zb_s, ca_s, cb_s, edges, n_bins)
        counts = jax.lax.psum(jnp.bincount(parked, length=n_bins + 1)[:n_bins], axis)
        if estimator == "matheron":
            acc = jnp.bincount(parked, weights=jnp.where(valid, d * d, 0.0), length=n_bins + 1)[:n_bins]
            return jax.lax.psum(acc, axis), counts
        if estimator == "cressie":
            acc = jnp.bincount(parked, weights=jnp.where(valid, jnp.sqrt(d), 0.0), length=n_bins + 1)[:n_bins]
            return jax.lax.psum(acc, axis), counts
        if estimator == "genton":
            # Qn is a scale estimator of the SIGNED pair differences (like the single-chip
            # _binned_genton): gamma = Qn(d_signed)^2 / 2 estimates the semivariance
            run0 = jax.lax.axis_index(axis) * n_local_runs
            return _genton_distributed(d_signed, parked, counts, run0, n_local_runs,
                                       n_pts, m_pts, n_bins, axis), counts
        # dowd: exact global per-bin median via distributed bit-space selection
        med = _median_by_bin_distributed(d, parked, counts, n_bins, axis)
        return med, counts

    acc, counts = run(
        jnp.asarray(za, jnp.float32), jnp.asarray(zb, jnp.float32),
        jnp.asarray(ca, jnp.float32), jnp.asarray(cb, jnp.float32),
    )
    acc = np.asarray(acc, dtype=np.float64)
    counts_np = np.asarray(counts, dtype=np.int64)
    with np.errstate(invalid="ignore", divide="ignore"):
        if estimator == "matheron":
            gamma = np.where(counts_np > 0, acc / (2 * np.maximum(counts_np, 1)), np.nan)
        elif estimator == "cressie":
            n = np.maximum(counts_np, 1)
            gamma = np.where(counts_np > 0, ((acc / n) ** 4) / (0.457 + 0.494 / n + 0.045 / n**2) / 2, np.nan)
        elif estimator == "genton":
            gamma = acc  # already finalized on device
        else:  # dowd on the exact global median
            gamma = np.where(counts_np > 0, 2.198 * acc**2 / 2, np.nan)
    return gamma, counts_np
