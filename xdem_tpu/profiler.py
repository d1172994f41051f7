"""Profiling hooks: entry-point timing, memory sampling, and JAX device traces.

The reference decorates all entry points with geoutils' `@profiler.profile("name",
memprof=True)` and exposes `Profiler.enable(save_graphs, save_raw_data)` +
`Profiler.generate_summary(dir)` (reference usage: xdem/dem.py:91, terrain/terrain.py:175,
coreg/base.py:2541; doc/source/config.md:67-105). This module mirrors that API, adding
jax.profiler trace capture for device-side analysis.
"""

from __future__ import annotations

import functools
import json
import logging
import os
import threading
import time
from pathlib import Path
from typing import Any, Callable, TypeVar

F = TypeVar("F", bound=Callable[..., Any])


class _MemorySampler(threading.Thread):
    """Samples host RSS every `interval` seconds while a profiled call runs."""

    def __init__(self, interval: float = 0.05):
        super().__init__(daemon=True)
        self.interval = interval
        self.samples: list[float] = []
        self._stop_evt = threading.Event()

    @staticmethod
    def _rss_mb() -> float:
        try:
            with open("/proc/self/statm") as f:
                pages = int(f.read().split()[1])
            return pages * os.sysconf("SC_PAGE_SIZE") / 1e6
        except (OSError, ValueError):
            return float("nan")

    def run(self) -> None:
        while not self._stop_evt.is_set():
            self.samples.append(self._rss_mb())
            self._stop_evt.wait(self.interval)

    def stop(self) -> list[float]:
        self._stop_evt.set()
        self.join(timeout=1)
        return self.samples


class Profiler:
    """Global profiler: enable once, decorate entry points, generate a summary."""

    _enabled = False
    _save_graphs = False
    _save_raw_data = False
    _jax_trace_dir: str | None = None
    _records: list[dict[str, Any]] = []

    @classmethod
    def enable(cls, save_graphs: bool = False, save_raw_data: bool = False,
               jax_trace_dir: str | None = None) -> None:
        """Start recording profiled calls; optionally capture jax.profiler device traces."""
        cls._enabled = True
        cls._save_graphs = save_graphs
        cls._save_raw_data = save_raw_data
        cls._jax_trace_dir = jax_trace_dir
        cls._records = []

    @classmethod
    def disable(cls) -> None:
        cls._enabled = False

    @classmethod
    def records(cls) -> list[dict[str, Any]]:
        return list(cls._records)

    @classmethod
    def generate_summary(cls, directory: str | Path) -> Path:
        """Write per-entry-point timing/memory tables (CSV + JSON) and return the directory."""
        directory = Path(directory)
        directory.mkdir(parents=True, exist_ok=True)
        import pandas as pd

        if cls._records:
            df = pd.DataFrame(cls._records)
            agg = df.groupby("name").agg(
                calls=("wall_s", "size"),
                total_s=("wall_s", "sum"),
                mean_s=("wall_s", "mean"),
                max_s=("wall_s", "max"),
                peak_mem_mb=("peak_mem_mb", "max"),
            ).reset_index().sort_values("total_s", ascending=False)
            agg.to_csv(directory / "profiling_summary.csv", index=False)
            if cls._save_raw_data:
                df.to_csv(directory / "profiling_raw.csv", index=False)
            if cls._save_graphs:
                try:
                    import matplotlib

                    matplotlib.use("Agg")
                    import matplotlib.pyplot as plt

                    fig, ax = plt.subplots(figsize=(8, max(2, 0.4 * len(agg))))
                    ax.barh(agg["name"], agg["total_s"])
                    ax.set_xlabel("total wall time (s)")
                    fig.savefig(directory / "profiling_graph.png", dpi=120, bbox_inches="tight")
                    plt.close(fig)
                except ImportError:
                    pass
        (directory / "profiling_meta.json").write_text(
            json.dumps({"n_records": len(cls._records), "jax_trace_dir": cls._jax_trace_dir})
        )
        return directory


def profile(name: str, memprof: bool = False) -> Callable[[F], F]:
    """Decorator: record wall time (and memory / jax trace when enabled) of an entry point."""

    def decorator(func: F) -> F:
        @functools.wraps(func)
        def wrapper(*args: Any, **kwargs: Any) -> Any:
            if not Profiler._enabled:
                return func(*args, **kwargs)
            sampler = None
            if memprof:
                sampler = _MemorySampler()
                sampler.start()
            trace_cm = None
            if Profiler._jax_trace_dir is not None:
                import jax

                trace_cm = jax.profiler.trace(Profiler._jax_trace_dir)
                trace_cm.__enter__()
            t0 = time.perf_counter()
            try:
                return func(*args, **kwargs)
            finally:
                wall = time.perf_counter() - t0
                if trace_cm is not None:
                    trace_cm.__exit__(None, None, None)
                peak = float("nan")
                if sampler is not None:
                    samples = sampler.stop()
                    peak = max(samples) if samples else float("nan")
                Profiler._records.append({"name": name, "wall_s": wall, "peak_mem_mb": peak,
                                          "ts": time.time()})
                logging.debug("profile[%s]: %.4f s", name, wall)

        return wrapper  # type: ignore[return-value]

    return decorator


#: Client-side trace events that mark one compiled-program launch, per PJRT client.
_EXECUTE_EVENTS = (
    "PjRtCpuExecutable::Execute",  # CPU client
    "PjRtStreamExecutorLoadedExecutable::Execute",  # GPU (StreamExecutor) client
)
#: Client-side trace event that marks one batched host->device copy.
_H2D_EVENT = "BatchedCopyToDeviceWithSharding: dispatch"


def count_trace_events(events) -> dict[str, int]:
    """Reduce Chrome-trace events (dicts with "ph" and "name") to dispatch counts.

    Returns ``{"executions": ..., "h2d_transfers": ...}``. Raises RuntimeError when the
    events hold no launch event this function knows: a backend whose client names its
    launches differently would otherwise read as zero launches.
    """
    counts = {"executions": 0, "h2d_transfers": 0}
    for e in events:
        if e.get("ph") != "X":
            continue
        name = e.get("name", "")
        if name in _EXECUTE_EVENTS:
            counts["executions"] += 1
        elif name == _H2D_EVENT:
            counts["h2d_transfers"] += 1
    if counts["executions"] == 0:
        raise RuntimeError(
            f"The trace holds no program-launch event ({', '.join(_EXECUTE_EVENTS)}): this "
            "backend's client is not recognised, or nothing ran on the device."
        )
    return counts


def count_device_dispatches(fn, *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` under a jax.profiler trace and count device dispatches.

    Returns ``(result, counts)`` where counts has:
      - ``executions``: compiled-program launches (each pays a fixed launch cost, so for
        small-shape pipelines this count is a latency model);
      - ``h2d_transfers``: batched host->device copies dispatched.

    Counts the PJRT client-side trace events of the CPU and GPU clients (see
    `count_trace_events`, which raises if none is found). Counting is a measurement probe —
    the trace adds overhead, so time separately.
    """
    import glob as _glob
    import gzip as _gzip
    import json as _json
    import shutil as _shutil
    import tempfile as _tempfile

    import jax

    d = _tempfile.mkdtemp(prefix="xdem_dispatch_probe_")
    try:
        with jax.profiler.trace(d):
            result = fn(*args, **kwargs)
            leaves = [x for x in jax.tree.leaves(result) if hasattr(x, "block_until_ready")]
            if leaves:
                jax.block_until_ready(leaves)
        events = []
        for path in _glob.glob(d + "/**/*.trace.json.gz", recursive=True):
            with _gzip.open(path) as fh:
                events.extend(_json.loads(fh.read()).get("traceEvents", []))
        return result, count_trace_events(events)
    finally:
        _shutil.rmtree(d, ignore_errors=True)  # multi-MB trace dumps otherwise accumulate
