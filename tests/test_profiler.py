"""Profiler subsystem tests."""

import numpy as np

from xdem_tpu import examples, terrain
from xdem_tpu.profiler import Profiler, profile


class TestProfiler:
    def test_disabled_no_overhead(self):
        calls = []

        @profile("test.fn")
        def fn(x):
            calls.append(x)
            return x * 2

        Profiler.disable()
        assert fn(3) == 6
        assert Profiler.records() == []

    def test_records_and_summary(self, tmp_path, ref_dem_test):
        Profiler.enable(save_graphs=True, save_raw_data=True)
        try:
            terrain.get_terrain_attribute(ref_dem_test, "slope")
            terrain.get_terrain_attribute(ref_dem_test, "hillshade")
            recs = Profiler.records()
            assert len(recs) == 2
            assert all(r["name"] == "xdem_tpu.terrain.get_terrain_attribute" for r in recs)
            assert all(r["wall_s"] > 0 for r in recs)
            assert all(np.isfinite(r["peak_mem_mb"]) for r in recs)
            out = Profiler.generate_summary(tmp_path / "prof")
            assert (out / "profiling_summary.csv").exists()
            assert (out / "profiling_raw.csv").exists()
            assert (out / "profiling_graph.png").exists()
        finally:
            Profiler.disable()

    def test_coreg_entry_points_profiled(self, ref_dem_test):
        from xdem_tpu import coreg

        Profiler.enable()
        try:
            c = coreg.VerticalShift()
            tba = ref_dem_test + 2.0
            c.fit(ref_dem_test, tba, random_state=42)
            c.apply(tba)
            names = {r["name"] for r in Profiler.records()}
            assert "xdem_tpu.coreg.Coreg.fit" in names
            assert "xdem_tpu.coreg.Coreg.apply" in names
        finally:
            Profiler.disable()


class TestDispatchCounter:
    # Client-side events as recorded in a jax.profiler trace of two jitted launches and one
    # batched host->device copy on an NVIDIA H100 (JAX 0.9, StreamExecutor GPU client),
    # with the device-side kernel and copy events of the same window.
    GPU_EVENTS = [
        {"ph": "X", "pid": 1, "name": "BatchedCopyToDeviceWithSharding: dispatch"},
        {"ph": "X", "pid": 1, "name": "DevicePutWithSharding"},
        {"ph": "X", "pid": 1, "name": "MemcpyH2D"},
        {"ph": "X", "pid": 2, "name": "MemcpyH2D"},
        {"ph": "X", "pid": 1, "name": "PjitFunction(<lambda>)"},
        {"ph": "X", "pid": 1, "name": "PjRtStreamExecutorLoadedExecutable::Execute"},
        {"ph": "X", "pid": 1, "name": "PjRtStreamExecutorLoadedExecutable::ExecuteHelper"},
        {"ph": "X", "pid": 1, "name": "GpuExecutable::ExecuteThunks"},
        {"ph": "X", "pid": 2, "name": "loop_add_fusion"},
        {"ph": "X", "pid": 1, "name": "PjRtStreamExecutorLoadedExecutable::Execute"},
        {"ph": "X", "pid": 2, "name": "input_reduce_fusion"},
        {"ph": "M", "pid": 2, "name": "process_name", "args": {"name": "/device:GPU:0"}},
    ]

    def test_counts_gpu_client_events(self):
        from xdem_tpu.profiler import count_trace_events

        assert count_trace_events(self.GPU_EVENTS) == {"executions": 2, "h2d_transfers": 1}

    def test_raises_without_known_launch_events(self):
        import pytest

        from xdem_tpu.profiler import count_trace_events

        with pytest.raises(RuntimeError, match="no program-launch event"):
            count_trace_events([])
        with pytest.raises(RuntimeError, match="no program-launch event"):
            count_trace_events([e for e in self.GPU_EVENTS if "Execute" not in e["name"]])
