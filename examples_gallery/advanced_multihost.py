"""Multi-host execution: a jax.distributed cluster computing one exact variogram together.

Spawns two coordinated CPU processes (the coordination path is the same for accelerator
hosts: only the platform changes); each contributes its local shard of the sampling runs, and the
shard_map'd kernel psums per-lag-bin accumulators across every device of every process. The
dowd estimator stays EXACT across the cluster — the global per-bin median is found by
distributed bit-space radix selection, not by aggregating shard medians.
"""
from xdem_tpu.parallel.distributed import launch_local_cluster

out = launch_local_cluster(num_processes=2, local_devices=2)
print(out.strip().splitlines()[-1])
