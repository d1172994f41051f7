"""Multi-chip parallelism: device meshes and halo-exchange sharded stencils.

The reference scales raster size via tiled map-overlap multiprocessing with halo depth derived
from the stencil radius (/root/reference/xdem/terrain/terrain.py:412-463) and per-tile writes.
The device equivalent here is spatial domain decomposition over a jax.sharding.Mesh with
shard_map + ppermute halo exchange between devices.
"""

from xdem_tpu.parallel.mesh import as_mesh_1d, as_mesh_2d, make_mesh
from xdem_tpu.parallel.halo import sharded_stencil, sharded_surface_attributes
from xdem_tpu.parallel.cpd import cpd_em_step_sharded
from xdem_tpu.parallel.neff import weighted_rho_sum_sharded

__all__ = [
    "make_mesh",
    "as_mesh_1d",
    "as_mesh_2d",
    "sharded_stencil",
    "sharded_surface_attributes",
    "cpd_em_step_sharded",
    "weighted_rho_sum_sharded",
]
