"""Device-mesh parallelism: the replacement for module_mpi_util.f90.

The reference's MPI machinery — cyclic 2-D domain decomposition, the
member-layout <-> domain-layout ``mpi_alltoallv`` transposes, obs broadcast
(module_mpi_util.f90) — collapses on a device mesh to one canonical
sharding: analysis points sharded over the mesh, ensemble and obs replicated.
The LETKF update is embarrassingly parallel over gridpoints (each point's
k-by-k solve is independent, letkf_core.f90:209-240), so no collectives are
needed inside the update at all; the only cross-device ops are the
ensemble-mean reductions at output time.
"""

from .mesh import make_mesh, shard_points
from .update import sharded_update_points

__all__ = ["make_mesh", "shard_points", "sharded_update_points"]
