"""cwbnwp_letkf_tpu: a LETKF analysis framework for WRF ensembles in JAX.

A from-scratch JAX/XLA re-design of the capabilities of the reference
Fortran90+MPI implementation (lopunch/CWBNWP-LETKF): the Hunt et al. (2007)
local ensemble transform Kalman filter for convective-scale WRF ensembles,
with conventional (GTS) and radar observations, distance-based R-localization,
and multiplicative/RTPP/RTPS inflation.  It runs on one NVIDIA GPU or on a
mesh of them; the CPU backend serves the tests.

Design at a glance (vs the reference's architecture):

* the per-gridpoint serial solve loop (module_letkf_core.f90:209-240) becomes
  one batched, sharded computation over all gridpoints: localized normal
  terms accumulated by matmul, then a batched k-by-k Newton-Schulz inverse
  square root (ops/solver.py);
* the kd-tree radius search (module_kdtree2.f90) becomes on-device distance
  matmuls with a capped threshold and block culling (ops/dense.py,
  ops/bucketed.py);
* the MPI domain decomposition (module_mpi_util.f90) becomes a
  ``jax.sharding.Mesh`` with gridpoints sharded over all devices and obs
  replicated (parallel/);
* Fortran namelist config is importable verbatim (config.py).
"""

from .config import LetkfConfig
from .projection import LambertProjection

__version__ = "0.1.0"

__all__ = ["LetkfConfig", "LambertProjection", "__version__"]
