"""The multi-device layer (port of matfac_tpu/parallel): the mesh, the
process group and the three DSGD solvers."""

from matfac_tpu_torch.parallel.mesh import make_mesh, shard_state, factor_sharding
from matfac_tpu_torch.parallel.dsgd import DSGDShardedSolver

__all__ = ["make_mesh", "shard_state", "factor_sharding",
           "DSGDShardedSolver"]
