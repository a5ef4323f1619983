from matfac_tpu_torch.solvers.als import (ALSSolver, DenseALSSolver,
                                          SubspaceALSSolver)
from matfac_tpu_torch.solvers.block_sgd import BlockSGDSolver
from matfac_tpu_torch.solvers.ccd import CCDPPSolver, CCDSolver
from matfac_tpu_torch.solvers.sgd import SGDSolver

__all__ = ["SGDSolver", "ALSSolver", "BlockSGDSolver", "CCDPPSolver",
           "CCDSolver", "DenseALSSolver", "SubspaceALSSolver"]
