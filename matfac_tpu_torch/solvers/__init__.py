from matfac_tpu_torch.solvers.als import (ALSSolver, DenseALSSolver,
                                          SubspaceALSSolver)
from matfac_tpu_torch.solvers.block_sgd import BlockSGDSolver
from matfac_tpu_torch.solvers.ccd import CCDPPSolver, CCDSolver

__all__ = ["ALSSolver", "BlockSGDSolver", "CCDPPSolver", "CCDSolver",
           "DenseALSSolver", "SubspaceALSSolver"]
