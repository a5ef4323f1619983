from matfac_tpu_torch.solvers.block_sgd import BlockSGDSolver

__all__ = ["BlockSGDSolver"]
