from matfac_tpu_torch.eval.metrics import Evaluator

__all__ = ["Evaluator"]
