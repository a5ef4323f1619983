"""The analysis layer (port of matfac_tpu/analysis), with JAX's exports."""

from matfac_tpu_torch.analysis.confidence import (confidence_curve,
                                                  ensemble_conf_scores,
                                                  rmse_curve,
                                                  score_bucket_rmses)
from matfac_tpu_torch.analysis.topn import top_n_rec
from matfac_tpu_torch.analysis.compare import model_agreement

__all__ = ["ensemble_conf_scores", "rmse_curve", "confidence_curve",
           "score_bucket_rmses", "top_n_rec", "model_agreement"]
