"""BPR ranking model (port of the plain-BPR part of
matfac_tpu/models/bpr.py).

ModelMFBPR (modelMFBPR.cpp) predicts with the plain factor dot, as
ModelMF does; what differs from pointwise MF is the pairwise update
(solvers/bpr.py) and the model selection on validation HR@10
(train/loop.TrainLoopHR). The BPR x TMF+Poisson hybrid
(``ModelBPRPoissonDropout``) needs the long-tail models, ROADMAP queue 1,
item 7.
"""

from __future__ import annotations

from matfac_tpu_torch.models.base import ModelMF


class ModelMFBPR(ModelMF):
    """Plain BPR: full-rank pairwise updates (modelMFBPR.cpp:405-559)."""

    name = "bpr"
    is_ranking = True
