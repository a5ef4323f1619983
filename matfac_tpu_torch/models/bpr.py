"""BPR ranking models (port of matfac_tpu/models/bpr.py): plain BPR and the
BPR x TMF+Poisson hybrid.

ModelMFBPR (modelMFBPR.cpp) predicts with the plain factor dot, as
ModelMF does; what differs from pointwise MF is the pairwise update
(solvers/bpr.py) and the model selection on validation HR@10
(train/loop.TrainLoopHR). The hybrid ModelBPRPoissonDropout
(modelBPRPoissonDropout.cpp) adds a per-triple rank mask from the least
frequent of (user, positive, negative) (:169-191), which the stream engine
applies to every pairwise update.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from matfac_tpu_torch.config import Params
from matfac_tpu_torch.models.base import ModelMF, rank_mask
from matfac_tpu_torch.models.longtail import (ModelDropoutSigmoid,
                                              _DeviceTables,
                                              poisson_cdf_ranks)


class ModelMFBPR(ModelMF):
    """Plain BPR: full-rank pairwise updates (modelMFBPR.cpp:405-559)."""

    name = "bpr"
    is_ranking = True

    def triple_rank_mask(self, u_idx, pos_idx, neg_idx,
                         generator: Optional[torch.Generator] = None):
        """[B, k] mask of the dims a pairwise update uses; None = full."""
        return None


class ModelBPRPoissonDropout(ModelDropoutSigmoid):
    """BPR x TMF hybrid.

    Training rank: lambda = the sigmoid rank of the LEAST frequent of (u,
    pos, neg), drawn as clip(Poisson(lambda), 1, k) in ``train``
    (modelBPRPoissonDropout.cpp:76-259), lambda itself in ``trainSigmoid``
    (:262-441). Inference truncates at the Poisson 0.99-CDF rank, as
    TMF+Dropout does (its own initCDFRanks, :3-23)."""

    name = "bpr_poisson"
    is_ranking = True

    def __init__(self, params: Params, n_users: int, n_items: int,
                 user_freq: np.ndarray, item_freq: np.ndarray,
                 sample_poisson: bool = True, **_):
        super().__init__(params, n_users, n_items, user_freq, item_freq)
        self.sample_poisson = sample_poisson
        # the lambda tables are TMF's sigmoid rank tables
        self.lambda_u = self.rank_u
        self.lambda_i = self.rank_i
        eff = torch.from_numpy(np.minimum(poisson_cdf_ranks(self.k) + 1,
                                          self.k).astype(np.int32))
        # inference ranks (estRating, modelBPRPoissonDropout.cpp:27-47)
        self.rank_u = eff[self.lambda_u.long() - 1]
        self.rank_i = eff[self.lambda_i.long() - 1]
        self._tabs = _DeviceTables(rank_u=self.rank_u, rank_i=self.rank_i,
                                   lambda_u=self.lambda_u,
                                   lambda_i=self.lambda_i)

    def triple_rank_mask(self, u_idx, pos_idx, neg_idx,
                         generator: Optional[torch.Generator] = None):
        """[B, k] {0,1} mask of each triple's training rank; a sampled
        rank is drawn from ``generator`` (on the indices' device)."""
        t = self._tabs.on(u_idx.device)
        lam = torch.minimum(torch.minimum(t["lambda_u"][u_idx],
                                          t["lambda_i"][pos_idx]),
                            t["lambda_i"][neg_idx])
        if self.sample_poisson:
            r = torch.poisson(lam.to(torch.float32), generator=generator)
            lam = r.clamp(1, self.k).to(torch.int32)
        return rank_mask(lam, self.k)
