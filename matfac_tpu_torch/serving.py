"""Batch recommendation serving (port of matfac_tpu/serving.py).

Load a trained model, keep the factor tables on the device, and answer
"top-N unrated items for these users" through the same top-N kernel as the
ranking eval (``ops/topk_kernel.topk_catalog``; on a CUDA view the
hand-written kernel, on a CPU view its plain version).

    recommender = Recommender.from_checkpoint(prefix, params, data)
    items, scores = recommender.recommend([12, 99, 1042], n=10)

Not carried over, as jit-compile and VMEM devices of the TPU: the
power-of-two query bucket, the 4096-user dispatch cap (the kernel wrapper
bounds its own scratch) and the clamp on ``item_block``. ``use_pallas`` is
accepted and selects nothing.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from matfac_tpu.config import Params
from matfac_tpu.utils import freq as ufreq
from matfac_tpu_torch.eval.ranking import CatalogScorer
from matfac_tpu_torch.models.base import EvalView


class Recommender:
    def __init__(self, view: EvalView, train_mat, n_users: int,
                 n_items: int, invalid_users: Optional[np.ndarray] = None,
                 invalid_items: Optional[np.ndarray] = None,
                 user_block: int = 256, item_block: int = 32768,
                 use_pallas: Optional[bool] = None):
        if invalid_users is None or invalid_items is None:
            invalid_users, invalid_items = ufreq.invalid_users_items(
                train_mat, n_users, n_items)
        self.view = view
        self.n_users = n_users
        self._scorer = CatalogScorer(
            train_mat, invalid_users, invalid_items, n_users, n_items,
            user_block=user_block, item_block=item_block,
            device=view.u_fac.device)
        self._prepared_src = None
        self._prepared = None

    @classmethod
    def from_checkpoint(cls, prefix: str, params: Params, data,
                        model=None, device="cuda", **kw) -> "Recommender":
        """Load the text-format factors saved by a training loop (of
        either package) onto ``device``."""
        from matfac_tpu_torch.models.base import ModelMF, init_state
        from matfac_tpu_torch.train import checkpoint as ck

        model = model or ModelMF(params, data.n_users, data.n_items)
        sig = ck.model_signature(params, data.n_users, data.n_items)
        state = ck.load_facs(
            init_state(params, data.n_users, data.n_items, device=device),
            prefix, sig)
        if state is None:
            raise FileNotFoundError(
                f"no checkpoint at {prefix}_*Fac_{sig}.mat")
        return cls(model.eval_view(state), data.train_mat, data.n_users,
                   data.n_items, **kw)

    def recommend(self, users: Sequence[int], n: int = 10
                  ) -> Tuple[np.ndarray, np.ndarray]:
        """(item_ids [len(users), n] int64, scores [len(users), n] f32):
        each user's train-rated and invalid items excluded; slots past the
        user's scorable items carry id -1."""
        users = np.asarray(users, dtype=np.int64).reshape(-1)
        if (users < 0).any() or (users >= self.n_users).any():
            raise ValueError("user id out of range")
        # cache keyed on view identity: replacing self.view (e.g. after
        # more training) must drop the prepared copy, or stale factors
        # would be served
        if self._prepared_src is not self.view:
            self._prepared = EvalView(*(t.to(torch.float32).contiguous()
                                        for t in self.view))
            self._prepared_src = self.view
        ids = torch.from_numpy(users).to(self._prepared.u_fac.device)
        scores, items = self._scorer.topk_users(self._prepared, ids, n)
        return (items.cpu().numpy().astype(np.int64),
                scores.cpu().numpy())
