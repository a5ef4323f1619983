"""Long-tail adaptive models, WWW'19 (port of the IFWMF and TMF models of
matfac_tpu/models/longtail.py).

Per-entity popularity weights and sigmoid effective ranks are dense
tables built once with numpy, as in the JAX package. They live on the CPU
and are copied to the device of the indices they are asked about (once
per device). Truncation is factor masking: the rank map is monotone, so
the pair rank min(R(f_u), R(f_i)) factorizes into per-entity masks
(models/base.py). ``ModelPoissonDropout`` (sampled training ranks) and the
othersrc variants are ROADMAP queue 1, items 7 and 14.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from matfac_tpu_torch.config import Params
from matfac_tpu_torch.models.base import ModelMF, rank_mask


class _DeviceTables:
    """CPU tensors with one cached copy per device."""

    def __init__(self, **tabs: torch.Tensor):
        self._tabs = {"cpu": tabs}

    def on(self, device: torch.device) -> dict:
        key = str(device)
        if key not in self._tabs:
            self._tabs[key] = {n: t.to(device)
                               for n, t in self._tabs["cpu"].items()}
        return self._tabs[key]


class ModelInvPopMF(ModelMF):
    """IFWMF — inverse-popularity-frequency weighted MF
    (modelInvPopMF.cpp:98-178): per-entity popularity = freq / number of
    valid entities on the other side, normalized to sum 1 over valid
    entities; a rating's weight uses the LESS frequent of (u, i)'s
    score p and multiplies only the data-fit term: w = 1 / (1 + rhoRMS p).
    """

    name = "ifwmf"

    def __init__(self, params: Params, n_users: int, n_items: int,
                 user_freq: np.ndarray, item_freq: np.ndarray,
                 invalid_users: Optional[np.ndarray] = None,
                 invalid_items: Optional[np.ndarray] = None):
        super().__init__(params, n_users, n_items, user_freq, item_freq)
        valid_u = (~invalid_users if invalid_users is not None
                   else np.ones(n_users, bool))
        valid_i = (~invalid_items if invalid_items is not None
                   else np.ones(n_items, bool))
        n_tr_users = max(int(valid_u.sum()), 1)
        n_tr_items = max(int(valid_i.sum()), 1)
        inv_pop_u = np.where(valid_u, user_freq / n_tr_items, 0.0)
        s = inv_pop_u.sum()
        inv_pop_u = inv_pop_u / (s if s > 0 else 1.0)
        inv_pop_i = np.where(valid_i, item_freq / n_tr_users, 0.0)
        s = inv_pop_i.sum()
        inv_pop_i = inv_pop_i / (s if s > 0 else 1.0)
        f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32))
        self.inv_pop_u = f32(inv_pop_u)
        self.inv_pop_i = f32(inv_pop_i)
        self._tabs = _DeviceTables(pop_u=self.inv_pop_u,
                                   pop_i=self.inv_pop_i,
                                   freq_u=f32(user_freq),
                                   freq_i=f32(item_freq))

    def example_weight(self, u_idx, i_idx):
        t = self._tabs.on(u_idx.device)
        fu, fi = t["freq_u"][u_idx], t["freq_i"][i_idx]
        # the item's score, or the user's when the item is MORE frequent
        # (modelInvPopMF.cpp:163-168)
        pop = torch.where(fi > fu, t["pop_u"][u_idx], t["pop_i"][i_idx])
        return 1.0 / (1.0 + self.params.rho_rms * pop)


def _sigmoid_rank_table(freq: np.ndarray, mean: float, std: float,
                        rho: float, alpha: float, k: int) -> np.ndarray:
    """R(f) = clamp(ceil(sigmoid(rho*((f-mean)/std - alpha)) * k), 1, k),
    the TMF effective-rank map (modelDropoutSigmoid.cpp:158-172); monotone
    nondecreasing in f for rho >= 0 (copy of the JAX numpy helper)."""
    scale = (freq - mean) / (std if std > 0 else 1.0)
    sigm = 1.0 / (1.0 + np.exp(-rho * (scale - alpha)))
    ranks = np.ceil(sigm * k).astype(np.int64)
    return np.clip(ranks, 1, k).astype(np.int32)


class ModelDropoutSigmoid(ModelMF):
    """TMF — prediction and update truncated to the first
    R(min_freq(u, i)) dims (modelDropoutSigmoid.cpp:140-246). The z-score
    constants are the mean / std of concat(userFreq, itemFreq) over ALL
    entities (modelDropoutSigmoid.h constructor)."""

    name = "tmf"

    def __init__(self, params: Params, n_users: int, n_items: int,
                 user_freq: np.ndarray, item_freq: np.ndarray, **_):
        super().__init__(params, n_users, n_items, user_freq, item_freq)
        concat = np.concatenate([user_freq, item_freq]).astype(np.float64)
        self.mean_freq = float(concat.mean())
        self.std_freq = float(concat.std())
        if params.rho_rms < 0:
            raise ValueError("TMF requires rho_rms >= 0 (monotone rank map)")
        table = lambda f: torch.from_numpy(_sigmoid_rank_table(
            f, self.mean_freq, self.std_freq, params.rho_rms, params.alpha,
            self.k))
        self.rank_u = table(user_freq)
        self.rank_i = table(item_freq)
        self._tabs = _DeviceTables(rank_u=self.rank_u, rank_i=self.rank_i)

    def entity_ranks(self):
        return self.rank_u, self.rank_i

    def pair_rank(self, u_idx, i_idx):
        t = self._tabs.on(u_idx.device)
        return torch.minimum(t["rank_u"][u_idx], t["rank_i"][i_idx])

    def update_rank_mask(self, u_idx, i_idx):
        """[B, k] {0,1} mask of the dims a pair predicts and updates."""
        return rank_mask(self.pair_rank(u_idx, i_idx), self.k)
