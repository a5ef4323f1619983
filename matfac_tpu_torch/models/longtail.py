"""Long-tail adaptive models, WWW'19 (port of the IFWMF and TMF models of
matfac_tpu/models/longtail.py).

Per-entity popularity weights and sigmoid effective ranks are dense
tables built once with numpy, as in the JAX package. They live on the CPU
and are copied to the device of the indices they are asked about (once
per device). Truncation is factor masking: the rank map is monotone, so
the pair rank min(R(f_u), R(f_i)) factorizes into per-entity masks
(models/base.py). ``ModelPoissonDropout`` draws its training ranks from a
``torch.Generator`` the caller passes in. The othersrc variants are ROADMAP
queue 1, item 14.
"""

from __future__ import annotations

import math
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

    def update_rank_mask(self, u_idx, i_idx, generator=None):
        """[B, k] {0,1} mask of the dims a pair predicts and updates."""
        return rank_mask(self.pair_rank(u_idx, i_idx), self.k)


def poisson_cdf_ranks(fac_dim: int, cdf_cut: float = 0.99) -> np.ndarray:
    """initCDFRanks (modelPoissonDropout.cpp:25-47): for each lambda in
    1..k, the smallest index m with P(X <= m+1) >= cdf_cut under
    Poisson(lambda), or k - 1 when none reaches it (copy of the JAX numpy
    helper)."""
    out = np.zeros(fac_dim, dtype=np.int32)
    for lam in range(1, fac_dim + 1):
        cdf = math.exp(-lam)  # P(X = 0)
        k = 0
        for k in range(fac_dim):
            wt = math.exp(-lam + (k + 1) * math.log(lam)
                          - math.lgamma(k + 2))  # P(X = k+1)
            cdf += wt
            if cdf >= cdf_cut:
                break
        else:
            k = fac_dim - 1
        out[lam - 1] = k
    return out


def poisson_cdf_table(k: int) -> np.ndarray:
    """C [k, k] f32 with C[lam-1, m] = P(Poisson(lam) <= m), m = 0..k-1:
    the quantile table of the stripe engine's common-random-number rank
    draw. Per stripe visit one uniform U sets every entity's rank to
    q(lam) = clip(#{m : C[lam-1, m] < U}, 1, k). The Poisson family is
    stochastically increasing in lam, so q is monotone in lam and the pair
    rank min(q(lam_u), q(lam_i)) is q(min(lam_u, lam_i)): for a uniform U,
    exactly the reference's per-update marginal clip(Poisson(lam_pair), 1,
    k) (modelPoissonDropout.cpp:189-207; README deviation #15). Only the
    correlation differs: the pairs of one visit share its quantile level."""
    C = np.zeros((k, k), np.float64)
    for lam in range(1, k + 1):
        cdf = math.exp(-lam)                       # P(X = 0)
        C[lam - 1, 0] = cdf
        for m in range(1, k):
            cdf += math.exp(-lam + m * math.log(lam)
                            - math.lgamma(m + 1))  # P(X = m)
            C[lam - 1, m] = cdf
    return C.astype(np.float32)


class ModelPoissonDropout(ModelDropoutSigmoid):
    """TMF+Dropout: the training rank of each update is drawn from
    Poisson(lambda(u, i)), lambda = the TMF rank map, clipped to [1, k];
    inference truncates at the Poisson 0.99-CDF rank of lambda
    (modelPoissonDropout.cpp)."""

    name = "tmf_dropout"
    stochastic_rank = True

    def __init__(self, params: Params, n_users: int, n_items: int,
                 user_freq: np.ndarray, item_freq: np.ndarray, **_):
        super().__init__(params, n_users, n_items, user_freq, item_freq)
        # the entity lambda tables are TMF's sigmoid rank tables
        self.lambda_u = self.rank_u
        self.lambda_i = self.rank_i
        self.cdf_ranks = poisson_cdf_ranks(self.k)
        # inference dims for lambda: cdfRanks[lambda - 1] + 1, capped at k
        eff = torch.from_numpy(
            np.minimum(self.cdf_ranks + 1, self.k).astype(np.int32))
        self.rank_u = eff[self.lambda_u.long() - 1]
        self.rank_i = eff[self.lambda_i.long() - 1]
        self._tabs = _DeviceTables(rank_u=self.rank_u, rank_i=self.rank_i,
                                   lambda_u=self.lambda_u,
                                   lambda_i=self.lambda_i)

    def pair_lambda(self, u_idx, i_idx):
        t = self._tabs.on(u_idx.device)
        return torch.minimum(t["lambda_u"][u_idx], t["lambda_i"][i_idx])

    def update_rank_mask(self, u_idx, i_idx, generator=None):
        """clip(Poisson(pair lambda), 1, k) per example
        (modelPoissonDropout.cpp:200-206), drawn from ``generator`` (a
        generator of the indices' device)."""
        lam = self.pair_lambda(u_idx, i_idx).to(torch.float32)
        r = torch.poisson(lam, generator=generator).clamp(1, self.k)
        return rank_mask(r.to(torch.int32), self.k)

    def entity_lambdas(self):
        """Per-entity training lambda tables (int32 in [1, k]): the
        sigmoid rank map before the CDF inference transform."""
        return self.lambda_u, self.lambda_i

    def poisson_cdf_table(self) -> np.ndarray:
        """``poisson_cdf_table(k)`` of this model's k."""
        return poisson_cdf_table(self.k)
