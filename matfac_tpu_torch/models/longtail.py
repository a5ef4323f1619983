"""Long-tail adaptive models, WWW'19, and the othersrc variants (port of
matfac_tpu/models/longtail.py).

Per-entity popularity weights and sigmoid effective ranks are dense
tables built once with numpy, as in the JAX package. They live on the CPU
and are copied to the device of the indices they are asked about (once
per device). Truncation is factor masking: the rank map is monotone, so
the pair rank min(R(f_u), R(f_i)) factorizes into per-entity masks
(models/base.py). ``ModelPoissonDropout`` draws its training ranks from a
``torch.Generator`` the caller passes in, and so does the adaptive-rank
``ModelAdaptiveDropoutMF``, whose rank rule also takes given uniforms
(``ranks_from_uniforms``). The othersrc variants: TMF with biases,
head/tail rank locality, per-side entity gates (the mf_freq curriculum's
stages) and head-item down-weighting.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from matfac_tpu_torch.config import Params
from matfac_tpu_torch.models.base import EvalView, ModelMF, rank_mask


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


def adaptive_rank_map(freq: np.ndarray, fac_dim: int) -> np.ndarray:
    """setAdapRank (main.cpp:1109-1135): entities sorted by DESCENDING
    frequency, ties in id order (``np.argsort(kind="stable")``), split into
    four quartiles of ranks k, k/2, k/4, k/8 (integer halving, floor 1; the
    4th part takes the remainder, and a part has at least one entity)."""
    freq = np.asarray(freq, np.float64)
    n = len(freq)
    order = np.argsort(-freq, kind="stable")
    ranks = np.zeros(n, np.int32)
    cur, i, part = fac_dim, 0, 0
    while i < n:
        end = int(i + 0.25 * n)
        if end > n or part == 3:
            end = n
        end = max(end, i + 1)   # tiny-n guard (the reference assumes n >= 4)
        ranks[order[i:end]] = cur
        cur = max(cur // 2, 1)
        i, part = end, part + 1
    return ranks


class ModelAdaptiveDropoutMF(ModelMF):
    """othersrc ModelDropoutMF: adaptive-rank MF with a SOFT three-tier
    prediction (othersrc/modelDropoutMF.cpp:4-20):

        estRating = sum_k w_k u_k v_k,
        w_k = 1.0  for k <  c           (c = max(facDim/8, 1))
              0.5  for c <= k < minRank (minRank = min(rank_u, rank_i))
              0.15 for k >= minRank

    The pair weights factorize into a width-doubled view: with
    m_e = [k < rank_e], g = [k >= c] and alpha_k = 1 (k < c) or 0.15,
    w_k = alpha_k + 0.35 g_k m_u,k m_i,k, so

        estRating = <[u alpha ; 0.35 u m_u g], [v ; v m_i g]>

    (the asymmetric split keeps f32 exactness: no sqrt(0.35) rounding).
    The rank maps are ``adaptive_rank_map`` of each side's frequencies.
    The training rank of each update is drawn (``update_rank_mask``):

      * 'prob' (trainSGDProbPar, :423-650): minRank lifted to facDim with
        probability rhoRMS (0.3 when rhoRMS < eps, :548-550);
      * 'ordered' (trainSGDProbOrderedPar, :650-884): the lift, then a cap
        at c with probability 0.5 (:800-808);
      * 'onlyordered' (trainSGDOnlyOrderedPar, :884-1115): full rank,
        capped at c with probability 0.5 (:1037-1042).
    """

    name = "dropoutmf"
    stochastic_rank = True

    def __init__(self, params: Params, n_users: int, n_items: int,
                 user_freq: np.ndarray, item_freq: np.ndarray,
                 mode: str = "prob", **_):
        super().__init__(params, n_users, n_items, user_freq, item_freq)
        if mode not in ("prob", "ordered", "onlyordered"):
            raise ValueError(f"unknown dropoutmf mode {mode!r}")
        self.mode = mode
        self.cand = max(self.k // 8, 1)
        # rhoRMS < EPS -> 0.3 (modelDropoutMF.cpp:548-550)
        self.rho = (params.rho_rms if params.rho_rms >= params.eps
                    else 0.3)
        self.rank_u = torch.from_numpy(adaptive_rank_map(user_freq, self.k))
        self.rank_i = torch.from_numpy(adaptive_rank_map(item_freq, self.k))
        self._tabs = _DeviceTables(rank_u=self.rank_u, rank_i=self.rank_i)

    def pair_rank(self, u_idx, i_idx):
        t = self._tabs.on(u_idx.device)
        return torch.minimum(t["rank_u"][u_idx], t["rank_i"][i_idx])

    def ranks_from_uniforms(self, u_idx, i_idx, lift_u, cap_u):
        """The training ranks [B] the mode's rule gives for uniforms in
        [0, 1): ``lift_u`` decides the lift to full rank ('prob',
        'ordered'; JAX draws it from the first half of split(key)),
        ``cap_u`` the cap at c ('ordered': the second half; 'onlyordered':
        the key itself)."""
        if self.mode == "onlyordered":
            return torch.where(cap_u <= 0.5, self.cand, self.k)
        r = self.pair_rank(u_idx, i_idx)
        lift = (r != self.k) & (lift_u <= self.rho)
        r = torch.where(lift, self.k, r)
        if self.mode == "ordered":
            r = torch.where(cap_u <= 0.5, torch.clamp(r, max=self.cand), r)
        return r

    def update_rank_mask(self, u_idx, i_idx, generator=None):
        """[B, k] mask of the drawn training ranks, two uniforms an example
        from ``generator`` (a generator of the indices' device)."""
        draw = lambda: torch.rand(u_idx.shape, generator=generator,
                                  device=u_idx.device)
        lift_u = draw()
        return rank_mask(self.ranks_from_uniforms(u_idx, i_idx, lift_u,
                                                  draw()), self.k)

    def entity_ranks(self):
        return None   # the soft three-tier view below, not a truncation

    def eval_view(self, state):
        dev = state.u_fac.device
        iota = torch.arange(self.k, device=dev)
        alpha = torch.where(iota < self.cand, 1.0, 0.15).to(torch.float32)
        gate = (iota >= self.cand).to(torch.float32)
        m_u = rank_mask(self.rank_u.to(dev), self.k)
        m_i = rank_mask(self.rank_i.to(dev), self.k)
        uf, vf = state.u_fac.float(), state.i_fac.float()
        u_hat = torch.cat([uf * alpha[None, :],
                           0.35 * uf * m_u * gate[None, :]], dim=1)
        v_hat = torch.cat([vf, vf * m_i * gate[None, :]], dim=1)
        return EvalView(u_hat, v_hat, torch.zeros_like(state.u_bias),
                        torch.zeros_like(state.i_bias),
                        torch.zeros_like(state.mu))


class ModelDropoutSigmoidBias(ModelDropoutSigmoid):
    """TMF with biases, othersrc's ModelDropoutMFBias: the rank-truncated
    dot PLUS user and item biases, with NO global mean
    (othersrc/modelDropoutMFBias.cpp:3-23), the biases trained by the
    factors' SGD rule (:243-261). The rank map is the TMF sigmoid table."""

    name = "tmf_bias"
    use_bias = True


class ModelLocalityMF(ModelMF):
    """MFLoc, a static head / tail rank split (othersrc/modelMFLoc.cpp).

    Entities outside the ``head_pc`` rating-mass head (getHeadItems /
    getHeadUsers, util.cpp:4-66) live in the first fac_dim/2 dims: their
    upper halves are zeroed at init (zeroedTail*Facs, :4-31) and each
    update writes only the first effFacDim dims of each SIDE (:124-159,
    the full gradient, reg included, applied to dims < effFacDim). The
    prediction is the full dot (:120-121); the masked dims start at zero
    and never move, so it equals the truncated dot that ``entity_ranks``
    exposes to evaluation."""

    name = "mf_loc"

    def __init__(self, params: Params, n_users: int, n_items: int,
                 head_user_mask: np.ndarray, head_item_mask: np.ndarray,
                 **_):
        super().__init__(params, n_users, n_items)
        tail_rank = max(self.k // 2, 1)
        hu = np.zeros(n_users, bool)
        hu[: len(head_user_mask)] = head_user_mask[:n_users]
        hi = np.zeros(n_items, bool)
        hi[: len(head_item_mask)] = head_item_mask[:n_items]
        table = lambda h: torch.from_numpy(
            np.where(h, self.k, tail_rank).astype(np.int32))
        self.rank_u, self.rank_i = table(hu), table(hi)
        self._tabs = _DeviceTables(rank_u=self.rank_u, rank_i=self.rank_i)

    def entity_ranks(self):
        return self.rank_u, self.rank_i

    def update_side_masks(self, u_idx, i_idx):
        t = self._tabs.on(u_idx.device)
        return (rank_mask(t["rank_u"][u_idx], self.k),
                rank_mask(t["rank_i"][i_idx], self.k))

    def transform_init_state(self, state):
        t = self._tabs.on(state.u_fac.device)
        return state._replace(
            u_fac=state.u_fac * rank_mask(t["rank_u"], self.k).to(
                state.u_fac.dtype),
            i_fac=state.i_fac * rank_mask(t["rank_i"], self.k).to(
                state.i_fac.dtype))


class ModelSideGatedMF(ModelMF):
    """Plain MF whose user-side and item-side updates are gated by static
    per-entity {0,1} masks: a stage of ModelMFFreq's head-first curriculum
    (othersrc/modelMFFreq.cpp:1-41, updateModelInval skips the USER update
    when u is in the stage's invalid set and the ITEM update when i is;
    the prediction always uses both). ``gate_u`` / ``gate_i`` are boolean
    [n_users] / [n_items]: "this entity's factors train in this stage"."""

    name = "mf_freq"

    def __init__(self, params: Params, n_users: int, n_items: int,
                 gate_u: np.ndarray, gate_i: np.ndarray, **_):
        super().__init__(params, n_users, n_items)
        f32 = lambda g: torch.from_numpy(np.asarray(g).astype(np.float32))
        self._gate_u, self._gate_i = f32(gate_u), f32(gate_i)
        self._tabs = _DeviceTables(gate_u=self._gate_u, gate_i=self._gate_i)

    def update_side_masks(self, u_idx, i_idx):
        """[B, 1] gates of each side."""
        t = self._tabs.on(u_idx.device)
        return t["gate_u"][u_idx][:, None], t["gate_i"][i_idx][:, None]


class ModelHeadWeightedMF(ModelMF):
    """Head-item down-weighted MF, othersrc's ModelMFWt
    (othersrc/modelMFWt.cpp:151-176): the data-fit weight of a rating is
    lambda0 for HEAD items (those covering ``head_pc`` of rating mass,
    getHeadItems util.cpp:4-34) and lambda0 + lambda1 = 1.0 for tail items.
    The weight rides the data-fit gradient and the objective's squared
    error (IFWMF's hook). The reference's objective also intersects head
    USERS (modelMFWt.cpp:31-44) while its train rule keys on items alone;
    both follow the train rule here, as in the JAX package."""

    name = "mf_headwt"

    def __init__(self, params: Params, n_users: int, n_items: int,
                 head_item_mask: np.ndarray, lambda0: float = 0.8):
        super().__init__(params, n_users, n_items)
        self.lambda0 = float(lambda0)
        hm = np.zeros(n_items, bool)
        hm[: len(head_item_mask)] = head_item_mask[:n_items]
        self._head = torch.from_numpy(hm)
        self._tabs = _DeviceTables(head=self._head)

    def example_weight(self, u_idx, i_idx):
        head = self._tabs.on(i_idx.device)["head"][i_idx]
        return torch.where(head, self.lambda0, 1.0).to(torch.float32)
