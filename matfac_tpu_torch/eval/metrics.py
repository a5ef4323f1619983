"""Pointwise evaluation: RMSE, the regularized objective and NDCG@n (port
of matfac_tpu/eval/metrics.py; ``objective_sing`` and
``full_low_rank_err`` are ROADMAP queue 1, item 4).

Semantics of the reference (model.cpp:214-251 RMSE with invalid
filtering, model.cpp:1770-1815 objective). Torch runs eagerly, so the COO
streams are not padded to static sizes; the error reduction walks chunks
of ``_EVAL_CHUNK`` entries so the gathered factor rows stay bounded
(2 * _EVAL_CHUNK * k * 4 bytes), and sums in float64.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from matfac_tpu_torch.data.csr import RatingMatrix
from matfac_tpu_torch.models.base import EvalView

_EVAL_CHUNK = 1 << 21


class CooDevice(NamedTuple):
    """COO triplets on one device."""
    rows: torch.Tensor   # [n] int64
    cols: torch.Tensor   # [n] int64
    vals: torch.Tensor   # [n] float32


def stage_coo(mat: RatingMatrix, invalid_users: np.ndarray,
              invalid_items: np.ndarray, n_users: int, n_items: int,
              device="cuda") -> CooDevice:
    """Keep the entries inside the bounds whose user and item are valid
    (RMSE semantics, model.cpp:222-240)."""
    r, c, v = mat.to_coo()
    keep = (r < n_users) & (c < n_items)
    keep &= ~invalid_users[np.clip(r, 0, n_users - 1)]
    keep &= ~invalid_items[np.clip(c, 0, n_items - 1)]
    as_t = lambda a, dt: torch.from_numpy(np.ascontiguousarray(
        a[keep].astype(dt))).to(device)
    return CooDevice(as_t(r, np.int64), as_t(c, np.int64),
                     as_t(v, np.float32))


def predict_pairs(view: EvalView, rows: torch.Tensor,
                  cols: torch.Tensor) -> torch.Tensor:
    dots = (view.u_fac[rows] * view.i_fac[cols]).sum(dim=1)
    return view.mu + view.u_bias[rows] + view.i_bias[cols] + dots


def sse(view: EvalView, coo: CooDevice,
        weights: Optional[torch.Tensor] = None) -> Tuple[float, int]:
    """(sum of squared errors, count) over the staged entries; with
    ``weights`` (aligned with ``coo``) each squared error is weighted, the
    IFWMF objective's data term (modelInvPopMF.cpp:22-32)."""
    total = torch.zeros((), dtype=torch.float64, device=coo.vals.device)
    n = coo.rows.shape[0]
    for s in range(0, n, _EVAL_CHUNK):
        e = min(s + _EVAL_CHUNK, n)
        d = coo.vals[s:e] - predict_pairs(view, coo.rows[s:e],
                                          coo.cols[s:e])
        se = d * d if weights is None else weights[s:e] * d * d
        total += se.sum(dtype=torch.float64)
    return float(total), n


def rmse_value(view: EvalView, coo: CooDevice) -> float:
    s, n = sse(view, coo)
    return float(np.sqrt(s / max(n, 1)))


def reg_penalty(u_fac: torch.Tensor, i_fac: torch.Tensor,
                valid_u: torch.Tensor, valid_i: torch.Tensor,
                u_reg: float, i_reg: float) -> float:
    """u_reg*||uFac[valid]||^2 + i_reg*||iFac[valid]||^2
    (model.cpp:1782-1807), on the raw factors."""
    u = ((u_fac * u_fac).sum(dim=1) * valid_u).sum(dtype=torch.float64)
    i = ((i_fac * i_fac).sum(dim=1) * valid_i).sum(dtype=torch.float64)
    return u_reg * float(u) + i_reg * float(i)


class Evaluator:
    """Device-staged eval inputs for one Data bundle + invalid masks:
    RMSE(train/test/val) and the objective."""

    def __init__(self, data, invalid_users: np.ndarray,
                 invalid_items: np.ndarray, params, device="cuda"):
        self.params = params
        self.n_users = data.n_users
        self.n_items = data.n_items
        self.valid_u = torch.from_numpy(
            (~invalid_users).astype(np.float32)).to(device)
        self.valid_i = torch.from_numpy(
            (~invalid_items).astype(np.float32)).to(device)
        self.invalid_users = invalid_users
        self.invalid_items = invalid_items
        self.device = torch.device(device)
        self._data = data
        self._ndcg_cache = {}
        stage = lambda mat: None if mat is None else stage_coo(
            mat, invalid_users, invalid_items, self.n_users, self.n_items,
            device)
        self.train_coo = stage(data.train_mat)
        self.test_coo = stage(data.test_mat)
        self.val_coo = stage(data.val_mat)

    def rmse(self, view: EvalView, which: str = "test") -> float:
        coo = {"train": self.train_coo, "test": self.test_coo,
               "val": self.val_coo}[which]
        if coo is None:
            raise ValueError(f"no {which} matrix")
        return rmse_value(view, coo)

    def objective(self, view: EvalView, state,
                  weights: Optional[torch.Tensor] = None,
                  use_factors: bool = True, use_bias: bool = False) -> float:
        """SSE(train) + reg penalty (model.cpp:1770-1815), with the JAX
        signature. ``weights`` aligned with ``train_coo`` switches to the
        IFWMF weighted objective. ``use_factors=False`` drops the factor
        penalty; ``use_bias=True`` adds u_reg*||uBias||^2 +
        i_reg*||iBias||^2 over valid entities. The penalty reads the raw
        factors, never the rank-masked view (model.cpp:1782-1807)."""
        s, _ = sse(view, self.train_coo, weights)
        p = self.params
        reg = 0.0
        if use_factors:
            reg = reg_penalty(state.u_fac, state.i_fac, self.valid_u,
                              self.valid_i, float(p.u_reg), float(p.i_reg))
        if use_bias:
            reg += reg_penalty(state.u_bias[:, None], state.i_bias[:, None],
                               self.valid_u, self.valid_i, float(p.u_reg),
                               float(p.i_reg))
        return float(s + reg)

    # -- NDCG ----------------------------------------------------------
    def _padded_test(self, which: str):
        if which not in self._ndcg_cache:
            mat = (self._data.test_mat if which == "test"
                   else self._data.val_mat)
            cols, vals, mask = mat.pad_rows()
            # invalid items are excluded from the scan (model.cpp:785)
            mask = mask & ~self.invalid_items[cols]
            user_ids = np.arange(mat.nrows, dtype=np.int64)
            user_valid = ~self.invalid_users[:mat.nrows]
            self._ndcg_cache[which] = tuple(
                torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                for a in (cols.astype(np.int64), vals.astype(np.float32),
                          mask, user_ids, user_valid))
        return self._ndcg_cache[which]

    def ndcg(self, view: EvalView, which: str = "test", n: int = 10,
             user_mask=None) -> float:
        """``user_mask``: optional boolean [n_users-ish] restricting the
        averaged users (quartileNDCG, main.cpp:568)."""
        cols, vals, mask, user_ids, user_valid = self._padded_test(which)
        if user_mask is not None:
            um = torch.from_numpy(np.asarray(
                user_mask[: user_valid.shape[0]], bool)).to(self.device)
            user_valid = user_valid & um
        total, cnt = ndcg_at_n(view, cols, vals, mask, user_ids,
                               user_valid, n=n, eps=self.params.eps)
        return total / cnt if cnt else 0.0


def ndcg_at_n(view: EvalView, test_cols: torch.Tensor,
              test_vals: torch.Tensor, test_mask: torch.Tensor,
              user_ids: torch.Tensor, user_valid: torch.Tensor, n: int = 10,
              eps: float = 1e-5) -> Tuple[float, int]:
    """NDCG@n with the reference's protocol (model.cpp:760-830): per user,
    keep the n test items with the HIGHEST PREDICTED rating (equal
    predictions in column order, as lax.top_k); DCG uses their actual
    ratings in prediction order, the ideal DCG re-sorts those same n by
    actual rating. Users with <2 valid test entries or ideal DCG <= eps
    are skipped. Inputs are padded per-user test rows [B, C] (bool mask
    and validity); returns (sum of NDCG in float64, contributing users)."""
    B, C = test_cols.shape
    preds = ((view.mu + view.u_bias[user_ids][:, None])
             + view.i_bias[test_cols]) + torch.einsum(
                 "bk,bck->bc", view.u_fac[user_ids], view.i_fac[test_cols])
    neg_inf = float(np.float32(-3e38))
    masked = torch.where(test_mask, preds, neg_inf)
    n_eff = min(n, C)
    top_idx = torch.sort(masked, dim=1, descending=True,
                         stable=True)[1][:, :n_eff]
    rels = torch.gather(test_vals, 1, top_idx)
    sel_valid = torch.gather(test_mask, 1, top_idx)
    discounts = 1.0 / torch.log2(torch.arange(
        2, n_eff + 2, dtype=torch.float32, device=preds.device))
    gains = torch.where(sel_valid, torch.exp2(rels) - 1.0, 0.0)
    dcg = (gains * discounts[None, :]).sum(dim=1)
    # ideal order: valid gains (negative for negative ratings) sorted
    # descending and COMPACTED to the front: masked padding sorts last
    sort_key = torch.where(sel_valid, gains, neg_inf)
    ideal_sorted = torch.sort(sort_key, dim=1, descending=True)[0]
    ideal_gains = torch.where(ideal_sorted > neg_inf / 2, ideal_sorted, 0.0)
    idcg = (ideal_gains * discounts[None, :]).sum(dim=1)
    counts = test_mask.sum(dim=1)
    ok = user_valid & (counts >= 2) & (idcg > eps)
    ratio = dcg / torch.clamp(idcg, min=eps)
    return (float(torch.where(ok, ratio, 0.0).sum(dtype=torch.float64)),
            int(ok.sum()))
