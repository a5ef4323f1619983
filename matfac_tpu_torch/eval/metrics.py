"""Pointwise evaluation: RMSE and the regularized objective (port of the
training-time part of matfac_tpu/eval/metrics.py; ``objective_sing``,
``full_low_rank_err`` and NDCG are ROADMAP queue 1, item 4).

Semantics of the reference (model.cpp:214-251 RMSE with invalid
filtering, model.cpp:1770-1815 objective). Torch runs eagerly, so the COO
streams are not padded to static sizes; the error reduction walks chunks
of ``_EVAL_CHUNK`` entries so the gathered factor rows stay bounded
(2 * _EVAL_CHUNK * k * 4 bytes), and sums in float64.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from matfac_tpu.data.csr import RatingMatrix
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


def sse(view: EvalView, coo: CooDevice) -> Tuple[float, int]:
    """(sum of squared errors, count) over the staged entries."""
    total = torch.zeros((), dtype=torch.float64, device=coo.vals.device)
    n = coo.rows.shape[0]
    for s in range(0, n, _EVAL_CHUNK):
        e = min(s + _EVAL_CHUNK, n)
        d = coo.vals[s:e] - predict_pairs(view, coo.rows[s:e],
                                          coo.cols[s:e])
        total += (d * d).sum(dtype=torch.float64)
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

    def objective(self, view: EvalView, state, use_factors: bool = True,
                  use_bias: bool = False) -> float:
        """SSE(train) + reg penalty (model.cpp:1770-1815).
        ``use_factors=False`` drops the factor penalty; ``use_bias=True``
        adds u_reg*||uBias||^2 + i_reg*||iBias||^2 over valid entities."""
        s, _ = sse(view, self.train_coo)
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
