"""Quartile (frequency-bucket) RMSE and ranking reports (port of
matfac_tpu/eval/quartile.py).

The reference's post-train reports (quartileRMSEs main.cpp:700-768,
quartileHR :656, quartileARHR :612, quartileNDCG :568, over the partitions
of getUserItemRankMap main.cpp:1137-1168): users and items are split into
frequency quartiles of the TRAIN matrix, and test / val RMSE is reported
per user quartile and per item quartile (count and RMSE of each bucket).
One prediction pass a split runs on the device; the buckets are numpy
filters of its residuals.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from matfac_tpu_torch.eval.metrics import _EVAL_CHUNK, predict_pairs
from matfac_tpu_torch.eval.ranking import _loo_score
from matfac_tpu_torch.utils import freq as ufreq


def _coo(ev, which: str):
    return {"train": ev.train_coo, "test": ev.test_coo,
            "val": ev.val_coo}[which]


def _predict(view, coo) -> np.ndarray:
    n = coo.rows.shape[0]
    return torch.cat([predict_pairs(view, coo.rows[s:s + _EVAL_CHUNK],
                                    coo.cols[s:s + _EVAL_CHUNK])
                      for s in range(0, n, _EVAL_CHUNK)]
                     or [coo.vals[:0]]).cpu().numpy()


def split_residuals(view, ev, which: str):
    """(rows, cols, residuals, valid) of a split: one predict pass and one
    copy to the host, for repeated ``filtered_rmse`` calls. The evaluator
    stages the valid entries only, so ``valid`` is all True."""
    coo = _coo(ev, which)
    rows, cols = coo.rows.cpu().numpy(), coo.cols.cpu().numpy()
    d = coo.vals.cpu().numpy() - _predict(view, coo)
    return rows, cols, d, np.ones(len(rows), bool)


def filtered_rmse(view, ev, which: str, user_filter=None,
                  item_filter=None, residuals=None) -> Tuple[int, float]:
    """(count, RMSE) over the entries whose user / item passes the filter,
    Model::RMSE(mat, filtItems, ...) / RMSEU (model.cpp:348-486).
    ``residuals``: a ``split_residuals`` result reused across buckets."""
    if residuals is None:
        residuals = split_residuals(view, ev, which)
    r, c, d, valid = residuals
    mask = valid.copy()
    if user_filter is not None:
        mask &= user_filter[r]
    if item_filter is not None:
        mask &= item_filter[c]
    if not mask.any():
        return 0, float("nan")
    dm = d[mask]
    return int(mask.sum()), float(np.sqrt((dm * dm).mean()))


def _pad_zeros(a: np.ndarray, n: int) -> np.ndarray:
    """Zero-pad to n (np.resize would tile cyclically, and entities beyond
    the train matrix would take entity 0, 1, 2...'s frequencies)."""
    a = np.asarray(a)
    return a[:n] if len(a) >= n else np.pad(a, (0, n - len(a)))


def quartile_partitions(data, inval_u, inval_i, n_quantiles: int = 4
                        ) -> Tuple[np.ndarray, np.ndarray]:
    user_freq, item_freq = ufreq.row_col_freq(data.train_mat)
    user_freq = _pad_zeros(user_freq, data.n_users)
    item_freq = _pad_zeros(item_freq, data.n_items)
    uq = ufreq.quartile_assignments(user_freq, ~inval_u, n_quantiles)
    iq = ufreq.quartile_assignments(item_freq, ~inval_i, n_quantiles)
    return uq, iq


def quartile_report(view, data, ev, inval_u, inval_i,
                    n_quantiles: int = 4) -> str:
    uq, iq = quartile_partitions(data, inval_u, inval_i, n_quantiles)
    lines: List[str] = []
    for which in ("test", "val"):
        if _coo(ev, which) is None:
            continue
        lines.append(f"{which.capitalize()} RMSE by quartile "
                     f"(q0 = least frequent):")
        res = split_residuals(view, ev, which)   # one pass a split
        for label, q in (("Items", iq), ("Users", uq)):
            parts = []
            for b in range(n_quantiles):
                filt = q == b
                cnt, rmse = filtered_rmse(
                    view, ev, which,
                    user_filter=filt if label == "Users" else None,
                    item_filter=filt if label == "Items" else None,
                    residuals=res)
                parts.append(f"{cnt} {rmse:.6f}")
            lines.append(f"  {label} Part: " + "  ".join(parts))
    return "\n".join(lines)


def quartile_ranking_report(view, data, scorer, inval_u, inval_i,
                            n_quantiles: int = 4, n: int = 10,
                            evaluator=None) -> str:
    """quartileHR / quartileARHR / quartileNDCG (main.cpp:568-698):
    leave-one-out HR@n and ARHR (and NDCG@n with an Evaluator) over the
    users of each frequency quartile. The two top-N passes (n, and
    min(1000, n_items) for ARHR) go through ``scorer.topk``: the top-N
    kernel on the card."""
    uq, _ = quartile_partitions(data, inval_u, inval_i, n_quantiles)
    _, top_hr = scorer.topk(view, n)
    _, top_ar = scorer.topk(view, min(1000, data.n_items))
    lines = []
    for label, ti, recip in ((f"Test HR@{n}", top_hr, False),
                             ("Test ARHR", top_ar, True)):
        parts = []
        for b in range(n_quantiles):
            inval_mask = inval_u | (uq != b)
            v = _loo_score(ti, data.test_mat, inval_mask,
                           data.n_users, reciprocal=recip)
            parts.append(f"q{b}={v:.4f}")
        lines.append(f"{label} by user quartile:\n  " + "  ".join(parts))
    if evaluator is not None:
        parts = []
        for b in range(n_quantiles):
            nd = evaluator.ndcg(view, "test", n=n, user_mask=(uq == b))
            parts.append(f"q{b}={nd:.4f}")
        lines.append("Test NDCG@10 by user quartile:\n  "
                     + "  ".join(parts))
    return "\n".join(lines)


def submat_rmse(view, ev, which: str, u_range, i_range,
                exclude: bool = False):
    """subMatRMSE / subMatExRMSE (model.h:179-181): (count, RMSE) over the
    entries inside (or, with exclude=True, outside) the
    [uStart, uEnd) x [iStart, iEnd) block."""
    u_lo, u_hi = u_range
    i_lo, i_hi = i_range
    uf = np.zeros(len(ev.valid_u), bool)
    uf[u_lo:u_hi] = True
    itf = np.zeros(len(ev.valid_i), bool)
    itf[i_lo:i_hi] = True
    if not exclude:
        return filtered_rmse(view, ev, which, user_filter=uf,
                             item_filter=itf)
    r, c, d, valid = split_residuals(view, ev, which)
    mask = valid & ~(uf[r] & itf[c])
    if not mask.any():
        return 0, float("nan")
    dm = d[mask]
    return int(mask.sum()), float(np.sqrt((dm * dm).mean()))
