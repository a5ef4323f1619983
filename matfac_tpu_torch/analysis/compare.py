"""Multi-model agreement analysis (port of matfac_tpu/analysis/compare.py).

Analog of /root/reference/analyzeModels.cpp (compJaccSimAccu :4 and
friends): load several trained factor sets, compare per-item prediction
accuracy and cross-model consistency (mean/variance of predictions per
pair), and correlate per-item agreement with item-item Jaccard
similarity structure. The dense cell scans run on the views' device a
block of users at a time.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from matfac_tpu_torch.data.csr import RatingMatrix
from matfac_tpu_torch.analysis.confidence import _pairs, _predict
from matfac_tpu_torch.models.base import EvalView
from matfac_tpu_torch.utils.freq import pearson_corr


def _stack_views(views: Sequence[EvalView]) -> EvalView:
    """[M, ...]-stacked ensemble view (all members share shapes)."""
    return EvalView(*(torch.stack([getattr(v, f) for v in views])
                      for f in EvalView._fields))


def _block_ok_mask(train_mat: RatingMatrix, invalid_users: np.ndarray,
                   invalid_items: np.ndarray, n_users: int,
                   n_items: int, dev):
    """Device staging for the blocked unrated-valid cell scans: padded
    rated rows and validity vectors (the loops in analyzeModels.cpp
    iterate items x users skipping invalid entities and train-rated
    cells; here the cell mask is built per user block)."""
    cols, _, mask = train_mat.pad_rows()
    if train_mat.nrows < n_users:
        pad = n_users - train_mat.nrows
        cols = np.pad(cols, ((0, pad), (0, 0)))
        mask = np.pad(mask, ((0, pad), (0, 0)))
    as_t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return (as_t(cols.astype(np.int64)), as_t(mask),
            as_t((~invalid_users[:n_users]).astype(np.float32)),
            as_t((~invalid_items[:n_items]).astype(np.float32)))


def _block_preds(stacked: EvalView, orig: EvalView, uids: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """([M, B, n_items] ensemble predictions, [B, n_items] ground
    truth) for a user block — the dense analog of the per-cell
    estRating loops."""
    preds = (stacked.mu[:, None, None]
             + stacked.u_bias[:, uids][:, :, None]
             + stacked.i_bias[:, None, :]
             + torch.einsum("mbk,mik->mbi", stacked.u_fac[:, uids],
                            stacked.i_fac))
    r_orig = (orig.mu + orig.u_bias[uids][:, None] + orig.i_bias[None, :]
              + orig.u_fac[uids] @ orig.i_fac.t())
    return preds, r_orig


def _ok_cells(uids, rated_cols, rated_mask, valid_u, valid_i):
    """[B, n_items] 1.0 where (user valid, item valid, not train-rated)
    — the skip conditions of the reference cell loops."""
    ok = valid_u[uids][:, None] * valid_i[None, :]
    m = rated_mask[uids]
    rows = torch.arange(len(uids), device=ok.device)[:, None].expand_as(m)
    rc = rated_cols[uids]
    keep = m & (rc < ok.shape[1])
    ok[rows[keep], rc[keep]] = 0.0
    return ok


def _ensemble_block_stats(stacked: EvalView, orig: EvalView,
                          uids: torch.Tensor, rated_cols, rated_mask,
                          valid_u, valid_i):
    """Per-block (per-model sse [M], ensemble-mean sse, mean-var sums,
    cell count) over valid unrated cells, summed in float64."""
    preds, r_orig = _block_preds(stacked, orig, uids)
    ok = _ok_cells(uids, rated_cols, rated_mask, valid_u, valid_i)
    d = preds - r_orig[None]
    sum64 = lambda x, dim=None: (x.sum(dtype=torch.float64) if dim is None
                                 else x.sum(dim=dim, dtype=torch.float64))
    sse_m = sum64(d * d * ok[None], (1, 2))
    mean = preds.mean(dim=0)
    var = ((preds - mean[None]) ** 2).mean(dim=0)
    err2 = (mean - r_orig) ** 2
    return sse_m, sum64(err2 * ok), sum64(var * ok), sum64(ok)


def mean_and_var_same_ground_all_users(
        views: Sequence[EvalView], orig_view: EvalView,
        train_mat: RatingMatrix, invalid_users: np.ndarray,
        invalid_items: np.ndarray, user_block: int = 256
        ) -> Dict[str, object]:
    """meanAndVarSameGroundAllUsers (analyzeModels.cpp:1366-1510):
    over ALL valid (user, item) cells not rated in train, compare each
    ensemble member and the ensemble MEAN against a ground-truth model.

    Returns {"rmse_models" [M], "best_rmse", "avg_rmse" (the averaged-
    ensemble RMSE), "mean_var" (mean of cross-model prediction
    variance), "count"}.
    """
    n_users = int(views[0].u_fac.shape[0])
    n_items = int(views[0].i_fac.shape[0])
    dev = views[0].u_fac.device
    stacked = _stack_views(views)
    staged = _block_ok_mask(train_mat, invalid_users, invalid_items,
                            n_users, n_items, dev)
    sse_m = np.zeros(len(views))
    sse_avg = var_sum = count = 0.0
    for s in range(0, n_users, user_block):
        uids = torch.arange(s, min(s + user_block, n_users), device=dev)
        bm, ba, bv, bc = _ensemble_block_stats(stacked, orig_view,
                                               uids, *staged)
        sse_m += bm.cpu().numpy()
        sse_avg += float(ba)
        var_sum += float(bv)
        count += float(bc)
    count = max(count, 1.0)
    rmse_models = np.sqrt(sse_m / count)
    return {"rmse_models": rmse_models,
            "best_rmse": float(rmse_models.min()),
            "avg_rmse": float(np.sqrt(sse_avg / count)),
            "mean_var": float(var_sum / count),
            "count": int(count)}


def average_models_rmse(views: Sequence[EvalView], orig_view: EvalView,
                        train_mat: RatingMatrix,
                        invalid_users: np.ndarray,
                        invalid_items: np.ndarray,
                        user_block: int = 256) -> Dict[str, float]:
    """averageModels (analyzeModels.cpp:338-487): RMSE between the
    ground-truth model and the MEAN of the ensemble's predictions over
    valid unrated cells (the reference averages its SGD/ALS/CCD++
    factor sets; any view list works here). Returns {"rmse", "sse",
    "count"} matching the reference's final print."""
    out = mean_and_var_same_ground_all_users(
        views, orig_view, train_mat, invalid_users, invalid_items,
        user_block)
    return {"rmse": out["avg_rmse"],
            "sse": out["avg_rmse"] ** 2 * out["count"],
            "count": out["count"]}


def _accu_block(first: EvalView, second: EvalView, orig: EvalView,
                uids, rated_cols, rated_mask, valid_u, valid_i,
                epsilon: float):
    stacked = _stack_views([first, second])
    preds, r_orig = _block_preds(stacked, orig, uids)
    ok = _ok_cells(uids, rated_cols, rated_mask, valid_u, valid_i) > 0
    acc = (preds - r_orig[None]).abs() <= epsilon   # [2, B, n_items]
    a1, a2 = acc[0], acc[1]
    cnt = lambda m: (m & ok).sum(dim=0)
    return (cnt(a1), cnt(a2), cnt(a1 & a2),
            cnt(~a1), cnt(~a2), cnt(~a1 & ~a2))


def compare_models_accuracy(first: EvalView, second: EvalView,
                            orig_view: EvalView,
                            train_mat: RatingMatrix,
                            invalid_users: np.ndarray,
                            invalid_items: np.ndarray,
                            epsilon: float = 0.25,
                            user_block: int = 256
                            ) -> Dict[str, np.ndarray]:
    """compareModels (analyzeModels.cpp:489-625): per item, count the
    valid unrated cells where each model (and both / neither) predicts
    within ``epsilon`` of the ground truth (the reference's 0.25
    default). Returns per-item count arrays keyed like the reference's
    _firstSecAccuCount.txt columns."""
    n_users = int(first.u_fac.shape[0])
    n_items = int(first.i_fac.shape[0])
    dev = first.u_fac.device
    staged = _block_ok_mask(train_mat, invalid_users, invalid_items,
                            n_users, n_items, dev)
    keys = ("first_accu", "second_accu", "both_accu",
            "first_inaccu", "second_inaccu", "both_inaccu")
    out = {k: np.zeros(n_items, np.int64) for k in keys}
    for s in range(0, n_users, user_block):
        uids = torch.arange(s, min(s + user_block, n_users), device=dev)
        blocks = _accu_block(first, second, orig_view, uids, *staged,
                             epsilon=epsilon)
        for k, b in zip(keys, blocks):
            out[k] += b.cpu().numpy().astype(np.int64)
    return out


def write_accu_counts(path: str, counts: Dict[str, np.ndarray],
                      invalid_items: np.ndarray) -> None:
    """The reference's _firstSecAccuCount.txt layout
    (analyzeModels.cpp:613-623): one line per valid item."""
    keys = ("first_accu", "second_accu", "both_accu",
            "first_inaccu", "second_inaccu", "both_inaccu")
    with open(path, "w") as f:
        for item in range(len(counts["first_accu"])):
            if invalid_items[item]:
                continue
            f.write(" ".join([str(item)]
                             + [str(int(counts[k][item]))
                                for k in keys]) + "\n")


def mean_and_var_same_ground_samp_users(
        views: Sequence[EvalView], orig_view: EvalView,
        train_mat: RatingMatrix, invalid_users: np.ndarray,
        invalid_items: np.ndarray, samp_frac: float = 0.25,
        seed: int = 0) -> Dict[str, np.ndarray]:
    """meanAndVarSameGroundSampUsers (analyzeModels.cpp:1258-1363):
    per item, sample ``samp_frac * n_users`` users who have NOT rated
    it (and are valid), then record the ensemble mean, the (biased,
    /M) cross-model variance, and |mean - ground truth| per sampled
    (user, item) pair. Returns flat arrays {"users", "items", "mean",
    "var", "err"} — the _ui_mean_var.txt columns."""
    n_users = int(views[0].u_fac.shape[0])
    n_items = int(views[0].i_fac.shape[0])
    rng = np.random.default_rng(seed)
    samp = max(int(samp_frac * n_users), 1)
    csc = train_mat.transpose()
    valid_u = ~invalid_users[:n_users]
    users_l, items_l = [], []
    for item in range(n_items):
        if invalid_items[item]:
            continue
        rated = (csc.indices[csc.indptr[item]:csc.indptr[item + 1]]
                 if item < csc.nrows else np.empty(0, np.int64))
        ok = valid_u.copy()
        ok[rated[rated < n_users]] = False
        cand = np.nonzero(ok)[0]
        if len(cand) == 0:
            continue
        pick = rng.choice(cand, size=min(samp, len(cand)),
                          replace=False)
        users_l.append(pick)
        items_l.append(np.full(len(pick), item, np.int64))
    if not users_l:
        empty = np.empty(0)
        return {"users": empty.astype(np.int64),
                "items": empty.astype(np.int64),
                "mean": empty, "var": empty, "err": empty}
    users = np.concatenate(users_l)
    items = np.concatenate(items_l)
    uj, ij = _pairs(users, items, views[0])
    preds = np.stack([_predict(v, uj, ij) for v in views])
    orig = _predict(orig_view, uj, ij)
    mean = preds.mean(axis=0)
    var = preds.var(axis=0)      # biased /M, like the reference
    return {"users": users, "items": items, "mean": mean, "var": var,
            "err": np.abs(mean - orig)}


def model_agreement(views: Sequence[EvalView], test_mat: RatingMatrix,
                    invalid_users: np.ndarray, invalid_items: np.ndarray
                    ) -> Dict[str, np.ndarray]:
    """Per-item statistics over test entries:

      * rmse_per_model [M, n_items]  — each model's per-item test RMSE
      * pred_mean / pred_var [nnz]   — ensemble mean/variance per pair
      * item_disagreement [n_items]  — mean cross-model pred variance
    """
    r, c, v = test_mat.to_coo()
    keep = ~invalid_users[r] & ~invalid_items[c]
    r, c, v = r[keep], c[keep], v[keep]
    rj, cj = _pairs(r, c, views[0])
    preds = np.stack([_predict(vw, rj, cj) for vw in views])   # [M, nnz]
    M = len(views)
    n_items = test_mat.ncols
    sq = (preds - v[None, :]) ** 2
    rmse_pm = np.full((M, n_items), np.nan)
    counts = np.bincount(c, minlength=n_items).astype(np.float64)
    for m in range(M):
        ssum = np.bincount(c, weights=sq[m], minlength=n_items)
        with np.errstate(invalid="ignore", divide="ignore"):
            rmse_pm[m] = np.sqrt(ssum / counts)
    var = preds.var(axis=0)
    disagree = np.bincount(c, weights=var, minlength=n_items)
    with np.errstate(invalid="ignore", divide="ignore"):
        disagree = disagree / counts
    return {"rmse_per_model": rmse_pm,
            "pred_mean": preds.mean(axis=0),
            "pred_var": var,
            "item_disagreement": disagree,
            "item_counts": counts}


def jaccard_accuracy_correlation(agreement: Dict[str, np.ndarray],
                                 jacc_graph: RatingMatrix) -> float:
    """compJaccSimAccu essence: correlation between an item's mean
    Jaccard similarity to its graph neighbors and its ensemble
    agreement (negative variance)."""
    n_items = jacc_graph.nrows
    deg = jacc_graph.row_degrees()
    sim_sum = np.zeros(n_items)
    rr, cc, vv = jacc_graph.to_coo()
    np.add.at(sim_sum, rr, vv)
    with np.errstate(invalid="ignore", divide="ignore"):
        mean_sim = np.where(deg > 0, sim_sum / np.maximum(deg, 1), 0.0)
    dis = agreement["item_disagreement"][:n_items]
    ok = np.isfinite(dis) & (agreement["item_counts"][:n_items] > 0)
    return pearson_corr(mean_sim[ok], -dis[ok])
