"""Confidence estimation + calibration-curve analysis (port of
matfac_tpu/analysis/confidence.py).

Analog of /root/reference/confCompute.cpp: ensemble
confidence = 1/std of predictions across trained models (confScore,
confCompute.cpp:152-166); bucket curves sort (u, i) pairs by a
confidence/PPR/GPR/frequency/optimal score, split into equal-count
buckets, and report per-bucket RMSE against a ground-truth model
(genRMSECurve :217, confBucketRMSEs family :1480-1860) or the
(1-alpha)-quantile confidence-interval half-width (genConfidenceCurve
:168-214). The predictions of a pair list are one batched call on the
views' device; the curves are numpy on the host.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from matfac_tpu_torch.eval.metrics import predict_pairs
from matfac_tpu_torch.models.base import EvalView


def _pairs(rows, cols, view: EvalView):
    dev = view.u_fac.device
    return (torch.from_numpy(np.asarray(rows, np.int64)).to(dev),
            torch.from_numpy(np.asarray(cols, np.int64)).to(dev))


def _predict(view: EvalView, r, c) -> np.ndarray:
    return predict_pairs(view, r, c).cpu().numpy()


def std_to_conf(std: np.ndarray) -> np.ndarray:
    """confScore's std -> confidence map: 1/std, with -1 where the
    ensemble std is exactly 0 (confCompute.cpp:152-166)."""
    return np.where(std != 0, 1.0 / np.where(std == 0, 1.0, std), -1.0)


def ensemble_conf_scores(views: Sequence[EvalView], rows, cols
                         ) -> np.ndarray:
    """confScore batched: 1/std of the ensemble's predictions per pair
    (confCompute.cpp:152-166)."""
    r, c = _pairs(rows, cols, views[0])
    preds = np.stack([_predict(v, r, c) for v in views])
    return std_to_conf(preds.std(axis=0))


def rmse_curve(scores: np.ndarray, actual: np.ndarray,
               predicted: np.ndarray, n_buckets: int) -> np.ndarray:
    """genRMSECurve (confCompute.cpp:217-268): sort pairs by DESCENDING
    score, split into n equal buckets, per-bucket RMSE."""
    order = np.argsort(-scores, kind="stable")
    d = (actual - predicted)[order]
    n = len(d)
    per = n // n_buckets
    out = np.zeros(n_buckets)
    for b in range(n_buckets):
        s = b * per
        e = n if b == n_buckets - 1 else min((b + 1) * per, n)
        seg = d[s:e]
        out[b] = np.sqrt((seg * seg).mean()) if len(seg) else np.nan
    return out


def confidence_curve(scores: np.ndarray, actual: np.ndarray,
                     predicted: np.ndarray, n_buckets: int,
                     alpha: float) -> np.ndarray:
    """genConfidenceCurve (confCompute.cpp:168-214): per-bucket
    half-width w s.t. (1 - alpha) of |actual - predicted| <= w."""
    order = np.argsort(-scores, kind="stable")
    w = np.abs(actual - predicted)[order]
    n = len(w)
    per = n // n_buckets
    out = np.zeros(n_buckets)
    for b in range(n_buckets):
        s = b * per
        e = n if b == n_buckets - 1 else min((b + 1) * per, n)
        seg = np.sort(w[s:e])
        ind = int((1.0 - alpha) * len(seg))
        out[b] = seg[min(ind, len(seg) - 1)] if len(seg) else np.nan
    return out


def score_bucket_rmses(orig_view: EvalView, full_view: EvalView,
                       rows, cols, scores: np.ndarray,
                       n_buckets: int = 10) -> np.ndarray:
    """The conf/ppr/gpr/freq BucketRMSEs family: per-bucket RMSE of the
    trained model's predictions against the ground-truth model's, with
    pairs ordered by ``scores`` descending."""
    r, c = _pairs(rows, cols, full_view)
    actual = _predict(orig_view, r, c)
    predicted = _predict(full_view, r, c)
    return rmse_curve(scores, actual, predicted, n_buckets)


# ----------------------------------------------------------------------
# pair-score providers — the orderings the reference's bucket family
# compares (computeModConf / computeGPRConf / computePPRConf /
# genOptConfRMSECurve / genUserConfRMSECurve / genItemConfRMSECurve,
# confCompute.cpp:379-993): feed any of these into score_bucket_rmses.
# ----------------------------------------------------------------------

def gpr_pair_scores(ppr_engine, cols, lamda: float = 0.85) -> np.ndarray:
    """Global-PageRank score of each pair's item (computeGPRConf)."""
    gpr = ppr_engine.global_pagerank(lamda).cpu().numpy()
    return gpr[np.asarray(cols)]


def ppr_pair_scores(ppr_engine, train_mat, rows, cols,
                    lamda: float = 0.85, user_batch: int = 64
                    ) -> np.ndarray:
    """Personalized-PageRank score of each pair's item w.r.t. its user
    (computePPRConf / computeMissingPPRConf)."""
    rows = np.asarray(rows)
    cols = np.asarray(cols)
    out = np.zeros(len(rows))
    uniq = np.unique(rows)
    for s in range(0, len(uniq), user_batch):
        us = uniq[s:s + user_batch]
        pr = ppr_engine.user_ppr(train_mat, us, lamda)
        for j, u in enumerate(us):
            m = rows == u
            out[m] = pr[j, cols[m]]
    return out


def freq_pair_scores(item_freq: np.ndarray, cols) -> np.ndarray:
    """Item-frequency ordering (genItemConfCurve by freq)."""
    return np.asarray(item_freq)[np.asarray(cols)]


def optimal_pair_scores(orig_view: EvalView, full_view: EvalView,
                        rows, cols) -> np.ndarray:
    """Oracle ordering: most-confident = smallest true error
    (genOptConfRMSECurve, confCompute.cpp:271-313)."""
    r, c = _pairs(rows, cols, full_view)
    a = _predict(orig_view, r, c)
    p = _predict(full_view, r, c)
    return -np.abs(a - p)


def per_user_bucket_rmses(orig_view: EvalView, full_view: EvalView,
                          item_scores: np.ndarray, users: np.ndarray,
                          item_mask: np.ndarray, n_buckets: int = 10
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """updateBucketsSorted semantics (confCompute.cpp:1358-1447): for
    each user, rank candidate items by that user's score vector
    descending, split into n_buckets, accumulate squared pred-vs-orig
    error per bucket across users. Returns (bucket RMSEs, bucket nnz).

    item_scores: [n_users_eval, n_items]; item_mask: [n_items] bool of
    allowed items (valid, maybe unrated).
    """
    cand = np.nonzero(item_mask)[0]
    scores_sum = np.zeros(n_buckets)
    nnz = np.zeros(n_buckets, np.int64)
    per = len(cand) // n_buckets
    # bucket index of each sorted position (same for every user)
    pos_bucket = np.minimum(np.arange(len(cand)) // max(per, 1),
                            n_buckets - 1)
    # the catalog errors in device blocks of users
    from matfac_tpu_torch.analysis.batch import catalog_sq_err
    users = np.asarray(users)
    for idx, d2_blk in catalog_sq_err(orig_view, full_view, users):
        sc = item_scores[idx][:, cand]                  # [B, n_cand]
        order = np.argsort(-sc, axis=1, kind="stable")
        d2 = np.take_along_axis(d2_blk[:, cand], order, axis=1)
        # per-bucket sums across the block in one segment pass
        for b in range(n_buckets):
            m = pos_bucket == b
            scores_sum[b] += d2[:, m].sum()
            nnz[b] += m.sum() * d2.shape[0]
    return np.sqrt(scores_sum / np.maximum(nnz, 1)), nnz


def sample_missing_pairs(train_mat, invalid_users: np.ndarray,
                         invalid_items: np.ndarray, n_pairs: int,
                         seed: int = 1):
    """Sample valid UNOBSERVED (user, item) pairs — the pair source for
    the computeMissing*Conf family (confCompute.cpp:733-1199), which
    evaluates confidence orderings on cells outside the train matrix
    (capped by MAX_MISS_RATS=200000 in the reference, const.h:9)."""
    rng = np.random.default_rng(seed)
    n_users, n_items = train_mat.nrows, train_mat.ncols
    rows = np.empty(0, np.int64)
    cols = np.empty(0, np.int64)
    while len(rows) < n_pairs:
        m = 2 * (n_pairs - len(rows)) + 16
        r = rng.integers(0, n_users, m)
        c = rng.integers(0, n_items, m)
        ok = ~invalid_users[r] & ~invalid_items[c]
        # reject observed entries by row membership — CSR rows are NOT
        # guaranteed column-sorted (read_csr keeps file order)
        lo = train_mat.indptr[r]
        hi = train_mat.indptr[r + 1]
        observed = np.array(
            [np.isin(cc, train_mat.indices[l:h])
             for l, h, cc in zip(lo, hi, c)], dtype=bool)
        ok &= ~observed
        rows = np.concatenate([rows, r[ok]])
        cols = np.concatenate([cols, c[ok]])
    return rows[:n_pairs], cols[:n_pairs]
