"""Per-user item-scoring comparisons and top-bucket RMSE curves (port of
matfac_tpu/analysis/top_bucket.py).

Analog of /root/reference/topBucketComp.cpp: several ways to
score a user's candidate items —

  * model:     predicted rating (itemPredScores, :468)
  * optimal:   ground-truth model's rating (itemOptScores, :441)
  * frequency: global item frequency (itemFreqScores, :550)
  * svd:       scores from an SVD factorization (itemSVDScores, :403)
  * ppr:       personalized PageRank restarted on the user's rated
               items weighted by rating (itemGraphItemScores, :348-400)

— plus score-fusion ops (average / product / log-sum, :192-345) and the
sliding-window RMSE-vs-rank curves written by writeTopBuckRMSEs
(:4684): order a user's candidate items by one score, then report the
pred-vs-orig RMSE of each successive bucket of the ranking.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from matfac_tpu_torch.data.csr import RatingMatrix
from matfac_tpu_torch.eval.metrics import predict_pairs
from matfac_tpu_torch.models.base import EvalView


def _user_pairs(view: EvalView, user: int, items: np.ndarray):
    dev = view.u_fac.device
    return (torch.full((len(items),), int(user), dtype=torch.int64,
                       device=dev),
            torch.from_numpy(np.asarray(items, np.int64)).to(dev))


def item_pred_scores(view: EvalView, user: int, items: np.ndarray
                     ) -> np.ndarray:
    return predict_pairs(view, *_user_pairs(view, user, items)
                         ).cpu().numpy()


def item_freq_scores(train_mat: RatingMatrix, items: np.ndarray
                     ) -> np.ndarray:
    return train_mat.col_degrees()[items].astype(np.float64)


def fuse_scores(scores: Sequence[np.ndarray], how: str = "avg"
                ) -> np.ndarray:
    """Score fusion (topBucketComp.cpp:192-345). Each score vector is
    first normalized to sum 1 (the reference normalizes PPR-like
    distributions)."""
    norm = []
    for s in scores:
        t = s.sum()
        norm.append(s / t if t > 0 else s)
    norm = np.stack(norm)
    if how == "avg":
        return norm.mean(axis=0)
    if how == "prod":
        return norm.prod(axis=0)
    if how == "logsum":
        with np.errstate(divide="ignore"):
            return np.where(norm > 0, np.log(norm), -np.inf).sum(axis=0)
    raise ValueError(how)


def top_bucket_rmse_curve(orig_view: EvalView, full_view: EvalView,
                          user: int, items: np.ndarray,
                          scores: np.ndarray, n_buckets: int = 10
                          ) -> np.ndarray:
    """RMSE of pred vs ground truth over successive buckets of the
    user's score-ranked candidate items."""
    order = items[np.argsort(-scores, kind="stable")]
    r, c = _user_pairs(full_view, user, order)
    a = predict_pairs(orig_view, r, c).cpu().numpy()
    p = predict_pairs(full_view, r, c).cpu().numpy()
    d2 = (a - p) ** 2
    per = max(len(order) // n_buckets, 1)
    out = np.zeros(n_buckets)
    for b in range(n_buckets):
        s = b * per
        e = len(order) if b == n_buckets - 1 else min((b + 1) * per,
                                                      len(order))
        out[b] = np.sqrt(d2[s:e].mean()) if e > s else np.nan
    return out


def sample_users(invalid_users: np.ndarray, nrows: int, n_users: int,
                 seed: int) -> np.ndarray:
    """The sampled-user protocol of predSampUsersRMSE*Par."""
    rng = np.random.default_rng(seed)
    elig = np.nonzero(~invalid_users[:nrows])[0]
    return (rng.choice(elig, n_users, replace=False)
            if len(elig) > n_users else elig)


def pred_samp_users_rmse(orig_view: EvalView, full_view: EvalView,
                         train_mat: RatingMatrix,
                         invalid_users: np.ndarray,
                         invalid_items: np.ndarray,
                         scorers: Dict[str, Callable[[int, np.ndarray],
                                                     np.ndarray]],
                         n_users: int = 1000, n_buckets: int = 10,
                         seed: int = 1,
                         users: Optional[np.ndarray] = None
                         ) -> Dict[str, np.ndarray]:
    """predSampUsersRMSEFreqPar / ...ProbPar analog
    (topBucketComp.cpp:2669, :3883): sample users, average each scorer's
    top-bucket RMSE curve over them. ``scorers`` maps name ->
    fn(user, candidate_items) -> scores. Pass ``users`` to evaluate a
    caller-chosen sample (e.g. so PPR scores can be precomputed in
    batches — sample_users below replicates the sampling)."""
    cand_mask = ~invalid_items[:train_mat.ncols]
    if users is None:
        users = sample_users(invalid_users, train_mat.nrows, n_users,
                             seed)
    curves = {k: np.zeros(n_buckets) for k in scorers}
    counts = {k: 0 for k in scorers}
    all_items = np.nonzero(cand_mask)[0]
    # catalog errors arrive in device blocks; the per-user work below is
    # numpy on the host
    from matfac_tpu_torch.analysis.batch import catalog_sq_err
    for idx, d2_blk in catalog_sq_err(orig_view, full_view,
                                      np.asarray(users)):
        for j, d2_row in zip(idx, d2_blk):
            u = int(users[j])
            rated = train_mat.row(u)[0]
            items = np.setdiff1d(all_items, rated, assume_unique=False)
            if len(items) < n_buckets:
                continue
            per = max(len(items) // n_buckets, 1)
            for name, fn in scorers.items():
                sc = fn(u, items)
                d2 = d2_row[items[np.argsort(-sc, kind="stable")]]
                curve = np.empty(n_buckets)
                for b in range(n_buckets):
                    s = b * per
                    e = (len(items) if b == n_buckets - 1
                         else min((b + 1) * per, len(items)))
                    curve[b] = (np.sqrt(d2[s:e].mean()) if e > s
                                else np.nan)
                if np.isfinite(curve).all():
                    curves[name] += curve
                    counts[name] += 1
    return {k: curves[k] / max(counts[k], 1) for k in scorers}


# ----------------------------------------------------------------------
# score-ordering overlap statistics (topBucketComp.h:73-78)
# ----------------------------------------------------------------------
# "item pairs" = a ranking: (ids, scores) arrays already ordered by rank
# (the reference passes vectors of (item, score) sorted descending).

def ordering_overlap(ids_a: np.ndarray, ids_b: np.ndarray,
                     scores_b: np.ndarray, size_a: int
                     ) -> "tuple[np.ndarray, np.ndarray]":
    """orderingOverlap (topBucketComp.cpp:1339-1359): items among the
    first ``size_a`` of ranking B that also appear in the first
    ``size_a`` of ranking A, in B's order, with B's scores."""
    top_a = set(ids_a[:size_a].tolist())
    n = min(size_a, len(ids_b))
    keep = np.fromiter((int(i) in top_a for i in ids_b[:n]), bool, n)
    return ids_b[:n][keep], scores_b[:n][keep]


def ordering_diff(ids_a: np.ndarray, ids_b: np.ndarray,
                  scores_b: np.ndarray, size_a: int
                  ) -> "tuple[np.ndarray, np.ndarray]":
    """orderingDiff (topBucketComp.cpp:1363-1383): top-size_a items of B
    NOT present in the top-size_a of A."""
    top_a = set(ids_a[:size_a].tolist())
    n = min(size_a, len(ids_b))
    keep = np.fromiter((int(i) not in top_a for i in ids_b[:n]), bool, n)
    return ids_b[:n][keep], scores_b[:n][keep]


def comp_ordering_overlap(ids_a: np.ndarray, ids_b: np.ndarray,
                          size_a: int) -> float:
    """compOrderingOverlap (topBucketComp.cpp:1478-1501): fraction of
    A's top-size_a item set found in B's first size_a entries
    (denominator = |set(A[:size_a])|)."""
    if len(ids_a) == 0 or len(ids_b) == 0:
        return 0.0
    top_a = set(ids_a[:size_a].tolist())
    count = sum(1 for i in ids_b[:size_a] if int(i) in top_a)
    return count / len(top_a)


def comp_ordering_overlap2(ids_a: np.ndarray, ids_b: np.ndarray,
                           size_a: int) -> float:
    """compOrderingOverlap2 (topBucketComp.cpp:1450-1475): same count,
    denominator = number of B entries actually scanned
    (min(size_a, len(B)))."""
    if len(ids_a) == 0 or len(ids_b) == 0:
        return 0.0
    top_a = set(ids_a[:size_a].tolist())
    n = min(size_a, len(ids_b))
    if n == 0:
        return 0.0
    count = sum(1 for i in ids_b[:n] if int(i) in top_a)
    return count / n


def comp_ordering_overlap_bscores(ids_a: np.ndarray, ids_b: np.ndarray,
                                  scores_b: np.ndarray, size_a: int
                                  ) -> "tuple[float, float]":
    """compOrderingOverlapBScores (topBucketComp.cpp:1386-1424): mean
    B-score of B's top-size_a items that are / are not in A's top set.
    Reference quirk preserved: the accumulators START at -1 (sentinel
    value is also the additive identity there), so each mean is
    (sum - 1) / count; -1 is returned when the group is empty."""
    if len(ids_a) == 0 or len(ids_b) == 0:
        return -1.0, -1.0
    top_a = set(ids_a[:size_a].tolist())
    ov_sum, ov_n = -1.0, 0
    out_sum = -1.0
    n = min(size_a, len(ids_b))   # sibling fns clamp too (review r3)
    for i in range(n):
        item = int(ids_b[i])
        if item in top_a:
            ov_n += 1
            ov_sum += float(scores_b[i])
        else:
            out_sum += float(scores_b[i])
    ov = ov_sum / ov_n if ov_n > 0 else -1.0
    out = out_sum / (n - ov_n) if n - ov_n > 0 else -1.0
    return ov, out


def comp_diff_pc(ids_a: np.ndarray, ids_b: np.ndarray
                 ) -> "tuple[float, float]":
    """compDiffPc (topBucketComp.cpp:1427-1447): fraction of each
    ranking's item set absent from the other."""
    if len(ids_a) == 0 or len(ids_b) == 0:
        return 0.0, 0.0
    set_a = set(ids_a.tolist())
    ov = sum(1 for i in ids_b if int(i) in set_a)
    return (len(set_a) - ov) / len(set_a), (len(ids_b) - ov) / len(ids_b)
