"""Named confCompute surface — 1:1 analogs of the reference's
confidence-analysis entry points (/root/reference/confCompute.h:14-192),
assembled from the generic machinery in analysis.confidence (port of
matfac_tpu/analysis/conf_compat.py).

The reference file is ~3k LoC of near-duplicated variants; each function
here wires the same three choices the C++ copies hard-code:

  * pair source   — all (user, item) cells, observed entries of a
    matrix, sampled unobserved cells (computeMissing*), or an explicit
    test-pair list (getTestPairs / *Samp);
  * score provider — model-ensemble confidence (1/std), global
    PageRank, personalized PageRank, item/user frequency, or the
    optimal oracle;
  * curve         — per-bucket RMSE against the ground-truth model
    (genRMSECurve) or the (1-alpha)-quantile confidence width
    (genConfidenceCurve), either globally sorted or per-user sorted
    (updateBucketsSorted).

Device math runs in blocks (analysis.batch); functions taking the full
n_users x n_items grid accept a ``users`` subset for large shapes (the
reference's own *Samp* variants exist for exactly that reason).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from matfac_tpu_torch.analysis import confidence as C
from matfac_tpu_torch.models.base import EvalView


# ----------------------------------------------------------------------
# pair sources
# ----------------------------------------------------------------------

def get_test_pairs(mat, invalid_users: np.ndarray,
                   invalid_items: np.ndarray, test_size: int,
                   seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """getTestPairs (confCompute.cpp): sample valid OBSERVED entries."""
    r, c, _ = mat.to_coo()
    keep = ~invalid_users[r] & ~invalid_items[c]
    r, c = r[keep], c[keep]
    rng = np.random.default_rng(seed)
    if len(r) > test_size:
        sel = rng.choice(len(r), test_size, replace=False)
        r, c = r[sel], c[sel]
    return r, c


def _grid_pairs(n_users, n_items, invalid_users, invalid_items,
                max_pairs=5_000_000, seed=1):
    """All valid cells, or a uniform sample when the grid is too big to
    enumerate (the reference loops O(U*I) — only run on small grids)."""
    vu = np.nonzero(~invalid_users[:n_users])[0]
    vi = np.nonzero(~invalid_items[:n_items])[0]
    if len(vu) * len(vi) <= max_pairs:
        r = np.repeat(vu, len(vi))
        c = np.tile(vi, len(vu))
        return r, c
    rng = np.random.default_rng(seed)
    r = vu[rng.integers(0, len(vu), max_pairs)]
    c = vi[rng.integers(0, len(vi), max_pairs)]
    return r, c


# ----------------------------------------------------------------------
# globally-sorted conf curves (computeXConf / computeMissingXConf /
# gen*ConfRMSECurve families)
# ----------------------------------------------------------------------

def _curves(orig_view, full_view, rows, cols, scores, n_buckets, alpha):
    """(RMSE curve, confidence-width curve) for scored pairs."""
    r, c = C._pairs(rows, cols, full_view)
    actual = C._predict(orig_view, r, c)
    pred = C._predict(full_view, r, c)
    return (C.rmse_curve(scores, actual, pred, n_buckets),
            C.confidence_curve(scores, actual, pred, n_buckets, alpha))


def compute_mod_conf(mat, views: Sequence[EvalView], invalid_users,
                     invalid_items, orig_view, full_view,
                     n_buckets: int = 10, alpha: float = 0.05):
    """computeModConf (confCompute.cpp:379+): ensemble confidence over
    the OBSERVED entries of ``mat``; returns (rmse curve, conf curve)."""
    r, c, _ = mat.to_coo()
    keep = ~invalid_users[r] & ~invalid_items[c]
    r, c = r[keep], c[keep]
    scores = C.ensemble_conf_scores(views, r, c)
    return _curves(orig_view, full_view, r, c, scores, n_buckets, alpha)


def compute_gpr_conf(mat, ppr_engine, invalid_users, invalid_items,
                     lamda, orig_view, full_view, n_buckets: int = 10,
                     alpha: float = 0.05):
    """computeGPRConf: global-PageRank ordering over observed entries."""
    r, c, _ = mat.to_coo()
    keep = ~invalid_users[r] & ~invalid_items[c]
    r, c = r[keep], c[keep]
    scores = C.gpr_pair_scores(ppr_engine, c, lamda)
    return _curves(orig_view, full_view, r, c, scores, n_buckets, alpha)


def compute_ppr_conf(mat, train_mat, ppr_engine, invalid_users,
                     invalid_items, lamda, orig_view, full_view,
                     n_buckets: int = 10, alpha: float = 0.05):
    """computePPRConf: personalized-PageRank ordering, observed pairs."""
    r, c, _ = mat.to_coo()
    keep = ~invalid_users[r] & ~invalid_items[c]
    r, c = r[keep], c[keep]
    scores = C.ppr_pair_scores(ppr_engine, train_mat, r, c, lamda)
    return _curves(orig_view, full_view, r, c, scores, n_buckets, alpha)


def _missing(train_mat, invalid_users, invalid_items, n_pairs, seed):
    return C.sample_missing_pairs(train_mat, invalid_users,
                                  invalid_items, n_pairs, seed)


def compute_missing_mod_conf(train_mat, views, invalid_users,
                             invalid_items, orig_view, full_view,
                             n_buckets: int = 10, alpha: float = 0.05,
                             n_pairs: int = 200_000, seed: int = 1):
    """computeMissingModConf: ensemble confidence over sampled UNOBSERVED
    cells (MAX_MISS_RATS=200000, const.h:9)."""
    r, c = _missing(train_mat, invalid_users, invalid_items, n_pairs,
                    seed)
    scores = C.ensemble_conf_scores(views, r, c)
    return _curves(orig_view, full_view, r, c, scores, n_buckets, alpha)


def compute_missing_gpr_conf(train_mat, ppr_engine, invalid_users,
                             invalid_items, lamda, orig_view, full_view,
                             n_buckets: int = 10, alpha: float = 0.05,
                             n_pairs: int = 200_000, seed: int = 1):
    r, c = _missing(train_mat, invalid_users, invalid_items, n_pairs,
                    seed)
    scores = C.gpr_pair_scores(ppr_engine, c, lamda)
    return _curves(orig_view, full_view, r, c, scores, n_buckets, alpha)


def compute_missing_ppr_conf(train_mat, ppr_engine, invalid_users,
                             invalid_items, lamda, orig_view, full_view,
                             n_buckets: int = 10, alpha: float = 0.05,
                             n_pairs: int = 200_000, seed: int = 1):
    """computeMissingPPRConf / ...Ext / ...ExtSamp (the Ext variants
    only differ by reading precomputed PPR from a file — the engine
    computes it directly)."""
    r, c = _missing(train_mat, invalid_users, invalid_items, n_pairs,
                    seed)
    scores = C.ppr_pair_scores(ppr_engine, train_mat, r, c, lamda)
    return _curves(orig_view, full_view, r, c, scores, n_buckets, alpha)


# explicit test-pair curve family (genXConfRMSECurve / genXConfCurve)

def gen_opt_conf_rmse_curve(pairs, orig_view, full_view,
                            n_buckets: int = 10):
    """genOptConfRMSECurve (confCompute.cpp:271-313)."""
    r, c = pairs
    scores = C.optimal_pair_scores(orig_view, full_view, r, c)
    return C.score_bucket_rmses(orig_view, full_view, r, c, scores,
                                n_buckets)


def gen_item_conf_rmse_curve(pairs, orig_view, full_view,
                             item_freq: np.ndarray,
                             n_buckets: int = 10):
    """genItemConfRMSECurve: item-frequency ordering."""
    r, c = pairs
    return C.score_bucket_rmses(orig_view, full_view, r, c,
                                C.freq_pair_scores(item_freq, c),
                                n_buckets)


def gen_user_conf_rmse_curve(pairs, orig_view, full_view,
                             user_freq: np.ndarray,
                             n_buckets: int = 10):
    """genUserConfRMSECurve: user-frequency ordering."""
    r, c = pairs
    return C.score_bucket_rmses(orig_view, full_view, r, c,
                                C.freq_pair_scores(user_freq, r),
                                n_buckets)


def gen_gpr_conf_rmse_curve(pairs, orig_view, full_view, ppr_engine,
                            lamda: float = 0.85, n_buckets: int = 10):
    r, c = pairs
    return C.score_bucket_rmses(orig_view, full_view, r, c,
                                C.gpr_pair_scores(ppr_engine, c, lamda),
                                n_buckets)


def gen_model_conf_rmse_curve(pairs, orig_view, full_view,
                              views: Sequence[EvalView],
                              n_buckets: int = 10):
    r, c = pairs
    return C.score_bucket_rmses(orig_view, full_view, r, c,
                                C.ensemble_conf_scores(views, r, c),
                                n_buckets)


def gen_ppr_conf_rmse_curve(pairs, orig_view, full_view, ppr_engine,
                            train_mat, lamda: float = 0.85,
                            n_buckets: int = 10):
    r, c = pairs
    return C.score_bucket_rmses(
        orig_view, full_view, r, c,
        C.ppr_pair_scores(ppr_engine, train_mat, r, c, lamda), n_buckets)


def gen_opt_confidence_curve(pairs, orig_view, full_view,
                             n_buckets: int = 10, alpha: float = 0.05):
    """genOptConfidenceCurve: width curve under the oracle ordering."""
    r, c = pairs
    scores = C.optimal_pair_scores(orig_view, full_view, r, c)
    return _curves(orig_view, full_view, r, c, scores, n_buckets,
                   alpha)[1]


# ----------------------------------------------------------------------
# per-user-sorted bucket-RMSE families (updateBucketsSorted protocol)
# ----------------------------------------------------------------------

def _per_user(orig_view, full_view, item_scores, users, n_items,
              invalid_items, n_buckets):
    mask = ~invalid_items[:n_items]
    return C.per_user_bucket_rmses(orig_view, full_view, item_scores,
                                   users, mask, n_buckets)[0]


def _users_subset(n_users, invalid_users, users, n_samp, seed):
    if users is not None:
        return np.asarray(users)
    elig = np.nonzero(~invalid_users[:n_users])[0]
    if n_samp and len(elig) > n_samp:
        rng = np.random.default_rng(seed)
        return rng.choice(elig, n_samp, replace=False)
    return elig


def conf_bucket_rmses(orig_view, full_view, views: Sequence[EvalView],
                      n_users: int, n_items: int, n_buckets: int = 10,
                      invalid_users: Optional[np.ndarray] = None,
                      invalid_items: Optional[np.ndarray] = None,
                      users: Optional[np.ndarray] = None,
                      n_samp_users: int = 0, seed: int = 1):
    """confBucketRMSEs / confBucketRMSEsWInval (confCompute.cpp:1480+):
    per user, rank all items by ensemble confidence, bucket RMSEs."""
    if invalid_users is None:
        invalid_users = np.zeros(n_users, bool)
    if invalid_items is None:
        invalid_items = np.zeros(n_items, bool)
    users = _users_subset(n_users, invalid_users, users, n_samp_users,
                          seed)
    # blocks of users: one full [U, n_items] device matrix per view
    # would not fit at scale
    from matfac_tpu_torch.analysis.batch import catalog_preds
    from matfac_tpu_torch.analysis.confidence import std_to_conf
    scores = np.empty((len(users), n_items), np.float32)
    iters = [catalog_preds(v, users) for v in views]
    for blocks in zip(*iters):
        idx = blocks[0][0]
        preds = np.stack([p[:, :n_items] for _, p in blocks])
        scores[idx] = std_to_conf(preds.std(axis=0))
    return _per_user(orig_view, full_view, scores, users, n_items,
                     invalid_items, n_buckets)


def gpr_bucket_rmses(orig_view, full_view, ppr_engine, n_users: int,
                     n_items: int, lamda: float = 0.85,
                     n_buckets: int = 10,
                     invalid_users: Optional[np.ndarray] = None,
                     invalid_items: Optional[np.ndarray] = None,
                     users: Optional[np.ndarray] = None,
                     n_samp_users: int = 0, seed: int = 1):
    """gprBucketRMSEs / WInVal / gprSampBucketRMSEsWInVal: one global
    item ordering for every user."""
    if invalid_users is None:
        invalid_users = np.zeros(n_users, bool)
    if invalid_items is None:
        invalid_items = np.zeros(n_items, bool)
    users = _users_subset(n_users, invalid_users, users, n_samp_users,
                          seed)
    gpr = ppr_engine.global_pagerank(lamda).cpu().numpy()[:n_items]
    scores = np.broadcast_to(gpr, (len(users), n_items))
    return _per_user(orig_view, full_view, scores, users, n_items,
                     invalid_items, n_buckets)


def ppr_bucket_rmses(orig_view, full_view, ppr_engine, train_mat,
                     n_users: int, n_items: int, lamda: float = 0.85,
                     n_buckets: int = 10,
                     invalid_users: Optional[np.ndarray] = None,
                     invalid_items: Optional[np.ndarray] = None,
                     users: Optional[np.ndarray] = None,
                     n_samp_users: int = 0, seed: int = 1):
    """pprBucketRMSEs / FrmPR / WInVal / pprSampBucketRMSEsWInVal:
    per-user personalized-PageRank ordering."""
    if invalid_users is None:
        invalid_users = np.zeros(n_users, bool)
    if invalid_items is None:
        invalid_items = np.zeros(n_items, bool)
    users = _users_subset(n_users, invalid_users, users, n_samp_users,
                          seed)
    scores = np.asarray(ppr_engine.user_ppr(train_mat, users, lamda)
                        )[:, :n_items]
    return _per_user(orig_view, full_view, scores, users, n_items,
                     invalid_items, n_buckets)


def conf_opt_bucket_rmses(orig_view, full_view, n_users: int,
                          n_items: int, n_buckets: int = 10,
                          invalid_users: Optional[np.ndarray] = None,
                          invalid_items: Optional[np.ndarray] = None,
                          users: Optional[np.ndarray] = None,
                          n_samp_users: int = 0, seed: int = 1):
    """confOptBucketRMSEs / WInVal: oracle (smallest-true-error first)
    per-user ordering."""
    if invalid_users is None:
        invalid_users = np.zeros(n_users, bool)
    if invalid_items is None:
        invalid_items = np.zeros(n_items, bool)
    users = _users_subset(n_users, invalid_users, users, n_samp_users,
                          seed)
    # blocks of users, never [U, n_items] on the device at once
    from matfac_tpu_torch.analysis.batch import catalog_sq_err
    scores = np.empty((len(users), n_items), np.float32)
    for idx, d2 in catalog_sq_err(orig_view, full_view, users):
        scores[idx] = -np.sqrt(d2[:, :n_items])
    return _per_user(orig_view, full_view, scores, users, n_items,
                     invalid_items, n_buckets)


def item_freq_bucket_rmses(orig_view, full_view, item_freq: np.ndarray,
                           n_users: int, n_items: int,
                           n_buckets: int = 10,
                           invalid_users: Optional[np.ndarray] = None,
                           invalid_items: Optional[np.ndarray] = None,
                           users: Optional[np.ndarray] = None,
                           n_samp_users: int = 0, seed: int = 1):
    """itemFreqBucketRMSEsWInVal / itemFreqSampBucketRMSEsWInVal."""
    if invalid_users is None:
        invalid_users = np.zeros(n_users, bool)
    if invalid_items is None:
        invalid_items = np.zeros(n_items, bool)
    users = _users_subset(n_users, invalid_users, users, n_samp_users,
                          seed)
    f = np.zeros(n_items)
    f[: min(len(item_freq), n_items)] = item_freq[:n_items]
    scores = np.broadcast_to(f, (len(users), n_items))
    return _per_user(orig_view, full_view, scores, users, n_items,
                     invalid_items, n_buckets)
