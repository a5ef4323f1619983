"""Long-tail top-N recommendation evaluation (port of
matfac_tpu/analysis/topn.py).

Analog of /root/reference/longTail.cpp topNRec
(:279-502) and the topNRecTail* variants (:505-1382): sample up to 10k
test users; for each of a user's test items sample 1000 unrated valid
negatives; a "hit" = the test item ranks in the top-N of
{test item} ∪ negatives under a scoring function. Recall is reported
overall and split into head vs tail items (head = items covering
``head_pc`` of train rating mass, getHeadItems util.cpp:4-34).

Three scorers, as in the reference: the model's predicted rating, the
PPR "local" rank score (item's descending-PPR rank index,
longTail.cpp:356-365), and the frequency-weighted local score
(rank/freq). The per-(user, item) candidate scoring runs as batched
gather-dots on the view's device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from matfac_tpu_torch.data.csr import RatingMatrix
from matfac_tpu_torch.models.base import EvalView
from matfac_tpu_torch.utils import freq as ufreq


@dataclasses.dataclass
class TopNRecReport:
    n_test_items: int
    n_head_items: int
    n_tail_items: int
    recall: Dict[str, float]        # scorer -> overall recall
    head_recall: Dict[str, float]
    tail_recall: Dict[str, float]

    def __str__(self):
        lines = [f"nTestItems: {self.n_test_items} nHeadItems: "
                 f"{self.n_head_items} nTailItems: {self.n_tail_items}"]
        for k in self.recall:
            lines.append(f"{k}: recall {self.recall[k]:.4f} head "
                         f"{self.head_recall[k]:.4f} tail "
                         f"{self.tail_recall[k]:.4f}")
        return "\n".join(lines)


def _pad_cols(a: np.ndarray, n: int, fill=0):
    """Zero/fill-pad the LAST axis to length n (test splits may carry
    item ids beyond train_mat.ncols — dataset.py sets n_items to the
    max across splits, so train-sized tables must be padded, never
    indexed raw)."""
    if a.shape[-1] >= n:
        return a
    pad = [(0, 0)] * (a.ndim - 1) + [(0, n - a.shape[-1])]
    return np.pad(a, pad, constant_values=fill)


def _topn_ranks(view: EvalView, train_mat: RatingMatrix,
                test_mat: RatingMatrix, invalid_users: np.ndarray,
                invalid_items: np.ndarray, head_pc: float,
                n_samp_users: int, n_negatives: int, seed: int,
                ppr_scores: Optional[np.ndarray],
                sampled_users: Optional[np.ndarray]):
    """Shared core: sample pairs + pools, score once, and return the
    per-pair rank of the test item under every scorer (rank does NOT
    depend on the N cutoff, so callers threshold it per N)."""
    rng = np.random.default_rng(seed)
    n_items = train_mat.ncols
    # pad train-derived tables to the full id range seen by any split
    n_all = max(n_items, test_mat.ncols, len(invalid_items))
    _, item_freq = ufreq.row_col_freq(train_mat)
    item_freq = _pad_cols(item_freq, n_all)
    head_mask = _pad_cols(ufreq.head_items(train_mat, head_pc), n_all,
                          fill=False)

    # eligible users: valid with >= 1 test rating (longTail.cpp:316-334)
    deg_t = test_mat.row_degrees()
    elig = np.nonzero(~invalid_users[:test_mat.nrows] & (deg_t > 0))[0]
    if sampled_users is None:
        if len(elig) > n_samp_users:
            sampled_users = rng.choice(elig, n_samp_users, replace=False)
        else:
            sampled_users = elig
    scorers = ["model"]
    if ppr_scores is not None:
        scorers += ["local", "local_wt"]
        # rank-index scores: item sorted desc by PPR gets score n..1
        # (longTail.cpp:356-365)
        order = np.argsort(-ppr_scores, axis=1, kind="stable")
        rank_scores = np.zeros_like(ppr_scores)
        nn = ppr_scores.shape[1]
        np.put_along_axis(rank_scores, order,
                          (nn - np.arange(nn))[None, :].astype(
                              ppr_scores.dtype), axis=1)
        rank_scores = _pad_cols(rank_scores, n_all)
        wt_scores = np.where(item_freq[None, :] > 0,
                             rank_scores
                             / np.maximum(item_freq[None, :], 1),
                             0.0)

    valid_items = ~invalid_items[:n_items]

    # one (user, test-item) pair per evaluation; all pools staged up
    # front and scored in device blocks
    from matfac_tpu_torch.analysis.batch import (sample_unrated_pools,
                                                 score_pools)
    pair_u, pair_ti, pair_row = [], [], []
    for j, u in enumerate(sampled_users):
        for ti in test_mat.row(int(u))[0]:
            pair_u.append(int(u))
            pair_ti.append(int(ti))
            pair_row.append(j)
    pair_u = np.asarray(pair_u, np.int64)
    pair_ti = np.asarray(pair_ti, np.int64)
    pair_row = np.asarray(pair_row, np.int64)
    n_test = len(pair_u)
    is_head = head_mask[pair_ti] if n_test else np.zeros(0, bool)
    if n_test == 0:
        return {s: np.zeros(0, np.int64) for s in scorers}, is_head

    pools = sample_unrated_pools(train_mat, valid_items, pair_u, pair_ti,
                                 n_negatives, rng)
    pred = score_pools(view, pair_u, pools)            # [P, C]

    ranks = {}
    for s in scorers:
        if s == "model":
            sc = pred
        elif s == "local":
            sc = rank_scores[pair_row[:, None], pools]
        else:
            sc = wt_scores[pair_row[:, None], pools]
        # rank of the test item (column 0) within its pool
        ranks[s] = np.asarray((sc[:, 1:] > sc[:, :1]).sum(axis=1))
    return ranks, is_head


def _report(ranks: Dict[str, np.ndarray], is_head: np.ndarray,
            n: int) -> TopNRecReport:
    n_test = len(is_head)
    n_head = int(is_head.sum())
    n_tail = n_test - n_head
    hits = {s: r < n for s, r in ranks.items()}
    return TopNRecReport(
        n_test, n_head, n_tail,
        {s: float(h.sum()) / max(n_test, 1) for s, h in hits.items()},
        {s: float(h[is_head].sum()) / max(n_head, 1)
         for s, h in hits.items()},
        {s: float(h[~is_head].sum()) / max(n_tail, 1)
         for s, h in hits.items()})


def top_n_rec(view: EvalView, train_mat: RatingMatrix,
              test_mat: RatingMatrix, invalid_users: np.ndarray,
              invalid_items: np.ndarray, head_pc: float = 0.5,
              n: int = 10, n_samp_users: int = 10_000,
              n_negatives: int = 1000, seed: int = 1,
              ppr_scores: Optional[np.ndarray] = None,
              sampled_users: Optional[np.ndarray] = None
              ) -> TopNRecReport:
    """``ppr_scores``: optional [n_users_eval, n_items] per-user local
    scores aligned with ``sampled_users`` (from ops.ppr.PPREngine
    .user_ppr); enables the local / freq-weighted-local scorers."""
    ranks, is_head = _topn_ranks(
        view, train_mat, test_mat, invalid_users, invalid_items,
        head_pc, n_samp_users, n_negatives, seed, ppr_scores,
        sampled_users)
    return _report(ranks, is_head, n)


def spot_rec(views: Dict[str, EvalView], train_mat: RatingMatrix,
             test_mat: RatingMatrix, invalid_users: np.ndarray,
             invalid_items: np.ndarray, n_values=(1, 5, 10, 20),
             head_pc: float = 0.5, n_samp_users: int = 5000,
             n_negatives: int = 1000, seed: int = 1
             ) -> Dict[str, "TopNRecReport"]:
    """spotRec analog (longTail.cpp:2139): sampled-negative recall at
    several N cutoffs for multiple models (e.g. trained vs SVD),
    head/tail split. Returns {f"{name}@N": report}. Pools are sampled
    and scored ONCE per model; the N cutoffs just threshold the
    test-item rank (it does not depend on N)."""
    out = {}
    for name, view in views.items():
        ranks, is_head = _topn_ranks(
            view, train_mat, test_mat, invalid_users, invalid_items,
            head_pc, n_samp_users, n_negatives, seed, None, None)
        for n in n_values:
            out[f"{name}@{n}"] = _report(ranks, is_head, n)
    return out
