"""Frequency and validity helpers: the functions of matfac_tpu/utils/freq.py,
copied (tests/test_torch_data.py holds them to the
originals).

Row/col frequencies (getRowColFreq, util.cpp:555), invalid-entity
detection (getInvalidUsersItems, util.cpp:511-544), head-item extraction
(getHeadItems, util.cpp:4-34) and the frequency quartiles of main.cpp's
reports (main.cpp:1137-1168), the percentile rank map (main.cpp:1170-1201),
the TMF frequency scale, Pearson correlation and genStats (util.cpp:319-411),
as dense numpy arrays.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from matfac_tpu_torch.data.csr import RatingMatrix


def row_col_freq(mat: RatingMatrix) -> Tuple[np.ndarray, np.ndarray]:
    """Ratings-count per user / item (getRowColFreq, util.cpp:555)."""
    return (mat.row_degrees().astype(np.float64),
            mat.col_degrees().astype(np.float64))


def invalid_users_items(mat: RatingMatrix, n_users: int, n_items: int
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Boolean invalid masks over [n_users], [n_items].

    Semantics of getInvalidUsersItems (util.cpp:511-544) plus the
    out-of-range extension every trainer applies (e.g. modelMF.cpp:40-45):
    users/items with zero train ratings are invalid, as are indices >=
    the train matrix's dimensions up to the global n_users/n_items.
    """
    u_bad = np.ones(n_users, dtype=bool)
    i_bad = np.ones(n_items, dtype=bool)
    deg_u = mat.row_degrees()
    deg_i = mat.col_degrees()
    nr = min(mat.nrows, n_users)
    nc = min(mat.ncols, n_items)
    u_bad[:nr] = deg_u[:nr] == 0
    i_bad[:nc] = deg_i[:nc] == 0
    return u_bad, i_bad


def head_items(mat: RatingMatrix, head_pc: float) -> np.ndarray:
    """Items covering ``head_pc`` of total rating mass, most-rated first
    (getHeadItems, util.cpp:4-34). Returns a boolean mask [n_items]."""
    return head_items_from_freq(mat.col_degrees(), head_pc)


def head_items_from_freq(freq: np.ndarray, head_pc: float) -> np.ndarray:
    """head_items from a frequency vector: the most frequent entities (ties
    in id order) up to and including the one whose cumulative frequency
    reaches ``head_pc`` of the total."""
    freq = np.asarray(freq, np.float64)
    order = np.argsort(-freq, kind="stable")
    csum = np.cumsum(freq[order])
    total = csum[-1] if len(csum) else 0.0
    cutoff = np.searchsorted(csum, head_pc * total) + 1
    mask = np.zeros(len(freq), dtype=bool)
    mask[order[:cutoff]] = True
    return mask


def quartile_assignments(freq: np.ndarray, valid: np.ndarray,
                         n_quantiles: int = 4) -> np.ndarray:
    """Frequency-quantile id per entity, -1 for invalid (getUserItemRankMap,
    main.cpp:1137-1168): valid entities sorted by ascending frequency (ties
    in id order) are split into ``n_quantiles`` equal-count buckets, the
    last taking the remainder; bucket 0 = least frequent (tail)."""
    out = np.full(len(freq), -1, dtype=np.int32)
    idx = np.nonzero(valid)[0]
    if len(idx) == 0:
        return out
    order = idx[np.argsort(freq[idx], kind="stable")]
    n = len(order)
    per = max(n // n_quantiles, 1)
    for q in range(n_quantiles):
        s = q * per
        e = (q + 1) * per if q < n_quantiles - 1 else n
        out[order[s:e]] = q
    return out


def percentile_rank_map(freq: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """Percentile-in-[0,1] of each entity's frequency among valid entities
    (getUserItemRankMapPc analog, main.cpp:1170-1201); invalid → 0."""
    out = np.zeros(len(freq), dtype=np.float64)
    idx = np.nonzero(valid)[0]
    if len(idx) == 0:
        return out
    order = np.argsort(freq[idx], kind="stable")
    ranks = np.empty(len(idx), dtype=np.float64)
    ranks[order] = np.arange(1, len(idx) + 1)
    out[idx] = ranks / len(idx)
    return out


def freq_scale_stats(user_freq: np.ndarray, item_freq: np.ndarray
                     ) -> Tuple[float, float, float, float]:
    """(min, max, mean, std) over concat(userFreq, itemFreq) — the TMF
    z-scoring constants (modelDropoutSigmoid.h:38-150 ctor)."""
    concat = np.concatenate([user_freq, item_freq]).astype(np.float64)
    return (float(concat.min()), float(concat.max()),
            float(concat.mean()), float(concat.std()))


def pearson_corr(a: np.ndarray, b: np.ndarray) -> float:
    """util.cpp pearsonCorr analog."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if len(a) < 2:
        return 0.0
    sa, sb = a.std(), b.std()
    if sa == 0 or sb == 0:
        return 0.0
    return float(((a - a.mean()) * (b - b.mean())).mean() / (sa * sb))


def gen_stats(mat, ignore_pairs=None) -> dict:
    """genStats analog (util.cpp:319-411): nnz + per-entity rating
    counts, optionally AFTER removing an ignore set of (u, i) pairs
    (the reference's uISetIgnore — e.g. the val+test entries carved
    out of train), plus the entity counts at the post-ignore min/max.

    ``ignore_pairs``: optional (rows, cols) arrays of pairs to drop.
    Returns a dict; use format_gen_stats() for the reference's
    line-per-stat log dump."""
    r, c, _ = mat.to_coo()
    n_users, n_items = mat.shape
    u_cnt = np.bincount(r, minlength=n_users)
    i_cnt = np.bincount(c, minlength=n_items)
    if ignore_pairs is not None:
        ir = np.asarray(ignore_pairs[0], np.int64)
        ic = np.asarray(ignore_pairs[1], np.int64)
        ign = np.isin(r.astype(np.int64) * n_items + c,
                      ir * n_items + ic)
    else:
        ign = np.zeros(len(r), bool)
    u_ig = np.bincount(r[~ign], minlength=n_users)
    i_ig = np.bincount(c[~ign], minlength=n_items)

    def mm(x):
        return (int(x.min()), int(x.max())) if len(x) else (0, 0)

    u_lo, u_hi = mm(u_cnt)
    i_lo, i_hi = mm(i_cnt)
    uig_lo, uig_hi = mm(u_ig)
    iig_lo, iig_hi = mm(i_ig)
    return {
        "n_users": n_users, "n_items": n_items,
        "nnz": int(len(r)), "ig_nnz": int(ign.sum()),
        "min_user_ratings": u_lo, "max_user_ratings": u_hi,
        "min_item_ratings": i_lo, "max_item_ratings": i_hi,
        "min_user_ratings_after_ig": uig_lo,
        "max_user_ratings_after_ig": uig_hi,
        "min_item_ratings_after_ig": iig_lo,
        "max_item_ratings_after_ig": iig_hi,
        "n_users_with_min": int((u_ig == uig_lo).sum()),
        "n_users_with_max": int((u_ig == uig_hi).sum()),
        "n_items_with_min": int((i_ig == iig_lo).sum()),
        "n_items_with_max": int((i_ig == iig_hi).sum()),
    }


def format_gen_stats(stats: dict, op_prefix: str = "") -> str:
    """The reference's genStats stdout protocol (one stat per line,
    trailing 'opPrefix:' tag on the per-entity lines)."""
    sfx = f" opPrefix: {op_prefix}" if op_prefix else ""
    s = stats
    lines = [
        f"nUsers: {s['n_users']}",
        f"nItems: {s['n_items']}",
        f"NNZ: {s['nnz']}",
        f"min nratings per user: {s['min_user_ratings']}{sfx}",
        f"max nratings per user: {s['max_user_ratings']}{sfx}",
        f"min nratings per item: {s['min_item_ratings']}{sfx}",
        f"max nratings per item: {s['max_item_ratings']}{sfx}",
        f"min nratings per user after ig: "
        f"{s['min_user_ratings_after_ig']}{sfx}",
        f"max nratings per user after ig: "
        f"{s['max_user_ratings_after_ig']}{sfx}",
        f"min nratings per item after ig: "
        f"{s['min_item_ratings_after_ig']}{sfx}",
        f"max nratings per item after ig: "
        f"{s['max_item_ratings_after_ig']}{sfx}",
        f"nUsers with minRatcount({s['min_user_ratings_after_ig']}): "
        f"{s['n_users_with_min']}{sfx}",
        f"nUsers with maxRatcount({s['max_user_ratings_after_ig']}): "
        f"{s['n_users_with_max']}{sfx}",
        f"nItems with minRatCount({s['min_item_ratings_after_ig']}): "
        f"{s['n_items_with_min']}{sfx}",
        f"nItems with maxRatCount({s['max_item_ratings_after_ig']}): "
        f"{s['n_items_with_max']}{sfx}",
    ]
    return "\n".join(lines)
