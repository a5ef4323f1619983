"""Frequency and validity helpers: the functions of matfac_tpu/utils/freq.py
that the port calls, copied (tests/test_torch_data.py holds them to the
originals).

Row/col frequencies (getRowColFreq, util.cpp:555), invalid-entity
detection (getInvalidUsersItems, util.cpp:511-544), head-item extraction
(getHeadItems, util.cpp:4-34) and the frequency quartiles of main.cpp's
reports (main.cpp:1137-1168), as dense numpy arrays.
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
