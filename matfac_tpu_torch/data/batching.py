"""Host batch staging (port of ``CooBatches`` / ``coo_batches`` and
``RowBucket`` / ``bucketed_rows`` of matfac_tpu/data/batching.py).

Ratings become fixed-size COO batches for the scatter SGD engine: the
filtered triplets (getUIRatings semantics, util.cpp:636-722) padded to a
multiple of the batch size. Per-row work (ALS) becomes power-of-two degree
buckets of padded rows. Host numpy arrays; the solver moves them to its
device once.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from matfac_tpu_torch.data.csr import RatingMatrix


@dataclasses.dataclass
class CooBatches:
    """COO triplets padded to a multiple of ``batch_size``. Padding
    examples point at (row 0, col 0) with ``valid = 0``, so a weight of
    zero removes them from every update and reduction."""
    rows: np.ndarray      # [n] int32
    cols: np.ndarray      # [n] int32
    vals: np.ndarray      # [n] float32
    valid: np.ndarray     # [n] float32 (1.0 real, 0.0 pad)
    batch_size: int

    @property
    def n_total(self) -> int:
        return len(self.rows)

    @property
    def n_batches(self) -> int:
        return self.n_total // self.batch_size

    @property
    def nnz(self) -> int:
        return int(self.valid.sum())


def coo_batches(mat: RatingMatrix, batch_size: int,
                invalid_users: Optional[np.ndarray] = None,
                invalid_items: Optional[np.ndarray] = None,
                multiple_of: int = 1) -> CooBatches:
    """Triplets without invalid users / items, padded to a multiple of
    ``batch_size * multiple_of`` (one whole batch of padding when there is
    no rating)."""
    r, c, v = mat.to_coo()
    keep = np.ones(len(r), dtype=bool)
    if invalid_users is not None:
        keep &= ~invalid_users[r]
    if invalid_items is not None:
        keep &= ~invalid_items[c]
    r, c, v = r[keep], c[keep], v[keep]
    n = len(r)
    chunk = batch_size * multiple_of
    n_pad = (-n) % chunk if n else chunk
    rows = np.concatenate([r, np.zeros(n_pad, np.int32)]).astype(np.int32)
    cols = np.concatenate([c, np.zeros(n_pad, np.int32)]).astype(np.int32)
    vals = np.concatenate([v, np.zeros(n_pad, np.float32)]).astype(np.float32)
    valid = np.concatenate([np.ones(n, np.float32),
                            np.zeros(n_pad, np.float32)])
    return CooBatches(rows, cols, vals, valid, batch_size)


@dataclasses.dataclass
class RowBucket:
    """One degree bucket of padded rows (for ALS / per-row sweeps)."""
    row_ids: np.ndarray   # [nb] int32 — original row indices
    cols: np.ndarray      # [nb, cap] int32
    vals: np.ndarray      # [nb, cap] float32
    mask: np.ndarray      # [nb, cap] float32

    @property
    def cap(self) -> int:
        return self.cols.shape[1]


def bucketed_rows(mat: RatingMatrix, min_cap: int = 8,
                  invalid: Optional[np.ndarray] = None,
                  rows_multiple: int = 8) -> List[RowBucket]:
    """Group rows into power-of-two capacity buckets: rows with degree in
    (cap/2, cap] share a bucket padded to ``cap`` (at most ~2x padding).
    Zero-degree and invalid rows are dropped (they are exactly the
    reference's invalid entities). Bucket row counts are padded to
    ``rows_multiple`` with all-masked dummy rows whose id is 0."""
    deg = mat.row_degrees()
    keep = deg > 0
    if invalid is not None:
        keep &= ~invalid[: mat.nrows]
    out: List[RowBucket] = []
    if not keep.any():
        return out
    # vectorized fill: per-entry destination = (bucket-local row, slot)
    r, c, v = mat.to_coo()
    slot = np.arange(mat.nnz, dtype=np.int64) - np.repeat(
        mat.indptr[:-1], deg)
    max_deg = int(deg[keep].max())
    cap = max(min_cap, 1)
    lo = 0
    while lo < max_deg:
        hi = cap
        sel = np.nonzero(keep & (deg > lo) & (deg <= hi))[0]
        if len(sel):
            nb = -(-len(sel) // rows_multiple) * rows_multiple
            local = np.full(mat.nrows, -1, np.int64)
            local[sel] = np.arange(len(sel))
            erow = local[r]
            ok = erow >= 0
            cols = np.zeros((nb, cap), np.int32)
            vals = np.zeros((nb, cap), np.float32)
            mask = np.zeros((nb, cap), np.float32)
            cols[erow[ok], slot[ok]] = c[ok]
            vals[erow[ok], slot[ok]] = v[ok]
            mask[erow[ok], slot[ok]] = 1.0
            row_ids = np.concatenate(
                [sel.astype(np.int32), np.zeros(nb - len(sel), np.int32)])
            out.append(RowBucket(row_ids, cols, vals, mask))
        lo = hi
        cap *= 2
    return out
