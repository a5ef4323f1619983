"""COO minibatch staging for the scatter SGD engine (port of
``CooBatches`` / ``coo_batches`` of matfac_tpu/data/batching.py).

Ratings become fixed-size COO batches: the filtered triplets (getUIRatings
semantics, util.cpp:636-722) padded to a multiple of the batch size. Host
numpy arrays; the solver moves them to its device once.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

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
