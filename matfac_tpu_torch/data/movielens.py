"""MovieLens dataset parsers → RatingMatrix (port of
matfac_tpu/data/movielens.py, numpy).

The reference consumes MovieLens via offline conversion scripts
(python/convert_scipy_sparse_to_text_csr.py etc.); here the parsers are
first-class. Supports the ``u.data`` (ML-100K, tab-separated) and
``ratings.dat`` (ML-1M/10M, ``::``-separated) and ``ratings.csv``
(ML-20M/25M) formats. IDs are remapped to dense 0-based indices.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from matfac_tpu_torch.data.csr import RatingMatrix
from matfac_tpu_torch.data.dataset import Data
from matfac_tpu_torch.data.io import split_train_test_val


def load_ratings_file(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Return (user_ids, item_ids, ratings) with dense 0-based ids."""
    if path.endswith(".csv"):
        raw = np.genfromtxt(path, delimiter=",", skip_header=1,
                            usecols=(0, 1, 2), dtype=np.float64)
    elif path.endswith(".dat"):
        with open(path) as f:
            txt = f.read().replace("::", "\t")
        flat = np.array(txt.split(), dtype=np.float64)
        raw = flat.reshape(-1, 4)[:, :3]
    else:  # u.data: user \t item \t rating \t ts
        raw = np.loadtxt(path, usecols=(0, 1, 2), dtype=np.float64)
    users = raw[:, 0].astype(np.int64)
    items = raw[:, 1].astype(np.int64)
    ratings = raw[:, 2].astype(np.float32)
    _, users = np.unique(users, return_inverse=True)
    _, items = np.unique(items, return_inverse=True)
    return users, items, ratings


def load_movielens(path: str, test_pc: float = 0.1, val_pc: float = 0.1,
                   seed: int = 1) -> Data:
    users, items, ratings = load_ratings_file(path)
    mat = RatingMatrix.from_coo(users, items, ratings,
                                int(users.max()) + 1, int(items.max()) + 1)
    train, test, val = split_train_test_val(mat, test_pc, val_pc, seed)
    return Data(train_mat=train, test_mat=test, val_mat=val,
                prefix=os.path.splitext(os.path.basename(path))[0])
