"""Frequency and validity helpers: the functions of matfac_tpu/utils/freq.py
that the port calls, copied (tests/test_torch_data.py holds them to the
originals).

Row/col frequencies (getRowColFreq, util.cpp:555) and invalid-entity
detection (getInvalidUsersItems, util.cpp:511-544), as dense numpy arrays.
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
