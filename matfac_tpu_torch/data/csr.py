"""Host-side sparse rating-matrix container (the port's own copy of
``RatingMatrix`` from matfac_tpu/data/csr.py; tests/test_torch_data.py
holds the two together).

Replacement for GKlib's ``gk_csr_t`` (used throughout the reference, e.g.
datastruct.cpp:16-98): a light numpy CSR with an on-demand column (CSC)
view, frequency/stat helpers, and conversions to COO / padded-row
layouts.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


class RatingMatrix:
    """CSR rating matrix over ``float32`` values and ``int32`` indices.

    Equivalent roles of ``gk_csr_t``: ``indptr`` = rowptr, ``indices`` =
    rowind, ``values`` = rowval. The CSC view (``gk_csr_CreateIndex`` with
    GK_CSR_COL) is built lazily by :meth:`csc`.
    """

    def __init__(self, indptr: np.ndarray, indices: np.ndarray,
                 values: np.ndarray, ncols: int):
        self.indptr = np.asarray(indptr, dtype=np.int64)
        self.indices = np.asarray(indices, dtype=np.int32)
        self.values = np.asarray(values, dtype=np.float32)
        self.ncols = int(ncols)
        if self.indptr.ndim != 1 or self.indptr[0] != 0:
            raise ValueError("indptr must be 1-D and start at 0")
        if self.indptr[-1] != len(self.indices) or len(self.indices) != len(self.values):
            raise ValueError("inconsistent CSR arrays")
        self._csc: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None

    # ------------------------------------------------------------------
    # basic properties
    # ------------------------------------------------------------------
    @property
    def nrows(self) -> int:
        return len(self.indptr) - 1

    @property
    def nnz(self) -> int:
        return int(self.indptr[-1])

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.nrows, self.ncols)

    def row(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        s, e = self.indptr[i], self.indptr[i + 1]
        return self.indices[s:e], self.values[s:e]

    def row_degrees(self) -> np.ndarray:
        return np.diff(self.indptr).astype(np.int64)

    def col_degrees(self) -> np.ndarray:
        return np.bincount(self.indices, minlength=self.ncols).astype(np.int64)

    # ------------------------------------------------------------------
    # constructors / converters
    # ------------------------------------------------------------------
    @classmethod
    def from_coo(cls, rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
                 nrows: int, ncols: int) -> "RatingMatrix":
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int32)
        vals = np.asarray(vals, dtype=np.float32)
        order = np.lexsort((cols, rows))  # sort by row, then col (sorted CSR)
        rows, cols, vals = rows[order], cols[order], vals[order]
        indptr = np.zeros(nrows + 1, dtype=np.int64)
        np.add.at(indptr, rows + 1, 1)
        indptr = np.cumsum(indptr)
        return cls(indptr, cols, vals, ncols)

    @classmethod
    def from_dense(cls, dense: np.ndarray,
                   keep: Optional[np.ndarray] = None) -> "RatingMatrix":
        """Build from a dense matrix; ``keep`` masks which entries are observed
        (default: nonzero entries)."""
        dense = np.asarray(dense)
        if keep is None:
            keep = dense != 0
        rows, cols = np.nonzero(keep)
        return cls.from_coo(rows, cols, dense[rows, cols],
                            dense.shape[0], dense.shape[1])

    def to_coo(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Triplet view (reference util.cpp:636-722 getUIRatings analog,
        without filtering)."""
        rows = np.repeat(np.arange(self.nrows, dtype=np.int32),
                         self.row_degrees())
        return rows, self.indices.copy(), self.values.copy()

    def to_dense(self) -> np.ndarray:
        out = np.zeros(self.shape, dtype=np.float32)
        r, c, v = self.to_coo()
        out[r, c] = v
        return out

    def csc(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Column view: (colptr, colind, colval). Lazily built and cached
        (``gk_csr_CreateIndex(mat, GK_CSR_COL)`` analog)."""
        if self._csc is None:
            r, c, v = self.to_coo()
            order = np.lexsort((r, c))
            cc, rr, vv = c[order], r[order], v[order]
            colptr = np.zeros(self.ncols + 1, dtype=np.int64)
            np.add.at(colptr, cc.astype(np.int64) + 1, 1)
            colptr = np.cumsum(colptr)
            self._csc = (colptr, rr.astype(np.int32), vv.astype(np.float32))
        return self._csc

    def transpose(self) -> "RatingMatrix":
        colptr, rowind, vals = self.csc()
        return RatingMatrix(colptr, rowind, vals, self.nrows)

    def copy(self) -> "RatingMatrix":
        """``gk_csr_Dup`` analog (used for CCD++ residuals, modelMF.cpp:1013)."""
        return RatingMatrix(self.indptr.copy(), self.indices.copy(),
                            self.values.copy(), self.ncols)

    # ------------------------------------------------------------------
    # checks / stats
    # ------------------------------------------------------------------
    def is_sorted(self) -> bool:
        """Rows have strictly increasing column indices
        (``checkIfUISorted`` analog, util.cpp:919-948; gate for CCD)."""
        if self.nnz <= 1:
            return True
        diffs = np.diff(self.indices.astype(np.int64))
        # diffs[j] compares entries (j, j+1); skip pairs straddling a row
        # boundary, i.e. where entry j+1 starts a new row.
        boundary = np.zeros(self.nnz - 1, dtype=bool)
        starts = self.indptr[1:-1]
        valid = (starts >= 1) & (starts <= self.nnz - 1)
        boundary[starts[valid] - 1] = True
        return bool(np.all(diffs[~boundary] > 0))

    def sort_rows(self) -> "RatingMatrix":
        r, c, v = self.to_coo()
        return RatingMatrix.from_coo(r, c, v, self.nrows, self.ncols)

    def mean_rating(self) -> float:
        return float(self.values.mean()) if self.nnz else 0.0

    def pad_rows(self, cap: Optional[int] = None,
                 pad_col: int = 0) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Dense padded-row layout: (cols[n, cap], vals[n, cap], mask[n, cap]).

        The TPU-friendly layout for per-row work (ALS gram accumulation,
        rated-item exclusion in top-k eval). Padding uses ``pad_col`` with
        mask 0.
        """
        deg = self.row_degrees()
        if cap is None:
            cap = int(deg.max()) if len(deg) else 1
        cap = max(int(cap), 1)
        n = self.nrows
        cols = np.full((n, cap), pad_col, dtype=np.int32)
        vals = np.zeros((n, cap), dtype=np.float32)
        mask = np.zeros((n, cap), dtype=bool)
        # vectorized fill: position within row
        r, c, v = self.to_coo()
        pos = np.arange(self.nnz, dtype=np.int64) - np.repeat(self.indptr[:-1], deg)
        ok = pos < cap
        cols[r[ok], pos[ok]] = c[ok]
        vals[r[ok], pos[ok]] = v[ok]
        mask[r[ok], pos[ok]] = True
        return cols, vals, mask

    def stats(self) -> dict:
        """genStats analog (util.cpp:319-411): nnz + degree summary."""
        du = self.row_degrees()
        di = self.col_degrees()
        return {
            "nnz": self.nnz, "nrows": self.nrows, "ncols": self.ncols,
            "mean_rating": self.mean_rating(),
            "row_deg_min": int(du.min()) if len(du) else 0,
            "row_deg_max": int(du.max()) if len(du) else 0,
            "row_deg_mean": float(du.mean()) if len(du) else 0.0,
            "col_deg_min": int(di.min()) if len(di) else 0,
            "col_deg_max": int(di.max()) if len(di) else 0,
            "col_deg_mean": float(di.mean()) if len(di) else 0.0,
            "zero_rows": int((du == 0).sum()),
            "zero_cols": int((di == 0).sum()),
        }

    def __repr__(self) -> str:
        return (f"RatingMatrix(nrows={self.nrows}, ncols={self.ncols}, "
                f"nnz={self.nnz})")

