"""The Data bundle: train/test/val matrices + optional graph and
ground-truth factors (the port's own copy of matfac_tpu/data/dataset.py;
tests/test_torch_data.py holds the two together).

Analog of the reference ``Data`` class (datastruct.h:72-136,
datastruct.cpp:3-120): reads three GKlib-text CSR matrices, computes
``n_items = maxItemInd + 1`` across all three, optionally loads an
item-graph CSR and ground-truth factor matrices.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from matfac_tpu_torch.config import Params
from matfac_tpu_torch.data.csr import RatingMatrix


class Data:
    train_mat: RatingMatrix
    test_mat: Optional[RatingMatrix]
    val_mat: Optional[RatingMatrix]
    graph_mat: Optional[RatingMatrix]
    orig_u_fac: Optional[np.ndarray]
    orig_i_fac: Optional[np.ndarray]

    def __init__(self, params: Optional[Params] = None,
                 train_mat: Optional[RatingMatrix] = None,
                 test_mat: Optional[RatingMatrix] = None,
                 val_mat: Optional[RatingMatrix] = None,
                 graph_mat: Optional[RatingMatrix] = None,
                 orig_u_fac: Optional[np.ndarray] = None,
                 orig_i_fac: Optional[np.ndarray] = None,
                 prefix: str = "mf"):
        from matfac_tpu_torch.data import io as mfio

        self.prefix = prefix
        self.graph_mat = graph_mat
        self.orig_u_fac = orig_u_fac
        self.orig_i_fac = orig_i_fac

        if params is not None:
            self.prefix = params.prefix
            if train_mat is None and params.train_mat_file:
                train_mat = mfio.read_csr(params.train_mat_file)
            if test_mat is None and params.test_mat_file:
                test_mat = mfio.read_csr(params.test_mat_file)
            if val_mat is None and params.val_mat_file:
                val_mat = mfio.read_csr(params.val_mat_file)
            if graph_mat is None and params.graph_mat_file:
                self.graph_mat = mfio.read_csr(params.graph_mat_file)

        if train_mat is None:
            raise ValueError("Data requires a train matrix")
        self.train_mat = train_mat
        self.test_mat = test_mat
        self.val_mat = val_mat

        # n_items = maxItemInd+1 across train/test/val (datastruct.cpp:24-91)
        max_item = train_mat.ncols - 1
        for m in (test_mat, val_mat):
            if m is not None and m.nnz:
                max_item = max(max_item, int(m.indices.max()))
        self.n_items = max_item + 1
        self.n_users = train_mat.nrows
        for m in (test_mat, val_mat):
            if m is not None:
                self.n_users = max(self.n_users, m.nrows)
        self.train_nnz = train_mat.nnz
        self.fac_dim = params.fac_dim if params is not None else -1

        if params is not None and params.fac_dim > 0:
            if self.orig_u_fac is None and params.orig_u_fac_file:
                self.orig_u_fac = mfio.read_factor_mat(
                    params.orig_u_fac_file, self.n_users, params.fac_dim)
            if self.orig_i_fac is None and params.orig_i_fac_file:
                self.orig_i_fac = mfio.read_factor_mat(
                    params.orig_i_fac_file, self.n_items, params.fac_dim)

    def __repr__(self) -> str:
        return (f"Data(n_users={self.n_users}, n_items={self.n_items}, "
                f"train_nnz={self.train_nnz}, "
                f"test={'yes' if self.test_mat is not None else 'no'}, "
                f"val={'yes' if self.val_mat is not None else 'no'})")
