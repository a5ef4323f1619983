"""The least work of one ALS epoch (a user pass, then an item pass, of
exact normal-equation solves), with ``roofline.py``'s peaks and counting
rules: the model's work, whatever implements it.

A side's FLOPs: each rating adds q q^T to its row's Gram, the upper
triangle k(k+1)/2 multiply-adds, and r q to its right-hand side, k
multiply-adds: k(k+1) + 2k; each row solved costs a Cholesky factor (k^3 /
3) and two triangular solves (2 k^2). Bytes: each side's CSR read once (a
rating's int32 column and f32 value, a row's int64 pointer), each factor
table read once and written once in f32."""

from __future__ import annotations

from benchmark import roofline


def side_flops(n_ratings: int, n_rows: int, k: int) -> float:
    """FLOPs of one pass over ``n_ratings`` ratings solving ``n_rows``
    rows."""
    return n_ratings * (k * (k + 1) + 2.0 * k) + \
        n_rows * (k ** 3 / 3.0 + 2.0 * k * k)


def als_epoch_work(n_ratings: int, n_users: int, n_items: int, k: int):
    """(FLOPs, bytes) of one epoch over ``n_ratings`` train ratings of
    ``n_users`` valid users and ``n_items`` valid items."""
    flops = side_flops(n_ratings, n_users, k) + \
        side_flops(n_ratings, n_items, k)
    nbytes = (2 * roofline.ENTRY_BYTES * n_ratings
              + roofline.INDPTR_BYTES * (n_users + 1 + n_items + 1)
              + 2 * roofline.F32 * k * (n_users + n_items))
    return flops, nbytes
