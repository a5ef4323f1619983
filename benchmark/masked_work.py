"""The least work of TMF+Dropout's epoch, whose ratings train at drawn
ranks: the model's work at each rating's expected rank, with
``roofline.py``'s peaks and counting rules.

A rating of pair lambda lam trains at rank r = clip(X, 1, k), X ~
Poisson(lam), and costs 10 r FLOPs (``roofline.mf_epoch_work`` at width r).
E[r] = sum_{j=1..k} P(r >= j) = 1 + sum_{m=1..k-1} (1 - C[lam - 1, m]), C
the Poisson CDF table: exact for an independent draw a rating, and for the
program's common uniform a stripe visit, whose marginal is the same. Each
rating is read once, each user row read and written once at its own
expected rank (a stripe visits each of its users once an epoch), each item
row at full width (every stripe visits every item)."""

from __future__ import annotations

import torch

from benchmark import roofline


def expected_ranks(C: torch.Tensor) -> torch.Tensor:
    """float64 [k]: E[clip(Poisson(lam), 1, k)] for lam = 1..k, from C [k, k]
    (C[lam - 1, m] = P(Poisson(lam) <= m))."""
    return 1.0 + (1.0 - C[:, 1:].double()).sum(1)


def tmf_epoch_work(lam_pair: torch.Tensor, lam_u: torch.Tensor,
                   n_items: int, k: int, C: torch.Tensor):
    """(FLOPs, bytes, sum of E[r] over the ratings) of one epoch over the
    ratings of pair lambdas ``lam_pair`` (one a rating), user lambdas
    ``lam_u`` (one a user)."""
    er = expected_ranks(C).to(lam_pair.device)
    dims = float(er[lam_pair - 1].sum())
    user_dims = float(er.to(lam_u.device)[lam_u - 1].sum())
    n_ratings, n_users = lam_pair.numel(), lam_u.numel()
    flops = 10.0 * dims
    nbytes = (roofline.ENTRY_BYTES * n_ratings
              + roofline.INDPTR_BYTES * (n_users + 1)
              + 2 * roofline.F32 * (user_dims + n_items * k))
    return flops, nbytes, dims
