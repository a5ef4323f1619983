"""Plain MF by alternating least squares, the bucketed ALS engine's sweep
(``als`` with exact solves; ModelMF::trainALS, modelMF.cpp:709-928,
mohit-shrma/matfac; Zhou et al., "Large-scale Parallel Collaborative
Filtering for the Netflix Prize", AAIM 2008). An epoch solves every valid
user u, with R_u its train ratings whose rating is > 0 (the reference's
gate, modelMF.cpp:820/:862):

    G_u = sum_{i in R_u} q_i q_i^T + u_reg I
    b_u = sum_{i in R_u} r_ui q_i
    p_u = G_u^{-1} b_u

then every valid item the same way over the columns, from the new user
table. Users and items without a train rating keep their factors.

Departures from the reference C++, as the program makes them: the flat
lambda of the C++ (Zhou et al. weight it by the row's count); rows solved
in batches, where the C++ loops over them one at a time; a Cholesky factor
and two triangular solves where the C++ takes Eigen's ``ldlt``.

Worked out again from the train split, with nothing of the program's
layout: the valid rows (``_eval.valid``), and each side's equations from
blocks of target rows densified from the split, G = M QQ over the k(k+1)/2
packed products of the source rows and b = R Q (M the block's 0/1 rated
slots, R its ratings), no gathers and no degree buckets. f32 with TF32
off; ``torch.linalg.cholesky_ex`` and ``cholesky_solve``, a row whose
Gram has no f32 Cholesky factor solved as NaN."""

from __future__ import annotations

import torch

from benchmark.reference import _eval

_ELEMS = 1 << 27     # elements of a dense block of target rows (512 MiB)

FAULTS = (None, "half_batch", "jacobi", "no_reg", "users_only")


def side(target, source, vals, n_target: int, n_source: int,
         fault=None):
    """One side's equations as a CSR sorted by target, then source:
    (indptr [n_target + 1] on the host, source ids, the ratings with the
    rating>0 gate applied as 0/1 weights ``w``). ``fault="half_batch"``
    keeps only the first half of each row's ratings (the second half
    weighted 0)."""
    order = torch.argsort(target * n_source + source)
    target, source, vals = target[order], source[order], vals[order]
    n = torch.bincount(target, minlength=n_target)
    indptr = torch.zeros(n_target + 1, dtype=torch.int64,
                         device=target.device)
    indptr[1:] = torch.cumsum(n, 0)
    w = (vals > 0).to(torch.float32)
    if fault == "half_batch":
        pos = torch.arange(target.numel(), device=target.device) - \
            indptr[:-1][target]
        w = w * (2 * pos < n[target]).to(torch.float32)
    return indptr.cpu(), source, vals.float() * w, w


def sweep(T: torch.Tensor, S: torch.Tensor, eqs, valid: torch.Tensor,
          reg: float) -> torch.Tensor:
    """The new table of target rows ``T`` from source rows ``S`` (in the
    tables' type; products and solves in f32): each valid row solved from
    its equations ``eqs`` (``side``), the others kept."""
    indptr, src, rv, w = eqs
    n_t, k = T.shape
    n_s = S.shape[0]
    dev = T.device
    Sf = S.float()
    iu, ju = torch.triu_indices(k, k, device=dev)
    QQ = Sf[:, iu] * Sf[:, ju]                          # [n_s, k(k+1)/2]
    eye = reg * torch.eye(k, dtype=torch.float32, device=dev)
    out = T.clone()
    blk = max(1, _ELEMS // max(n_s, 1))
    for s0 in range(0, n_t, blk):
        e0 = min(s0 + blk, n_t)
        a, b = int(indptr[s0]), int(indptr[e0])
        counts = (indptr[s0 + 1:e0 + 1] - indptr[s0:e0]).to(dev)
        local = torch.repeat_interleave(
            torch.arange(e0 - s0, device=dev), counts)
        M = torch.zeros(e0 - s0, n_s, dtype=torch.float32, device=dev)
        R = torch.zeros_like(M)
        M[local, src[a:b]] = w[a:b]
        R[local, src[a:b]] = rv[a:b]
        packed = M @ QQ
        G = torch.zeros(e0 - s0, k, k, dtype=torch.float32, device=dev)
        G[:, iu, ju] = packed
        G[:, ju, iu] = packed
        L, info = torch.linalg.cholesky_ex(G + eye)
        x = torch.cholesky_solve((R @ Sf)[:, :, None], L)[:, :, 0]
        # a Gram that is not positive definite in f32 (a planted fault's
        # may not be) gives its row NaN, and the checks fail on it
        x = x.masked_fill((info > 0)[:, None], float("nan"))
        keep = valid[s0:e0]
        out[s0:e0] = torch.where(keep[:, None], x.to(out.dtype), out[s0:e0])
        del M, R, packed, G, L, x
    return out


def follow(inp: dict, hp: dict, epochs: int, dtype=torch.float32,
           fault=None) -> dict:
    """Job 0's first ``epochs`` epochs from (u0, i0): the tables after each
    epoch (f32), and the objective and val RMSE before and after the first.
    ``dtype``: of the tables (each solved row rounded to it). Planted
    faults: ``half_batch`` (each row's equations from the first half of
    its ratings), ``jacobi`` (the item pass from the old user table),
    ``no_reg`` (lambda left out), ``users_only`` (the item pass
    skipped)."""
    if fault not in FAULTS:
        raise ValueError(f"fault {fault!r}; one of {FAULTS}")
    _eval.no_tf32()
    nu, ni = inp["n_users"], inp["n_items"]
    vu, vi = _eval.valid(inp["train"], nu, ni)
    rows, cols, vals = inp["train"]
    half = "half_batch" if fault == "half_batch" else None
    by_user = side(rows, cols, vals, nu, ni, half)
    by_item = side(cols, rows, vals, ni, nu, half)
    U, V = inp["u0"].to(dtype).clone(), inp["i0"].to(dtype).clone()
    ur, ir = hp["u_reg"], hp["i_reg"]
    if fault == "no_reg":
        ur = ir = 0.0
    checks = {"objective": [], "rmse": []}

    def check():
        checks["objective"].append(_eval.objective(
            U, V, inp["train"], vu, vi, hp["u_reg"], hp["i_reg"]))
        checks["rmse"].append(_eval.rmse(U, V, inp["val"], vu, vi))
    check()
    states = []
    for e in range(epochs):
        U_old = U
        U = sweep(U, V, by_user, vu, ur)
        if fault != "users_only":
            V = sweep(V, U_old if fault == "jacobi" else U, by_item, vi, ir)
        states.append((U.to(torch.float32, copy=True),
                       V.to(torch.float32, copy=True)))
        if e == 0:
            check()
    return dict(states=states, checks=checks)
