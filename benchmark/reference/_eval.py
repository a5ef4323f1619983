"""The checks of the training loops and the top-N lists, in plain
PyTorch: RMSE and the regularized objective (Model::RMSE,
model.cpp:214-251; Model::objective, model.cpp:1770-1815), full-catalog
top-N with the user's train items and the items without a train rating
excluded, leave-one-out HR@10 (model.cpp:1158-1211)."""

from __future__ import annotations

import torch

_CHUNK = 1 << 21
_USERS = 2048    # users a block of the top-N scores


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def valid(train, n_users: int, n_items: int):
    """(valid users, valid items): those with a train rating."""
    rows, cols, _ = train
    return (torch.bincount(rows, minlength=n_users) > 0,
            torch.bincount(cols, minlength=n_items) > 0)


def sse(U, V, split, vu, vi):
    """(sum of squared errors in f64, count) over the split's entries whose
    user and item are valid; predictions in the tables' type."""
    rows, cols, vals = split
    keep = vu[rows] & vi[cols]
    rows, cols, vals = rows[keep], cols[keep], vals[keep]
    total = torch.zeros((), dtype=torch.float64, device=U.device)
    for s in range(0, rows.numel(), _CHUNK):
        e = min(s + _CHUNK, rows.numel())
        pred = (U[rows[s:e]] * V[cols[s:e]]).sum(1)
        d = vals[s:e].double() - pred.double()
        total += (d * d).sum()
    return float(total), int(rows.numel())


def rmse(U, V, split, vu, vi) -> float:
    s, n = sse(U, V, split, vu, vi)
    return (s / max(n, 1)) ** 0.5


def objective(U, V, train, vu, vi, u_reg: float, i_reg: float) -> float:
    s, _ = sse(U, V, train, vu, vi)
    sq = lambda X, m: float((X.double() ** 2).sum(1)[m].sum())
    return s + u_reg * sq(U, vu) + i_reg * sq(V, vi)


def exclusions(train, n_users: int):
    """(indptr, cols) of the train rows, sorted by row."""
    rows, cols, _ = train
    indptr = torch.zeros(n_users + 1, dtype=torch.int64, device=rows.device)
    indptr[1:] = torch.cumsum(torch.bincount(rows, minlength=n_users), 0)
    return indptr, cols


def scores(U, V, users, excl, invalid_items):
    """[B, n_items] scores <U[u], V[i]> in the tables' type, cast to f32,
    -inf where the item is the user's train item or has no train rating."""
    indptr, cols = excl
    sc = (U[users] @ V.T).float()
    sc[:, invalid_items] = -torch.inf
    start, end = indptr[users], indptr[users + 1]
    n = end - start
    r = torch.repeat_interleave(torch.arange(users.numel(),
                                             device=users.device), n)
    pos = torch.arange(int(n.sum()), device=users.device) - \
        torch.repeat_interleave(torch.cumsum(n, 0) - n, n) + \
        torch.repeat_interleave(start, n)
    sc[r, cols[pos]] = -torch.inf
    return sc


def topn(U, V, users, excl, invalid_items, n: int):
    """(scores [B, n] f32, ids [B, n] int64) of the n best scorable items,
    descending."""
    out_s, out_i = [], []
    for s in range(0, users.numel(), _USERS):
        sc = scores(U, V, users[s:s + _USERS], excl, invalid_items)
        v, i = torch.topk(sc, n, dim=1)
        out_s.append(v)
        out_i.append(i)
    return torch.cat(out_s), torch.cat(out_i)


def hr10(U, V, val, train, vu, vi) -> float:
    """Leave-one-out HR@10 on ``val``: a valid user's first val item among
    its top 10."""
    rows, cols, _ = val
    n_users = vu.numel()
    first = torch.full((n_users,), -1, dtype=torch.int64, device=U.device)
    # the first entry of each user's row: rows are sorted, so scatter the
    # entries in reverse and the first one lands last
    first[rows.flip(0)] = cols.flip(0)
    users = torch.nonzero((first >= 0) & vu).squeeze(1)
    if users.numel() == 0:
        return 0.0
    _, ids = topn(U, V, users, exclusions(train, n_users), ~vi, 10)
    hits = (ids == first[users][:, None]).any(1)
    return float(hits.double().sum()) / users.numel()
