"""Explicit ratings of a known low-rank model with heavy-tailed user
activity, made on the device from a seed: ``explicit_lowrank``'s truth,
item law, noise, grid and split, with each user's count of ratings drawn
first instead of users drawn uniformly.

User activity: every user has at least ``user_min_ratings`` ratings (the
MovieLens READMEs' rule); the rest of the configuration's ratings are
shared out in proportion to exp(sigma z), z ~ N(0, 1) clipped at
``user_activity_z_max`` (a log-normal law of spread
``user_activity_sigma``), no user above half the items, and the counts
rounded by largest remainder so that they sum to ``n_ratings`` exactly.
A user's items are the first distinct ones of independent draws from the
item power law (item j weighs 1 / (j + 1) ** ``item_power_law``), that
is, drawn without replacement in proportion to the same weights.

Returns ``dict(n_users, n_items, train, val, test)``; each split is a
tuple (rows int64, cols int64, vals f32) on the device, sorted by row,
then column.
"""

from __future__ import annotations

import math

import torch

from benchmark.data.explicit_lowrank import _orthonormal


def user_counts(n_users: int, n_items: int, n: int, a: dict,
                g: torch.Generator, device) -> torch.Tensor:
    """int64 [n_users]: each user's count of ratings, summing to n."""
    lo, cap = a["user_min_ratings"], n_items // 2
    if not lo * n_users <= n <= cap * n_users:
        raise ValueError(f"{n} ratings do not fit {n_users} users of "
                         f"{lo}..{cap} ratings each")
    z = torch.randn(n_users, generator=g, device=device,
                    dtype=torch.float64)
    w = torch.exp(a["user_activity_sigma"]
                  * z.clamp_(max=a["user_activity_z_max"]))
    q = torch.full_like(w, float(lo))
    free = torch.ones(n_users, dtype=torch.bool, device=device)
    while True:
        # the ratings above the minimum, shared by the users under the cap
        left = n - float(q[~free].sum()) - lo * int(free.sum())
        t = lo + left * w / float(w[free].sum())
        over = free & (t > cap)
        if not bool(over.any()):
            q[free] = t[free]
            break
        q[over] = float(cap)
        free &= ~over
    base = q.floor()
    short = n - int(base.sum())
    up = torch.argsort(q - base, descending=True, stable=True)[:short]
    base[up] += 1
    return base.to(torch.int64)


def _user_items(counts: torch.Tensor, n_items: int, cdf: torch.Tensor,
                g: torch.Generator, device) -> torch.Tensor:
    """Keys user * n_items + item: each user's first ``counts[u]``
    distinct items of its draws, in draw order."""
    nu = counts.numel()
    users = torch.arange(nu, device=device)
    keys = torch.empty(0, dtype=torch.int64, device=device)
    have = torch.zeros_like(counts)
    factor = 1.25
    while True:
        need = counts - have
        if not bool((need > 0).any()):
            return keys
        draws = torch.where(need > 0, (need * factor).ceil().long() + 4, 0)
        r = torch.repeat_interleave(users, draws)
        c = torch.searchsorted(cdf, torch.rand(r.numel(), generator=g,
                                               device=device,
                                               dtype=torch.float64))
        keys = torch.cat([keys, r * n_items + c.clamp_(max=n_items - 1)])
        # the first draw of each key, in draw order
        sk, idx = torch.sort(keys, stable=True)
        first = torch.ones_like(sk, dtype=torch.bool)
        first[1:] = sk[1:] != sk[:-1]
        keys = keys[torch.sort(idx[first]).values]
        # each user's first counts[u] of them
        u = keys // n_items
        by_user = torch.argsort(u, stable=True)
        per = torch.bincount(u, minlength=nu)
        start = torch.cumsum(per, 0) - per
        su = u[by_user]
        keep = torch.empty(keys.numel(), dtype=torch.bool, device=device)
        keep[by_user] = (torch.arange(keys.numel(), device=device)
                         - start[su]) < counts[su]
        keys = keys[keep]
        have = torch.bincount(keys // n_items, minlength=nu)
        factor *= 2.0


def make(cfg: dict, seed: int, device) -> dict:
    a = cfg["assumed"]
    nu, ni, n = cfg["n_users"], cfg["n_items"], cfg["n_ratings"]
    k, scale = a["truth_rank"], float(a["truth_scale"])
    g = torch.Generator(device=device).manual_seed(seed)
    U = _orthonormal(nu, k, g, device) * math.sqrt(scale)
    V = _orthonormal(ni, k, g, device) * (math.sqrt(scale) * ni
                                          / math.sqrt(nu))
    if a["nonneg"]:
        U, V = U.abs(), V.abs()
    V *= scale / ((U @ V[: min(128, ni)].T).abs().mean() + 1e-9)
    w = 1.0 / torch.arange(1, ni + 1, device=device,
                           dtype=torch.float64) ** a["item_power_law"]
    cdf = torch.cumsum(w, 0)
    cdf /= cdf[-1].clone()
    counts = user_counts(nu, ni, n, a, g, device)
    keys = torch.sort(_user_items(counts, ni, cdf, g, device)).values
    rows, cols = keys // ni, keys % ni
    vals = torch.empty(n, dtype=torch.float64, device=device)
    step = 1 << 22
    for s in range(0, n, step):
        e = min(s + step, n)
        vals[s:e] = (U[rows[s:e]] * V[cols[s:e]]).sum(1)
    vals += a["noise"] * torch.randn(n, generator=g, device=device,
                                     dtype=torch.float64)
    q = cfg["rating_step"]
    vals = (torch.clamp(torch.round(vals / q), round(cfg["rating_min"] / q),
                        round(cfg["rating_max"] / q)) * q).to(torch.float32)
    u = torch.rand(n, generator=g, device=device)
    test = u < a["test_share"]
    val = ~test & (u < a["test_share"] + a["val_share"])
    train = ~(test | val)
    part = lambda m: (rows[m], cols[m], vals[m])
    return dict(n_users=nu, n_items=ni, train=part(train), val=part(val),
                test=part(test))
