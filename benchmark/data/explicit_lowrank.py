"""Explicit ratings of a known low-rank model, made on the device from a
seed (the recipe of ``low_rank_ratings`` in
matfac_tpu_torch/data/synthetic.py, as scripts/torch_ml20m_flagship.py
calls it, in a few large device calls instead of host numpy).

Ground truth: orthonormal random factors (QR of a Gaussian matrix; the
recipe takes the SVD's left factor, the same law) of rank ``truth_rank``,
made nonnegative and rescaled so that a typical rating is ``truth_scale``.
Items are drawn by a power law of exponent ``item_power_law`` (item j
weighs 1 / (j + 1) ** p), users uniformly; (user, item) draws repeat, and
the first draw of each pair is kept until the configuration's count of
ratings is reached. A rating is the truth plus N(0, noise^2), quantized to
the configuration's grid. Each rating is test with p ``test_share``, val
with p ``val_share``, else train.

Returns ``dict(n_users, n_items, train, val, test)``; each split is a
tuple (rows int64, cols int64, vals f32) on the device, sorted by row,
then column.
"""

from __future__ import annotations

import math

import torch


def _orthonormal(n: int, k: int, g: torch.Generator, device) -> torch.Tensor:
    q, _ = torch.linalg.qr(torch.randn(n, k, generator=g, device=device,
                                       dtype=torch.float64))
    return q


def _first_draws(n_users, n_items, n, cdf, g, device) -> torch.Tensor:
    """n distinct (user, item) keys user * n_items + item, the first draw
    of each pair in draw order."""
    keys = torch.empty(0, dtype=torch.int64, device=device)
    draw = int(n * 1.25) + 1024
    while True:
        r = torch.randint(0, n_users, (draw,), generator=g, device=device)
        c = torch.searchsorted(cdf, torch.rand(draw, generator=g,
                                               device=device,
                                               dtype=torch.float64))
        keys = torch.cat([keys, r * n_items + c.clamp_(max=n_items - 1)])
        sk, idx = torch.sort(keys, stable=True)
        first = torch.ones_like(sk, dtype=torch.bool)
        first[1:] = sk[1:] != sk[:-1]
        have = int(first.sum())
        if have >= n:
            pos = torch.sort(idx[first]).values[:n]
            return keys[pos]
        draw = int((n - have) * 1.5) + 1024


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
    keys = torch.sort(_first_draws(nu, ni, n, cdf, g, device)).values
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
