"""Implicit positives drawn from a low-rank softmax preference, made on the
device from a seed (the recipe of ``leave_one_out_data(structured=True)``
in matfac_tpu_torch/data/synthetic.py, without its loop over users on the
host).

Preference factors uf [n_users, r] and vf [n_items, r] are standard
normal. Each user takes ``positives_per_user`` distinct items from
softmax(uf vf^T / temperature): the top of logits + Gumbel noise, in
descending order, which has the law of draws one after another without
replacement. The first item is the user's test item, the second its val
item, the rest its train positives (rating 1). ``serve_factors`` pads
(uf, vf) to the configuration's rank with N(0, 0.01^2) columns.

Returns ``dict(n_users, n_items, train, val, test, uf, vf)``; each split a
tuple (rows int64, cols int64, vals f32) on the device, sorted by row,
then column.
"""

from __future__ import annotations

import torch

_BLOCK = 4096   # users a block: [4096, n_items] f32 logits and noise


def make(cfg: dict, seed: int, device) -> dict:
    a = cfg["assumed"]
    nu, ni, p = cfg["n_users"], cfg["n_items"], cfg["positives_per_user"]
    r, temp = a["truth_rank"], float(a["temperature"])
    g = torch.Generator(device=device).manual_seed(seed)
    uf = torch.randn(nu, r, generator=g, device=device)
    vf = torch.randn(ni, r, generator=g, device=device)
    items = torch.empty(nu, p, dtype=torch.int64, device=device)
    tiny = torch.finfo(torch.float32).tiny
    for s in range(0, nu, _BLOCK):
        e = min(s + _BLOCK, nu)
        logits = (uf[s:e] @ vf.T) / temp
        u = torch.rand(e - s, ni, generator=g, device=device).clamp_(min=tiny)
        logits -= torch.log(-torch.log(u))
        items[s:e] = torch.topk(logits, p, dim=1, sorted=True).indices
    one = lambda c: torch.ones(c.numel(), dtype=torch.float32, device=device)
    users = torch.arange(nu, device=device)
    train_c = torch.sort(items[:, 2:], dim=1).values
    train_r = users.repeat_interleave(p - 2)
    split = lambda rr, cc: (rr, cc, one(cc))
    return dict(n_users=nu, n_items=ni,
                train=split(train_r, train_c.reshape(-1)),
                val=split(users, items[:, 1].clone()),
                test=split(users, items[:, 0].clone()), uf=uf, vf=vf,
                generator=g)


def serve_factors(cfg: dict, bundle: dict, device):
    """(U [n_users, k], V [n_items, k]) f32: the preference factors padded
    to rank k with small noise, drawn after the positives from the same
    generator."""
    g, k = bundle["generator"], cfg["fac_dim"]
    pad = lambda x: torch.cat([x, 0.01 * torch.randn(
        x.shape[0], k - x.shape[1], generator=g, device=device)], 1)
    return pad(bundle["uf"]), pad(bundle["vf"])
