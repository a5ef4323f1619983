"""Plain MF by row stripes, the row-dense engine's update (``densesgd``):
users in stripes, each epoch the stripes in a random order, each stripe
one full-batch step over all its ratings from the stripe's starting
tables:

    e_ui = r_ui - <p_u, q_i>
    g_u  = (-2 sum_i e_ui q_i + 2 u_reg c_u p_u) / max(c_u, 1)
    g_i  = (-2 sum_u e_ui p_u + 2 i_reg c_i q_i) / max(c_i, 1)
    p_u -= lr g_u,  q_i -= lr g_i

c_u, c_i the stripe's ratings of the user and of the item (the
per-occurrence regularization of modelMF.cpp:83-105, each side's step
the mean of its ratings' steps). Worked out again from the inputs and the
seed: the stripes (users relabeled round-robin over descending train
count, in a snake order, stripes of the engine's height) and the stripe
order (``torch.randperm`` of a CPU generator seeded seed + 41, after the
warm-up's draws). The products are in the tables' type, f32 with TF32
off; the program rounds their operands to bf16."""

from __future__ import annotations

import torch

from benchmark.reference import _eval


def stripe_height(n_users: int, n_items: int) -> int:
    """Users a stripe: at least 8 stripes, a multiple of 256 (of 8 where
    256 would leave fewer than 8), at most 2560."""
    cdiv = lambda a, b: -(-a // b)
    target = cdiv(n_users, 8)
    bu = min(2560, max(cdiv(target, 256) * 256, 256))
    if cdiv(n_users, bu) < 8:
        bu = min(2560, max(cdiv(target, 8) * 8, 8))
    return bu


def stripe_of_users(rows, n_users: int, n_stripes: int):
    """Each user's stripe: users by descending train count (ties by id)
    dealt round-robin over the stripes, the direction turning each round."""
    count = torch.bincount(rows, minlength=n_users)
    order = torch.argsort(-count, stable=True)
    pos = torch.arange(n_users, device=rows.device)
    rnd, blk = pos // n_stripes, pos % n_stripes
    snake = torch.where(rnd % 2 == 1, n_stripes - 1 - blk, blk)
    out = torch.empty_like(order)
    out[order] = snake
    return out


def step(U, V, u, i, r, lr, u_reg, i_reg):
    cnt_u = torch.bincount(u, minlength=U.shape[0]).to(U.dtype)[:, None]
    cnt_i = torch.bincount(i, minlength=V.shape[0]).to(V.dtype)[:, None]
    pu, qi = U[u], V[i]
    e = (r - (pu * qi).sum(1))[:, None]
    gu = torch.zeros_like(U).index_add_(0, u, e * qi) * -2.0 \
        + (2.0 * u_reg) * cnt_u * U
    gi = torch.zeros_like(V).index_add_(0, i, e * pu) * -2.0 \
        + (2.0 * i_reg) * cnt_i * V
    return (U - lr * (gu / cnt_u.clamp(min=1.0)),
            V - lr * (gi / cnt_i.clamp(min=1.0)))


def follow(inp: dict, hp: dict, epochs: int, dtype=torch.float32,
           fault=None) -> dict:
    """Job 0's first ``epochs`` epochs from (u0, i0): the tables after each
    epoch (f32), and the objective and val RMSE before and after the first.
    ``fault="half_batch"`` leaves out the second half of each stripe's
    ratings (a planted fault)."""
    _eval.no_tf32()
    nu, ni = inp["n_users"], inp["n_items"]
    vu, vi = _eval.valid(inp["train"], nu, ni)
    rows, cols, vals = inp["train"]
    keep = vu[rows] & vi[cols]
    rows, cols, vals = rows[keep], cols[keep], vals[keep].to(dtype)
    bu = stripe_height(nu, ni)
    n_stripes = -(-nu // bu)
    stripe = stripe_of_users(rows, nu, n_stripes)[rows]
    by_stripe = torch.argsort(stripe, stable=True)
    bounds = [0] + torch.cumsum(torch.bincount(
        stripe, minlength=n_stripes), 0).tolist()
    gen = torch.Generator().manual_seed(inp["seed"] + 41)
    for _ in range(inp["skip"]):
        torch.randperm(n_stripes, generator=gen)
    U, V = inp["u0"].to(dtype).clone(), inp["i0"].to(dtype).clone()
    lr, ur, ir = hp["lr"], hp["u_reg"], hp["i_reg"]
    checks = {"objective": [], "rmse": []}

    def check():
        checks["objective"].append(_eval.objective(U, V, inp["train"], vu,
                                                   vi, ur, ir))
        checks["rmse"].append(_eval.rmse(U, V, inp["val"], vu, vi))
    check()
    states = []
    for e in range(epochs):
        for s in torch.randperm(n_stripes, generator=gen).tolist():
            sl = by_stripe[bounds[s]:bounds[s + 1]]
            if fault == "half_batch":
                sl = sl[: sl.numel() // 2]
            U, V = step(U, V, rows[sl], cols[sl], vals[sl], lr, ur, ir)
        states.append((U.to(torch.float32, copy=True),
                       V.to(torch.float32, copy=True)))
        if e == 0:
            check()
    return dict(states=states, checks=checks)
