"""TMF+Dropout by row stripes, the masked row-dense engine's update
(``densesgd``): users in stripes, each epoch the stripes in a random order,
each stripe one full-batch step over all its ratings from the stripe's
starting tables, each rating truncated to the rank its pair drew.

The model (Sharma & Karypis, WWW'19; modelPoissonDropout.cpp): entity
frequencies f (train ratings) give lambdas

    lam(f) = clamp(ceil(sigmoid(rho ((f - mean) / std - alpha)) k), 1, k)

(mean and population std over concat(user f, item f) of all entities). A
rating trains at rank r = clip(Poisson(min(lam_u, lam_i)), 1, k), and its
prediction and update use the dims d < r alone:

    e_ui = r_ui - sum_{d<r} p_ud q_id
    g_u  = (-2 sum_i [d<r] e_ui q_i + 2 u_reg sum_i [d<r] p_u) / max(c_u, 1)
    g_i  = (-2 sum_u [d<r] e_ui p_u + 2 i_reg sum_u [d<r] q_i) / max(c_i, 1)
    p_u -= lr g_u,  q_i -= lr g_i

c_u, c_i the stripe's ratings of the user and of the item. The checks
read the inference view: each entity truncated at min(cdfRank(lam) + 1,
k), cdfRank the first m with P(Poisson(lam) <= m + 1) >= 0.99 (k - 1 where
none below k - 1 is), the objective its train SSE plus the penalty on the
raw factors (Model::objective, model.cpp:1770-1815).

Departures from the paper, as the program makes them (README deviation
#15): the rank is drawn by one common uniform U_t a stripe visit, not an
independent Poisson a update: every lambda's rank at visit t is the
quantile q_t(lam) = clip(#{m : C[lam - 1, m] < U_t}, 1, k), C[lam - 1, m]
= P(Poisson(lam) <= m) in f32, and the pair's rank is q_t(min(lam_u,
lam_i)) (the same marginal law, correlated within a visit); a stripe takes
one full-batch step, not a per-rating SGD pass; the regularization counts
are masked and the step is normalized by the unmasked counts.

Worked out again from the inputs and the seed: the frequencies, the
lambda tables, C (float64 sums cast to f32), the stripes (``mf_stripes``),
the stripe order and the visit uniforms (a CPU generator seeded seed + 41:
``torch.randperm`` of the stripes, then ``torch.rand`` of one uniform a
stripe, each epoch; the warm-up's epochs drawn first). The products are in
the tables' type, f32 with TF32 off; the program rounds their operands to
bf16."""

from __future__ import annotations

import torch

from benchmark.reference import _eval
from benchmark.reference.mf_stripes import stripe_height, stripe_of_users

CDF_CUT = 0.99   # the inference rank's Poisson CDF level


def lambda_table(freq: torch.Tensor, mean: float, std: float, rho: float,
                 alpha: float, k: int) -> torch.Tensor:
    """int64 lambdas of the frequencies ``freq`` (the sigmoid rank map)."""
    z = (freq.double() - mean) / (std if std > 0 else 1.0)
    sig = 1.0 / (1.0 + torch.exp(-rho * (z - alpha)))
    return torch.ceil(sig * k).clamp(1, k).to(torch.int64)


def poisson_cdf(k: int) -> torch.Tensor:
    """float64 [k, k]: row lam - 1 holds P(Poisson(lam) <= m), m = 0..k-1,
    the pmf summed in order."""
    lam = torch.arange(1, k + 1, dtype=torch.float64)[:, None]
    m = torch.arange(k, dtype=torch.float64)
    return torch.exp(-lam + m * torch.log(lam)
                     - torch.lgamma(m + 1)).cumsum(1)


def inference_ranks(C64: torch.Tensor) -> torch.Tensor:
    """int64 [k]: lam's inference rank min(cdfRank + 1, k), cdfRank the
    first m < k - 1 with P(X <= m + 1) >= 0.99, else k - 1."""
    k = C64.shape[0]
    out = []
    for row in C64.tolist():
        hit = [m for m in range(k - 1) if row[m + 1] >= CDF_CUT]
        out.append(min(hit[0] + 1, k) if hit else k)
    return torch.tensor(out, dtype=torch.int64)


def tables(train, n_users: int, n_items: int, k: int, rho: float,
           alpha: float):
    """(lam_u [n_users], lam_i [n_items] int64 on the split's device,
    C [k, k] f32 on the CPU, inference rank [k] int64 on the CPU)."""
    rows, cols, _ = train
    fu = torch.bincount(rows, minlength=n_users).cpu()
    fi = torch.bincount(cols, minlength=n_items).cpu()
    f = torch.cat([fu, fi]).double()
    mean, std = float(f.mean()), float(f.std(unbiased=False))
    lam = lambda x: lambda_table(x, mean, std, rho, alpha, k).to(rows.device)
    C64 = poisson_cdf(k)
    return lam(fu), lam(fi), C64.to(torch.float32), inference_ranks(C64)


def visit_rows(C: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """int64 [n, k]: row t holds q_t(lam) = clip(#{m : C[lam - 1, m] <
    u[t]}, 1, k) for lam = 1..k."""
    k = C.shape[0]
    return (C[None] < u[:, None, None]).sum(2).clamp(1, k)


def step(U, V, u, i, r, rank, lr, u_reg, i_reg):
    """One stripe's masked full-batch step; ``rank`` each rating's rank."""
    k = U.shape[1]
    m = (torch.arange(k, device=U.device) < rank[:, None]).to(U.dtype)
    cnt_u = torch.bincount(u, minlength=U.shape[0]).to(U.dtype)[:, None]
    cnt_i = torch.bincount(i, minlength=V.shape[0]).to(V.dtype)[:, None]
    pu, qi = U[u] * m, V[i] * m
    e = (r - (pu * qi).sum(1))[:, None]
    cm_u = torch.zeros_like(U).index_add_(0, u, m)
    cm_i = torch.zeros_like(V).index_add_(0, i, m)
    gu = torch.zeros_like(U).index_add_(0, u, e * qi) * -2.0 \
        + (2.0 * u_reg) * cm_u * U
    gi = torch.zeros_like(V).index_add_(0, i, e * pu) * -2.0 \
        + (2.0 * i_reg) * cm_i * V
    return (U - lr * (gu / cnt_u.clamp(min=1.0)),
            V - lr * (gi / cnt_i.clamp(min=1.0)))


def follow(inp: dict, hp: dict, epochs: int, dtype=torch.float32,
           fault=None) -> dict:
    """Job 0's first ``epochs`` epochs from (u0, i0): the tables after each
    epoch (f32), and the objective and val RMSE before and after the first.
    Planted faults: ``"half_batch"`` leaves out the second half of each
    stripe's ratings; ``"static_ranks"`` trains each rating at its pair
    lambda (TMF's static ranks, no draw); ``"rank_plus_one"`` one dim more
    than each drawn rank (capped at k); ``"shuffled_user_lambdas"`` the
    users' lambdas dealt to other users (a fixed permutation), the item
    side and the checks' inference view kept."""
    _eval.no_tf32()
    nu, ni, k = inp["n_users"], inp["n_items"], hp["k"]
    vu, vi = _eval.valid(inp["train"], nu, ni)
    lam_u, lam_i, C, eff = tables(inp["train"], nu, ni, k, hp["rho_rms"],
                                  hp["alpha"])
    rows, cols, vals = inp["train"]
    keep = vu[rows] & vi[cols]
    rows, cols, vals = rows[keep], cols[keep], vals[keep].to(dtype)
    lam_train = lam_u
    if fault == "shuffled_user_lambdas":
        lam_train = lam_u[torch.randperm(
            nu, generator=torch.Generator().manual_seed(0)).to(lam_u.device)]
    lam = torch.minimum(lam_train[rows], lam_i[cols])
    bu = stripe_height(nu, ni)
    n_stripes = -(-nu // bu)
    stripe = stripe_of_users(rows, nu, n_stripes)[rows]
    by_stripe = torch.argsort(stripe, stable=True)
    bounds = [0] + torch.cumsum(torch.bincount(
        stripe, minlength=n_stripes), 0).tolist()
    gen = torch.Generator().manual_seed(inp["seed"] + 41)
    for _ in range(inp["skip"]):
        torch.randperm(n_stripes, generator=gen)
        torch.rand(n_stripes, generator=gen)
    U, V = inp["u0"].to(dtype).clone(), inp["i0"].to(dtype).clone()
    lr, ur, ir = hp["lr"], hp["u_reg"], hp["i_reg"]
    iota = torch.arange(k, device=U.device)
    eff = eff.to(U.device)
    mask_u = (iota < eff[lam_u - 1][:, None]).to(dtype)
    mask_i = (iota < eff[lam_i - 1][:, None]).to(dtype)
    checks = {"objective": [], "rmse": []}

    def check():
        Ut, Vt = U * mask_u, V * mask_i
        s, _ = _eval.sse(Ut, Vt, inp["train"], vu, vi)
        sq = lambda X, m: float((X.double() ** 2).sum(1)[m].sum())
        checks["objective"].append(s + ur * sq(U, vu) + ir * sq(V, vi))
        checks["rmse"].append(_eval.rmse(Ut, Vt, inp["val"], vu, vi))
    check()
    states = []
    for e in range(epochs):
        order = torch.randperm(n_stripes, generator=gen)
        Q = visit_rows(C, torch.rand(n_stripes, generator=gen)).to(U.device)
        for t, s in enumerate(order.tolist()):
            sl = by_stripe[bounds[s]:bounds[s + 1]]
            if fault == "half_batch":
                sl = sl[: sl.numel() // 2]
            rank = (lam[sl] if fault == "static_ranks"
                    else Q[t][lam[sl] - 1])
            if fault == "rank_plus_one":
                rank = (rank + 1).clamp(max=k)
            U, V = step(U, V, rows[sl], cols[sl], vals[sl], rank, lr, ur, ir)
        states.append((U.to(torch.float32, copy=True),
                       V.to(torch.float32, copy=True)))
        if e == 0:
            check()
    return dict(states=states, checks=checks)
