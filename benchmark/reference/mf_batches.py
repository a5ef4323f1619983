"""Plain MF by minibatches, the scatter engine's update (``sgd``): the
train ratings (row-major, padded to whole batches with weightless
entries) shuffled once, each epoch their batches in a random order, each
batch one step from the batch's starting tables:

    e    = r_ui - <p_u, q_i>
    p_u -= lr (-2 e q_i + 2 u_reg p_u) / n_u
    q_i -= lr (-2 e p_u + 2 i_reg q_i) / n_i

summed over the batch's ratings, n_u and n_i the batch's ratings of the
user and of the item (a hot row takes the mean of its steps;
modelMF.cpp:83-105's per-occurrence update). Worked out again from the
seed: the shuffle (``numpy.random.default_rng(seed).permutation``) and
the batch order (``torch.randperm`` of a CPU generator seeded seed + 43,
after the warm-up's draws). f32 with TF32 off."""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import _eval


def follow(inp: dict, hp: dict, epochs: int, dtype=torch.float32,
           fault=None) -> dict:
    """Job 0's first ``epochs`` epochs from (u0, i0): the tables after each
    epoch (f32), and the objective and val RMSE before and after the first.
    ``fault="half_batch"`` leaves out the second half of each batch, the
    mean taken over the rest (a planted fault)."""
    _eval.no_tf32()
    nu, ni = inp["n_users"], inp["n_items"]
    vu, vi = _eval.valid(inp["train"], nu, ni)
    rows, cols, vals = inp["train"]
    keep = vu[rows] & vi[cols]
    rows, cols, vals = rows[keep], cols[keep], vals[keep]
    dev = rows.device
    B = hp["batch_size"]
    n = rows.numel()
    n_pad = (-n) % B if n else B
    z = lambda dt: torch.zeros(n_pad, dtype=dt, device=dev)
    rows = torch.cat([rows, z(torch.int64)])
    cols = torch.cat([cols, z(torch.int64)])
    vals = torch.cat([vals, z(torch.float32)])
    wts = torch.cat([torch.ones(n, device=dev), z(torch.float32)])
    perm = torch.from_numpy(np.random.default_rng(inp["seed"]).permutation(
        n + n_pad)).to(dev)
    rows, cols, vals, wts = rows[perm], cols[perm], vals[perm], wts[perm]
    n_batches = (n + n_pad) // B
    gen = torch.Generator().manual_seed(inp["seed"] + 43)
    for _ in range(inp["skip"]):
        torch.randperm(n_batches, generator=gen)
    U, V = inp["u0"].to(dtype).clone(), inp["i0"].to(dtype).clone()
    lr, ur, ir = hp["lr"], hp["u_reg"], hp["i_reg"]
    half = (torch.arange(B, device=dev) < B // 2).to(torch.float32)
    checks = {"objective": [], "rmse": []}

    def check():
        checks["objective"].append(_eval.objective(U, V, inp["train"], vu,
                                                   vi, ur, ir))
        checks["rmse"].append(_eval.rmse(U, V, inp["val"], vu, vi))
    check()
    states = []
    for e in range(epochs):
        for b in torch.randperm(n_batches, generator=gen).tolist():
            sl = slice(b * B, (b + 1) * B)
            u, i, r, w = rows[sl], cols[sl], vals[sl].to(dtype), wts[sl]
            if fault == "half_batch":
                w = w * half
            per = lambda idx, m: torch.bincount(idx, weights=w, minlength=m
                                                )[idx].clamp(min=1.0)
            inv_u = torch.where(w > 0, 1.0 / per(u, nu), 0.0).to(dtype)
            inv_i = torch.where(w > 0, 1.0 / per(i, ni), 0.0).to(dtype)
            w = w.to(dtype)
            pu, qi = U[u], V[i]
            we = (w * (r - (pu * qi).sum(1)))[:, None]
            gu = (-2.0 * we * qi + (2.0 * ur) * w[:, None] * pu) \
                * inv_u[:, None]
            gi = (-2.0 * we * pu + (2.0 * ir) * w[:, None] * qi) \
                * inv_i[:, None]
            U.index_add_(0, u, -lr * gu)
            V.index_add_(0, i, -lr * gi)
        states.append((U.to(torch.float32, copy=True),
                       V.to(torch.float32, copy=True)))
        if e == 0:
            check()
    return dict(states=states, checks=checks)
