"""BPR by minibatches of positives, the stream engine's update (``train``
with the rank-gap sampler): the train positives (row-major, padded to
whole batches with weightless entries) shuffled once; each epoch their
batches in a random order, each positive (u, p) with a negative n, each
batch one step from its starting tables (modelMFBPR.cpp:501-521):

    r   = <p_u, q_p - q_n>,   c = -1 / (1 + e^r)
    p_u -= lr (c (q_p - q_n) + 2 u_reg p_u)
    q_p -= lr (c p_u + 2 i_reg q_p),   q_n -= lr (-c p_u + 2 i_reg q_n)

summed over the batch, the learn rate times 0.9 after each epoch; the
epoch's loss is the sum of ln(1 + e^-r). The negative of a try: a random
entry j of the user's sorted train row (words ``a % deg``) names a gap of
the catalog: [0, col_j) for the first entry, (col_j, n_items) for the
last, else (col_j, col_{j+1}); the ``b % count``-th item with a train
rating inside it is the negative, and a try in an empty gap fails; a
positive whose tries all fail is left out. Worked out again from the
seed: the shuffle (``numpy.random.default_rng(seed).permutation``), and
each epoch's batch order and words, drawn as ``torch.randperm`` and
``torch.randint(0, 2**32)`` of a generator on the tables' device seeded
``seed``, after the warm-up's draws. f32 with TF32 off."""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import _eval


def _draw(gen, n_batches: int, tries: int, B: int, dev):
    order = torch.randperm(n_batches, generator=gen, device=dev)
    words = torch.randint(0, 1 << 32, (n_batches, 2, tries, B),
                          generator=gen, device=dev, dtype=torch.int64)
    return order, words


def follow(inp: dict, hp: dict, epochs: int, dtype=torch.float32,
           fault=None) -> dict:
    """Job 0's first ``epochs`` epochs from (u0, i0): the tables after each
    epoch (f32), each epoch's loss, and val HR@10 before and after the
    first. ``fault="half_batch"`` leaves out the second half of each batch
    (a planted fault)."""
    _eval.no_tf32()
    nu, ni = inp["n_users"], inp["n_items"]
    vu, vi = _eval.valid(inp["train"], nu, ni)
    rows, cols, vals = inp["train"]
    dev = rows.device
    indptr, _ = _eval.exclusions(inp["train"], nu)
    keep = (vals > 0) & vu[rows] & vi[cols]
    pr, pc = rows[keep], cols[keep]
    perm = torch.from_numpy(np.random.default_rng(inp["seed"]).permutation(
        pr.numel())).to(dev)
    pr, pc = pr[perm], pc[perm]
    B, tries = hp["batch_size"], hp["n_tries"]
    n = pr.numel()
    n_pad = (-n) % B if n else B
    zi = torch.zeros(n_pad, dtype=torch.int64, device=dev)
    pr, pc = torch.cat([pr, zi]), torch.cat([pc, zi])
    wts = torch.cat([torch.ones(n, device=dev),
                     torch.zeros(n_pad, device=dev)])
    start = indptr[pr]
    deg = (indptr[pr + 1] - start).clamp(min=1)
    n_batches = (n + n_pad) // B
    # the catalog's items with a train rating, and each item's rank in them
    has = torch.bincount(cols, minlength=ni) > 0
    rated = torch.nonzero(has).squeeze(1)
    below = torch.zeros(ni + 1, dtype=torch.int64, device=dev)
    below[1:] = torch.cumsum(has.to(torch.int64), 0)
    nnz = cols.numel()
    gen = torch.Generator(device=dev).manual_seed(inp["seed"])
    for _ in range(inp["skip"]):
        _draw(gen, n_batches, tries, B, dev)
    U, V = inp["u0"].to(dtype).clone(), inp["i0"].to(dtype).clone()
    ur, ir = hp["u_reg"], hp["i_reg"]
    half = (torch.arange(B, device=dev) < B // 2).to(torch.float32)
    checks = {"hr10": [_eval.hr10(U, V, inp["val"], inp["train"], vu, vi)]}
    states, losses = [], []
    lr = hp["lr"]
    for e in range(epochs):
        order, words = _draw(gen, n_batches, tries, B, dev)
        loss = torch.zeros((), dtype=torch.float64, device=dev)
        for t, b in enumerate(order.tolist()):
            sl = slice(b * B, (b + 1) * B)
            st, dg = start[sl], deg[sl]
            neg = torch.zeros(B, dtype=torch.int64, device=dev)
            ok = torch.zeros(B, dtype=torch.bool, device=dev)
            for a in range(tries):
                j = words[t, 0, a] % dg
                pos = (st + j).clamp(max=nnz - 1)
                col = cols[pos]
                nxt = cols[(pos + 1).clamp(max=nnz - 1)]
                lo = torch.where(j == 0, 0, col + 1)
                hi = torch.where(j == 0, col,
                                 torch.where(j == dg - 1, ni, nxt))
                count = below[hi] - below[lo]
                cand = rated[(below[lo] + words[t, 1, a]
                              % count.clamp(min=1)).clamp(max=rated.numel()
                                                          - 1)]
                take = (count > 0) & ~ok
                neg = torch.where(take, cand, neg)
                ok |= count > 0
            w = wts[sl] * ok.to(torch.float32)
            if fault == "half_batch":
                w = w * half
            w = w.to(dtype)
            u, p = pr[sl], pc[sl]
            pu, qp, qn = U[u], V[p], V[neg]
            r = (pu * qp).sum(1) - (pu * qn).sum(1)
            loss += (w * torch.logaddexp(torch.zeros_like(r), -r)).sum()
            c = (w * (-1.0 / (1.0 + torch.exp(r))))[:, None]
            gu = c * (qp - qn) + (2.0 * ur) * w[:, None] * pu
            gp = c * pu + (2.0 * ir) * w[:, None] * qp
            gn = -c * pu + (2.0 * ir) * w[:, None] * qn
            U.index_add_(0, u, -lr * gu)
            V.index_add_(0, torch.cat([p, neg]), -lr * torch.cat([gp, gn]))
        states.append((U.to(torch.float32, copy=True),
                       V.to(torch.float32, copy=True)))
        losses.append(float(loss))
        if e == 0:
            checks["hr10"].append(_eval.hr10(U, V, inp["val"], inp["train"],
                                             vu, vi))
        lr *= 0.9
    return dict(states=states, checks=checks, losses=losses)
