"""Incremental-rank MF (port of matfac_tpu/models/increment.py).

ModelIncrement (modelIncrement.cpp): every user and item starts at rank 1;
a rating is predicted by the dot product truncated at min(rank_u, rank_i)
(:10-18); every INC_ITER = 5 epochs an entity whose probe RMSE (on
``data.graph_mat``, the probe set) improved grows its rank by 5, capped
at fac_dim, and any other active entity rolls its factors back to the
last snapshot and stops growing (:251-316).

The epoch is the JAX engine's scan over minibatches as an eager loop: each
batch gathers its rows, predicts and updates at the truncated rank, and
adds the updates into the tables with ``index_add_``. The rank tables
change between epochs and are arguments of the epoch. Growth, rollback and
stop run on the host, line for line as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from matfac_tpu_torch.config import Params
from matfac_tpu_torch.data.batching import coo_batches
from matfac_tpu_torch.models.base import MFState, ModelMF, init_state, rank_mask

INC_ITER = 5      # modelIncrement.h, the reference's constants
INC_STEP = 5


class ModelIncrement(ModelMF):
    name = "increment"

    def __init__(self, params: Params, n_users: int, n_items: int, **_):
        super().__init__(params, n_users, n_items)
        self.rank_u = torch.ones(n_users, dtype=torch.int32)
        self.rank_i = torch.ones(n_items, dtype=torch.int32)

    def entity_ranks(self):
        return self.rank_u, self.rank_i


@dataclasses.dataclass
class IncrementReport:
    state: MFState
    rank_u: np.ndarray
    rank_i: np.ndarray
    history: List[Tuple[int, int, int]]   # (epoch, incremented_u, _i)


def increment_epoch(state: MFState, rows, cols, vals, valid, rank_u, rank_i,
                    lr: float, u_reg: float, i_reg: float, batch_size: int,
                    border: Sequence[int]) -> MFState:
    """One epoch over the staged stream's batches in ``border``: per batch,
    predict at the pair rank and apply the rank-masked SGD step of every
    example, computed at the batch's starting values and summed into the
    tables. Returns a new state."""
    k = state.u_fac.shape[1]
    U, I = state.u_fac.clone(), state.i_fac.clone()
    B = batch_size
    for b in (int(x) for x in border):
        sl = slice(b * B, (b + 1) * B)
        u, i, r, v = rows[sl], cols[sl], vals[sl], valid[sl]
        m = rank_mask(torch.minimum(rank_u[u], rank_i[i]), k)
        pu, qi = U[u], I[i]
        diff = r - ((pu * m) * qi).sum(dim=1)
        gu = (-2.0 * (v * diff)[:, None] * qi
              + 2.0 * u_reg * v[:, None] * pu) * m
        gi = (-2.0 * (v * diff)[:, None] * pu
              + 2.0 * i_reg * v[:, None] * qi) * m
        U.index_add_(0, u, (-lr * gu).to(U.dtype))
        I.index_add_(0, i, (-lr * gi).to(I.dtype))
    return state._replace(u_fac=U, i_fac=I)


def probe_rmse(state: MFState, rows, cols, vals, rank_u, rank_i,
               n_users: int, n_items: int):
    """Per-user and per-item RMSE on the probe entries at the pair ranks;
    -1 where the entity has no probe entry (RMSEUser / RMSEItem). Sums in
    float32, as the JAX segment sums."""
    k = state.u_fac.shape[1]
    m = rank_mask(torch.minimum(rank_u[rows], rank_i[cols]), k)
    pred = ((state.u_fac[rows] * m) * state.i_fac[cols]).sum(dim=1)
    d2 = (vals - pred) ** 2
    ones = torch.ones_like(d2)

    def per_entity(idx, n):
        s = torch.zeros(n, dtype=torch.float32, device=d2.device)
        c = torch.zeros(n, dtype=torch.float32, device=d2.device)
        s.index_add_(0, idx, d2)
        c.index_add_(0, idx, ones)
        return torch.where(c > 0, torch.sqrt(s / torch.clamp(c, min=1)),
                           -1.0)

    return per_entity(rows, n_users), per_entity(cols, n_items)


def train_increment(data, params: Params,
                    invalid_users: np.ndarray, invalid_items: np.ndarray,
                    max_iter: Optional[int] = None, log_fn=print,
                    device="cuda",
                    order: Optional[Callable[[int], Sequence[int]]] = None
                    ) -> Tuple[IncrementReport, ModelIncrement]:
    """Train ModelIncrement for ``max_iter`` (default ``params.max_iter``)
    epochs. ``order(epoch)`` gives the epoch's batch order (a permutation of
    range(n_batches)); None draws it from a generator seeded with
    ``params.seed``."""
    if data.graph_mat is None:
        raise ValueError("ModelIncrement needs a probe matrix in "
                         "data.graph_mat (reference uses graphMat as "
                         "the probe set)")
    k = params.fac_dim
    n_users, n_items = data.n_users, data.n_items
    dev = torch.device(device)
    model = ModelIncrement(params, n_users, n_items)

    b = coo_batches(data.train_mat, params.batch_size, invalid_users,
                    invalid_items)
    sperm = np.random.default_rng(params.seed).permutation(b.n_total)
    idx = lambda a: torch.from_numpy(a.astype(np.int64)).to(dev)
    stage = (idx(b.rows[sperm]), idx(b.cols[sperm]),
             torch.from_numpy(b.vals[sperm]).to(dev),
             torch.from_numpy(b.valid[sperm]).to(dev))
    if order is None:
        gen = torch.Generator().manual_seed(params.seed)
        order = lambda it: torch.randperm(b.n_batches, generator=gen)

    pr, pc, pv = data.graph_mat.to_coo()
    keep = (pr < n_users) & (pc < n_items)
    keep &= ~invalid_users[np.clip(pr, 0, n_users - 1)]
    keep &= ~invalid_items[np.clip(pc, 0, n_items - 1)]
    probe_stage = (idx(pr[keep]), idx(pc[keep]),
                   torch.from_numpy(pv[keep].astype(np.float32)).to(dev))

    def probe(st, ru, ri):
        tabs = (torch.from_numpy(ru).to(dev), torch.from_numpy(ri).to(dev))
        return tuple(t.cpu().numpy() for t in probe_rmse(
            st, *probe_stage, *tabs, n_users, n_items))

    state = init_state(params, n_users, n_items, device=dev)
    rank_u = np.ones(n_users, np.int32)
    rank_i = np.ones(n_items, np.int32)
    prev_rank_u, prev_rank_i = rank_u.copy(), rank_i.copy()
    grow_u = ~invalid_users.copy()
    grow_i = ~invalid_items.copy()
    prev_rmse_u = np.full(n_users, 10.0)
    prev_rmse_i = np.full(n_items, 10.0)
    ru0, ri0 = probe(state, rank_u, rank_i)
    prev_rmse_u[ru0 >= 0] = ru0[ru0 >= 0]
    prev_rmse_i[ri0 >= 0] = ri0[ri0 >= 0]
    u_prev = state.u_fac.cpu().numpy()
    i_prev = state.i_fac.cpu().numpy()

    history = []
    for it in range(max_iter or params.max_iter):
        state = increment_epoch(
            state, *stage, torch.from_numpy(rank_u).to(dev),
            torch.from_numpy(rank_i).to(dev), float(params.learn_rate),
            float(params.u_reg), float(params.i_reg), b.batch_size,
            order(it))

        if it > 0 and it % INC_ITER == 0:
            ru, ri = probe(state, rank_u, rank_i)
            u_fac = state.u_fac.cpu().numpy().copy()   # writable host copies
            i_fac = state.i_fac.cpu().numpy().copy()
            inc_u = inc_i = 0
            for (ranks, prev_ranks, grow, prev_rmse, cur, fac, fac_prev
                 ) in ((rank_u, prev_rank_u, grow_u, prev_rmse_u, ru,
                        u_fac, u_prev),
                       (rank_i, prev_rank_i, grow_i, prev_rmse_i, ri,
                        i_fac, i_prev)):
                active = grow.copy()
                no_probe = active & (cur < 0)
                grow[no_probe] = False
                improved = active & (cur >= 0) & (cur < prev_rmse) \
                    & (ranks < k)
                stalled = active & ~no_probe & ~improved
                prev_ranks[improved] = ranks[improved]
                prev_rmse[improved] = cur[improved]
                ranks[improved] += INC_STEP
                capped = improved & (ranks >= k)
                ranks[capped] = k
                grow[capped] = False
                ranks[stalled] = prev_ranks[stalled]
                fac[stalled] = fac_prev[stalled]
                grow[stalled] = False
                if fac is u_fac:
                    inc_u = int(improved.sum())
                else:
                    inc_i = int(improved.sum())
            state = state._replace(u_fac=torch.from_numpy(u_fac).to(dev),
                                   i_fac=torch.from_numpy(i_fac).to(dev))
            u_prev, i_prev = u_fac.copy(), i_fac.copy()
            history.append((it, inc_u, inc_i))
            if inc_u or inc_i:
                log_fn(f"iter {it}: incremented users {inc_u} "
                       f"items {inc_i}")
        if it == 0:
            u_prev = state.u_fac.cpu().numpy()
            i_prev = state.i_fac.cpu().numpy()

    model.rank_u = torch.from_numpy(rank_u)
    model.rank_i = torch.from_numpy(rank_i)
    return IncrementReport(state, rank_u, rank_i, history), model
