"""Device-batched primitives for the analysis layer (port of
matfac_tpu/analysis/batch.py).

The analysis drivers score whole blocks on the device instead of one
call per user or item:

  * ``catalog_sq_err``: per-user squared pred-vs-orig error over the
    whole catalog, one [B, n_items] product block at a time — feeds
    every bucket-RMSE family (confCompute.cpp:1358-1447,
    topBucketComp.cpp:2669/3883 inner loops).
  * ``score_pools``: batched scoring of per-pair candidate pools
    ({test item} ∪ sampled negatives) — the longTail.cpp:279-502
    topNRec hot loop as gather-dot batches.

Both consume EvalViews, so rank-truncated (TMF-family) models work
unchanged (masking is folded into the view's factors). The JAX package
pads every block to one size so that XLA compiles once; eager torch needs
no padding, and the last block is just shorter. Blocks are computed on the
view's device and returned as host arrays.
"""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np
import torch

from matfac_tpu_torch.models.base import EvalView


def _preds_block(view: EvalView, user_ids: torch.Tensor) -> torch.Tensor:
    """[B, n_items] predicted scores for a block of users."""
    s = view.u_fac[user_ids] @ view.i_fac.t()
    return (s + view.mu + view.u_bias[user_ids][:, None]
            + view.i_bias[None, :])


def _user_blocks(view: EvalView, users: np.ndarray, block: int):
    users = np.asarray(users, np.int64)
    for s in range(0, len(users), block):
        ids = users[s:s + block]
        yield (np.arange(s, s + len(ids)),
               torch.from_numpy(ids).to(view.u_fac.device))


def catalog_preds(view: EvalView, users: np.ndarray, block: int = 1024
                  ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Yield (user_block_positions, preds[B, n_items]) host arrays, one
    block at a time — never the full [n_users, n_items] score matrix on
    the device."""
    for pos, ids in _user_blocks(view, users, block):
        yield pos, _preds_block(view, ids).cpu().numpy()


def catalog_sq_err(orig_view: EvalView, full_view: EvalView,
                   users: np.ndarray, block: int = 1024
                   ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Yield (user_block_positions, d2[B, n_items]) host arrays: the
    squared error between the two models' predictions over the full
    catalog, a block of users at a time."""
    for pos, ids in _user_blocks(full_view, users, block):
        d = _preds_block(orig_view, ids) - _preds_block(full_view, ids)
        yield pos, (d * d).cpu().numpy()


def score_pools(view: EvalView, pool_users: np.ndarray,
                pools: np.ndarray, pair_block: int = 256) -> np.ndarray:
    """[P, C] f32 predicted scores of P (user, candidate-pool) pairs
    (pools: [P, C] item ids), pair_block pairs at a time."""
    dev = view.u_fac.device
    as_t = lambda a: torch.from_numpy(np.asarray(a, np.int64)).to(dev)
    out = []
    for s in range(0, len(pool_users), pair_block):
        u = as_t(pool_users[s:s + pair_block])
        c = as_t(pools[s:s + pair_block])
        sc = torch.einsum("pk,pck->pc", view.u_fac[u], view.i_fac[c])
        out.append(sc + view.mu + view.u_bias[u][:, None] + view.i_bias[c])
    if not out:
        return np.zeros((0, np.shape(pools)[1]), np.float32)
    return torch.cat(out).cpu().numpy()


def sample_unrated_pools(train_mat, valid_items: np.ndarray,
                         users: np.ndarray, test_items: np.ndarray,
                         n_negatives: int, rng) -> np.ndarray:
    """[P, 1 + n_negatives] candidate pools: column 0 = the test item,
    the rest uniform unrated valid negatives (the reference's sampling,
    longTail.cpp:279-366), vectorized rejection per pair against the
    sorted CSR row."""
    P = len(users)
    n_items = len(valid_items)
    pools = np.empty((P, 1 + n_negatives), np.int64)
    pools[:, 0] = test_items
    indptr, indices = train_mat.indptr, train_mat.indices
    for p in range(P):
        u, ti = int(users[p]), int(test_items[p])
        row = np.sort(indices[indptr[u]:indptr[u + 1]])
        chosen = np.empty(0, np.int64)
        stalls = 0
        while len(chosen) < n_negatives:
            need = n_negatives - len(chosen)
            cand = rng.integers(0, n_items, size=2 * need + 8)
            ok = valid_items[cand] & (cand != ti)
            if len(row):
                pos = np.searchsorted(row, cand)
                rated = (pos < len(row)) & (
                    row[np.minimum(pos, len(row) - 1)] == cand)
                ok &= ~rated
            cand = cand[ok]
            # the reference draws DISTINCT negatives (unordered_set
            # insert until 1000 members, longTail.cpp:373-408): dedupe
            # within the draw (keep first occurrence) and vs chosen
            _, first = np.unique(cand, return_index=True)
            cand = cand[np.sort(first)]
            cand = cand[~np.isin(cand, chosen)][:need]
            chosen = np.concatenate([chosen, cand])
            stalls = stalls + 1 if len(cand) == 0 else 0
            if stalls >= 4 and len(chosen) < n_negatives:
                # fewer distinct valid unrated items than requested
                # (tiny catalogs): exhaust the exact remainder, then
                # pad by cycling (the reference would loop forever
                # here; its datasets always have >1000 candidates)
                avail = np.setdiff1d(
                    np.nonzero(valid_items)[0],
                    np.concatenate([row, [ti], chosen]))
                rng.shuffle(avail)
                chosen = np.concatenate(
                    [chosen, avail[: n_negatives - len(chosen)]])
                if len(chosen) < n_negatives:
                    base = chosen if len(chosen) else np.asarray([ti])
                    chosen = np.concatenate(
                        [chosen,
                         np.resize(base, n_negatives - len(chosen))])
                break
        pools[p, 1:] = chosen
    return pools
