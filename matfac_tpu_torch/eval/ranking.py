"""Ranking evaluation: full-catalog top-N, leave-one-out HR@N and ARHR, and
the sampled-negatives protocol (port of matfac_tpu/eval/ranking.py).

Model::hitRate (model.cpp:1158-1211) and Model::arHR (model.cpp:981-1034)
walk every item of every user through a heap; here each catalog pass is
``ops/topk_kernel.topk_catalog``: the hand-written CUDA kernel on a CUDA
view, the plain PyTorch version on a CPU view. Exclusion reads the train
matrix's CSR rows, so any set of users can be scored and eval and serving
share one kernel.

Not ported: the mesh sharding (ROADMAP queue 1, item 13) and the
padded-row fallback for skewed COO blocks (``_use_coo``), which is TPU
scatter machinery with no meaning over CSR exclusion. ``user_block`` and
``item_block`` are kept for call compatibility; the kernel picks its own
tiling. ``sample_negatives`` and ``popularity_ranking_metrics`` are numpy,
copied from the JAX module (which imports jax).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from matfac_tpu_torch.data.csr import RatingMatrix
from matfac_tpu_torch.models.base import EvalView
from matfac_tpu_torch.ops.topk_kernel import NEG_INF, topk_catalog

__all__ = ["CatalogScorer", "topk_catalog_block", "sample_negatives",
           "sampled_ranking_metrics", "popularity_ranking_metrics",
           "NEG_INF"]


def exclusion_csr(train_mat: RatingMatrix, n_users: int, n_items: int,
                  device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(indptr int64 [n_users + 1], indices int32) of the train rows: rows
    past ``n_users`` and columns past ``n_items`` dropped (the reference
    truncates), missing rows empty."""
    r, c, _ = train_mat.to_coo()
    keep = (r < n_users) & (c < n_items)
    r, c = r[keep], c[keep]
    indptr = np.zeros(n_users + 1, np.int64)
    np.cumsum(np.bincount(r, minlength=n_users), out=indptr[1:])
    # to_coo walks the CSR row by row, so (r, c) stays row-major sorted
    return (torch.from_numpy(indptr).to(device),
            torch.from_numpy(c.astype(np.int32)).to(device))


def topk_catalog_block(view: EvalView, user_ids: torch.Tensor,
                       indptr: torch.Tensor, indices: torch.Tensor,
                       invalid_items: torch.Tensor, n: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-n unrated items for ``user_ids`` (any ids, any count): (scores
    [B, n] f32, item ids [B, n] int32) descending; see topk_catalog."""
    return topk_catalog(view.u_fac, view.i_fac, view.i_bias, view.u_bias,
                        view.mu, invalid_items, indptr, indices,
                        user_ids, n)


def _as_f32(view: EvalView) -> EvalView:
    return EvalView(*(t.to(torch.float32) for t in view))


class CatalogScorer:
    """Stages the exclusion CSR and the invalid-item mask once, and scores
    full-catalog top-N through the kernel."""

    def __init__(self, train_mat: RatingMatrix, invalid_users: np.ndarray,
                 invalid_items: np.ndarray, n_users: int, n_items: int,
                 user_block: int = 1024, item_block: int = 32768,
                 mesh=None, device="cuda"):
        if mesh is not None:
            raise NotImplementedError(
                "mesh-sharded eval is ROADMAP queue 1, item 13")
        self.n_users = n_users
        self.n_items = n_items
        self.user_block = user_block
        self.item_block = item_block
        self.device = torch.device(device)
        self.invalid_users = invalid_users
        self.invalid_items_dev = torch.from_numpy(
            np.asarray(invalid_items[:n_items], bool).copy()).to(self.device)
        self.indptr, self.indices = exclusion_csr(train_mat, n_users,
                                                  n_items, self.device)
        self._all_users = torch.arange(n_users, dtype=torch.int64,
                                       device=self.device)
        self._loo_mat = None
        self._loo_cache = None

    def topk_users(self, view: EvalView, users: torch.Tensor, n: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """On-device (scores, ids) [len(users), n] for int64 ``users``."""
        return topk_catalog_block(_as_f32(view), users, self.indptr,
                                  self.indices, self.invalid_items_dev, n)

    def _topk_dev(self, view: EvalView, n: int):
        return self.topk_users(view, self._all_users, n)

    def topk(self, view: EvalView, n: int) -> Tuple[np.ndarray, np.ndarray]:
        """[n_users, n] (scores, item ids) of top unrated items."""
        s, i = self._topk_dev(view, n)
        return s.cpu().numpy(), i.cpu().numpy()

    # ------------------------------------------------------------------
    def _loo_staged(self, test_mat: RatingMatrix):
        """(first test item, valid mask, valid count) per user, staged on
        the device; cached per test matrix (the training loop evaluates
        the same val matrix every epoch). The cache holds the matrix and
        compares by identity: an id() key without a reference can alias a
        new matrix at a recycled address."""
        if self._loo_mat is test_mat:
            return self._loo_cache
        deg = test_mat.row_degrees()
        nr = min(test_mat.nrows, self.n_users)
        first = np.zeros(self.n_users, np.int32)
        valid = np.zeros(self.n_users, bool)
        nz = deg[:nr] > 0
        first[:nr][nz] = test_mat.indices[test_mat.indptr[:nr][nz]]
        valid[:nr] = nz & ~self.invalid_users[:nr]
        self._loo_cache = (torch.from_numpy(first).to(self.device),
                           torch.from_numpy(valid).to(self.device),
                           int(valid.sum()))
        self._loo_mat = test_mat
        return self._loo_cache

    def loo_credit(self, top_i: torch.Tensor, test_mat: RatingMatrix,
                   reciprocal: bool) -> float:
        """Mean LOO credit of the [n_users, n] ids ``top_i``: 1 per hit
        (HR), or 1/(rank+1) (ARHR); invalid users and users with an empty
        test row leave the denominator."""
        first, valid, n_val = self._loo_staged(test_mat)
        if n_val == 0:
            return 0.0
        return float(_loo_credit_dev(top_i, first, valid, reciprocal)) \
            / n_val

    def hit_rate(self, view: EvalView, test_mat: RatingMatrix,
                 n: int = 10) -> float:
        """Leave-one-out HR@n (model.cpp:1158-1211): the held-out item is
        the FIRST entry of each user's test row; only the scalar leaves
        the device."""
        if self._loo_staged(test_mat)[2] == 0:
            return 0.0
        return self.loo_credit(self._topk_dev(view, n)[1], test_mat, False)

    def arhr(self, view: EvalView, test_mat: RatingMatrix,
             n: int = 1000) -> float:
        """ARHR over top-n (model.cpp:981-1034): 1/(rank+1) credit."""
        if self._loo_staged(test_mat)[2] == 0:
            return 0.0
        return self.loo_credit(self._topk_dev(view, n)[1], test_mat, True)


def _loo_credit_dev(top_i: torch.Tensor, first: torch.Tensor,
                    valid: torch.Tensor, reciprocal: bool) -> torch.Tensor:
    """Sum of LOO credits on the device, in float64 (the JAX package sums
    in f32). top_i [U, n]; first/valid [U]."""
    match = top_i == first[:, None]
    has_hit = match.any(dim=1) & valid
    if reciprocal:
        rank = torch.argmax(match.to(torch.uint8), dim=1)   # first hit
        credit = torch.where(has_hit, 1.0 / (rank + 1.0).double(), 0.0)
    else:
        credit = has_hit.double()
    return credit.sum()


def _loo_score(top_i: np.ndarray, test_mat: RatingMatrix,
               invalid_users: np.ndarray, n_users: int,
               reciprocal: bool) -> float:
    deg = test_mat.row_degrees()
    nr = min(test_mat.nrows, n_users)
    first = np.zeros(nr, dtype=np.int64)
    nz = deg[:nr] > 0
    first[nz] = test_mat.indices[test_mat.indptr[:nr][nz]]
    valid = nz & ~invalid_users[:nr]
    n_val = int(valid.sum())
    if n_val == 0:
        return 0.0
    match = top_i[:nr] == first[:, None]          # [nr, N]
    has_hit = match.any(axis=1) & valid
    if reciprocal:
        rank = np.argmax(match, axis=1)           # first hit position
        credit = np.where(has_hit, 1.0 / (rank + 1.0), 0.0)
    else:
        credit = has_hit.astype(np.float64)
    return float(credit.sum()) / n_val


# ----------------------------------------------------------------------
# Sampled-negatives ranking protocol (non-saturated parity rows)
# ----------------------------------------------------------------------

def sample_negatives(test_mat: RatingMatrix, train_mat: RatingMatrix,
                     invalid_users: np.ndarray,
                     invalid_items: np.ndarray, n_users: int,
                     n_items: int, n_candidates: int = 1000,
                     popularity: "np.ndarray | None" = None,
                     seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Per-user candidate sets for the sampled LOO protocol: column 0 =
    the held-out (first test) item, columns 1.. = negatives drawn from
    ``popularity`` (None = uniform) with the user's train-rated items,
    the held-out item, and invalid items rejected by vectorized
    resampling (longTail.cpp:279-502 samples 1000 unrated negatives per
    test item). Returns (cands [n_val, n_candidates] int32, user_ids
    [n_val])."""
    rng = np.random.default_rng(seed)
    deg = test_mat.row_degrees()
    nr = min(test_mat.nrows, n_users)
    nz = deg[:nr] > 0
    users = np.nonzero(nz & ~invalid_users[:nr])[0]
    first = test_mat.indices[test_mat.indptr[:nr][users]].astype(np.int64)

    p = None
    if popularity is not None:
        w = np.asarray(popularity, np.float64).copy()
        w[invalid_items[: len(w)]] = 0.0
        w = np.maximum(w, 0.0)
        mass = w.sum()
        # all popularity mass on invalid items would make p NaN: uniform
        p = w / mass if mass > 0 else None
    M = n_candidates - 1
    cands = np.empty((len(users), M), np.int64)
    todo = np.ones((len(users), M), bool)
    # global sorted (user, item) keys: rated-membership of any (u, d) is
    # one vectorized binary search (CSR rows are sorted)
    r_all, c_all, _ = train_mat.to_coo()
    keys = r_all.astype(np.int64) * n_items + c_all.astype(np.int64)
    inval_i = np.zeros(n_items, bool)
    inval_i[: len(invalid_items)] = invalid_items[:n_items]
    row_user = np.broadcast_to(users[:, None], todo.shape)
    row_first = np.broadcast_to(first[:, None], todo.shape)
    for _ in range(50):
        n_todo = int(todo.sum())
        if n_todo == 0:
            break
        draw = rng.choice(n_items, size=n_todo, p=p)
        kq = row_user[todo].astype(np.int64) * n_items + draw
        pos = np.searchsorted(keys, kq)
        rated = np.zeros(n_todo, bool)
        inb = pos < len(keys)
        rated[inb] = keys[pos[inb]] == kq[inb]
        bad = rated | (draw == row_first[todo]) | inval_i[draw]
        cands[todo] = draw
        new_todo = np.zeros_like(todo)
        new_todo[todo] = bad
        todo = new_todo
    if todo.any():
        # popularity mass may sit in a user's rated set: uniform for the
        # stragglers (same rejection)
        rows, colsx = np.nonzero(todo)
        for a, b in zip(rows, colsx):
            while True:
                d = int(rng.integers(0, n_items))
                kq = int(users[a]) * n_items + d
                j = np.searchsorted(keys, kq)
                if (d != first[a] and not inval_i[d]
                        and not (j < len(keys) and keys[j] == kq)):
                    cands[a, b] = d
                    break
    out = np.concatenate([first[:, None], cands], axis=1)
    return out.astype(np.int32), users.astype(np.int32)


def _sampled_rank(view: EvalView, users: torch.Tensor, cands: torch.Tensor,
                  n: int, blk: int) -> Tuple[float, float]:
    """Rank of column 0 among each row's candidates (strict greater: ties
    favor the held-out), summed into HR@n and 1/(rank+1) credits."""
    hr = torch.zeros((), dtype=torch.float64, device=users.device)
    ar = torch.zeros((), dtype=torch.float64, device=users.device)
    for s in range(0, users.numel(), blk):
        u, cd = users[s:s + blk], cands[s:s + blk]
        sc = torch.einsum("bk,bmk->bm", view.u_fac[u], view.i_fac[cd])
        sc = sc + view.i_bias[cd] + view.u_bias[u][:, None] + view.mu
        rank = (sc[:, 1:] > sc[:, :1]).sum(dim=1)
        hit = rank < n
        hr += hit.sum()
        ar += (hit / (rank + 1.0).double()).sum()
    return float(hr), float(ar)


def sampled_ranking_metrics(view: EvalView, test_mat: RatingMatrix,
                            train_mat: RatingMatrix,
                            invalid_users: np.ndarray,
                            invalid_items: np.ndarray,
                            n: int = 10, n_candidates: int = 1000,
                            popularity: "np.ndarray | None" = None,
                            seed: int = 0,
                            blk: int = 1024) -> Tuple[float, float]:
    """(HR@n, ARHR@n) under the sampled LOO protocol: the held-out item
    ranked against ``n_candidates - 1`` sampled negatives (see
    sample_negatives), scored by the EvalView's estRating on its device."""
    n_users = view.u_fac.shape[0]
    n_items = view.i_fac.shape[0]
    cands, users = sample_negatives(
        test_mat, train_mat, invalid_users, invalid_items, n_users,
        n_items, n_candidates, popularity, seed)
    if len(users) == 0:
        return 0.0, 0.0
    dev = view.u_fac.device
    hr, ar = _sampled_rank(
        _as_f32(view), torch.from_numpy(users.astype(np.int64)).to(dev),
        torch.from_numpy(cands.astype(np.int64)).to(dev), n, blk)
    return hr / len(users), ar / len(users)


def popularity_ranking_metrics(test_mat: RatingMatrix,
                               train_mat: RatingMatrix,
                               invalid_users: np.ndarray,
                               invalid_items: np.ndarray,
                               n_users: int, n_items: int,
                               n: int = 10, n_candidates: int = 1000,
                               popularity: "np.ndarray | None" = None,
                               seed: int = 0) -> Tuple[float, float]:
    """The popularity-scorer baseline under the SAME sampled protocol
    (score = train frequency): the margin base that makes a parity row
    informative when the full-catalog HR saturates."""
    cands, users = sample_negatives(
        test_mat, train_mat, invalid_users, invalid_items, n_users,
        n_items, n_candidates, popularity, seed)
    if len(users) == 0:
        return 0.0, 0.0
    freq = train_mat.col_degrees().astype(np.float64)
    freq = np.pad(freq, (0, max(n_items - len(freq), 0)))
    sc = freq[cands]
    rank = (sc[:, 1:] > sc[:, :1]).sum(axis=1)
    hr = float((rank < n).mean())
    ar = float(((rank < n) / (rank + 1.0)).mean())
    return hr, ar
