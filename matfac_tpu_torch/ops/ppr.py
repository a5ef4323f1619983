"""PageRank / personalized PageRank by sparse power iteration (port of
matfac_tpu/ops/ppr.py).

Replacement for GKlib's ``gk_rw_PageRank`` (confCompute.cpp:18,
topBucketComp.cpp:377, othersrc/computePPR.cpp:24): random walk with
restart on the item-item graph,

    pr <- (1 - lamda) * restart + lamda * (W_norm^T pr + lost * restart)

with row-stochastic W (``lost`` = the mass on dangling nodes, which
restarts), iterated until the largest column L1 change is at most ``eps`` or
``max_iter`` steps ran. Restart vectors are batched as the columns of an
[n_nodes, B] iterate. The spread W_norm^T pr sums each node's in-edges in a
fixed order (edges sorted by target, ``torch.segment_reduce``), so two runs
on one device give the same bits; the stopping test reads one scalar back
to the host after every step, as JAX's while_loop tests it on the device.
"""

from __future__ import annotations

import numpy as np
import torch

from matfac_tpu_torch.data.csr import RatingMatrix


class PPREngine:
    """The normalized graph on ``device``; ``iterations`` is the step count
    of the last power iteration."""

    def __init__(self, graph: RatingMatrix, device="cuda"):
        r, c, v = graph.to_coo()
        deg = np.zeros(graph.nrows, np.float64)
        np.add.at(deg, r, v.astype(np.float64))
        norm = np.where(deg[r] > 0, v / deg[r], 0.0)
        # edges grouped by target node: the segments of the spread's sums
        order = np.argsort(c, kind="stable")
        dev = torch.device(device)
        as_t = lambda a, dt: torch.from_numpy(np.ascontiguousarray(
            a.astype(dt))).to(dev)
        self.device = dev
        self.n = graph.nrows
        self.src = as_t(r[order], np.int64)
        self.w = as_t(norm[order], np.float32)
        self.in_deg = as_t(np.bincount(c, minlength=self.n), np.int64)
        self.dangling = as_t((deg == 0).astype(np.float32), np.float32)
        self.iterations = 0

    def _spread(self, pr: torch.Tensor) -> torch.Tensor:
        """out[j] = sum_i pr[i] w_ij, the in-edges of j summed in order."""
        return torch.segment_reduce(self.w[:, None] * pr[self.src], "sum",
                                    lengths=self.in_deg, axis=0)

    def ppr(self, restart, lamda: float = 0.85, eps: float = 1e-4,
            max_iter: int = 10_000) -> torch.Tensor:
        """restart: [n] or [n, B] restart distribution(s) (will be
        normalized), a tensor or an array. Returns the stationary PPR
        scores on the engine's device, same shape."""
        r = torch.as_tensor(restart, dtype=torch.float32, device=self.device)
        squeeze = r.ndim == 1
        r = r[:, None] if squeeze else r
        r = r / torch.clamp(r.sum(dim=0, keepdim=True), min=1e-12)
        lam = torch.tensor(lamda, dtype=torch.float32, device=self.device)
        base = (1.0 - lam) * r

        def step(pr):
            lost = (pr * self.dangling[:, None]).sum(dim=0, keepdim=True)
            return base + lam * (self._spread(pr) + lost * r)

        prev, pr, it = r, step(r), 1
        while it < max_iter and float(
                (pr - prev).abs().sum(dim=0).max()) > np.float32(eps):
            prev, pr, it = pr, step(pr), it + 1
        self.iterations = it
        return pr[:, 0] if squeeze else pr

    def global_pagerank(self, lamda: float = 0.85, eps: float = 1e-4,
                        max_iter: int = 10_000) -> torch.Tensor:
        """GPR: uniform restart (confCompute's gpr usage)."""
        return self.ppr(torch.ones(self.n, device=self.device), lamda, eps,
                        max_iter)

    def user_ppr(self, train_mat: RatingMatrix, users: np.ndarray,
                 lamda: float = 0.85, eps: float = 1e-4,
                 max_iter: int = 10_000) -> np.ndarray:
        """Per-user PPR with restart on the user's rated items weighted
        by rating (itemGraphItemScores, topBucketComp.cpp:348-400).
        Returns a host array [len(users), n_items]."""
        B = len(users)
        restart = np.zeros((self.n, B), np.float32)
        for j, u in enumerate(users):
            cols, vals = train_mat.row(int(u))
            restart[cols, j] = vals
        return self.ppr(restart, lamda, eps, max_iter).t().cpu().numpy()
