"""Offline analysis drivers — the composite reports main.cpp runs
after/around training (port of matfac_tpu/analysis/drivers.py).

* ``freq_rmse_sweep``  — computeFreqRMSEs (main.cpp:398-524): test/val
  RMSE restricted to items above a sweep of frequency percentiles.
* ``sample_top_n_analysis`` — computeSampTopNFrmFullModel
  (main.cpp:75-396): load a trained model + ground-truth model (+ SVD
  model), run filtered RMSE sweeps and sampled per-user top-bucket
  RMSE curves under freq / SVD / PPR orderings.
* ``compare_ppr_gpr`` — comparePPR2GPR (confCompute.cpp:5-150):
  overlap of each user's top-M PPR items with the global top-M GPR
  items.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from matfac_tpu_torch.analysis.top_bucket import (pred_samp_users_rmse,
                                                  sample_users)
from matfac_tpu_torch.eval.quartile import filtered_rmse, split_residuals
from matfac_tpu_torch.models.base import EvalView


def freq_rmse_sweep(view: EvalView, ev, data,
                    percentiles: Sequence[float] = (0.1, 0.25, 0.5,
                                                    0.75, 1.0),
                    which: str = "test") -> Dict[float, tuple]:
    """{(top-percentile) -> (count, RMSE)} over entries whose ITEM is in
    the top-p fraction by train frequency."""
    deg = data.train_mat.col_degrees().astype(np.float64)
    item_freq = np.zeros(data.n_items)
    item_freq[: len(deg)] = deg[: data.n_items]
    order = np.argsort(-item_freq, kind="stable")
    residuals = split_residuals(view, ev, which)   # one prediction pass
    out = {}
    for p in percentiles:
        cutoff = max(int(p * data.n_items), 1)
        mask = np.zeros(data.n_items, bool)
        mask[order[:cutoff]] = True
        out[p] = filtered_rmse(view, ev, which, item_filter=mask,
                               residuals=residuals)
    return out


def sample_top_n_analysis(full_view: EvalView, orig_view: EvalView,
                          ev, data, invalid_users, invalid_items,
                          svd_view: Optional[EvalView] = None,
                          ppr_engine=None, n_users: int = 200,
                          n_buckets: int = 10, seed: int = 1) -> Dict:
    """Filtered RMSE sweeps + per-user score-ordered bucket curves."""
    report: Dict = {"freq_rmse_sweep": freq_rmse_sweep(full_view, ev,
                                                       data)}
    item_freq = data.train_mat.col_degrees().astype(np.float64)

    scorers = {"freq": lambda u, items: item_freq[items]}
    if svd_view is not None:
        # scored on the host from host copies of the factors, as the JAX
        # package scores them (there to spare a device round trip a user;
        # here it keeps the same float32 numpy arithmetic)
        su, si, sub, sib = (t.cpu().numpy() for t in (
            svd_view.u_fac, svd_view.i_fac, svd_view.u_bias,
            svd_view.i_bias))
        smu = float(svd_view.mu)

        def svd_score(u, items):
            return (smu + sub[int(u)] + sib[items]
                    + si[items] @ su[int(u)])
        scorers["svd"] = svd_score
    users = sample_users(invalid_users, data.train_mat.nrows, n_users,
                         seed)
    if ppr_engine is not None:
        # one batched power iteration per 512-user chunk, the JAX
        # package's chunks (there sized to save device round trips; here
        # they keep its iterates: the stopping test is over a chunk's
        # columns)
        pos = {int(u): j for j, u in enumerate(users)}
        pr_rows = np.empty((len(users), data.n_items), np.float32)
        for s in range(0, len(users), 512):
            pr_rows[s:s + 512] = ppr_engine.user_ppr(
                data.train_mat, users[s:s + 512])

        def ppr_score(u, items):
            return pr_rows[pos[int(u)], items]
        scorers["ppr"] = ppr_score

    report["bucket_curves"] = pred_samp_users_rmse(
        orig_view, full_view, data.train_mat, invalid_users,
        invalid_items, scorers, n_users=n_users, n_buckets=n_buckets,
        seed=seed, users=users)
    return report


def compare_ppr_gpr(ppr_engine, train_mat, users: Sequence[int],
                    top_m: int = 100, lamda: float = 0.85) -> Dict:
    """Mean overlap fraction between each sampled user's top-M PPR items
    and the global top-M GPR items (comparePPR2GPR essence)."""
    gpr = ppr_engine.global_pagerank(lamda).cpu().numpy()
    top_gpr = set(np.argsort(-gpr, kind="stable")[:top_m])
    overlaps = []
    users = np.asarray(users)
    pr = ppr_engine.user_ppr(train_mat, users, lamda)
    for j in range(len(users)):
        top_ppr = set(np.argsort(-pr[j], kind="stable")[:top_m])
        overlaps.append(len(top_ppr & top_gpr) / top_m)
    return {"mean_overlap": float(np.mean(overlaps)),
            "overlaps": np.asarray(overlaps)}
