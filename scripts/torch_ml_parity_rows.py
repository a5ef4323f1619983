"""BASELINE.md's measurement-plan parity rows on the port (the counterpart
of scripts/ml_parity_rows.py).

There are no MovieLens files here, so each row runs on a shape- and
rating-distribution-matched synthetic: power-law item popularity + 1-5
star quantile quantization (data.synthetic ``stars=True``), tagged
SYNTHETIC in BASELINE.md. Rows (``PARITY_ROWS``, default
"als,ccdpp,tmf,bpr"; "bprhard" adds the non-saturated BPR row):

  * ML-1M shape   (6040 x 3706, ~1M ratings), rank-64 ALS   -> RMSE
  * ML-10M shape  (69878 x 10677, ~10M),     rank-64 CCD++ -> RMSE
  * ML-10M shape  implicit positives,        rank-64 BPR   -> HR@10/NDCG@10
  * ML-20M shape  (138k x 27k, ~20M),        rank-128 TMF+Poisson -> RMSE
    (+ frequency-quartile RMSEs: the WWW'19 long-tail protocol)

Runs every row on the card unless ``--cpu``. ``--scale`` multiplies each
row's users, items (at the row's density) and BPR positives a user;
``--maxiter`` replaces each row's epochs. Their defaults are the JAX
script's shapes and epochs.

Usage: PARITY_ROWS=als,ccdpp,tmf,bpr,bprhard \
  python scripts/torch_ml_parity_rows.py [--cpu] [--scale S] [--maxiter N]
"""

import argparse
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from matfac_tpu_torch.config import Params  # noqa: E402
from matfac_tpu_torch.data.synthetic import (leave_one_out_data,  # noqa: E402
                                             synthetic_data)
from matfac_tpu_torch.eval.metrics import Evaluator  # noqa: E402
from matfac_tpu_torch.eval.quartile import quartile_report  # noqa: E402
from matfac_tpu_torch.eval.ranking import (  # noqa: E402
    popularity_ranking_metrics, sampled_ranking_metrics)
from matfac_tpu_torch.train.loop import train_model  # noqa: E402


def log(*a):
    print(*a, flush=True)


def pointwise_row(name, algo, method, n_users, n_items, density, k,
                  max_iter, seed=11, quartiles=False, device="cuda",
                  **params_kw):
    """One rating row: train_model on the row's synthetic split, the best
    state's val / test RMSE (and the quartile report). Returns the
    numbers and the report."""
    data, _, _ = synthetic_data(
        n_users=n_users, n_items=n_items, k=16,
        density=density, seed=seed, noise=0.4, power_law=0.9,
        nonneg=True, stars=True)
    r0, c0, v0 = data.train_mat.to_coo()
    rv, cv, vv = data.val_mat.to_coo()
    base = float(np.sqrt(((vv - v0.mean()) ** 2).mean()))
    log(f"--- {name}: {data.train_mat} k={k} method={method} "
        f"mean-baseline val RMSE={base:.4f}")
    p = Params(fac_dim=k, max_iter=max_iter, seed=1, disp_iter=10 ** 6,
               **params_kw)
    t0 = time.time()
    rep, model, ev, (iu, ii) = train_model(
        data, p, algo=algo, mf_method=method, log_fn=lambda s: None,
        device=device)
    test = ev.rmse(model.eval_view(rep.best_state), "test")
    wall = time.time() - t0
    log(f"{name}: best_val={rep.best_metric:.4f} test={test:.4f} "
        f"best_iter={rep.best_iter} stop={rep.stop_reason} "
        f"wall={wall:.0f}s")
    out = dict(best_val=rep.best_metric, test=test, best_iter=rep.best_iter,
               stop=rep.stop_reason, wall=wall, baseline=base,
               solver=type(rep.solver).__name__, rep=rep)
    if quartiles:
        rpt = quartile_report(model.eval_view(rep.best_state), data, ev,
                              iu, ii)
        log(f"{name} quartiles:\n{rpt}")
        out["quartiles"] = rpt
    return out


def bpr_row(n_users=69878, n_items=10677, per_user=140, k=64,
            max_iter=40, temp=0.3, device="cuda"):
    """The ML-10M-shaped BPR row: train_model(algo="bpr") selecting on val
    HR@10, then the best state's test HR@10, ARHR and NDCG@10, and the
    sampled protocol (the held-out item against 999 popularity-sampled
    negatives) beside the popularity scorer. Returns the numbers."""
    data = leave_one_out_data(n_users=n_users, n_items=n_items, k=16,
                              per_user=per_user, seed=6,
                              structured=True, temp=temp)
    log(f"--- ML-10M-shape BPR (temp={temp}): {data.train_mat}")
    p = Params(fac_dim=k, max_iter=max_iter, seed=2, learn_rate=0.1,
               u_reg=0.001, i_reg=0.001, batch_size=65536,
               disp_iter=10, n_negatives=2, bpr_sampler="rankgap")
    t0 = time.time()
    rep, model, scorer, _ = train_model(data, p, algo="bpr",
                                        log_fn=log, device=device)
    view = model.eval_view(rep.best_state)
    hr = scorer.hit_rate(view, data.test_mat, 10)
    arhr = scorer.arhr(view, data.test_mat)
    iu = np.zeros(n_users, bool)
    ii = np.zeros(n_items, bool)
    ev = Evaluator(data, iu, ii, p, device=device)
    ndcg = ev.ndcg(view, "test")
    wall = time.time() - t0
    log(f"ML-10M-shape BPR: best_val_HR={rep.best_metric:.4f} "
        f"test_HR@10={hr:.4f} test_ARHR={arhr:.4f} "
        f"test_NDCG@10={ndcg:.4f} wall={wall:.0f}s")

    # non-saturated protocol: the held-out item vs 999
    # POPULARITY-sampled negatives, with the popularity scorer itself
    # as the margin base; full-catalog HR ~1.0 on this data says only
    # that the pipeline runs
    pop = data.train_mat.col_degrees().astype(np.float64) + 0.1
    shr, sar = sampled_ranking_metrics(
        view, data.test_mat, data.train_mat, iu, ii, n=10,
        n_candidates=1000, popularity=pop, seed=7)
    phr, par = popularity_ranking_metrics(
        data.test_mat, data.train_mat, iu, ii, n_users, n_items,
        n=10, n_candidates=1000, popularity=pop, seed=7)
    log(f"ML-10M-shape BPR sampled-negatives (999 pop-sampled): "
        f"model HR@10={shr:.4f} ARHR={sar:.4f} | popularity scorer "
        f"HR@10={phr:.4f} ARHR={par:.4f} | margin {shr-phr:+.4f}")
    return dict(best_val_hr=rep.best_metric, hr=hr, arhr=arhr, ndcg=ndcg,
                sampled_hr=shr, sampled_arhr=sar, pop_hr=phr, pop_arhr=par,
                best_iter=rep.best_iter, stop=rep.stop_reason, wall=wall,
                rep=rep)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--maxiter", type=int, default=None)
    args = ap.parse_args()
    if not args.cpu and not torch.cuda.is_available():
        print("no CUDA device visible (pass --cpu for the CPU)",
              file=sys.stderr)
        return 2
    device = "cpu" if args.cpu else "cuda"
    log("device:", torch.cuda.get_device_name(0) if device == "cuda"
        else "cpu")
    rows = os.environ.get("PARITY_ROWS", "als,ccdpp,tmf,bpr").split(",")
    s = args.scale
    n = lambda x: max(int(round(x * s)), 8)
    it = lambda x: x if args.maxiter is None else args.maxiter
    # ML-1M shape, ALS rank-64 (reg from the JAX script's CPU sweep:
    # lambda=10 is the val basin at 600k ratings / 623k params)
    if "als" in rows:
        pointwise_row("ML-1M-shape ALS", "mf", "als", n(6040), n(3706),
                      1_000_000 / (6040 * 3706), 64, it(60),
                      u_reg=10.0, i_reg=10.0, device=device)
    # ML-10M shape, CCD++ rank-64, same basin
    if "ccdpp" in rows:
        pointwise_row("ML-10M-shape CCD++", "mf", "ccd++", n(69878),
                      n(10677), 10_000_000 / (69878 * 10677), 64, it(12),
                      u_reg=10.0, i_reg=10.0, device=device)
    # ML-20M shape, TMF+Poisson rank-128 + quartiles
    if "tmf" in rows:
        pointwise_row("ML-20M-shape TMFDropout", "tmfdropout", "auto",
                      n(138_000), n(27_000),
                      20_000_000 / (138_000 * 27_000), 128, it(60),
                      u_reg=0.005, i_reg=0.005, learn_rate=0.05,
                      rho_rms=1.0, alpha=0.0, batch_size=65536,
                      quartiles=True, device=device)
    per_user = max(int(round(140 * s)), 5)
    # ML-10M shape, BPR
    if "bpr" in rows:
        bpr_row(n(69878), n(10677), per_user, max_iter=it(40),
                device=device)
    # harder preference noise (temp=1.0): the non-saturated ranking row
    # (HR@10 < 0.99, so quality differences are visible)
    if "bprhard" in rows:
        bpr_row(n(69878), n(10677), per_user, max_iter=it(40), temp=1.0,
                device=device)
    log("PARITY_ROWS_DONE")
    return 0


if __name__ == "__main__":
    sys.exit(main())
