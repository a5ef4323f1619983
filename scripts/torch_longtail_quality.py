"""WWW'19 long-tail comparison harness on the port (the counterpart of
scripts/longtail_quality.py, with its flags, grids and lines):
tail/head-quartile test RMSE for plain MF vs the adaptive models (TMF
truncation, IFWMF weighting; modelDropoutSigmoid.cpp / modelInvPopMF.cpp),
each grid-tuned on validation-tail RMSE the way the paper tunes rho/alpha
per dataset. BASELINE.md "Long-tail adaptive models" records the JAX
package's results; ``--lowrank-tail --tail-boost 2.5`` is the regime where
the truncation models won there (data.synthetic.tail_lowrank_data: tail
items' ground-truth factors in one shared rank-3 subspace of the rank-16
model, with stronger preferences than the head).

Runs on the card unless ``--cpu``.

Usage: python scripts/torch_longtail_quality.py [--cpu] [--hetero]
       [--lowrank-tail]
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
from matfac_tpu_torch.data.csr import RatingMatrix  # noqa: E402
from matfac_tpu_torch.data.synthetic import (synthetic_data,  # noqa: E402
                                             tail_lowrank_data)
from matfac_tpu_torch.eval.quartile import (filtered_rmse,  # noqa: E402
                                            quartile_partitions)
from matfac_tpu_torch.train.loop import train_model  # noqa: E402
from matfac_tpu_torch.utils import freq as ufreq  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--maxiter", type=int, default=250)
    ap.add_argument("--hetero", action="store_true",
                    help="tail-noisier ratings (the paper regime)")
    ap.add_argument("--hetero-head", action="store_true",
                    help="HEAD-noisier ratings (popularity-correlated "
                         "noise: popular items are rated by diverse "
                         "audiences) — the regime inverse-popularity "
                         "weighting is the right estimator for")
    ap.add_argument("--lowrank-tail", action="store_true",
                    help="tail items carry rank-3 signal in a rank-16 "
                         "model (tail_lowrank_data)")
    ap.add_argument("--power-law", type=float, default=1.1)
    ap.add_argument("--spectrum-pow", type=float, default=0.5)
    ap.add_argument("--tail-boost", type=float, default=1.0)
    ap.add_argument("--data-seed", type=int, default=100)
    ap.add_argument("--shape", choices=["small", "ml10m"],
                    default="small",
                    help="ml10m: 70k x 10k / ~10M ratings at-scale "
                         "table (VERDICT r4 #4); implies --method "
                         "densesgd-capable auto dispatch, obj_iter=5 "
                         "and a trimmed tuning grid")
    ap.add_argument("--method", default="sgd",
                    help="mf_method for every run (at scale use "
                         "'auto' -> densesgd for all four models)")
    args = ap.parse_args()
    if not args.cpu and not torch.cuda.is_available():
        print("no CUDA device visible (pass --cpu for the CPU)",
              file=sys.stderr)
        return 2
    device = "cpu" if args.cpu else "cuda"

    if args.lowrank_tail:
        shape_kw = {}
        if args.shape == "ml10m":
            shape_kw = dict(n_users=70_000, n_items=10_000,
                            density=0.0143)
        data, _ = tail_lowrank_data(seed=args.data_seed,
                                    power_law=args.power_law,
                                    spectrum_pow=args.spectrum_pow,
                                    tail_boost=args.tail_boost,
                                    **shape_kw)
    else:
        data, _, _ = synthetic_data(
            n_users=943, n_items=1682, k=6, density=0.063,
            seed=args.data_seed,
            noise=0.35, power_law=1.0, nonneg=True, test_pc=0.1,
            val_pc=0.1)
    if args.hetero or args.hetero_head:
        # --hetero: TAIL entities' ratings are noisier (the WWW'19
        # narrative; measured — homoscedastic AND this variant reward
        # plain regularization, see the module docstring conclusion).
        # --hetero-head: popularity-correlated noise — HEAD items'
        # ratings are noisier (diverse audiences). This is the regime
        # where inverse-popularity data weighting (modelInvPopMF.cpp's
        # literal estimator: weight = 1/(1+rho*pop)) is statistically
        # right: per-rating information ~ 1/sigma^2 ~ 1/popularity.
        rng = np.random.default_rng(0)
        ifreq = data.train_mat.col_degrees().astype(np.float64)
        ifreq = np.maximum(ifreq, 1)
        for name in ("train_mat", "test_mat", "val_mat"):
            m = getattr(data, name)
            r, c, v = m.to_coo()
            f = ifreq[np.clip(c, 0, len(ifreq) - 1)]
            if args.hetero_head:
                sig = 1.2 * np.sqrt(f / ifreq.max())
            else:
                sig = 1.2 / np.sqrt(f)
            v = v + (sig * rng.standard_normal(len(v))).astype(
                np.float32)
            setattr(data, name, RatingMatrix.from_coo(
                r, c, v, m.nrows, m.ncols))
    print(f"config: {data} (lowrank_tail={args.lowrank_tail}, "
          f"hetero={args.hetero}, hetero_head={args.hetero_head})")
    if device == "cuda":
        print(f"device: {torch.cuda.get_device_name(0)}")
    iu, ii = ufreq.invalid_users_items(data.train_mat, data.n_users,
                                       data.n_items)
    uq, iq = quartile_partitions(data, iu, ii)

    if args.lowrank_tail:
        # oracle floor: test RMSE of the generator's true factors —
        # the noise level any model is chasing, split tail vs head
        r, c, v = data.test_mat.to_coo()
        pred = np.einsum("ek,ek->e", data.orig_u_fac[r],
                         data.orig_i_fac[c])
        se = (pred - v) ** 2
        for name, qs in (("tail", (0, 1)), ("head", (3,))):
            m = np.isin(iq[c], qs) & ~ii[c] & ~iu[r]
            print(f"oracle {name} RMSE: "
                  f"{np.sqrt(se[m].mean()):.4f} (n={m.sum()})")

    def tail_head_rmse(view, ev):
        """test RMSE for tail (q0+q1) vs head (q3) item quartiles."""
        out = {}
        for name, qs in (("tail", (0, 1)), ("head", (3,))):
            mask = np.isin(iq, qs)
            out[name] = filtered_rmse(view, ev, "test",
                                      item_filter=mask)[1]
        return out

    def run(algo, kw):
        kw = dict(kw)
        method = kw.pop("_method", args.method)
        base = dict(fac_dim=16, max_iter=args.maxiter, seed=1,
                    learn_rate=0.1, batch_size=2048, u_reg=0.002,
                    i_reg=0.002, disp_iter=10 ** 6)
        if args.shape == "ml10m":
            # per-epoch eval at 10M nnz costs ~10x the dense epoch —
            # check every 5th (termination semantics unchanged
            # otherwise); stripe-batch dynamics like a large minibatch
            base["obj_iter"] = 5
        base.update(kw)
        p = Params(**base)
        rep, model, ev, _ = train_model(data, p, algo=algo,
                                        mf_method=method,
                                        log_fn=lambda s: None,
                                        device=device)
        view = model.eval_view(rep.best_state)
        # model selection on VALIDATION tail RMSE (the paper tunes
        # rho/alpha per dataset)
        mask = np.isin(iq, (0, 1))
        vt = filtered_rmse(view, ev, "val", item_filter=mask)[1]
        return vt, view, ev

    # hyperparameter grids (the adaptive knobs; MF grid = reg only)
    grids = {
        "mf": [{}, dict(u_reg=0.01, i_reg=0.01),
               dict(u_reg=0.05, i_reg=0.05)],
        "IFWMF": [dict(rho_rms=r) for r in (10.0, 100.0, 300.0,
                                            1000.0, 3000.0)],
        "TMF": [dict(rho_rms=r, alpha=a)
                for r in (0.5, 1.0, 2.0) for a in (-1.0, -0.5, 0.0)],
        "TMFDropout": [dict(rho_rms=r, alpha=a)
                       for r in (0.5, 1.0, 2.0)
                       for a in (-1.0, -0.5, 0.0)],
    }
    if args.shape == "ml10m":
        # trimmed at-scale grid around the small-shape winners (each
        # run re-stages the dense grid; full 9-point grids would cost
        # hours per seed)
        # MF gets BOTH engines (dense stripe-batch GD converges
        # slowly on the decaying-spectrum generator at this scale —
        # measured; the scatter engine is its strong config)
        grids = {
            "mf": [{}, dict(u_reg=0.01, i_reg=0.01),
                   dict(_method="sgd", u_reg=0.005, i_reg=0.005),
                   dict(_method="sgd", u_reg=0.002, i_reg=0.002)],
            "TMF": [dict(rho_rms=r, alpha=a)
                    for r, a in ((0.5, -1.0), (1.0, -1.0),
                                 (1.0, -0.5), (2.0, -0.5))]
                   + [dict(_method="sgd", rho_rms=0.5, alpha=-1.0,
                           u_reg=0.005, i_reg=0.005),
                      dict(_method="sgd", rho_rms=1.0, alpha=-1.0,
                           u_reg=0.005, i_reg=0.005)],
            "TMFDropout": [dict(rho_rms=r, alpha=a)
                           for r, a in ((0.5, -1.0), (1.0, -1.0),
                                        (1.0, -0.5), (2.0, -0.5))]
                          + [dict(_method="sgd", rho_rms=0.5,
                                  alpha=-1.0, u_reg=0.005,
                                  i_reg=0.005),
                             dict(_method="sgd", rho_rms=1.0,
                                  alpha=-1.0, u_reg=0.005,
                                  i_reg=0.005)],
        }
    rows = []
    for algo, grid in grids.items():
        best = None
        t0 = time.time()
        for kw in grid:
            vt, view, ev = run(algo, kw)
            if best is None or vt < best[0]:
                best = (vt, view, ev, kw)
        vt, view, ev, kw = best
        r = tail_head_rmse(view, ev)
        overall = ev.rmse(view, "test")
        rows.append((algo, overall, r["tail"], r["head"]))
        print(f"{algo:8s} test={overall:.4f} tail={r['tail']:.4f} "
              f"head={r['head']:.4f} best={kw} "
              f"({time.time()-t0:.0f}s)", flush=True)

    base_tail = rows[0][2]
    for algo, overall, tail, head in rows[1:]:
        print(f"{algo}: tail RMSE {tail:.4f} vs MF {base_tail:.4f} "
              f"({(base_tail-tail)/base_tail:+.1%})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
