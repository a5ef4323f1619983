"""Solver quality comparison on an ML-100K-shaped synthetic problem, on
the port (the counterpart of scripts/quality_report.py).

Runs every pointwise solver through the port's training loop on the same
943x1682 / ~100k-rating config as the JAX script (the reference's PR1
shape, BASELINE.md) and reports best validation / test RMSE and epochs to
best, in the JAX script's lines. Runs on the card unless ``--cpu``.

Usage: python scripts/torch_quality_report.py [--cpu] [--maxiter N]
"""

import argparse
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from matfac_tpu_torch.config import Params  # noqa: E402
from matfac_tpu_torch.data.synthetic import synthetic_data  # noqa: E402
from matfac_tpu_torch.train.loop import train_model  # noqa: E402

# (method, epoch multiplier, Params overrides): the JAX script's grid.
# Iterative first-order solvers need more epochs than the closed-form
# sweeps to reach the same floor. SGD regs are per-occurrence (effective
# lambda = freq * reg): 0.005 corresponds to the coordinate solvers' 0.05
# (scripts/sgd_parity.py)
CONFIGS = [
    ("sgd", 5, dict(learn_rate=0.1, batch_size=2048, u_reg=0.005,
                    i_reg=0.005)),
    ("sgdparsvd", 5, dict(learn_rate=0.05, batch_size=2048, u_reg=0.1,
                          i_reg=1.0)),
    ("als", 1, dict(u_reg=0.05, i_reg=0.05)),
    ("ialspp", 1, dict(u_reg=0.05, i_reg=0.05)),
    ("alsdense", 1, dict(u_reg=0.05, i_reg=0.05)),
    ("ccd++", 1, dict(u_reg=0.05, i_reg=0.05)),
    ("ccd++g5", 1, dict(u_reg=0.05, i_reg=0.05, ccd_group_dims=5)),
    ("ccd", 5, dict(u_reg=0.05, i_reg=0.05)),
    # the row-dense engine at the quality grid
    ("densesgd", 5, dict(learn_rate=0.1, u_reg=0.005, i_reg=0.005)),
]


def quality_data():
    """The JAX script's split (synthetic_data, seed 100)."""
    data, _, _ = synthetic_data(
        n_users=943, n_items=1682, k=8, density=0.063, seed=100,
        noise=0.1, power_law=0.6, nonneg=True, test_pc=0.1, val_pc=0.1)
    return data


def run(data, maxiter: int, device: str, configs=CONFIGS, log=print):
    """Train each config; returns rows (method, best val RMSE, test RMSE,
    best epoch, stop reason, seconds) and logs the JAX script's line for
    each."""
    rows = []
    for method, iter_mult, kw in configs:
        p = Params(fac_dim=10, max_iter=maxiter * iter_mult, seed=1,
                   disp_iter=10 ** 6, **kw)
        t0 = time.time()
        mm = "ccd++" if method == "ccd++g5" else method
        rep, model, ev, _ = train_model(data, p, algo="mf", mf_method=mm,
                                        log_fn=lambda s: None,
                                        device=device)
        test = ev.rmse(model.eval_view(rep.best_state), "test")
        rows.append((method, rep.best_metric, test, rep.best_iter,
                     rep.stop_reason, time.time() - t0))
        log(f"{method:10s} best_val={rep.best_metric:.4f} "
            f"test={test:.4f} best_iter={rep.best_iter:3d} "
            f"stop={rep.stop_reason} ({rows[-1][5]:.1f}s)")
    return rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--maxiter", type=int, default=60)
    args = ap.parse_args()
    if not args.cpu and not torch.cuda.is_available():
        print("no CUDA device visible (pass --cpu for the CPU)",
              file=sys.stderr)
        return 2
    device = "cpu" if args.cpu else "cuda"
    data = quality_data()
    print(f"config: {data} (ML-100K shape)")
    if device == "cuda":
        print(f"device: {torch.cuda.get_device_name(0)}")
    rows = run(data, args.maxiter, device)
    vals = [r[1] for r in rows]
    spread = max(vals) - min(vals)
    print(f"\nval-RMSE spread across solvers: {spread:.4f} "
          f"(parity target: within run-to-run variance)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
