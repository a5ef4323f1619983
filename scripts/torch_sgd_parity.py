"""SGD quality parity in the reference regime, on the port (the
counterpart of scripts/sgd_parity.py).

The reference's sequential SGD runs with maxiter 1000+ under the
termination machine (model.cpp:1471-1540: lr halving at 100 stagnant
epochs, CHANCE_ITER=500 give-up). This script runs the port's minibatched
scatter SGD engine with that budget on the ML-100K-shaped synthetic split
of scripts/torch_quality_report.py and prints best val/test RMSE per (lr,
batch) config, in the JAX script's lines. Target: within 0.01 of ALS
(~0.136 val, BASELINE.md quality table). Runs on the card unless
``--cpu``.

Usage: python scripts/torch_sgd_parity.py [--cpu] [--maxiter N]
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

# SGD applies the L2 term PER OCCURRENCE (modelMF.cpp:92-105), so its
# effective per-entity lambda is freq * reg: the coordinate solvers'
# u_reg=0.05 corresponds to SGD regs ~50x smaller on this split (mean freq
# ~78). The JAX script's grid
GRIDS = [
    dict(learn_rate=0.05, batch_size=2048, u_reg=0.005, i_reg=0.005),
    dict(learn_rate=0.05, batch_size=2048, u_reg=0.001, i_reg=0.001),
    dict(learn_rate=0.1, batch_size=2048, u_reg=0.005, i_reg=0.005),
]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--maxiter", type=int, default=3000)
    args = ap.parse_args()
    if not args.cpu and not torch.cuda.is_available():
        print("no CUDA device visible (pass --cpu for the CPU)",
              file=sys.stderr)
        return 2
    device = "cpu" if args.cpu else "cuda"
    data, _, _ = synthetic_data(
        n_users=943, n_items=1682, k=8, density=0.063, seed=100,
        noise=0.1, power_law=0.6, nonneg=True, test_pc=0.1, val_pc=0.1)
    print(f"config: {data} (ML-100K shape)", flush=True)
    if device == "cuda":
        print(f"device: {torch.cuda.get_device_name(0)}", flush=True)
    best = None
    for kw in GRIDS:
        p = Params(fac_dim=10, max_iter=args.maxiter, seed=1,
                   disp_iter=10 ** 6, **kw)
        t0 = time.time()
        rep, model, ev, _ = train_model(data, p, mf_method="sgd",
                                        log_fn=lambda s: None,
                                        device=device)
        test = ev.rmse(model.eval_view(rep.best_state), "test")
        print(f"lr={kw['learn_rate']} B={kw['batch_size']}: "
              f"best_val={rep.best_metric:.4f} test={test:.4f} "
              f"best_iter={rep.best_iter} stop={rep.stop_reason} "
              f"({time.time()-t0:.0f}s)", flush=True)
        if best is None or rep.best_metric < best[0]:
            best = (rep.best_metric, test, kw)
    print(f"BEST: val={best[0]:.4f} test={best[1]:.4f} cfg={best[2]}",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
