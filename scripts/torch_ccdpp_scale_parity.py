"""CCD++ against ALS quality parity at the ML-10M shape, on the port (the
counterpart of scripts/ccdpp_scale_parity.py).

ALS, CCD++ and CCD++ with ``group_dims=4`` each train 12 epochs at
k 32 from one initial state on the 100k x 20k / ~10M-nnz synthetic split
(``synthetic_data(..., seed=11)``), val RMSE after each epoch (epoch wall
with the device synchronized), and the best. CCD++ draws each epoch's
dimension order from the solver's own generator. Runs on the card unless
``--cpu``; the size flags default to the JAX script's shape.

Usage: python scripts/torch_ccdpp_scale_parity.py [--cpu] [--n-users N]
  [--n-items N] [--density D] [--k K] [--epochs E]
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
from matfac_tpu_torch.eval.metrics import Evaluator  # noqa: E402
from matfac_tpu_torch.models.base import ModelMF, init_state  # noqa: E402
from matfac_tpu_torch.solvers.als import ALSSolver  # noqa: E402
from matfac_tpu_torch.solvers.ccd import CCDPPSolver  # noqa: E402
from matfac_tpu_torch.utils import freq  # noqa: E402


def make_data(n_users=100_000, n_items=20_000, density=0.005):
    data, _, _ = synthetic_data(
        n_users=n_users, n_items=n_items, k=8, density=density, seed=11,
        noise=0.1, power_law=0.6, nonneg=True, test_pc=0.05, val_pc=0.05)
    return data


def run(data, k=32, epochs=12, device="cuda", log=print) -> dict:
    """{name: {"best": best val RMSE, "vals": per epoch, "seconds": per
    epoch}} for als, ccd++ and ccd++g4."""
    p = Params(fac_dim=k, u_reg=0.05, i_reg=0.05, seed=1)
    m = ModelMF(p, data.n_users, data.n_items)
    iu, ii = freq.invalid_users_items(data.train_mat, data.n_users,
                                      data.n_items)
    ev = Evaluator(data, iu, ii, p, device=device)
    sync = (torch.cuda.synchronize if torch.device(device).type == "cuda"
            else lambda: None)
    out = {}
    for name, make in [
            ("als", lambda: ALSSolver(m, p, data.train_mat, iu, ii,
                                      device=device)),
            ("ccd++", lambda: CCDPPSolver(m, p, data.train_mat, iu, ii,
                                          device=device)),
            ("ccd++g4", lambda: CCDPPSolver(m, p, data.train_mat, iu, ii,
                                            group_dims=4, device=device)),
    ]:
        solver = make()
        st = init_state(p, data.n_users, data.n_items, device=device)
        best, vals, secs = float("inf"), [], []
        for e in range(epochs):
            sync()
            t0 = time.time()
            st = solver.epoch(st, 0)
            sync()
            dt = time.time() - t0
            val = ev.rmse(m.eval_view(st), "val")
            best = min(best, val)
            vals.append(val)
            secs.append(dt)
            log(f"{name} epoch {e}: val={val:.4f} ({dt:.1f}s)")
        log(f"{name} BEST val={best:.4f}")
        out[name] = dict(best=best, vals=vals, seconds=secs)
        del solver, st
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--n-users", type=int, default=100_000)
    ap.add_argument("--n-items", type=int, default=20_000)
    ap.add_argument("--density", type=float, default=0.005)
    ap.add_argument("--k", type=int, default=32)
    ap.add_argument("--epochs", type=int, default=12)
    args = ap.parse_args()
    if not args.cpu and not torch.cuda.is_available():
        print("no CUDA device visible (pass --cpu for the CPU)",
              file=sys.stderr)
        return 2
    device = "cpu" if args.cpu else "cuda"
    print("device:", torch.cuda.get_device_name(0) if device == "cuda"
          else "cpu", flush=True)
    data = make_data(args.n_users, args.n_items, args.density)
    print("config:", data, flush=True)
    run(data, args.k, args.epochs, device,
        log=lambda s: print(s, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
