"""BPR sampler quality parity on the port: rankgap vs literal gap sampler
through the full HR-selected training loop at the ML-100K shape (the
counterpart of scripts/bpr_sampler_quality.py).

The rankgap sampler deviates from the literal one only in the cross-gap
mixture when gaps contain never-rated items (README deviation #11); this
run shows whether the end metric (best val HR@10 / test HR@10) is
statistically equivalent, in the JAX script's lines. Every HR@10 runs
through the port's top-N kernel on the card; ``--cpu`` runs its plain
version.

Usage: python scripts/torch_bpr_sampler_quality.py [--cpu] [--maxiter N]
"""

import argparse
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from matfac_tpu_torch.config import Params  # noqa: E402
from matfac_tpu_torch.data.synthetic import leave_one_out_data  # noqa: E402
from matfac_tpu_torch.train.loop import train_model  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--maxiter", type=int, default=40)
    args = ap.parse_args()
    if not args.cpu and not torch.cuda.is_available():
        print("no CUDA device visible (pass --cpu for the CPU)",
              file=sys.stderr)
        return 2
    device = "cpu" if args.cpu else "cuda"
    data = leave_one_out_data(n_users=943, n_items=1682, per_user=50,
                              seed=4, structured=True)
    print(f"config: {data}")
    if device == "cuda":
        print(f"device: {torch.cuda.get_device_name(0)}")

    for sampler in ("rankgap", "gap"):
        for seed in (1, 2, 3):
            p = Params(fac_dim=16, u_reg=0.002, i_reg=0.002,
                       learn_rate=0.2, max_iter=args.maxiter, seed=seed,
                       batch_size=8192, disp_iter=10 ** 6,
                       bpr_sampler=sampler, n_negatives=2)
            t0 = time.time()
            rep, model, scorer, _ = train_model(data, p, algo="bpr",
                                                log_fn=lambda s: None,
                                                device=device)
            test_hr = scorer.hit_rate(
                model.eval_view(rep.best_state), data.test_mat, 10)
            print(f"{sampler:8s} seed={seed} "
                  f"val HR@10={rep.best_metric:.4f} "
                  f"test HR@10={test_hr:.4f} "
                  f"({time.time()-t0:.0f}s)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
