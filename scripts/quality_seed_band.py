"""The JAX package's solver-quality grid (scripts/quality_report.py) at
one depth over several Params seeds: the band of best val RMSE that
chip_smoke.py's phase (x) holds the port's scripts/torch_quality_report.py
to (QUALITY_JAX there). One seed is no yardstick at a cut depth: sgd and
ccd move by 0.03 and 0.016 between seeds at --maxiter 30.

Usage: PYTHONPATH=. python scripts/quality_seed_band.py --cpu
       [--maxiter 30] [--seeds 1 2 3 4]
"""

import argparse
import sys

# scripts/quality_report.py's grid, which that script keeps inside main():
# (method, epoch multiplier, Params overrides)
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
    ("densesgd", 5, dict(learn_rate=0.1, u_reg=0.005, i_reg=0.005)),
]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--maxiter", type=int, default=30)
    ap.add_argument("--seeds", type=int, nargs="+", default=[1, 2, 3, 4])
    args = ap.parse_args()
    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")

    from matfac_tpu.config import Params
    from matfac_tpu.data.synthetic import synthetic_data
    from matfac_tpu.train.loop import train_model

    data, _, _ = synthetic_data(
        n_users=943, n_items=1682, k=8, density=0.063, seed=100,
        noise=0.1, power_law=0.6, nonneg=True, test_pc=0.1, val_pc=0.1)
    band = {method: [] for method, _, _ in CONFIGS}
    for seed in args.seeds:
        for method, iter_mult, kw in CONFIGS:
            p = Params(fac_dim=10, max_iter=args.maxiter * iter_mult,
                       seed=seed, disp_iter=10 ** 6, **kw)
            mm = "ccd++" if method == "ccd++g5" else method
            rep, _, _, _ = train_model(data, p, algo="mf", mf_method=mm,
                                       log_fn=lambda s: None)
            band[method].append(round(rep.best_metric, 4))
            print(f"seed={seed} {method:10s} "
                  f"best_val={rep.best_metric:.4f}", flush=True)
    for method, vals in band.items():
        print(f"{method:10s} {vals} spread {max(vals) - min(vals):.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
