"""End-to-end tour on the port: data -> train -> evaluate -> checkpoint ->
serve (the counterpart of examples/train_eval_serve.py).

Mirrors the reference's default workflow (``mf --algo mf --mf_method als
...``, main.cpp:1233-1421) through the library instead of the CLI, on the
card (or on the CPU with ``--cpu``), in under a minute.

    python examples/torch_train_eval_serve.py [--cpu]
"""

import argparse
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true")
    a = ap.parse_args()
    if not a.cpu and not torch.cuda.is_available():
        print("no CUDA device visible (pass --cpu for the CPU)",
              file=sys.stderr)
        return 2
    dev = "cpu" if a.cpu else "cuda"
    # --- 1. data ---------------------------------------------------
    # GKlib-text CSR files load through Params / Data as in the reference
    # (datastruct.cpp:3-120); here a synthetic low-rank problem, split as
    # the reference validates (python/genLatFacs.py)
    from matfac_tpu_torch.config import Params
    from matfac_tpu_torch.data.dataset import Data
    from matfac_tpu_torch.data.io import split_train_test_val, write_csr
    from matfac_tpu_torch.data.synthetic import low_rank_ratings

    n_users, n_items = 1500, 600
    full, true_u, true_i = low_rank_ratings(
        n_users, n_items, k=8, density=0.05, seed=7, noise=0.05,
        power_law=0.5, nonneg=True)
    train, test, val = split_train_test_val(full, test_pc=0.1, val_pc=0.1,
                                            seed=3)
    # the files go under build/ in the repository (ignored by git)
    workdir = os.path.join(ROOT, "build", "torch_train_eval_serve")
    os.makedirs(workdir, exist_ok=True)
    paths = {}
    for name, m in (("train", train), ("test", test), ("val", val)):
        paths[name] = os.path.join(workdir, f"{name}.csr")
        write_csr(m, paths[name])
    params = Params(fac_dim=16, u_reg=0.01, i_reg=0.01, learn_rate=0.01,
                    max_iter=30, seed=1, train_mat_file=paths["train"],
                    test_mat_file=paths["test"], val_mat_file=paths["val"],
                    prefix=os.path.join(workdir, "mf"), disp_iter=10)
    print(params.display())
    data = Data(params)
    print(data)

    # --- 2. train (ALS; swap mf_method for sgd/blocksgd/ccd++/...) --
    from matfac_tpu_torch.train.loop import train_model
    report, model, evaluator, (inval_u, inval_i) = train_model(
        data, params, algo="mf", mf_method="als", prefix=params.prefix,
        device=dev)
    print(f"best val RMSE {report.best_metric:.4f} at epoch "
          f"{report.best_iter} ({report.stop_reason})")

    # --- 3. evaluate -------------------------------------------------
    view = model.eval_view(report.best_state)
    print(f"test RMSE   {evaluator.rmse(view, 'test'):.4f}")
    print(f"test NDCG@10 {evaluator.ndcg(view, 'test'):.4f}")
    from matfac_tpu_torch.eval.quartile import quartile_report
    print(quartile_report(view, data, evaluator, inval_u, inval_i))
    # recovery against the generating factors (fullLowRankErr,
    # model.cpp:1942)
    err = evaluator.full_low_rank_err(view, true_u, true_i)
    print(f"recovery error vs ground-truth factors: {err:.4f}")

    # --- 4. serve ----------------------------------------------------
    # train_model checkpointed the best factors under
    # prefix_uFac_<signature>.mat (model.cpp:89-101)
    from matfac_tpu_torch.serving import Recommender
    rec = Recommender.from_checkpoint(params.prefix, params, data,
                                      device=dev)
    users = [0, 1, 2]
    items, scores = rec.recommend(users, n=5)
    for u, it in zip(users, items):
        print(f"user {u}: top-5 items {it.tolist()}")
    print(f"(artifacts in {workdir})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
