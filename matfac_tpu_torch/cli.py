"""The port's command line, flag for flag the JAX package's
matfac_tpu/cli.py (the reference's gflags binary, main.cpp:26-73).

Usage:
  python -m matfac_tpu_torch.cli --algo mf --mf_method sgd \
      --trainmat train.csr --testmat test.csr --valmat val.csr \
      --facdim 10 --maxiter 500 --ureg 0.01 --ireg 0.01 \
      --learnrate 0.005 --seed 1 --prefix out/mf

It trains on the CUDA device, and refuses to start without one unless
``--cpu`` is given. After training it prints the final Train / Test / Val
RMSE and the quartile breakdowns (main.cpp:1377-1413) of a pointwise model,
or val HR@10, test HR@10 and test ARHR of a ranking model, then the stop
reason and the best epoch: the lines of ``python -m matfac_tpu.cli``.
``--mode analyze`` analyses saved factors (--initufac/--initifac) and prints
the JAX CLI's analysis report: train and test RMSE, the low-rank recovery
error against --origufac/--origifac, the freq-RMSE sweep, the per-user
bucket RMSE curves under the freq / SVD / PPR orderings, and the PPR-vs-GPR
overlap.
"""

from __future__ import annotations

import argparse
import sys

import torch

from matfac_tpu_torch.config import Params


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="matfac_tpu_torch",
        description="PyTorch / CUDA matrix factorization (reference-parity "
                    "CLI)")
    # names mirror main.cpp:26-46 gflags
    ap.add_argument("--algo", default="mf",
                    help="mf | mf_bias | IFWMF | TMF | TMFDropout | "
                         "tmf_bias | mf_headwt | mf_loc | mf_freq | "
                         "dropoutmf[_ordered|_onlyordered] | "
                         "bpr | bprPoissonDropout | "
                         "increment (increment needs --graphmat as "
                         "the probe set; mf_headwt/mf_loc/mf_freq/"
                         "tmf_bias/dropoutmf = othersrc ModelMFWt "
                         "head-item down-weighting / ModelMFLoc tail "
                         "half-rank / ModelMFFreq head-first "
                         "curriculum / ModelDropoutMFBias / "
                         "ModelDropoutMF soft three-tier adaptive rank)")
    ap.add_argument("--mf_method", default="sgd",
                    help="sgd|sgdpar|sgdparsvd|sgdu|hogsgd|blocksgd|"
                         "densesgd|als|"
                         "ialspp|alsdense|ccd|ccd++|ccd++freqadap|auto "
                         "(auto = measured TPU-first choice, PERF.md). "
                         "For --algo bpr*: train|hog|posneg|sigmoid|auto "
                         "(train/hog = stream + HR selection, posneg = "
                         "per-user pos/neg pairs + NDCG selection, "
                         "sigmoid = deterministic-rank BPRPoisson)")
    ap.add_argument("--maxiter", type=int, default=1000)
    ap.add_argument("--facdim", type=int, default=10)
    ap.add_argument("--svdfacdim", type=int, default=10)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--ureg", type=float, default=0.01)
    ap.add_argument("--ireg", type=float, default=0.01)
    ap.add_argument("--learnrate", type=float, default=0.005)
    ap.add_argument("--rhorms", type=float, default=1.0)
    ap.add_argument("--alpha", type=float, default=0.0)
    ap.add_argument("--regexponent", type=float, default=0.0,
                    help="frequency-scaled regularization: per-entity "
                         "lambda = reg * freq^e (0 = flat; othersrc "
                         "WtReg / iALS scaled-lambda)")
    ap.add_argument("--trainmat", required=True)
    ap.add_argument("--testmat", required=True)
    ap.add_argument("--valmat", required=True)
    ap.add_argument("--graphmat", default=None)
    ap.add_argument("--origufac", default=None)
    ap.add_argument("--origifac", default=None)
    ap.add_argument("--initufac", default=None)
    ap.add_argument("--initifac", default=None)
    ap.add_argument("--prefix", default="mf")
    # execution extras (no gflags analog)
    ap.add_argument("--batchsize", type=int, default=16384)
    ap.add_argument("--bprsampler", default="rankgap",
                    choices=["rankgap", "gap"],
                    help="BPR negative sampler (PERF.md 'BPR pairwise')")
    ap.add_argument("--bprtries", type=int, default=2,
                    help="BPR sampler tries per positive (failures "
                         "drop with weight 0)")
    ap.add_argument("--bprengine", default="stream",
                    choices=["stream", "dense"],
                    help="BPR epoch engine (dense = stripe score "
                         "panels, solvers/bpr_dense.py)")
    ap.add_argument("--ccdgroup", type=int, default=1,
                    help="CCD++ rank-g block sweeps (g dims solved "
                         "jointly; README deviation #14)")
    ap.add_argument("--svdinit", action="store_true",
                    help="initialize factors from truncated SVD")
    ap.add_argument("--quartiles", action="store_true", default=True)
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU backend")
    ap.add_argument("--resume", action="store_true",
                    help="continue from {prefix}_loop.npz if present "
                         "(bit-exact resume incl. PRNG key chain)")
    ap.add_argument("--mode", default="train",
                    choices=["train", "analyze"],
                    help="analyze = offline analysis of saved factors "
                         "(computeSampTopNFrmFullModel path, "
                         "main.cpp:75-396)")
    return ap


def params_from_args(args) -> Params:
    """Params of the parsed flags, built as the JAX CLI builds them."""
    return Params(
        fac_dim=args.facdim, max_iter=args.maxiter,
        svd_fac_dim=args.svdfacdim, seed=args.seed, u_reg=args.ureg,
        i_reg=args.ireg, learn_rate=args.learnrate, rho_rms=args.rhorms,
        alpha=args.alpha, reg_exponent=args.regexponent,
        train_mat_file=args.trainmat,
        test_mat_file=args.testmat, val_mat_file=args.valmat,
        graph_mat_file=args.graphmat, orig_u_fac_file=args.origufac,
        orig_i_fac_file=args.origifac, init_u_fac_file=args.initufac,
        init_i_fac_file=args.initifac, prefix=args.prefix,
        batch_size=args.batchsize, bpr_sampler=args.bprsampler,
        n_negatives=args.bprtries, bpr_engine=args.bprengine,
        ccd_group_dims=args.ccdgroup)


def _run_analyze(args, params, data, device) -> int:
    """Offline analysis (computeSampTopNFrmFullModel, main.cpp:75-396):
    load trained factors (--initufac/--initifac), optional ground truth
    (--origufac/--origifac), run freq-RMSE sweeps, top-bucket curves and
    the PPR/GPR comparison on ``device``; the JAX CLI's lines."""
    import numpy as np

    from matfac_tpu_torch.analysis.drivers import (compare_ppr_gpr,
                                                   sample_top_n_analysis)
    from matfac_tpu_torch.data.io import item_cosine_sim, read_factor_mat
    from matfac_tpu_torch.eval.metrics import Evaluator
    from matfac_tpu_torch.models.base import EvalView
    from matfac_tpu_torch.ops.ppr import PPREngine
    from matfac_tpu_torch.ops.svd_init import svd_init
    from matfac_tpu_torch.utils import freq as ufreq

    if not (args.initufac and args.initifac):
        raise SystemExit("--mode analyze needs --initufac/--initifac "
                         "(the trained factors)")
    inval_u, inval_i = ufreq.invalid_users_items(
        data.train_mat, data.n_users, data.n_items)
    ev = Evaluator(data, inval_u, inval_i, params, device=device)

    def view_of(u, i):
        f32 = dict(dtype=torch.float32, device=device)
        return EvalView(torch.as_tensor(u, **f32), torch.as_tensor(i, **f32),
                        torch.zeros(data.n_users, **f32),
                        torch.zeros(data.n_items, **f32),
                        torch.zeros((), **f32))

    full = view_of(read_factor_mat(args.initufac, data.n_users,
                                   params.fac_dim),
                   read_factor_mat(args.initifac, data.n_items,
                                   params.fac_dim))
    print(f"Loaded model: Train RMSE {ev.rmse(full, 'train'):.6f} "
          f"Test RMSE {ev.rmse(full, 'test'):.6f}")

    orig = full
    if data.orig_u_fac is not None and data.orig_i_fac is not None:
        orig = view_of(data.orig_u_fac, data.orig_i_fac)
        print(f"fullLowRankErr vs ground truth: "
              f"{ev.full_low_rank_err(full, data.orig_u_fac, data.orig_i_fac):.6f}")

    su, sv, _ = svd_init(data.train_mat, params.svd_fac_dim,
                         sparsity_only=True, device=device)
    svd_view = view_of(su, sv)
    if data.graph_mat is not None:
        eng = PPREngine(data.graph_mat, device=device)
    else:
        eng = PPREngine(item_cosine_sim(data.train_mat, top_k=50,
                                        device=device), device=device)
    rep = sample_top_n_analysis(full, orig, ev, data, inval_u, inval_i,
                                svd_view=svd_view, ppr_engine=eng,
                                n_users=min(200, data.n_users),
                                seed=params.seed)
    print("Freq-RMSE sweep (top-p items): ")
    for p, (cnt, rmse) in rep["freq_rmse_sweep"].items():
        print(f"  top {p:.0%}: n={cnt} rmse={rmse:.6f}")
    print("Per-user bucket RMSE curves (bucket 0 = top-scored):")
    for name, curve in rep["bucket_curves"].items():
        print(f"  {name}: " + " ".join(f"{x:.4f}" for x in curve))
    users = np.random.default_rng(params.seed).choice(
        data.n_users, size=min(50, data.n_users), replace=False)
    ov = compare_ppr_gpr(eng, data.train_mat, users)
    print(f"PPR-vs-GPR top-100 mean overlap: {ov['mean_overlap']:.4f}")
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.cpu:
        device = "cpu"
    elif torch.cuda.is_available():
        device = "cuda"
    else:
        raise RuntimeError("no CUDA device is visible: the CLI runs on the "
                           "card, or on the CPU with --cpu")
    params = params_from_args(args)
    print(params.display())

    from matfac_tpu_torch.data.dataset import Data
    from matfac_tpu_torch.data.io import read_factor_mat
    from matfac_tpu_torch.models.base import (init_state, state_from_numpy,
                                              state_to_numpy)
    from matfac_tpu_torch.train.loop import _pad_rows, train_model

    data = Data(params)
    print(data)

    if args.mode == "analyze":
        return _run_analyze(args, params, data, device)

    init_override = None
    if (args.initufac and args.initifac) or args.svdinit:
        st = init_state(params, data.n_users, data.n_items, device=device)
        _, _, u_bias, i_bias, mu = state_to_numpy(st)
        if args.initufac and args.initifac:
            u = read_factor_mat(args.initufac, data.n_users, params.fac_dim)
            v = read_factor_mat(args.initifac, data.n_items, params.fac_dim)
        else:
            from matfac_tpu_torch.ops.svd_init import svd_init
            u, v, _ = svd_init(data.train_mat, params.fac_dim, device=device)
            u = _pad_rows(u, data.n_users)
            v = _pad_rows(v, data.n_items)
        init_override = state_from_numpy(u, v, u_bias, i_bias, mu,
                                         device=device)

    report, model, ev, (inval_u, inval_i) = train_model(
        data, params, algo=args.algo, mf_method=args.mf_method,
        init_state_override=init_override, prefix=args.prefix,
        resume=args.resume, device=device)

    view = model.eval_view(report.best_state)
    if getattr(model, "is_ranking", False):
        scorer = ev  # the ranking trainer returns its CatalogScorer
        print(f"\nBest val HR@10: {report.best_metric:.6f}")
        print(f"Test HR@10: "
              f"{scorer.hit_rate(view, data.test_mat, 10):.6f}")
        print(f"Test ARHR: {scorer.arhr(view, data.test_mat):.6f}")
    else:
        # the final RMSE report (main.cpp:1377-1382)
        print(f"\nRE Train RMSE: {ev.rmse(view, 'train'):.6f}")
        print(f"RE Test RMSE: {ev.rmse(view, 'test'):.6f}")
        print(f"RE Val RMSE: {ev.rmse(view, 'val'):.6f}")
        if args.quartiles:
            from matfac_tpu_torch.eval.quartile import quartile_report
            print(quartile_report(view, data, ev, inval_u, inval_i))
        inc = getattr(report, "increment", None)
        if inc is not None:
            print(f"increment ranks: user mean {inc.rank_u.mean():.2f} "
                  f"max {int(inc.rank_u.max())} | item mean "
                  f"{inc.rank_i.mean():.2f} max {int(inc.rank_i.max())}")
    print(f"stop: {report.stop_reason} best_iter: {report.best_iter}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
