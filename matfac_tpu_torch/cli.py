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
``--mode analyze`` is not ported (ROADMAP queue 1, item 15).
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
    if args.mode == "analyze":
        raise NotImplementedError(
            "--mode analyze (the analysis stack, analysis/*, ops/ppr.py, "
            "tools.py) is ROADMAP queue 1, item 15")

    from matfac_tpu_torch.data.dataset import Data
    from matfac_tpu_torch.data.io import read_factor_mat
    from matfac_tpu_torch.models.base import (init_state, state_from_numpy,
                                              state_to_numpy)
    from matfac_tpu_torch.train.loop import _pad_rows, train_model

    data = Data(params)
    print(data)

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
