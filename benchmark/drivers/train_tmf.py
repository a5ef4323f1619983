"""Jobs of ``TrainLoop.run`` on TMF+Dropout, as ``train_model(algo=
"tmfdropout", mf_method)`` builds them: the masked row-stripe engine
(``BlockSGDSolver(engine="dense")`` with its ranks redrawn at every stripe
visit), checks (objective, val RMSE on the inference-truncated view) every
``obj_iter`` epochs. ``train_mf``'s jobs, with the configuration's rho_rms
and alpha in ``Params``, a run that fails where ``train_model`` fell back
from the Poisson row-stripe engine, and the masked work count
(``benchmark/masked_work.py``)."""

from __future__ import annotations

import time

import torch

from benchmark import harness, masked_work
from benchmark.drivers import _training, train_mf


def hyper(cell) -> dict:
    cfg = cell.config
    return dict(train_mf.hyper(cell), rho_rms=cfg["rho_rms"],
                alpha=cfg["alpha"])


def run(cell, seed: int, seconds: float, trace: bool, device, t0: float,
        dtype=torch.float32):
    from matfac_tpu_torch.config import Params
    from matfac_tpu_torch.solvers.block_sgd import BlockSGDSolver
    from matfac_tpu_torch.train.loop import TrainLoop, train_model

    cfg, tr = cell.config, cell.traffic
    hp = hyper(cell)
    bundle = cell.module("data", cfg["generator"]).make(cfg, seed, device)
    nu, ni, k = bundle["n_users"], bundle["n_items"], hp["k"]
    harness.log(f"set-up: inputs made at {time.perf_counter() - t0:.3f} s")
    data = harness.port_data(bundle)
    harness.log(f"set-up: host CSR at {time.perf_counter() - t0:.3f} s")
    params = Params(fac_dim=k, u_reg=hp["u_reg"], i_reg=hp["i_reg"],
                    learn_rate=hp["lr"], seed=seed,
                    max_iter=tr["warmup_epochs"], obj_iter=hp["obj_iter"],
                    disp_iter=10 ** 9, save_iter=10 ** 9,
                    batch_size=hp["batch_size"], rho_rms=hp["rho_rms"],
                    alpha=hp["alpha"])
    rep, model, ev, (iu, ii) = train_model(
        data, params, algo=cfg["algo"], mf_method=tr["mf_method"],
        log_fn=harness.quiet,
        init_state_override=harness.job_state(nu, ni, k, seed, -1, device),
        device=device)
    solver = rep.solver
    if not (isinstance(solver, BlockSGDSolver) and solver.engine == "dense"
            and getattr(solver, "pois_cdf", None) is not None):
        raise RuntimeError(f"{cell.name}: train_model fell back from the "
                           f"Poisson row-stripe engine to "
                           f"{type(solver).__name__}")
    harness.log(f"set-up: staged and warmed at {time.perf_counter() - t0:.3f}"
                " s")
    loop = TrainLoop(model, solver, ev,
                     params.replace(max_iter=tr["epochs_per_job"]),
                     invalid_users=iu, invalid_items=ii,
                     log_fn=harness.quiet)
    n_ratings = int(solver.nnz)
    w = _training.window(cell, loop, solver, seed, seconds, trace, device,
                         t0, (nu, ni, k),
                         [(ev, "objective", "objective"),
                          (ev, "rmse", "rmse")], dtype=dtype)
    del rep, model, ev, loop, solver, data
    ref_mod = cell.module("reference", tr["reference"])
    lam_u, lam_i, C, _ = ref_mod.tables(bundle["train"], nu, ni, k,
                                        hp["rho_rms"], hp["alpha"])
    rows, cols, _ = bundle["train"]
    flops, nbytes, dims = masked_work.tmf_epoch_work(
        torch.minimum(lam_u[rows], lam_i[cols]), lam_u, ni, k, C)
    share = dims / (n_ratings * k)
    harness.log(f"expected rank share {share:.6f} (sum of E[r] {dims:.6g} "
                f"over {n_ratings} ratings x k {k})")
    inputs = _training.reference_inputs(bundle, w, seed,
                                        tr["warmup_epochs"])
    ref = _training.run_reference(cell, inputs, hp, device)
    out = _training.finish(cell, w, "ratings", n_ratings, (flops, nbytes),
                           inputs, ref)
    out["record"].update(k=k, expected_rank_share=share)
    return out
