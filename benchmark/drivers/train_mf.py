"""Jobs of ``TrainLoop.run`` on a plain-MF configuration, as
``train_model(algo, mf_method)`` builds them: the traffic's engine
(``mf_method``, its learn rate and batch), checks (objective, val RMSE)
every ``obj_iter`` epochs.

Set-up: the ratings made on the card, their host CSR, then
``train_model`` for ``warmup_epochs`` (the engine staged, its kernels
built, every shape of the window run once); the window runs the same
solver, evaluator and model through a ``TrainLoop``."""

from __future__ import annotations

import time

import torch

from benchmark import harness, roofline
from benchmark.drivers import _training


def hyper(cell) -> dict:
    cfg, tr = cell.config, cell.traffic
    return dict(k=cfg["fac_dim"], u_reg=cfg["u_reg"], i_reg=cfg["i_reg"],
                lr=tr["learn_rate"], batch_size=tr.get("batch_size", 16384),
                obj_iter=cfg["obj_iter"])


def run(cell, seed: int, seconds: float, trace: bool, device, t0: float,
        dtype=torch.float32):
    from matfac_tpu_torch.config import Params
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
                    batch_size=hp["batch_size"])
    rep, model, ev, (iu, ii) = train_model(
        data, params, algo=cfg["algo"], mf_method=tr["mf_method"],
        log_fn=harness.quiet,
        init_state_override=harness.job_state(nu, ni, k, seed, -1, device),
        device=device)
    solver = rep.solver
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
    work = roofline.mf_epoch_work(n_ratings, nu, ni, k)
    inputs = _training.reference_inputs(bundle, w, seed,
                                        tr["warmup_epochs"])
    ref = _training.run_reference(cell, inputs, hp, device)
    return _training.finish(cell, w, "ratings", n_ratings, work, inputs, ref)
