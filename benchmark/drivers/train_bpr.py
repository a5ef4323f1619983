"""Jobs of ``TrainLoopHR.run`` on a BPR configuration, as
``train_model(algo="bpr")`` builds them: the stream engine with its
sampler, val HR@10 every ``obj_iter`` epochs, the learn rate decaying by
0.9 an epoch.

Set-up: the positives made on the card, their host CSR, then
``train_model`` for ``warmup_epochs``; the window runs the same solver,
scorer and model through a ``TrainLoopHR``."""

from __future__ import annotations

import time

import torch

from benchmark import harness, roofline
from benchmark.drivers import _training


def hyper(cell) -> dict:
    cfg = cell.config
    return dict(k=cfg["fac_dim"], u_reg=cfg["u_reg"], i_reg=cfg["i_reg"],
                lr=cfg["learn_rate"], batch_size=cfg["batch_size"],
                n_tries=cfg["n_negatives"], obj_iter=cfg["obj_iter"])


def run(cell, seed: int, seconds: float, trace: bool, device, t0: float,
        dtype=torch.float32):
    from matfac_tpu_torch.config import Params
    from matfac_tpu_torch.train.loop import TrainLoopHR, train_model

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
                    batch_size=hp["batch_size"], n_negatives=hp["n_tries"],
                    bpr_sampler=cfg["bpr_sampler"],
                    bpr_engine=cfg["bpr_engine"])
    rep, model, scorer, _ = train_model(
        data, params, algo=cfg["algo"], mf_method=tr["mf_method"],
        log_fn=harness.quiet,
        init_state_override=harness.job_state(nu, ni, k, seed, -1, device),
        device=device)
    solver = rep.solver
    harness.log(f"set-up: staged and warmed at {time.perf_counter() - t0:.3f}"
                " s")
    loop = TrainLoopHR(model, solver, scorer, data.val_mat,
                       params.replace(max_iter=tr["epochs_per_job"]),
                       log_fn=harness.quiet)
    n_pairs = int(solver.n_pos)
    w = _training.window(cell, loop, solver, seed, seconds, trace, device,
                         t0, (nu, ni, k), [(scorer, "hit_rate", "hr10")],
                         loss_of=lambda: solver.last_loss,
                         dtype=dtype)
    del rep, model, scorer, loop, solver, data
    work = roofline.bpr_epoch_work(n_pairs, nu, ni, k)
    inputs = _training.reference_inputs(bundle, w, seed,
                                        tr["warmup_epochs"])
    ref = _training.run_reference(cell, inputs, hp, device)
    return _training.finish(cell, w, "pairs", n_pairs, work, inputs, ref,
                            hr=True)
