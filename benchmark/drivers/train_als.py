"""Jobs of ``TrainLoop.run`` on plain MF by bucketed ALS, as
``train_model(algo="mf", mf_method="als")`` builds it (what ``auto``
resolves to for plain MF): ``ALSSolver`` with exact Cholesky solves
(``cg_iters`` 0), checks (objective, val RMSE) every ``obj_iter`` epochs.
``train_mf``'s jobs with ALS's rate and work: the rate counts the train
ratings of valid rows, worked out from the data made here, and the work is
``benchmark/als_work.py``'s. ALS takes no step: the loop's default learn
rate is passed and ignored.

Set-up: the ratings made on the card, their host CSR, then
``train_model`` for ``warmup_epochs`` (the degree buckets staged, every
chunk's shapes run once); the window runs the same solver, evaluator and
model through a ``TrainLoop``."""

from __future__ import annotations

import collections
import time

import torch

from benchmark import als_work, harness
from benchmark.drivers import _training
from benchmark.reference import _eval


def hyper(cell) -> dict:
    cfg = cell.config
    return dict(k=cfg["fac_dim"], u_reg=cfg["u_reg"], i_reg=cfg["i_reg"],
                obj_iter=cfg["obj_iter"])


def run(cell, seed: int, seconds: float, trace: bool, device, t0: float,
        dtype=torch.float32):
    from matfac_tpu_torch.config import Params
    from matfac_tpu_torch.solvers.als import ALSSolver
    from matfac_tpu_torch.train.loop import TrainLoop, train_model

    cfg, tr = cell.config, cell.traffic
    hp = hyper(cell)
    bundle = cell.module("data", cfg["generator"]).make(cfg, seed, device)
    nu, ni, k = bundle["n_users"], bundle["n_items"], hp["k"]
    harness.log(f"set-up: inputs made at {time.perf_counter() - t0:.3f} s")
    data = harness.port_data(bundle)
    harness.log(f"set-up: host CSR at {time.perf_counter() - t0:.3f} s")
    params = Params(fac_dim=k, u_reg=hp["u_reg"], i_reg=hp["i_reg"],
                    seed=seed, max_iter=tr["warmup_epochs"],
                    obj_iter=hp["obj_iter"], disp_iter=10 ** 9,
                    save_iter=10 ** 9)
    rep, model, ev, (iu, ii) = train_model(
        data, params, algo=cfg["algo"], mf_method=tr["mf_method"],
        log_fn=harness.quiet,
        init_state_override=harness.job_state(nu, ni, k, seed, -1, device),
        device=device)
    solver = rep.solver
    if type(solver) is not ALSSolver or solver.cg_iters != 0:
        raise RuntimeError(f"{cell.name}: train_model built "
                           f"{type(solver).__name__} (cg_iters "
                           f"{getattr(solver, 'cg_iters', None)}), not "
                           "ALSSolver with exact solves")
    harness.log(f"set-up: staged and warmed at {time.perf_counter() - t0:.3f}"
                " s")
    loop = TrainLoop(model, solver, ev,
                     params.replace(max_iter=tr["epochs_per_job"]),
                     invalid_users=iu, invalid_items=ii,
                     log_fn=harness.quiet)
    # each job's end: its epochs done, or the loop's own rules
    stops = collections.Counter()
    loop_run = loop.run
    loop.run = lambda state: stops.update([loop_run(state).stop_reason])
    rows, cols, _ = bundle["train"]
    vu, vi = _eval.valid(bundle["train"], nu, ni)
    n_ratings = int((vu[rows] & vi[cols]).sum())
    w = _training.window(cell, loop, solver, seed, seconds, trace, device,
                         t0, (nu, ni, k),
                         [(ev, "objective", "objective"),
                          (ev, "rmse", "rmse")], dtype=dtype)
    harness.log(f"jobs ended: {dict(stops)} (the last cut by the window)")
    del rep, model, ev, loop, loop_run, solver, data
    work = als_work.als_epoch_work(n_ratings, int(vu.sum()), int(vi.sum()),
                                   k)
    inputs = _training.reference_inputs(bundle, w, seed,
                                        tr["warmup_epochs"])
    ref = _training.run_reference(cell, inputs, hp, device)
    return _training.finish(cell, w, "ratings", n_ratings, work, inputs, ref)
