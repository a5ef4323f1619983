"""The training loop and its front door (port of matfac_tpu/train/loop.py
for plain MF on the row-dense engine).

Termination is Model::isTerminateModel (model.cpp:1471-1540):

  * every OBJ_ITER epochs compute objective(train) and RMSE(val);
  * NaN in either -> if lr > 1e-5: restore the best snapshot, halve lr,
    continue; else stop;
  * val RMSE improved -> snapshot the best model;
  * >= 100 epochs without improvement -> halve lr (every check, while
    lr > 1e-5);
  * >= CHANCE_ITER epochs without improvement -> stop ("NOT CONVERGED");
  * |prevObj - currObj| < EPS -> stop ("converged").

Best-on-validation is what gets checkpointed (modelMF.cpp:135-146).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from matfac_tpu.config import Params
from matfac_tpu.utils import freq as ufreq
from matfac_tpu_torch.eval.metrics import Evaluator
from matfac_tpu_torch.models.base import MFState, ModelMF, init_state
from matfac_tpu_torch.solvers.block_sgd import BlockSGDSolver
from matfac_tpu_torch.train import checkpoint as ckpt


@dataclasses.dataclass
class EpochLog:
    epoch: int
    objective: float
    val_rmse: float
    lr: float
    seconds: float


@dataclasses.dataclass
class TrainReport:
    state: MFState               # final running state
    best_state: MFState          # best-on-validation snapshot
    best_metric: float           # val RMSE
    best_iter: int
    stop_reason: str
    history: List[EpochLog]
    solver: object = None        # the solver that trained (train_model)


def _snapshot(state: MFState) -> MFState:
    # the solver's views are fresh tensors each epoch, but the resident
    # tables are updated in place: snapshots must be real copies
    return MFState(*(t.clone() for t in state))


def _sync(state: MFState) -> None:
    if state.u_fac.device.type == "cuda":
        torch.cuda.synchronize(state.u_fac.device)


class TrainLoop:
    def __init__(self, model, solver, evaluator: Evaluator, params: Params,
                 prefix: Optional[str] = None,
                 invalid_users: Optional[np.ndarray] = None,
                 invalid_items: Optional[np.ndarray] = None,
                 log_fn: Callable[[str], None] = print):
        self.model = model
        self.solver = solver
        self.ev = evaluator
        self.params = params
        self.prefix = prefix
        self.invalid_users = invalid_users
        self.invalid_items = invalid_items
        self.log_fn = log_fn

    def _objective(self, state: MFState) -> float:
        return self.ev.objective(self.model.eval_view(state), state,
                                 use_factors=self.model.use_factors,
                                 use_bias=self.model.use_bias)

    def run(self, state: MFState, resume: bool = False) -> TrainReport:
        """``resume=True`` with a prefix continues from the last loop
        checkpoint ({prefix}_loop.npz): epoch counter, lr, best state,
        the termination counters and the solver's stripe-order generator
        are restored, so the run continues exactly."""
        p = self.params
        lr = p.learn_rate
        best_iter = -1
        start_iter = 0
        history: List[EpochLog] = []
        stop = "max_iter"
        sig = (ckpt.model_signature(p, self.model.n_users,
                                    self.model.n_items)
               if self.prefix else None)
        loop_path = f"{self.prefix}_loop.npz" if self.prefix else None
        best_path = f"{self.prefix}_loop_best.npz" if self.prefix else None
        device = state.u_fac.device

        # a run killed between the loop.npz and best.npz writes restarts
        resuming = bool(resume and loop_path and os.path.exists(loop_path)
                        and os.path.exists(best_path))
        if resume and loop_path and os.path.exists(loop_path) \
                and not resuming:
            self.log_fn(f"resume requested but {best_path} is missing "
                        "(interrupted mid-save?) — starting fresh")
        if resuming:
            state, extra = ckpt.load_state(loop_path, device)
            best_state, _ = ckpt.load_state(best_path, device)
            lr = float(extra["lr"])
            best_val = float(extra["best_val"])
            best_iter = int(extra["best_iter"])
            prev_obj = float(extra["prev_obj"])
            start_iter = int(extra["epoch"]) + 1
            if hasattr(self.solver, "set_internal_state"):
                self.solver.set_internal_state(
                    {k[len("solver__"):]: v for k, v in extra.items()
                     if k.startswith("solver__")})
            self.log_fn(f"resumed from {loop_path} at epoch {start_iter}")
        else:
            best_state = _snapshot(state)
            prev_obj = self._objective(state)
            best_val = self.ev.rmse(self.model.eval_view(state), "val")

        for it in range(start_iter, p.max_iter):
            t0 = time.perf_counter()
            state = self.solver.epoch(state, lr)
            _sync(state)   # honest epoch timing
            dt = time.perf_counter() - t0

            if it % p.obj_iter == 0 or it == p.max_iter - 1:
                view = self.model.eval_view(state)
                obj = self._objective(state)
                val = self.ev.rmse(view, "val")

                # NaN rollback (model.cpp:1487-1498)
                if not (np.isfinite(obj) and np.isfinite(val)):
                    if lr > 1e-5:
                        self.log_fn(f"epoch {it}: non-finite obj/val — "
                                    f"rollback to best, lr {lr} -> {lr/2}")
                        state = _snapshot(best_state)
                        lr /= 2
                        continue
                    stop = "nan_at_min_lr"
                    break

                if val < best_val:
                    best_state = _snapshot(state)
                    best_val = val
                    best_iter = it

                if it - best_iter >= 100 and lr > 1e-5:
                    lr /= 2

                if it - best_iter >= p.chance_iter:
                    stop = "not_converged_chance_iter"
                    break

                converged = abs(prev_obj - obj) < p.eps
                prev_obj = obj

                history.append(EpochLog(it, obj, val, lr, dt))
                if it % p.disp_iter == 0:
                    self.log_fn(
                        f"epoch {it}: obj {obj:.6e} val_rmse {val:.6f} "
                        f"lr {lr:g} {dt*1000:.1f}ms")

                if self.prefix and (it % p.save_iter == 0
                                    or it == p.max_iter - 1):
                    ckpt.save_facs(best_state, self.prefix, sig)
                    solver_extra = {}
                    if hasattr(self.solver, "internal_state"):
                        solver_extra = {
                            "solver__" + k: np.asarray(v) for k, v in
                            self.solver.internal_state().items()}
                    ckpt.save_state(loop_path, state,
                                    epoch=np.int64(it), lr=np.float64(lr),
                                    best_val=np.float64(best_val),
                                    best_iter=np.int64(best_iter),
                                    prev_obj=np.float64(prev_obj),
                                    **solver_extra)
                    ckpt.save_state(best_path, best_state)

                if converged:
                    stop = "converged"
                    break

        if self.prefix:
            ckpt.save_facs(best_state, self.prefix, sig)
            if self.invalid_users is not None:
                ckpt.save_invalid(self.prefix, self.invalid_users,
                                  self.invalid_items)
        return TrainReport(state, best_state, best_val, best_iter, stop,
                           history)


# ----------------------------------------------------------------------
# one-call front door
# ----------------------------------------------------------------------

def train_model(data, params: Params, algo: str = "mf",
                mf_method: str = "densesgd", log_fn=print,
                init_state_override: Optional[MFState] = None,
                prefix: Optional[str] = None, mesh=None,
                resume: bool = False, device="cuda"):
    """Build model + solver and train; the JAX package's front door for
    the slice ported so far: ``algo="mf"`` with ``mf_method="densesgd"``.
    Everything else raises NotImplementedError naming its ROADMAP item.
    Returns (report, model, evaluator, (invalid_users, invalid_items))."""
    a, m = algo.lower(), mf_method.lower()
    if mesh is not None:
        raise NotImplementedError(
            "mesh training is ROADMAP queue 1, item 13")
    if a != "mf":
        raise NotImplementedError(
            f"algo={algo!r}: only plain MF is ported (long-tail models are "
            "ROADMAP queue 1, item 7; BPR item 11; othersrc variants "
            "item 14)")
    if m == "auto":
        raise NotImplementedError(
            "mf_method='auto' resolves to ALS for plain MF, which is "
            "ROADMAP queue 1, item 10 — pass mf_method='densesgd'")
    if m != "densesgd":
        raise NotImplementedError(
            f"mf_method={mf_method!r}: only 'densesgd' is ported (sgd and "
            "blocksgd are ROADMAP queue 1, item 9; ALS item 10; CCD/CCD++ "
            "item 12)")

    inval_u, inval_i = ufreq.invalid_users_items(
        data.train_mat, data.n_users, data.n_items)
    model = ModelMF(params, data.n_users, data.n_items)
    try:
        solver = BlockSGDSolver(model, params, data.train_mat, inval_u,
                                inval_i, bu=None, bi=None, device=device)
    except ValueError as e:
        # the JAX front door falls back to blocksgd here
        raise NotImplementedError(
            f"densesgd unavailable ({e}); the blocksgd fallback is "
            "ROADMAP queue 1, item 9") from e
    ev = Evaluator(data, inval_u, inval_i, params, device)
    state = init_state_override or init_state(
        params, data.n_users, data.n_items, device=device)
    loop = TrainLoop(model, solver, ev, params, prefix=prefix,
                     invalid_users=inval_u, invalid_items=inval_i,
                     log_fn=log_fn)
    report = loop.run(state, resume=resume)
    report.solver = solver
    return report, model, ev, (inval_u, inval_i)
