"""The training loops and their front door (port of matfac_tpu/train/loop.py
for plain MF, IFWMF and TMF on the one-hot cell engine, plain MF on the
row-dense engine, and plain BPR).

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
``TrainLoopHR`` is the ranking counterpart (Model::isTerminateModelHR).
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
from matfac_tpu_torch.eval.ranking import CatalogScorer
from matfac_tpu_torch.models.base import MFState, ModelMF, init_state
from matfac_tpu_torch.models.bpr import ModelMFBPR
from matfac_tpu_torch.models.longtail import (ModelDropoutSigmoid,
                                              ModelInvPopMF)
from matfac_tpu_torch.solvers.block_sgd import BlockSGDSolver
from matfac_tpu_torch.solvers.bpr import BPRSolver
from matfac_tpu_torch.train import checkpoint as ckpt


@dataclasses.dataclass
class EpochLog:
    epoch: int
    objective: float
    val_rmse: float      # the selection metric (val HR@10 in TrainLoopHR)
    train_rmse: float    # nan unless the loop tracks it
    lr: float
    seconds: float


@dataclasses.dataclass
class TrainReport:
    state: MFState               # final running state
    best_state: MFState          # best-on-validation snapshot
    best_metric: float   # val RMSE (TrainLoop) or val HR@10 (TrainLoopHR)
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
                 log_fn: Callable[[str], None] = print,
                 track_train_rmse: bool = False):
        self.model = model
        self.solver = solver
        self.ev = evaluator
        self.params = params
        self.prefix = prefix
        self.invalid_users = invalid_users
        self.invalid_items = invalid_items
        self.log_fn = log_fn
        self.track_train_rmse = track_train_rmse
        # IFWMF weights its objective (modelInvPopMF.cpp:22-32)
        w = model.example_weight(evaluator.train_coo.rows,
                                 evaluator.train_coo.cols)
        self.obj_weights = None if bool((w == 1.0).all()) else w

    def _objective(self, state: MFState) -> float:
        return self.ev.objective(self.model.eval_view(state), state,
                                 self.obj_weights,
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

                tr_rmse = (self.ev.rmse(view, "train")
                           if self.track_train_rmse else float("nan"))
                history.append(EpochLog(it, obj, val, tr_rmse, lr, dt))
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


class TrainLoopHR:
    """Ranking-model training loop: model selection on validation HR@10.

    Model::isTerminateModelHR (model.cpp:1335-1377) around
    ModelMFBPR::train's epoch structure (modelMFBPR.cpp:469-554): lr
    decays x0.9 every epoch, best snapshot on an HR improvement, halving
    after 100 stagnant epochs, CHANCE_ITER give-up, a stop on a non-finite
    loss. ``EpochLog.objective`` holds the epoch's BPR loss and
    ``val_rmse`` the selection metric."""

    def __init__(self, model, solver, scorer, val_mat, params: Params,
                 log_fn: Callable[[str], None] = print,
                 metric_fn: Optional[Callable] = None,
                 prefix: Optional[str] = None,
                 invalid_users: Optional[np.ndarray] = None,
                 invalid_items: Optional[np.ndarray] = None):
        """``metric_fn(view) -> float`` (higher = better) overrides val
        HR@10, e.g. NDCG for trainHog / trainHogPosNeg
        (modelMFBPR.cpp:633, isTerminateModelNDCG model.cpp:1379).
        ``prefix`` enables TrainLoop's checkpoint protocol (bestModel,
        model.cpp:89-101)."""
        self.model = model
        self.solver = solver
        self.scorer = scorer
        self.val_mat = val_mat
        self.params = params
        self.log_fn = log_fn
        self.prefix = prefix
        self.invalid_users = invalid_users
        self.invalid_items = invalid_items
        self.metric_fn = metric_fn or (
            lambda view: self.scorer.hit_rate(view, self.val_mat, 10))

    def run(self, state: MFState, resume: bool = False) -> TrainReport:
        """``resume=True`` with a prefix continues exactly from the last
        {prefix}_loop.npz: epoch counter, decayed lr, best HR and
        snapshot, the solver's generator state and its last loss and
        inversions."""
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
            best_hr = float(extra["best_hr"])
            best_iter = int(extra["best_iter"])
            start_iter = int(extra["epoch"]) + 1
            self.solver.set_internal_state(
                {k[len("solver__"):]: v for k, v in extra.items()
                 if k.startswith("solver__")})
            self.solver.last_loss = torch.tensor(
                float(extra["last_loss"]), device=device)
            self.solver.last_inversions = torch.tensor(
                int(extra["last_inversions"]), device=device)
            self.log_fn(f"resumed from {loop_path} at epoch {start_iter}")
        else:
            best_state = _snapshot(state)
            best_hr = self.metric_fn(self.model.eval_view(state))

        for it in range(start_iter, p.max_iter):
            t0 = time.perf_counter()
            state = self.solver.epoch(state, lr)
            _sync(state)
            dt = time.perf_counter() - t0
            loss = float(self.solver.last_loss)
            if not np.isfinite(loss):
                # the reference exits hard (modelMFBPR.cpp:527-530)
                self.log_fn(f"epoch {it}: non-finite BPR loss {loss} — "
                            "stopping (decrease learn rate)")
                stop = "nonfinite_loss"
                break
            lr *= 0.9  # modelMFBPR.cpp:533

            if it % p.obj_iter == 0 or it == p.max_iter - 1:
                hr = self.metric_fn(self.model.eval_view(state))
                if hr > best_hr:
                    best_state = _snapshot(state)
                    best_hr = hr
                    best_iter = it
                if it - best_iter >= 100 and lr > 1e-5:
                    lr /= 2
                if it - best_iter >= p.chance_iter:
                    stop = "not_converged_chance_iter"
                    break
                history.append(EpochLog(it, loss, hr, float("nan"), lr, dt))
                if it % p.disp_iter == 0:
                    self.log_fn(
                        f"epoch {it}: HR {hr:.4f} best {best_hr:.4f} "
                        f"loss {loss:.4e} inversions "
                        f"{int(self.solver.last_inversions)} "
                        f"lr {lr:g} {dt*1000:.1f}ms")

                if self.prefix and (it % p.save_iter == 0
                                    or it == p.max_iter - 1):
                    ckpt.save_facs(best_state, self.prefix, sig)
                    ckpt.save_state(
                        loop_path, state, epoch=np.int64(it),
                        lr=np.float64(lr), best_hr=np.float64(best_hr),
                        best_iter=np.int64(best_iter),
                        last_loss=np.float64(loss),
                        last_inversions=np.int64(
                            int(self.solver.last_inversions)),
                        **{"solver__" + k: np.asarray(v) for k, v in
                           self.solver.internal_state().items()})
                    ckpt.save_state(best_path, best_state)

        if self.prefix:
            ckpt.save_facs(best_state, self.prefix, sig)
            if self.invalid_users is not None:
                ckpt.save_invalid(self.prefix, self.invalid_users,
                                  self.invalid_items)
        return TrainReport(state, best_state, best_hr, best_iter, stop,
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
    the slices ported so far: ``algo`` "mf", "ifwmf" or "tmf" with
    ``mf_method="blocksgd"`` (the one-hot cell engine, diag schedule),
    "mf" with ``mf_method="densesgd"`` (the row-dense engine, falling back
    to blocksgd when its tiles miss the budget), and ``algo="bpr"`` (the
    pairwise stream or posneg engine with model selection on val HR@10,
    or NDCG for hog / posneg). Everything else raises NotImplementedError
    naming its ROADMAP item. Returns (report, model, evaluator or scorer,
    (invalid_users, invalid_items))."""
    a, m = algo.lower(), mf_method.lower()
    if mesh is not None:
        raise NotImplementedError(
            "mesh training is ROADMAP queue 1, item 13")
    if a in ("bprpoissondropout", "bpr_poisson", "tmfdropout"):
        raise NotImplementedError(
            f"algo={algo!r}: the Poisson-sampled TMF models are ROADMAP "
            "queue 1, item 7")
    inval_u, inval_i = ufreq.invalid_users_items(
        data.train_mat, data.n_users, data.n_items)
    if a == "bpr":
        if m == "auto":
            # ranking trains through the one pairwise engine; 'train'
            # (stream mode + HR selection) is the reference default
            m = "train"
            log_fn("mf_method=auto resolved to 'train' (BPR stream)")
        return _train_ranking(data, params, m, log_fn, init_state_override,
                              inval_u, inval_i, prefix, resume, device)
    if a == "mf_bias":
        raise NotImplementedError(
            "algo='mf_bias': bias models train through scatter SGD, "
            "ROADMAP queue 1, item 9")
    if a not in ("mf", "ifwmf", "tmf"):
        raise NotImplementedError(
            f"algo={algo!r}: the othersrc model variants are ROADMAP "
            "queue 1, item 14")
    user_freq, item_freq = ufreq.row_col_freq(data.train_mat)
    # zero-pad: entities seen only in test / val have zero train frequency
    user_freq = _pad_rows(user_freq, data.n_users)
    item_freq = _pad_rows(item_freq, data.n_items)
    if a == "ifwmf":
        model = ModelInvPopMF(params, data.n_users, data.n_items,
                              user_freq=user_freq, item_freq=item_freq,
                              invalid_users=inval_u, invalid_items=inval_i)
    elif a == "tmf":
        model = ModelDropoutSigmoid(params, data.n_users, data.n_items,
                                    user_freq=user_freq, item_freq=item_freq)
    else:
        model = ModelMF(params, data.n_users, data.n_items)
    if m == "auto":
        raise NotImplementedError(
            "mf_method='auto' resolves to ALS for plain MF (ROADMAP queue 1, "
            "item 10) and to densesgd for IFWMF / TMF, whose float-W and "
            "mask kernel instantiations are item 7 — pass "
            "mf_method='blocksgd' or 'densesgd'")
    if m not in ("densesgd", "blocksgd"):
        raise NotImplementedError(
            f"mf_method={mf_method!r}: only 'densesgd' and 'blocksgd' are "
            "ported (sgd is ROADMAP queue 1, item 9; ALS item 10; CCD/CCD++ "
            "item 12)")
    if m == "densesgd" and a != "mf":
        raise NotImplementedError(
            f"algo={algo!r} on densesgd needs the stripe kernel's float-W "
            "and mask instantiations, ROADMAP queue 1, item 7 — pass "
            "mf_method='blocksgd'")
    if params.reg_exponent:
        raise ValueError(
            f"reg_exponent is implemented for 'als' and the sgd engine, "
            f"not '{m}' — drop the exponent or switch method")

    # the one-hot cell engine as the JAX front door builds it: the DSGD
    # diag schedule, 384-blocks, at most 1024 ratings per lane and step
    # (JAX's pad_k=128 fills the TPU's matrix lanes; the port drops it)
    blocksgd = lambda: BlockSGDSolver(
        model, params, data.train_mat, inval_u, inval_i,
        batch_size=min(params.batch_size, 1024), bu=384, bi=384,
        schedule="diag", device=device)
    if m == "blocksgd":
        solver = blocksgd()
    else:
        try:
            solver = BlockSGDSolver(model, params, data.train_mat, inval_u,
                                    inval_i, engine="dense", bu=None,
                                    bi=None, device=device)
        except ValueError as e:
            # over-budget grids fall back rather than crash
            log_fn(f"densesgd unavailable ({e}); falling back to blocksgd")
            solver = blocksgd()
    ev = Evaluator(data, inval_u, inval_i, params, device)
    state = init_state_override or init_state(
        params, data.n_users, data.n_items, device=device)
    loop = TrainLoop(model, solver, ev, params, prefix=prefix,
                     invalid_users=inval_u, invalid_items=inval_i,
                     log_fn=log_fn)
    report = loop.run(state, resume=resume)
    report.solver = solver
    return report, model, ev, (inval_u, inval_i)


def _pad_rows(a: np.ndarray, n: int) -> np.ndarray:
    """Truncate or zero-pad (never tile) the leading axis to length n."""
    a = np.asarray(a)
    if a.shape[0] >= n:
        return a[:n]
    pad = [(0, n - a.shape[0])] + [(0, 0)] * (a.ndim - 1)
    return np.pad(a, pad)


def _train_ranking(data, params: Params, mf_method: str, log_fn,
                   init_state_override, inval_u, inval_i, prefix, resume,
                   device):
    """Plain BPR (the JAX ``_train_ranking``): 'hogposneg' / 'posneg'
    train in posneg mode, every other method in stream mode; 'hog',
    'hogposneg' and 'posneg' select on val NDCG@10 (trainHog /
    trainHogPosNeg, modelMFBPR.cpp:245-402, :633), the rest on val
    HR@10."""
    if getattr(params, "bpr_engine", "stream") == "dense":
        raise NotImplementedError(
            "bpr_engine='dense' (solvers/bpr_dense.py, stripe score "
            "panels) is ROADMAP queue 1, item 11")
    model = ModelMFBPR(params, data.n_users, data.n_items)
    mode = "posneg" if mf_method in ("hogposneg", "posneg") else "stream"
    solver = BPRSolver(model, params, data.train_mat, inval_u, inval_i,
                       n_tries=params.n_negatives, mode=mode,
                       sampler=params.bpr_sampler, device=device)
    scorer = CatalogScorer(data.train_mat, inval_u, inval_i, data.n_users,
                           data.n_items,
                           user_block=min(params.eval_user_block,
                                          _round_up_pow2(data.n_users)),
                           item_block=params.eval_item_block, device=device)
    state = init_state_override or init_state(
        params, data.n_users, data.n_items, device=device)
    metric_fn = None
    if mf_method in ("hog", "hogposneg", "posneg"):
        ev = Evaluator(data, inval_u, inval_i, params, device)
        metric_fn = lambda view: ev.ndcg(view, "val")
    loop = TrainLoopHR(model, solver, scorer, data.val_mat, params,
                       log_fn=log_fn, metric_fn=metric_fn, prefix=prefix,
                       invalid_users=inval_u, invalid_items=inval_i)
    report = loop.run(state, resume=resume)
    report.solver = solver
    return report, model, scorer, (inval_u, inval_i)


def _round_up_pow2(x: int) -> int:
    p = 1
    while p < x:
        p *= 2
    return p
