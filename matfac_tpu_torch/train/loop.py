"""The training loops and their front door (port of matfac_tpu/train/loop.py
for plain MF, MF with biases, IFWMF, TMF and TMF+Dropout on the scatter,
one-hot cell and row-dense engines, plain MF on the coordinate family (ALS,
CCD, CCD++) and SVD-initialised SGD, BPR and the BPR x TMF+Poisson hybrid
on the stream and dense-stripe pairwise engines, and the othersrc models:
TMF with biases, head-item weights, rank locality, adaptive-rank dropout,
the mf_freq curriculum and incremental rank).

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

from matfac_tpu_torch.config import Params
from matfac_tpu_torch.utils import freq as ufreq
from matfac_tpu_torch.eval.metrics import Evaluator
from matfac_tpu_torch.eval.ranking import CatalogScorer
from matfac_tpu_torch.models.base import (MFState, ModelMF, ModelMFBias,
                                          init_state)
from matfac_tpu_torch.models.bpr import ModelBPRPoissonDropout, ModelMFBPR
from matfac_tpu_torch.models.increment import train_increment
from matfac_tpu_torch.models.longtail import (ModelAdaptiveDropoutMF,
                                              ModelDropoutSigmoid,
                                              ModelDropoutSigmoidBias,
                                              ModelHeadWeightedMF,
                                              ModelInvPopMF, ModelLocalityMF,
                                              ModelPoissonDropout,
                                              ModelSideGatedMF)
from matfac_tpu_torch.solvers.als import (ALSSolver, DenseALSSolver,
                                          SubspaceALSSolver)
from matfac_tpu_torch.solvers.block_sgd import (BlockSGDSolver,
                                                rating_code_scale)
from matfac_tpu_torch.solvers.ccd import CCDPPSolver, CCDSolver
from matfac_tpu_torch.ops.svd_init import svd_init
from matfac_tpu_torch.solvers.bpr import BPRSolver
from matfac_tpu_torch.solvers.bpr_dense import DenseBPRSolver
from matfac_tpu_torch.solvers.sgd import SGDSolver
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
                        if hasattr(self.solver, "reset"):
                            # e.g. CCD's carried residual starts again
                            self.solver.reset()
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
                    self._save_text(best_state, sig)
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
            self._save_text(best_state, sig)
            if self.invalid_users is not None:
                ckpt.save_invalid(self.prefix, self.invalid_users,
                                  self.invalid_items)
        return TrainReport(state, best_state, best_val, best_iter, stop,
                           history)

    def _save_text(self, best_state: MFState, sig: str) -> None:
        """Text checkpoint of the best snapshot: a bias model's biases and
        mu beside its factors (Model::save, model.cpp:31-58), the factors
        alone otherwise (saveFacs)."""
        if getattr(self.model, "use_bias", False):
            ckpt.save_full(best_state, self.prefix, sig)
        else:
            ckpt.save_facs(best_state, self.prefix, sig)


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

_SGD = ("sgd", "sgdpar", "sgdu", "hogsgd")
_SOLVERS = ("auto",) + _SGD + ("sgdparsvd", "blocksgd", "densesgd", "als",
                                "ialspp", "alsdense", "ccd", "ccd++",
                                "ccdpp", "ccd++freqadap")
_COORD = ("als", "ialspp", "alsdense", "ccd", "ccd++", "ccdpp",
          "ccd++freqadap")
# the dropoutmf spellings and the training-rank rule each selects
_DROPOUT_MODES = {"dropoutmf": "prob", "dropoutmf_prob": "prob",
                  "dropoutmf_ordered": "ordered",
                  "dropoutmf_onlyordered": "onlyordered"}


def _auto_method(algo: str, data, params: Params) -> str:
    """The JAX package's single-device solver choice (``_auto_method`` of
    matfac_tpu/train/loop.py; the reference makes the user pick): plain MF
    -> 'als'; bias models, per-side gated and adaptive-dropout models ->
    'sgd'; the long-tail models -> 'densesgd' when the padded dense grid
    fits 6e9 bytes (1 byte a slot where the ratings stage as int8 codes,
    else 3), else 'sgd' for TMF+Dropout's sampled ranks, else 'blocksgd'
    when the one-hot stream fits 8e9 bytes, else 'sgd'."""
    if algo == "mf":
        return "als"
    if algo in ("mf_bias", "tmf_bias", "mf_loc", "mf_freq", "dropoutmf",
                "dropoutmf_prob", "dropoutmf_ordered",
                "dropoutmf_onlyordered"):
        return "sgd"
    nu_pad = -(-data.n_users // 2560) * 2560
    ni_pad = -(-data.n_items // 128) * 128
    bytes_per_slot = 3
    if algo != "ifwmf":
        v = data.train_mat.values
        if len(v) > 2_000_000:
            # a subsample decides the routing estimate only: the solver
            # proves the codes on the filtered data and densesgd falls back
            # on its budget error
            v = v[:: len(v) // 2_000_000]
        if rating_code_scale(v) is not None:
            bytes_per_slot = 1
    if nu_pad * ni_pad * bytes_per_slot <= 6e9:
        return "densesgd"
    if algo == "tmfdropout":
        return "sgd"
    if 7 * 4 * 1.5 * max(data.train_mat.nnz, 1) < 8e9:
        return "blocksgd"
    return "sgd"


def _freq_reg_scale(freq: np.ndarray, invalid: np.ndarray,
                    exponent: float) -> np.ndarray:
    """(freq / mean valid freq) ** exponent: the sgd engine's
    frequency-scaled regularization multiplier (othersrc
    modelMFWtReg.cpp:96, with the marginal normalized so that the exponent
    does not move the overall regularization)."""
    f = np.asarray(freq, np.float64)
    valid = ~invalid[: len(f)]
    mean = max(float(f[valid].mean()) if valid.any() else 1.0, 1e-12)
    return np.maximum(f / mean, 1e-12) ** exponent


def train_model(data, params: Params, algo: str = "mf",
                mf_method: str = "sgd", log_fn=print,
                init_state_override: Optional[MFState] = None,
                prefix: Optional[str] = None, mesh=None,
                resume: bool = False, device="cuda"):
    """Build model and solver from the reference's names and train; the
    JAX package's front door for the slices ported so far.

    algo: "mf", "mf_bias", "ifwmf", "tmf", "tmfdropout" (main.cpp --algo);
    the othersrc models "tmf_bias" (TMF with biases, no global mean),
    "mf_headwt" / "mfwt" (head items of the 0.5 rating-mass head weighted
    0.8), "mf_loc" / "mfloc" (entities outside the 0.8 rating-mass heads
    confined to k/2 dims), "dropoutmf" / "dropoutmf_prob" /
    "dropoutmf_ordered" / "dropoutmf_onlyordered" (adaptive-rank dropout,
    soft three-tier prediction), "mf_freq" / "mffreq" (the five-stage
    head-first curriculum, sgd only) and "increment" (incremental rank,
    probe set ``data.graph_mat``; its report carries ``.increment``); or
    the ranking models "bpr" and the BPR x TMF+Poisson hybrid
    "bpr_poisson" / "bprpoissondropout" (model selection on val HR@10, or
    NDCG for hog / posneg). mf_method for the pointwise models: "sgd" and
    its spellings "sgdpar", "sgdu", "hogsgd" (the scatter engine, JAX's
    default), "sgdparsvd" (the scatter engine from an SVD init with
    singular-value-weighted regularization, ``objective_sing``),
    "blocksgd" (the one-hot cell engine, diag schedule), "densesgd" (the
    row-dense stripe engine, falling back to sgd for sampled ranks and to
    blocksgd otherwise when its tiles miss the budget), the coordinate
    family "als" (bucketed, exact Cholesky), "ialspp" (iALS++ subspace
    sweeps), "alsdense" (dense masked Grams), "ccd", "ccd++" / "ccdpp" and
    "ccd++freqadap" (``params.ccd_group_dims`` dims a sweep), or "auto"
    (JAX's ``_auto_method``: "als" for plain MF). For the ranking models:
    "train" (stream mode; "auto" resolves to it), "sigmoid" (the hybrid's
    deterministic ranks), "hog", or "hogposneg" / "posneg" (posneg mode);
    ``params.bpr_engine="dense"`` trains stream mode on the dense-stripe
    engine, falling back to the stream engine for the hybrid's rank masks
    or a mask over budget. Mesh training is not ported and raises
    NotImplementedError naming its ROADMAP item; what JAX refuses raises
    JAX's ValueError.
    Returns (report, model, evaluator or scorer, (invalid_users,
    invalid_items))."""
    a, m = algo.lower(), mf_method.lower()
    if mesh is not None:
        raise NotImplementedError(
            "mesh training is ROADMAP queue 1, item 13")
    inval_u, inval_i = ufreq.invalid_users_items(
        data.train_mat, data.n_users, data.n_items)
    user_freq, item_freq = ufreq.row_col_freq(data.train_mat)
    # zero-pad: entities seen only in test / val have zero train frequency
    user_freq = _pad_rows(user_freq, data.n_users)
    item_freq = _pad_rows(item_freq, data.n_items)
    if a in ("bpr", "bprpoissondropout", "bpr_poisson"):
        if m == "auto":
            # ranking trains through the one pairwise engine; 'train'
            # (stream mode + HR selection) is the reference default
            m = "train"
            log_fn("mf_method=auto resolved to 'train' (BPR stream)")
        return _train_ranking(data, params, a, m, log_fn,
                              init_state_override, inval_u, inval_i,
                              user_freq, item_freq, prefix, resume, device)
    if a == "increment":
        # ModelIncrement (main.cpp:1325-1370); its probe matrix is
        # --graphmat (modelIncrement.cpp:251-316)
        inc, model = train_increment(data, params, inval_u, inval_i,
                                     log_fn=log_fn, device=device)
        ev = Evaluator(data, inval_u, inval_i, params, device)
        val = ev.rmse(model.eval_view(inc.state), "val")
        report = TrainReport(inc.state, inc.state, val, params.max_iter - 1,
                             "max_iter", [])
        report.increment = inc   # rank tables and growth history
        return report, model, ev, (inval_u, inval_i)
    if a in ("mf_freq", "mffreq"):
        # othersrc ModelMFFreq's head-first curriculum
        # (othersrc/modelMFFreq.cpp:200-278)
        return _train_mf_freq(data, params, m, log_fn, init_state_override,
                              inval_u, inval_i, user_freq, item_freq, prefix,
                              resume, device)
    n, n_i = data.n_users, data.n_items
    if a in ("mf_headwt", "mfwt"):
        # othersrc ModelMFWt, head_pc and lambda0 at the reference's
        # constants (othersrc/modelMFWt.cpp:118-120)
        a = "mf_headwt"
        model = ModelHeadWeightedMF(
            params, n, n_i, ufreq.head_items_from_freq(item_freq, 0.5),
            lambda0=0.8)
    elif a in _DROPOUT_MODES:
        model = ModelAdaptiveDropoutMF(params, n, n_i, user_freq, item_freq,
                                       mode=_DROPOUT_MODES[a])
        a = "dropoutmf"
    elif a in ("mf_loc", "mfloc"):
        # othersrc ModelMFLoc, head sets at the 0.8 rating-mass cut of
        # ModelMFFreq (othersrc/modelMFFreq.cpp:211-212)
        a = "mf_loc"
        model = ModelLocalityMF(params, n, n_i,
                                ufreq.head_items_from_freq(user_freq, 0.8),
                                ufreq.head_items_from_freq(item_freq, 0.8))
    elif a == "ifwmf":
        model = ModelInvPopMF(params, n, n_i, user_freq=user_freq,
                              item_freq=item_freq, invalid_users=inval_u,
                              invalid_items=inval_i)
    elif a in ("tmf", "tmfdropout", "tmf_bias"):
        cls = {"tmf": ModelDropoutSigmoid, "tmfdropout": ModelPoissonDropout,
               "tmf_bias": ModelDropoutSigmoidBias}[a]
        model = cls(params, n, n_i, user_freq=user_freq, item_freq=item_freq)
    elif a in ("mf", "mf_bias"):
        model = (ModelMF if a == "mf" else ModelMFBias)(params, n, n_i)
    else:
        raise ValueError(f"unknown algo {algo!r}")
    if m == "auto":
        m = _auto_method(a, data, params)
        log_fn(f"mf_method=auto resolved to '{m}' (the JAX package's "
               "measured guidance)")
        if m == "densesgd":
            log_fn("note: densesgd trains at batch = user stripe; at a "
                   "fixed learn_rate this differs from the blocksgd "
                   "default's ~1-8k minibatches (pass mf_method="
                   "'blocksgd' to keep the previous default)")
    # the single-device guards of the JAX front door
    if type(model).update_side_masks is not ModelMF.update_side_masks \
            and m not in _SGD:
        raise ValueError(
            f"{model.name} carries per-side update gates that '{m}' does "
            "not honor — use mf_method=sgd on a single device")
    if m in _COORD:
        weighted = (type(model).example_weight
                    is not ModelMF.example_weight)
        masked = (hasattr(model, "pair_rank")
                  or hasattr(model, "pair_lambda")
                  or type(model).update_side_masks
                  is not ModelMF.update_side_masks)
        if weighted or masked:
            raise ValueError(
                f"{model.name} carries per-example weights/rank masks "
                f"that '{m}' (coordinate family) does not honor — use "
                "an SGD-family method (sgd/blocksgd/sgdpar/auto)")
    if params.reg_exponent and m not in ("als",) + _SGD:
        raise ValueError(
            f"reg_exponent is implemented for 'als' and the sgd engine, "
            f"not '{m}' — drop the exponent or switch method")

    rs_u = rs_i = None
    if params.reg_exponent:   # past the guard: the sgd engine (or ALS)
        # per-occurrence multiplier normalized by the mean valid frequency,
        # so the magnitude stays comparable at exponent 0
        rs_u = _freq_reg_scale(user_freq, inval_u, params.reg_exponent)
        rs_i = _freq_reg_scale(item_freq, inval_i, params.reg_exponent)
    sgd = lambda: SGDSolver(model, params, data.train_mat, inval_u, inval_i,
                            reg_scale_u=rs_u, reg_scale_i=rs_i,
                            device=device)
    # the one-hot cell engine as the JAX front door builds it: the DSGD
    # diag schedule, 384-blocks, at most 1024 ratings per lane and step
    # (JAX's pad_k=128 fills the TPU's matrix lanes; the port drops it)
    blocksgd = lambda: BlockSGDSolver(
        model, params, data.train_mat, inval_u, inval_i,
        batch_size=min(params.batch_size, 1024), bu=384, bi=384,
        schedule="diag", device=device)
    if m in _SGD:
        solver = sgd()
    elif m == "blocksgd":
        solver = blocksgd()
    elif m == "densesgd":
        try:
            solver = BlockSGDSolver(model, params, data.train_mat, inval_u,
                                    inval_i, engine="dense", bu=None,
                                    bi=None, device=device)
        except ValueError as e:
            # over-budget grids fall back rather than crash; sampled ranks
            # need the scatter engine's per-update masks
            fb = ("sgd" if getattr(model, "stochastic_rank", False)
                  else "blocksgd")
            log_fn(f"densesgd unavailable ({e}); falling back to {fb}")
            solver = sgd() if fb == "sgd" else blocksgd()
    elif m == "sgdparsvd":
        # trainSGDParSVD (modelMF.cpp:353-557): SVD init, per-dim
        # singular-value-weighted regularization, objectiveSing
        u0, v0, sing_vals = svd_init(data.train_mat, params.fac_dim,
                                     device=device)
        sa = params.u_reg if params.sing_a is None else params.sing_a
        sb = params.i_reg if params.sing_b is None else params.sing_b
        solver = SGDSolver(model, params, data.train_mat, inval_u, inval_i,
                           reg_vec=(sa + 1.0) / (sb + sing_vals),
                           device=device)
        if init_state_override is None:
            as_t = lambda a, n: torch.from_numpy(_pad_rows(a, n)).to(device)
            init_state_override = init_state(
                params, data.n_users, data.n_items, device=device)._replace(
                    u_fac=as_t(u0, data.n_users),
                    i_fac=as_t(v0, data.n_items))
    elif m == "als":
        # exact Cholesky solves (cg_iters=0), as the JAX front door builds it
        solver = ALSSolver(model, params, data.train_mat, inval_u, inval_i,
                           device=device)
    elif m == "ialspp":
        solver = SubspaceALSSolver(model, params, data.train_mat, inval_u,
                                   inval_i, device=device)
    elif m == "alsdense":
        solver = DenseALSSolver(model, params, data.train_mat, inval_u,
                                inval_i, device=device)
    elif m == "ccd":
        if not data.train_mat.is_sorted():
            raise ValueError("CCD requires sorted CSR (main.cpp:1245)")
        solver = CCDSolver(model, params, data.train_mat, inval_u, inval_i,
                           device=device)
    elif m in ("ccd++", "ccdpp", "ccd++freqadap"):
        fa = m == "ccd++freqadap"
        solver = CCDPPSolver(model, params, data.train_mat, inval_u,
                             inval_i, freq_adaptive=fa,
                             item_freq=item_freq if fa else None,
                             group_dims=getattr(params, "ccd_group_dims", 1),
                             device=device)
    else:
        raise ValueError(f"unknown mf_method {mf_method!r}; one of "
                         f"{_SOLVERS}")
    ev = Evaluator(data, inval_u, inval_i, params, device)
    state = init_state_override or init_state(
        params, data.n_users, data.n_items, device=device)
    state = model.transform_init_state(state)
    loop = TrainLoop(model, solver, ev, params, prefix=prefix,
                     invalid_users=inval_u, invalid_items=inval_i,
                     log_fn=log_fn)
    if m == "sgdparsvd":
        # isTerminateModelSing: the objective weights the L2 by sigma
        loop._objective = lambda st: ev.objective_sing(
            model.eval_view(st), st, sing_vals)
    report = loop.run(state, resume=resume)
    report.solver = solver
    return report, model, ev, (inval_u, inval_i)


def _train_mf_freq(data, params: Params, m: str, log_fn, init_state_override,
                   inval_u, inval_i, user_freq, item_freq, prefix, resume,
                   device):
    """ModelMFFreq's head-first curriculum (othersrc/modelMFFreq.cpp:200-278):
    five stages over ONE factor state, each a full max_iter TrainLoop with
    the learn rate reset, gating which SIDE of each example updates:

      1. all valid entities            (warm-up)
      2. head users x head items       (the 0.8 rating-mass heads)
      3. tail items only               (users frozen)
      4. tail users only               (items frozen)
      5. all valid entities            (final polish)

    Each stage continues from the current state; the best snapshot is the
    best val-RMSE state of ALL stages, and the epochs of stage s are
    numbered from s * max_iter. Stage s draws its batch orders from the
    seed ``params.seed + s``, as the JAX loop's key of that stage."""
    if resume:
        raise ValueError("resume is not supported for the mf_freq "
                         "curriculum — restart the stage sequence")
    if m == "auto":
        m = "sgd"
        log_fn("mf_method=auto resolved to 'sgd' (curriculum stages)")
    if m not in _SGD:
        raise ValueError(
            f"mf_freq trains through the SGD engine, not '{m}'")
    head_u = ufreq.head_items_from_freq(user_freq, 0.8)
    head_i = ufreq.head_items_from_freq(item_freq, 0.8)
    valid_u, valid_i = ~inval_u, ~inval_i
    none_u = np.zeros(data.n_users, bool)
    none_i = np.zeros(data.n_items, bool)
    stages = [
        ("full", valid_u, valid_i),
        ("head-only", head_u & valid_u, head_i & valid_i),
        ("tail-items", none_u, ~head_i & valid_i),
        ("tail-users", ~head_u & valid_u, none_i),
        ("full", valid_u, valid_i),
    ]
    ev = Evaluator(data, inval_u, inval_i, params, device)
    state = init_state_override or init_state(
        params, data.n_users, data.n_items, device=device)
    best_state, best_metric, best_iter = None, float("inf"), -1
    history: List[EpochLog] = []
    epoch_off = 0
    model = solver = None
    stop = "max_iter"
    for si, (tag, gu, gi) in enumerate(stages):
        log_fn(f"mf_freq stage {si + 1}/5 ({tag}): "
               f"{int(gu.sum())} users x {int(gi.sum())} items trainable")
        model = ModelSideGatedMF(params, data.n_users, data.n_items, gu, gi)
        solver = SGDSolver(model, params, data.train_mat, inval_u, inval_i,
                           seed=params.seed + si, device=device)
        loop = TrainLoop(model, solver, ev, params, prefix=prefix,
                         invalid_users=inval_u, invalid_items=inval_i,
                         log_fn=log_fn)
        rep = loop.run(state)
        state = rep.state
        for el in rep.history:
            el.epoch += epoch_off
            history.append(el)
        if rep.best_metric < best_metric:
            best_metric = rep.best_metric
            best_state = _snapshot(rep.best_state)
            best_iter = rep.best_iter + epoch_off
        epoch_off += params.max_iter
        stop = rep.stop_reason
    report = TrainReport(state, best_state, best_metric, best_iter, stop,
                         history, solver)
    return report, model, ev, (inval_u, inval_i)


def _pad_rows(a: np.ndarray, n: int) -> np.ndarray:
    """Truncate or zero-pad (never tile) the leading axis to length n."""
    a = np.asarray(a)
    if a.shape[0] >= n:
        return a[:n]
    pad = [(0, n - a.shape[0])] + [(0, 0)] * (a.ndim - 1)
    return np.pad(a, pad)


def _train_ranking(data, params: Params, algo: str, mf_method: str, log_fn,
                   init_state_override, inval_u, inval_i, user_freq,
                   item_freq, prefix, resume, device):
    """The BPR family (the JAX ``_train_ranking``): plain BPR or the BPR x
    TMF+Poisson hybrid, whose ranks are sampled except for 'sigmoid'.
    'hogposneg' / 'posneg' train in posneg mode, every other method in
    stream mode; 'hog', 'hogposneg' and 'posneg' select on val NDCG@10
    (trainHog / trainHogPosNeg, modelMFBPR.cpp:245-402, :633), the rest
    on val HR@10. ``bpr_engine="dense"`` builds the dense-stripe engine in
    stream mode, and falls back to the stream engine where it refuses
    (rank masks, budget)."""
    if algo == "bpr":
        model = ModelMFBPR(params, data.n_users, data.n_items)
    else:
        model = ModelBPRPoissonDropout(
            params, data.n_users, data.n_items, user_freq, item_freq,
            sample_poisson=(mf_method != "sigmoid"))
    mode = "posneg" if mf_method in ("hogposneg", "posneg") else "stream"
    stream = lambda: BPRSolver(model, params, data.train_mat, inval_u,
                               inval_i, n_tries=params.n_negatives,
                               mode=mode, sampler=params.bpr_sampler,
                               device=device)
    # JAX builds the dense BPR solver in stream mode only; posneg trains on
    # BPRSolver whatever the engine
    if getattr(params, "bpr_engine", "stream") == "dense" and \
            mode == "stream":
        try:
            solver = DenseBPRSolver(model, params, data.train_mat, inval_u,
                                    inval_i, device=device)
        except ValueError as e:   # rank-masked model / mask budget
            log_fn(f"bpr_engine=dense unavailable ({e}); falling back to "
                   "the stream engine")
            solver = stream()
    else:
        solver = stream()
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
