"""Flagship end-to-end run at the ML-20M shape on one card (the counterpart
of scripts/ml20m_flagship.py).

Runs the whole production path at the north-star scale: star-quantized
ratings (the int8 code staging engages), train/val/test splits, TrainLoop
termination + best-on-val snapshot + text checkpoints, the row-dense
stripe engine (``csrc/dense_rows.cu``, codes instantiation) and the
full-catalog HR@10 (``csrc/topk.cu``, fused route), with the wall of each
phase: gen+split, the set-up before the first epoch (staging, evaluator,
initial objective), the first epoch, the steady epoch median, the evals,
the checkpoint writes and the HR@10 pass. The reference's flagship config
is ML-20M rank-64/128 (BASELINE.md north star).

Runs on the card unless ``--cpu``; the size flags default to the JAX
script's shapes. Checkpoints go under ``--out`` (``build/`` of the
checkout by default).

Usage: python scripts/torch_ml20m_flagship.py [--cpu] [--n-users N]
  [--n-items N] [--nnz N] [--ks 64 128] [--max-iter 60] [--out DIR]
"""

import argparse
import glob
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from matfac_tpu_torch.config import Params  # noqa: E402
from matfac_tpu_torch.data.csr import RatingMatrix  # noqa: E402
from matfac_tpu_torch.data.dataset import Data  # noqa: E402
from matfac_tpu_torch.data.io import split_train_test_val  # noqa: E402
from matfac_tpu_torch.data.synthetic import low_rank_ratings  # noqa: E402
from matfac_tpu_torch.eval.metrics import Evaluator  # noqa: E402
from matfac_tpu_torch.eval.ranking import CatalogScorer  # noqa: E402
from matfac_tpu_torch.train import checkpoint as ckpt  # noqa: E402
from matfac_tpu_torch.train import loop as loop_mod  # noqa: E402
from matfac_tpu_torch.train.loop import train_model  # noqa: E402
from matfac_tpu_torch.utils import freq as ufreq  # noqa: E402

N_USERS, N_ITEMS, NNZ = 138_000, 27_000, 20_000_000


def make_data(n_users: int = N_USERS, n_items: int = N_ITEMS,
              nnz: int = NNZ) -> Data:
    """The JAX script's data: low-rank ratings at nnz / (n_users n_items)
    density, quantized to half stars, split 85 / 10 / 5."""
    mat, _, _ = low_rank_ratings(n_users, n_items, k=8,
                                 density=nnz / (n_users * n_items),
                                 seed=0, noise=0.35, power_law=0.8,
                                 nonneg=True)
    mat.values[:] = (np.clip(np.round(mat.values / 0.5), 1, 10)
                     * 0.5).astype(np.float32)
    tr, te, va = split_train_test_val(mat, 0.1, 0.05, seed=1)
    return Data(train_mat=tr, test_mat=te, val_mat=va)


def flagship_params(k: int, max_iter: int = 60, save_iter: int = 50
                    ) -> Params:
    return Params(fac_dim=k, u_reg=0.002, i_reg=0.002, learn_rate=0.05,
                  seed=0, max_iter=max_iter, obj_iter=5, disp_iter=20,
                  save_iter=save_iter)


class PhaseClock:
    """Host seconds of one ``train_model`` call by phase, the device
    synchronized at each boundary: each solver epoch (through the loop's
    solver), the evaluator's RMSE and objective calls, and the checkpoint
    writes. Wraps them on entry and restores them on exit."""

    SAVES = ("save_facs", "save_full", "save_state", "save_invalid")

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"

    def _sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def _timed(self, bucket, fn):
        def call(*args, **kw):
            if self.depth:          # save_full calls save_facs
                return fn(*args, **kw)
            self.depth += 1
            self._sync()
            t0 = time.perf_counter()
            try:
                out = fn(*args, **kw)
                self._sync()
            finally:
                self.depth -= 1
            bucket.append(time.perf_counter() - t0)
            return out
        return call

    def __enter__(self):
        self.epochs, self.evals, self.saves = [], [], []
        self.first_epoch_at, self.depth = None, 0
        self.saved, self.solvers = [], []
        clock = self
        real_init = loop_mod.TrainLoop.__init__

        def init(loop, *args, **kw):
            real_init(loop, *args, **kw)
            epoch = clock._timed(clock.epochs, loop.solver.epoch)

            def first(*a, **k):
                if clock.first_epoch_at is None:
                    clock._sync()
                    clock.first_epoch_at = time.perf_counter()
                return epoch(*a, **k)
            loop.solver.epoch = first
            clock.solvers.append(loop.solver)

        self._patch(loop_mod.TrainLoop, "__init__", init)
        for name in ("rmse", "objective"):
            self._patch(Evaluator, name,
                        self._timed(self.evals, getattr(Evaluator, name)))
        for name in self.SAVES:
            self._patch(ckpt, name,
                        self._timed(self.saves, getattr(ckpt, name)))
        self.t0 = time.perf_counter()
        return self

    def _patch(self, owner, name, fn):
        self.saved.append((owner, name, getattr(owner, name)))
        setattr(owner, name, fn)

    def __exit__(self, *exc):
        for owner, name, fn in reversed(self.saved):
            setattr(owner, name, fn)
        for solver in self.solvers:
            del solver.epoch        # the class's method again

    def walls(self) -> dict:
        return dict(setup=(self.first_epoch_at or self.t0) - self.t0,
                    n_epochs=len(self.epochs),
                    first_epoch=self.epochs[0] if self.epochs else 0.0,
                    steady_epoch=(float(np.median(self.epochs[1:]))
                                  if len(self.epochs) > 1 else 0.0),
                    evals=float(sum(self.evals)), n_evals=len(self.evals),
                    ckpt_write=float(sum(self.saves)),
                    n_ckpt_writes=len(self.saves))


def hr10_users(n_users: int, n_items: int, seed: int = 1) -> RatingMatrix:
    """The JAX script's leave-one-out matrix: one random item a user."""
    rng = np.random.default_rng(seed)
    return RatingMatrix.from_coo(
        np.arange(n_users, dtype=np.int64), rng.integers(0, n_items, n_users),
        np.ones(n_users, np.float32), n_users, n_items)


def run_k(data: Data, params: Params, prefix: str, device="cuda",
          hr: bool = False, log=print) -> dict:
    """train_model(algo="mf", mf_method="densesgd") with the loop's
    checkpoints at ``prefix``; then the best state's test RMSE, the
    checkpoint files and (``hr``) a timed full-catalog HR@10 over every
    user, as the JAX script. Returns the numbers, the phase walls, the
    report, model, evaluator and (``hr``) scorer and leave-one-out matrix."""
    k = params.fac_dim
    n_users, n_items = data.n_users, data.n_items
    os.makedirs(os.path.dirname(prefix) or ".", exist_ok=True)
    for f in glob.glob(f"{prefix}*"):
        os.remove(f)
    t0 = time.time()
    with PhaseClock(device) as clock:
        rep, model, ev, _ = train_model(
            data, params, algo="mf", mf_method="densesgd", prefix=prefix,
            log_fn=log, device=device)
    train_s = time.time() - t0
    test = ev.rmse(model.eval_view(rep.best_state), "test")
    log(f"k={k}: {rep.best_iter + 1}+ epochs in {train_s:.0f}s "
        f"wall (incl. staging+compile+evals), best val "
        f"{rep.best_metric:.4f}, test {test:.4f}, "
        f"stop={rep.stop_reason}")
    cks = glob.glob(f"{prefix}*")
    log(f"k={k}: {len(cks)} checkpoint files")
    walls = clock.walls()
    out = dict(k=k, best_val=rep.best_metric, test=test,
               best_iter=rep.best_iter, stop=rep.stop_reason,
               train_s=train_s, n_ckpt=len(cks), walls=walls, rep=rep,
               model=model, ev=ev)
    if hr:
        # full-catalog ranking eval at the flagship shape
        iu, ii = ufreq.invalid_users_items(data.train_mat, n_users, n_items)
        scorer = CatalogScorer(data.train_mat, iu, ii, n_users, n_items,
                               device=device)
        loo = hr10_users(n_users, n_items)
        view = model.eval_view(rep.best_state)
        scorer.hit_rate(view, loo, 10)   # warm-up: the kernel's build
        if device != "cpu":
            torch.cuda.synchronize()
        t0 = time.time()
        out["hr10"] = scorer.hit_rate(view, loo, 10)
        walls["hr10"] = time.time() - t0
        log(f"k={k}: full-catalog HR@10 eval ({n_users // 1000}k x "
            f"{n_items // 1000}k) = {walls['hr10']:.2f}s")
        out.update(scorer=scorer, loo=loo)
    log(f"k={k}: phases: staging+setup {walls['setup']:.2f}s, first epoch "
        f"{walls['first_epoch']:.3f}s, steady epoch median "
        f"{walls['steady_epoch']:.4f}s ({len(clock.epochs)} epochs), "
        f"evals {walls['evals']:.2f}s ({walls['n_evals']} calls), "
        f"checkpoint write {walls['ckpt_write']:.2f}s "
        f"({walls['n_ckpt_writes']} writes)"
        + (f", HR@10 {out['hr10']:.4f} in {walls['hr10']:.3f}s" if hr
           else ""))
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--n-users", type=int, default=N_USERS)
    ap.add_argument("--n-items", type=int, default=N_ITEMS)
    ap.add_argument("--nnz", type=int, default=NNZ)
    ap.add_argument("--ks", type=int, nargs="+", default=[64, 128])
    ap.add_argument("--max-iter", type=int, default=60)
    ap.add_argument("--save-iter", type=int, default=50)
    ap.add_argument("--out", default=os.path.join(ROOT, "build",
                                                  "torch_ml20m_flagship"))
    args = ap.parse_args()
    if not args.cpu and not torch.cuda.is_available():
        print("no CUDA device visible (pass --cpu for the CPU)",
              file=sys.stderr)
        return 2
    device = "cpu" if args.cpu else "cuda"
    print("device:", torch.cuda.get_device_name(0) if device == "cuda"
          else "cpu", flush=True)
    log = lambda s: print(s, flush=True)
    t0 = time.time()
    data = make_data(args.n_users, args.n_items, args.nnz)
    print(f"data: {data} gen+split {time.time()-t0:.0f}s", flush=True)
    for k in args.ks:
        run_k(data, flagship_params(k, args.max_iter, args.save_iter),
              os.path.join(args.out, f"ml20m_k{k}"), device,
              hr=(k == 64), log=log)
    return 0


if __name__ == "__main__":
    sys.exit(main())
