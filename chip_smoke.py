"""Smoke run of the PyTorch / CUDA port (matfac_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root

Phases, in order; any failure raises and the script exits non-zero:
  (a) environment: the card's name and power limit, torch and CUDA versions;
  (b) build: nvcc compiles csrc/dense_rows.cu into build/ (timed);
  (c) kernel vs plain: one stripe epoch of the hand-written kernel against
      the plain PyTorch version on the same CUDA tensors, for every tile
      type x mm_bf16 x collision_norm at k = 32, 64, 128, on a ragged shape;
      then the same cases on one stripe whose bf16 rounding is exact, at a
      tight tolerance, with controls (kernel in one matmul precision
      against plain in the other) that must FAIL;
  (d) main path, float tiles: train_model(algo="mf", mf_method="densesgd")
      at 100,000 x 20,000, density 0.005 (~9.9M continuous ratings), k=64;
  (e) main path, code tiles: the ML-20M shape (138,000 x 27,000, ~20M
      half-star ratings), k=64;
  (f) top-N kernel vs plain: csrc/topk.cu against topk_plain on the same
      CUDA tensors at k = 32, 64, 128 and n = 1, 10, 100, 1000, on a ragged
      catalog with invalid items, heavy and fully rated users, mu and
      biases (scores at rtol 1e-5 / atol 1e-6, ids where scores are
      further apart than that), and on exact-score cases with duplicated
      item rows, where ids must match exactly, smallest id first;
  (g) the ranking path: train_model(algo="bpr", mf_method="train") at
      100,000 x 20,000 (bench.py's BPR and HR@10 shape), k=64, 8 epochs
      with val HR@10 through the kernel after each; then kernel vs plain
      on the best view (top-10 of every user, val HR@10, test ARHR at
      n=1000) and Recommender.from_checkpoint answering 2,048 users.
(d) and (e) check that every stripe went through the kernel (launch count),
that val RMSE is finite and below its value at the initial state, replay
the main path's first epoch on its staged tiles through the kernel and
through the plain version and hold them together (rtol 1e-3 / atol 1e-5),
and time both on those tensors. (g) checks the top-N launch count, that
HR@10 is finite every epoch and its best above the initial state's.

The line before the last is a JSON record of the kernels; the last line is
{"ok": true, "device": {...}}. Without a CUDA device the script exits
non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from matfac_tpu_torch import (Data, Params, low_rank_ratings,
                              split_train_test_val)
from matfac_tpu_torch.models.base import init_state
from matfac_tpu_torch.ops import _build
from matfac_tpu_torch.ops import dense_row_kernel as drk
from matfac_tpu_torch.ops import topk_kernel as tk
from matfac_tpu_torch.ops.dense_block_kernel import dense_sweep_rows
from matfac_tpu_torch.serving import Recommender
from matfac_tpu_torch.train.loop import train_model

SOURCE = "matfac_tpu_torch/csrc/dense_rows.cu"
TOPK_SOURCE = "matfac_tpu_torch/csrc/topk.cu"
# top-N: f32 dot products summed in another order at k <= 128
TOPK_RTOL, TOPK_ATOL = 1e-5, 1e-6
RTOL, ATOL = 1e-3, 1e-5   # summation order over bu and over panels
# Phase (c) steps at the main path's learn rate. Without collision
# normalization a stripe's gradient is a SUM over ~COUNT_PER_USER valid
# items per user (1000 items at 5% density), so those cases take lr /
# COUNT_PER_USER: the same step size.
LR, COUNT_PER_USER, REG = 0.05, 50, 0.01
# Factor scales. f32 matmuls: trained-size factors. mm_bf16: a one-ulp
# difference in P between two correct summation orders can flip one bf16
# rounding of E (an ulp of E ~ 0.016 at ratings ~3), which moves a factor
# by ~lr * 0.016 * |U| / count: ~1e-4 at factors ~0.3 (measured on an
# NVIDIA H100 80GB HBM3 at 700 W), below atol at 0.03, where each stripe still moves the factors by
# ~30%, so a wrong product or index shows far above the tolerance.
SCALE_F32, SCALE_BF16 = 0.3, 0.03
# One stripe with factors whose bf16 rounding is exact (see _dyadic): P, E
# and E's bf16 rounding are then the same in any summation order, no
# rounding can flip, and the kernel must match the plain version to f32
# summation noise (~1e-8 here), while the other matmul precision misses by
# 40-140x this tolerance (plain vs plain on the CPU, these inputs).
EXACT_RTOL, EXACT_ATOL = 1e-5, 1e-6

# The main path's two configurations: synthetic data (bench_data), Params,
# and whether the tile ladder should stage int8 rating codes.
CELLS = {
    # bench.py's full shape, continuous ratings -> bf16 R + int8 W
    "d": (dict(n_users=100_000, n_items=20_000, density=0.005, noise=0.1,
               power_law=0.6, stars=False, val_pc=0.1),
          dict(fac_dim=64, u_reg=0.01, i_reg=0.01, learn_rate=0.05, seed=0,
               max_iter=5, obj_iter=1, disp_iter=1),
          False),
    # scripts/ml20m_flagship.py's shape, half stars -> int8 codes
    "e": (dict(n_users=138_000, n_items=27_000,
               density=20e6 / (138_000 * 27_000), noise=0.35,
               power_law=0.8, stars=True, val_pc=0.05),
          dict(fac_dim=64, u_reg=0.002, i_reg=0.002, learn_rate=0.05,
               seed=0, max_iter=3, obj_iter=1, disp_iter=1),
          True),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def phase_env() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"(a) torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def phase_build() -> float:
    """Both sources at once (one nvcc each), then load both."""
    t0 = time.perf_counter()
    paths = _build.build_all(["dense_rows", "topk"])
    drk.library()
    tk.library()
    dt = time.perf_counter() - t0
    log(f"(b) build + load of {SOURCE} and {TOPK_SOURCE}: {dt:.2f} s "
        f"({', '.join(p.name for p in paths.values())})")
    return dt


def _tiles(kind: str, NU: int, bu: int, ni: int, gen: torch.Generator,
           dev):
    """Random stripe tiles, ~5% valid: (R, W, r_scale)."""
    valid = torch.rand((NU, bu, ni), generator=gen) < 0.05
    if kind == "codes":
        codes = torch.randint(1, 11, (NU, bu, ni), generator=gen)
        R = torch.where(valid, codes, 0).to(torch.int8)
        return R.to(dev), None, 0.5
    ratings = 1.0 + 4.0 * torch.rand((NU, bu, ni), generator=gen)
    R = torch.where(valid, ratings, 0.0)
    R = R.to(torch.bfloat16 if kind == "bf16+W" else torch.float32)
    return R.to(dev), valid.to(torch.int8).to(dev), None


def _epoch_pair(u3, i_tab, order, lr, R, W, r_scale, cn, mm):
    """(kernel result, plain result) from the same inputs."""
    uk, ik = drk.dense_rows_epoch(u3.clone(), i_tab.clone(), order, lr, R,
                                  W, r_scale, REG, REG, cn, mm)
    up, ip = dense_sweep_rows(u3.clone(), i_tab.clone(), order, lr, R, W,
                              REG, REG, cn, mm, r_scale=r_scale)
    return (uk, ik), (up, ip)


def _errors(got, want, rtol=RTOL, atol=ATOL):
    """(max abs error, max rel error, max error / tolerance); the pair
    agrees when the last is <= 1."""
    abs_err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    rel_err = max(float(((g - w).abs() / w.abs().clamp_min(1e-30)).max())
                  for g, w in zip(got, want))
    ratio = max(float(((g - w).abs() / (atol + rtol * w.abs())).max())
                for g, w in zip(got, want))
    return abs_err, rel_err, ratio


def phase_kernel_vs_plain(dev="cuda") -> dict:
    """Max abs error per tile kind over all cases."""
    NU, bu, ni = 8, 376, 1000   # 3000 users x 1000 items; ragged edges
    gen = torch.Generator().manual_seed(0)
    worst = {}
    failures = []
    for kind in ("f32+W", "bf16+W", "codes"):
        R, W, r_scale = _tiles(kind, NU, bu, ni, gen, dev)
        for k in (32, 64, 128):
            u3 = torch.randn((NU, bu, k), generator=gen).to(dev)
            i_tab = torch.randn((ni, k), generator=gen).to(dev)
            order = torch.randperm(NU, generator=gen)
            for mm in (True, False):
                scale = SCALE_BF16 if mm else SCALE_F32
                for cn in (True, False):
                    lr = LR if cn else LR / COUNT_PER_USER
                    got, want = _epoch_pair(scale * u3, scale * i_tab,
                                            order, lr, R, W, r_scale, cn,
                                            mm)
                    a, r, ratio = _errors(got, want)
                    ok = ratio <= 1.0
                    worst[kind] = max(worst.get(kind, 0.0), a)
                    log(f"(c) {kind:6s} k={k:3d} mm_bf16={mm!s:5s} "
                        f"collision_norm={cn!s:5s} max_abs {a:.3e} "
                        f"max_rel {r:.3e} err/tol {ratio:.3e} "
                        f"{'ok' if ok else 'FAIL'}")
                    if not ok:
                        failures.append((kind, k, mm, cn))
    if failures:
        raise AssertionError(f"kernel disagrees with the plain version "
                             f"(rtol {RTOL}, atol {ATOL}): {failures}")
    return worst


def _dyadic(shape, gen: torch.Generator) -> torch.Tensor:
    """+-(m + d) / 256 with m in [65, 127] and |d| < 1/4: bf16 rounds each
    value to exactly +-m / 256 (its ulp in [1/4, 1/2) is 1/512). Products
    of the rounded values are multiples of 2^-16 below 1/4, so P over
    k <= 128 is exact in f32 in any summation order."""
    m = torch.randint(65, 128, shape, generator=gen).float()
    d = (torch.rand(shape, generator=gen) - 0.5) * 0.5
    sign = torch.where(torch.rand(shape, generator=gen) < 0.5, -1.0, 1.0)
    return sign * (m + d) / 256.0


def phase_bf16_rounding(dev="cuda") -> dict:
    """One stripe (376 users x 1000 items) from _dyadic factors: the
    kernel must match the plain version in the same matmul precision at
    EXACT_RTOL / EXACT_ATOL, and must MISS it in the other precision (the
    control that shows the check separates bf16 operands from f32).
    Max abs error per tile kind over the matching cases."""
    bu, ni = 376, 1000
    gen = torch.Generator().manual_seed(2)
    order = torch.zeros(1, dtype=torch.int64)
    worst = {}
    failures = []
    for kind in ("f32+W", "bf16+W", "codes"):
        R, W, r_scale = _tiles(kind, 1, bu, ni, gen, dev)
        for k in (32, 64, 128):
            u3 = _dyadic((1, bu, k), gen).to(dev)
            i_tab = _dyadic((ni, k), gen).to(dev)
            assert torch.equal(u3.to(torch.bfloat16).float() * 256,
                               (u3 * 256).round())
            for cn in (True, False):
                lr = LR if cn else LR / COUNT_PER_USER
                kern, plain = {}, {}
                for mm in (True, False):
                    kern[mm], plain[mm] = _epoch_pair(
                        u3, i_tab, order, lr, R, W, r_scale, cn, mm)
                for mm in (True, False):
                    a, r, ratio = _errors(kern[mm], plain[mm],
                                          EXACT_RTOL, EXACT_ATOL)
                    ctl = _errors(kern[mm], plain[not mm],
                                  EXACT_RTOL, EXACT_ATOL)[2]
                    worst[kind] = max(worst.get(kind, 0.0), a)
                    ok = ratio <= 1.0 and ctl > 1.0
                    log(f"(c) exact-bf16 {kind:6s} k={k:3d} "
                        f"mm_bf16={mm!s:5s} collision_norm={cn!s:5s} "
                        f"max_abs {a:.3e} max_rel {r:.3e} err/tol "
                        f"{ratio:.3e}; control vs mm_bf16={not mm!s:5s} "
                        f"err/tol {ctl:.3e} (must be > 1) "
                        f"{'ok' if ok else 'FAIL'}")
                    if not ok:
                        failures.append((kind, k, mm, cn))
    if failures:
        raise AssertionError(
            f"exact-bf16 cases failed (rtol {EXACT_RTOL}, atol "
            f"{EXACT_ATOL}; a control that agrees fails too): {failures}")
    return worst


def _check_and_time(tag: str, solver, state, lr: float, reps: int = 2):
    """One epoch from ``state`` on the solver's staged tiles, through the
    kernel and through the plain version, held together at RTOL / ATOL;
    then ms per epoch of each, alternating plain, kernel, kernel, plain,
    CUDA-event timed. Returns (max abs error, kernel ms, plain ms)."""
    u3, i_tab = solver.stage_factors(state)
    order = torch.randperm(solver.NU, generator=torch.Generator()
                           .manual_seed(1))
    args = (solver.R_rows, solver.W_rows)
    p = solver.params

    def kernel():
        return drk.dense_rows_epoch(u3.clone(), i_tab.clone(), order, lr,
                                    *args, solver.r_scale, p.u_reg, p.i_reg,
                                    solver.collision_norm, solver.mm_bf16)

    def plain():
        return dense_sweep_rows(u3.clone(), i_tab.clone(), order, lr, *args,
                                p.u_reg, p.i_reg, solver.collision_norm,
                                solver.mm_bf16, r_scale=solver.r_scale)

    a, r, ratio = _errors(kernel(), plain())
    log(f"({tag}) first epoch replayed on the staged tiles, kernel vs "
        f"plain: max_abs {a:.3e} max_rel {r:.3e} err/tol {ratio:.3e} "
        f"{'ok' if ratio <= 1.0 else 'FAIL'}")
    if ratio > 1.0:
        raise AssertionError(f"({tag}) kernel disagrees with the plain "
                             f"version on the main path's tiles (rtol "
                             f"{RTOL}, atol {ATOL})")

    def timed(fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    kernel(), plain()   # warm-up
    torch.cuda.synchronize()
    plain_ms = [timed(plain)]
    kernel_ms = [timed(kernel), timed(kernel)]
    plain_ms.append(timed(plain))
    return a, float(np.mean(kernel_ms)), float(np.mean(plain_ms))


def phase_main_path(tag: str, data: Data, params: Params,
                    expect_codes: bool, dev="cuda"):
    drk.dense_rows_epoch.launches = 0
    t0 = time.perf_counter()
    rep, model, ev, _ = train_model(data, params, algo="mf",
                                    mf_method="densesgd", device=dev,
                                    log_fn=lambda s: log(f"({tag}) {s}"))
    wall = time.perf_counter() - t0
    launches = drk.dense_rows_epoch.launches
    solver = rep.solver
    log(f"({tag}) staged NU={solver.NU} bu={solver.bu} ni_pad="
        f"{solver.n_items_pad} R={solver.R_rows.dtype} W="
        f"{None if solver.W_rows is None else solver.W_rows.dtype} "
        f"r_scale={solver.r_scale} nnz={solver.nnz}; train_model wall "
        f"{wall:.1f} s; stop={rep.stop_reason}")
    if expect_codes:
        assert solver.W_rows is None and solver.r_scale == 0.5, \
            "star ratings should stage int8 code tiles"
    else:
        assert solver.W_rows is not None and \
            solver.R_rows.dtype == torch.bfloat16, \
            "continuous ratings at this shape should stage bf16 R + int8 W"
    epochs = len(rep.history)
    assert rep.stop_reason == "max_iter" and epochs == params.max_iter, \
        (rep.stop_reason, epochs)
    want = epochs * solver.NU * drk.KERNELS_PER_STRIPE
    assert launches == want, f"kernel launches {launches} != {want}"
    # the state train_model started from
    s0 = init_state(params, data.n_users, data.n_items, device=dev)
    val0 = ev.rmse(model.eval_view(s0), "val")
    vals = [h.val_rmse for h in rep.history]
    log(f"({tag}) val RMSE at init {val0!r}, per epoch {vals!r}")
    assert all(np.isfinite(vals)), vals
    assert rep.best_metric < val0, (rep.best_metric, val0)
    for t in rep.state[:2]:
        assert bool(torch.isfinite(t).all())
    assert tuple(rep.state.u_fac.shape) == (data.n_users, params.fac_dim)
    assert tuple(rep.state.i_fac.shape) == (data.n_items, params.fac_dim)
    loop_ms = [1e3 * h.seconds for h in rep.history]
    steady = float(np.median(loop_ms[1:])) if epochs > 1 else loop_ms[0]
    err, kernel_ms, plain_ms = _check_and_time(tag, solver, s0,
                                               params.learn_rate)
    log(f"({tag}) epoch in the loop (host clock, synchronized): "
        f"{loop_ms!r} ms; median after the first {steady:.3f} ms = "
        f"{solver.nnz / steady * 1e3:.4e} ratings/s")
    log(f"({tag}) stripe epoch alone (CUDA events): kernel "
        f"{kernel_ms:.3f} ms = {solver.nnz / kernel_ms * 1e3:.4e} "
        f"ratings/s; plain PyTorch {plain_ms:.3f} ms = "
        f"{solver.nnz / plain_ms * 1e3:.4e} ratings/s")
    del rep, solver, ev
    torch.cuda.empty_cache()
    return launches, err, kernel_ms, plain_ms


def bench_data(n_users, n_items, density, noise, power_law, stars, val_pc):
    t0 = time.perf_counter()
    mat, _, _ = low_rank_ratings(n_users, n_items, k=8, density=density,
                                 seed=0, noise=noise, power_law=power_law,
                                 nonneg=True)
    if stars:
        mat.values[:] = (np.clip(np.round(mat.values / 0.5), 1, 10)
                         * 0.5).astype(np.float32)
    tr, te, va = split_train_test_val(mat, 0.1, val_pc, seed=1)
    data = Data(train_mat=tr, test_mat=te, val_mat=va)
    log(f"data {data} made in {time.perf_counter() - t0:.1f} s")
    return data


def run_cell(tag: str):
    data_kw, params_kw, expect_codes = CELLS[tag]
    data = bench_data(**data_kw)
    return phase_main_path(tag, data, Params(**params_kw), expect_codes)


# ----------------------------------------------------------------------
# (f) and (g): the top-N kernel and the ranking path
# ----------------------------------------------------------------------

# bench.py's BPR + HR@10 shape and step (bench.py:44-55, 191-193,
# 210-211), split 80/10/10, with the regularization of the JAX package's
# own end-to-end BPR run at this shape (scripts/tpu_bpr_end2end.py:65):
# at bench.py's 0.01 the per-occurrence decay shrinks the popular items
# faster than lr 0.005 (x0.9 per epoch) grows them, and val HR@10 falls
# below its initial value and stays there (30 epochs at 20k x 4k on the
# CPU). Cut to 8 epochs: HR@10 dips in the first two and lifts from the
# third (same CPU run); the margin is for the 5x larger catalog.
BPR_CELL = (dict(n_users=100_000, n_items=20_000, density=0.005, noise=0.1,
                 power_law=0.6, stars=False, val_pc=0.1),
            dict(fac_dim=64, u_reg=0.001, i_reg=0.001, learn_rate=0.005,
                 seed=0, batch_size=65_536, n_negatives=2,
                 bpr_sampler="rankgap", eval_user_block=4096,
                 eval_item_block=32768, max_iter=8, obj_iter=1,
                 disp_iter=1, save_iter=1))
RUN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                       "chip_smoke")


def _csr(rated: torch.Tensor):
    """(int64 indptr, int32 indices) of a [n_users, n_items] bool mask."""
    r, c = rated.nonzero(as_tuple=True)
    indptr = torch.zeros(rated.shape[0] + 1, dtype=torch.int64)
    indptr[1:] = torch.cumsum(torch.bincount(r, minlength=rated.shape[0]),
                              0)
    return indptr, c.to(torch.int32)


def topk_case(n_users: int, n_items: int, k: int, exact: bool,
              gen: torch.Generator, dev) -> dict:
    """topk_catalog's inputs. ~5% invalid items; train rows at ~5% density;
    users 0-3 rated every item but 40 (fewer scorable items than n at
    n >= 100), users 4-5 every item (none scorable); every user queried,
    in a random order, some twice. exact=True: factors +-m/256 (_dyadic
    rounded to bf16, m in 65..127), biases and mu multiples of 1/64, so
    every score is exact in f32 in any summation order; a tenth of the
    items copy another item's row and bias: exact ties."""
    if exact:
        u = _dyadic((n_users, k), gen).bfloat16().float()
        i = _dyadic((n_items, k), gen).bfloat16().float()
        ub = torch.randint(-64, 65, (n_users,), generator=gen) / 64.0
        ib = torch.randint(-64, 65, (n_items,), generator=gen) / 64.0
        mu = torch.tensor(0.25)
        dst = torch.randperm(n_items, generator=gen)[: n_items // 10]
        src = torch.randint(0, n_items, (len(dst),), generator=gen)
        i[dst], ib[dst] = i[src], ib[src]
    else:
        u = 0.3 * torch.randn((n_users, k), generator=gen)
        i = 0.3 * torch.randn((n_items, k), generator=gen)
        ub = 0.1 * torch.randn((n_users,), generator=gen)
        ib = 0.1 * torch.randn((n_items,), generator=gen)
        mu = torch.tensor(0.3)
    rated = torch.rand((n_users, n_items), generator=gen) < 0.05
    rated[:6] = True
    for r in range(4):
        rated[r, torch.randperm(n_items, generator=gen)[:40]] = False
    indptr, indices = _csr(rated)
    users = torch.cat([torch.randperm(n_users, generator=gen),
                       torch.randint(0, n_users, (37,), generator=gen)])
    case = dict(u_fac=u, i_fac=i, i_bias=ib, u_bias=ub, mu=mu,
                invalid=torch.rand((n_items,), generator=gen) < 0.05,
                indptr=indptr, indices=indices, users=users)
    return {key: t.to(dev) for key, t in case.items()}


def topk_agree(got, want, exact: bool):
    """(ok, max abs score error, share of slots whose ids were held).
    Scores within TOPK_RTOL / TOPK_ATOL (exact: equal); ids equal at every
    slot whose score is further than twice that from both neighbours
    (exact: every slot); id -1 slots always."""
    gs, gi = (t.cpu() for t in got)
    ws, wi = (t.cpu() for t in want)
    tol = TOPK_ATOL + TOPK_RTOL * ws.abs()
    err = float((gs - ws).abs().max()) if ws.numel() else 0.0
    if exact:
        ok_s = torch.equal(gs, ws)
        held = torch.ones_like(wi, dtype=torch.bool)
    else:
        ok_s = bool(((gs - ws).abs() <= tol).all())
        inf = torch.full((ws.shape[0], 1), float("inf"))
        gap = ws[:, :-1] - ws[:, 1:]
        before = torch.cat([inf, gap], 1)
        after = torch.cat([gap, inf], 1)
        held = ((before > 2 * tol) & (after > 2 * tol)) | (wi == -1)
    ok = ok_s and bool((gi[held] == wi[held]).all())
    return ok, err, float(held.float().mean())


def phase_topk_vs_plain(dev="cuda") -> float:
    """Max abs score error over all (f) cases."""
    gen = torch.Generator().manual_seed(3)
    n_users, n_items = 600, 3001   # ragged against every tile
    worst, failures = 0.0, []
    for exact in (False, True):
        for k in (32, 64, 128):
            case = topk_case(n_users, n_items, k, exact, gen, dev)
            for n in (1, 10, 100, 1000):
                got = tk.topk_catalog(**case, n=n)
                want = tk.topk_plain(**case, n=n)
                torch.cuda.synchronize()
                ok, err, held = topk_agree(got, want, exact)
                worst = max(worst, err)
                pads = int((want[1] == -1).sum())
                ties = int((want[0][:, 1:] == want[0][:, :-1]).logical_and(
                    want[1][:, 1:] >= 0).sum())
                log(f"(f) {'exact' if exact else 'random'} k={k:3d} "
                    f"n={n:4d} max_abs {err:.3e} ids held at {held:.4f} of "
                    f"slots; -1 slots {pads}, tied neighbours {ties} "
                    f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    failures.append((exact, k, n))
    if failures:
        raise AssertionError(f"top-N kernel disagrees with topk_plain "
                             f"(rtol {TOPK_RTOL}, atol {TOPK_ATOL}; exact "
                             f"cases exactly): {failures}")
    return worst


def _cuda_ms(fn, reps: int = 1) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _held_metric(tag, name, kern, plain, rows_differ, n_val):
    """A LOO metric from the kernel's and the plain version's ids: equal,
    but for users whose id rows differ at near-ties (one credit each)."""
    bound = rows_differ / max(n_val, 1)
    ok = abs(kern - plain) <= bound
    log(f"(g) {name}: kernel {kern!r} plain {plain!r} ({rows_differ} of "
        f"the users' id rows differ at near-ties, bound {bound:.3e}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"({tag}) {name} kernel vs plain")


def phase_ranking(dev="cuda"):
    """(g): returns (launches, max abs error, kernel ms, plain ms) of the
    HR@10 top-N pass over every user."""
    data_kw, params_kw = BPR_CELL
    data = bench_data(**data_kw)
    params = Params(**params_kw)
    os.makedirs(RUN_DIR, exist_ok=True)
    prefix = os.path.join(RUN_DIR, "bpr")
    tk.topk_catalog.launches = 0
    t0 = time.perf_counter()
    rep, model, scorer, _ = train_model(data, params, algo="bpr",
                                        mf_method="train", device=dev,
                                        prefix=prefix,
                                        log_fn=lambda s: log(f"(g) {s}"))
    wall = time.perf_counter() - t0
    launches = tk.topk_catalog.launches
    epochs = len(rep.history)
    assert rep.stop_reason == "max_iter" and epochs == params.max_iter, \
        (rep.stop_reason, epochs)
    per_pass = (-(-data.n_users // tk.chunk_users(data.n_items))
                * tk.KERNELS_PER_CHUNK)
    want = (1 + epochs) * per_pass   # the initial check and one per epoch
    assert launches == want, f"top-N launches {launches} != {want}"
    solver = rep.solver
    s0 = init_state(params, data.n_users, data.n_items, device=dev)
    hr0 = scorer.hit_rate(model.eval_view(s0), data.val_mat, 10)
    hrs = [h.val_rmse for h in rep.history]
    log(f"(g) {solver.n_pos} positives in {solver.n_batches} batches; "
        f"train_model wall {wall:.1f} s; val HR@10 at init {hr0!r}, per "
        f"epoch {hrs!r}, best {rep.best_metric!r} at epoch "
        f"{rep.best_iter}; top-N launches {launches}")
    assert all(np.isfinite(hrs)), hrs
    assert rep.best_metric > hr0, (rep.best_metric, hr0)

    view = model.eval_view(rep.best_state)
    args = dict(u_fac=view.u_fac, i_fac=view.i_fac, i_bias=view.i_bias,
                u_bias=view.u_bias, mu=view.mu,
                invalid=scorer.invalid_items_dev, indptr=scorer.indptr,
                indices=scorer.indices, users=scorer._all_users)
    got = tk.topk_catalog(**args, n=10)
    want10 = tk.topk_plain(**args, n=10)
    ok, err, held = topk_agree(got, want10, False)
    log(f"(g) top-10 of all {data.n_users} users on the best view, kernel "
        f"vs plain: max_abs {err:.3e}, ids held at {held:.4f} of slots "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("(g) top-10 kernel vs plain")
    n_val = scorer._loo_staged(data.val_mat)[2]
    _held_metric("g", "val HR@10", scorer.hit_rate(view, data.val_mat, 10),
                 scorer.loo_credit(want10[1], data.val_mat, False),
                 int((got[1] != want10[1]).any(1).sum()), n_val)
    got1k = tk.topk_catalog(**args, n=1000)
    want1k = tk.topk_plain(**args, n=1000)
    ok1k, err1k, held1k = topk_agree(got1k, want1k, False)
    log(f"(g) top-1000, kernel vs plain: max_abs {err1k:.3e}, ids held at "
        f"{held1k:.4f} of slots {'ok' if ok1k else 'FAIL'}")
    if not ok1k:
        raise AssertionError("(g) top-1000 kernel vs plain")
    n_test = scorer._loo_staged(data.test_mat)[2]
    _held_metric("g", "test ARHR (n=1000)",
                 scorer.arhr(view, data.test_mat, 1000),
                 scorer.loo_credit(want1k[1], data.test_mat, True),
                 int((got1k[1] != want1k[1]).any(1).sum()), n_test)
    del got1k, want1k

    rec = Recommender.from_checkpoint(prefix, params, data, device=dev)
    users = torch.randperm(data.n_users, generator=torch.Generator()
                           .manual_seed(5))[:2048]
    items, scores = rec.recommend(users.numpy(), n=10)
    rv = rec.view
    want_r = tk.topk_plain(rv.u_fac, rv.i_fac, rv.i_bias, rv.u_bias, rv.mu,
                           scorer.invalid_items_dev, scorer.indptr,
                           scorer.indices, users.to(dev), 10)
    ok_r, err_r, held_r = topk_agree(
        (torch.from_numpy(scores), torch.from_numpy(items).to(torch.int32)),
        want_r, False)
    log(f"(g) Recommender.from_checkpoint: 2048 users at n=10 vs plain: "
        f"max_abs {err_r:.3e}, ids held at {held_r:.4f} of slots "
        f"{'ok' if ok_r else 'FAIL'}")
    if not ok_r:
        raise AssertionError("(g) Recommender kernel vs plain")

    # timings: the loop's epochs (host clock, synced), and the HR@10 top-N
    # pass over every user, CUDA events after the bench's 2 warm-ups, in
    # turns plain, kernel, kernel, plain
    epoch_ms = [1e3 * h.seconds for h in rep.history]
    steady = float(np.median(epoch_ms[1:])) if epochs > 1 else epoch_ms[0]
    kern = lambda: tk.topk_catalog(**args, n=10)
    plain = lambda: tk.topk_plain(**args, n=10)
    for _ in range(2):
        kern(), plain()
    p_ms = [_cuda_ms(plain)]
    k_ms = [_cuda_ms(kern), _cuda_ms(kern)]
    p_ms.append(_cuda_ms(plain))
    hr_ms = _cuda_ms(lambda: scorer.hit_rate(view, data.val_mat, 10), 2)
    log(f"(g) BPR epoch in the loop (host clock, synchronized): "
        f"{epoch_ms!r} ms; median after the first {steady:.3f} ms = "
        f"{solver.n_pos / steady * 1e3:.4e} pairs/s")
    log(f"(g) HR@10 top-N pass over {data.n_users} users x "
        f"{data.n_items} items (CUDA events): kernel {k_ms!r} ms, plain "
        f"{p_ms!r} ms; scorer.hit_rate (kernel, LOO credit included) "
        f"{hr_ms:.3f} ms")
    del rep, solver, scorer, rec, got, want10
    torch.cuda.empty_cache()
    return (launches, max(err, err1k, err_r), float(np.mean(k_ms)),
            float(np.mean(p_ms)))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; nothing to run",
              file=sys.stderr)
        return 2
    smi = phase_env()
    phase_build()
    worst = phase_kernel_vs_plain()
    exact = phase_bf16_rounding()
    n_d, err_d, k_d, p_d = run_cell("d")
    n_e, err_e, k_e, p_e = run_cell("e")
    err_f = phase_topk_vs_plain()
    n_g, err_g, k_g, p_g = phase_ranking()

    float_err = max(worst["f32+W"], worst["bf16+W"], exact["f32+W"],
                    exact["bf16+W"], err_d)
    kernels = [
        {"name": "dense_rows<f32|bf16 R, int8 W>", "route": "cuda",
         "source": SOURCE,
         "replaces": "matfac_tpu/ops/dense_row_kernel.py:108",
         "launches": n_d, "max_abs_err": float_err, "ms": k_d,
         "plain_ms": p_d},
        {"name": "dense_rows<int8 codes>", "route": "cuda",
         "source": SOURCE,
         "replaces": "matfac_tpu/ops/dense_row_kernel.py:231",
         "launches": n_e,
         "max_abs_err": max(worst["codes"], exact["codes"], err_e),
         "ms": k_e, "plain_ms": p_e},
        {"name": "topk_catalog", "route": "cuda", "source": TOPK_SOURCE,
         "replaces": "matfac_tpu/ops/topk_kernel.py:118",
         "launches": n_g, "max_abs_err": max(err_f, err_g), "ms": k_g,
         "plain_ms": p_g},
    ]
    log(smi)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
