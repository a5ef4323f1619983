"""Smoke run of the PyTorch / CUDA port (matfac_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root

Phases, in order; any failure raises and the script exits non-zero:
  (a) environment: the card's name and power limit, torch and CUDA versions;
  (b) build: nvcc compiles every csrc/*.cu into build/, one process each,
      all at once (timed);
  (c) kernel vs plain: one stripe epoch of the hand-written kernel against
      the plain PyTorch version on the same CUDA tensors, for every tile
      type (f32 / bf16 R with int8 validity or float weights of R's type,
      int8 codes) x mm_bf16 x collision_norm at k = 32, 64, 128, on a
      ragged shape; then the same cases on one stripe whose bf16 rounding
      is exact, at a tight tolerance, with controls (kernel in one matmul
      precision against plain in the other) that must FAIL; then half-star
      int8 codes against f32 and bf16 tiles of the same ratings, which must
      give bit-identical factors;
  (d) main path, float tiles: train_model(algo="mf", mf_method="densesgd")
      at 100,000 x 20,000, density 0.005 (~9.9M continuous ratings), k=64;
  (e) main path, code tiles: the ML-20M shape (138,000 x 27,000, ~20M
      half-star ratings), k=64;
  (f) top-N kernel vs plain: csrc/topk.cu against topk_plain on the same
      CUDA tensors at k = 32, 64, 128 and n = 1, 10, 100, 127, 128, 129,
      1000 (the fused route up to FUSED_MAX_N = 128, here with catalog
      slices and the merge; the radix route above), then 20,000 queried
      rows at n = 10, 128 (the fused route in one launch), on a ragged
      catalog with invalid items, heavy and fully rated users, mu and
      biases (scores at rtol 1e-5 / atol 1e-6, ids where scores are
      further apart than that), and on exact-score cases with duplicated
      item rows, where ids must match exactly, smallest id first; each
      call's launches must match its plan;
  (g) the ranking path: train_model(algo="bpr", mf_method="train") at
      100,000 x 20,000 (bench.py's BPR and HR@10 shape), k=64, 8 epochs
      with val HR@10 through the fused kernel after each, test ARHR at
      n=1000 (the radix route) and Recommender.from_checkpoint answering
      2,048 users (the fused route, catalog slices); then kernel vs plain
      on the best view (top-10 of every user, val HR@10, top-1000, test
      ARHR, the Recommender's answers), the fused pass's memory (no score
      scratch), and the passes timed, the radix route beside the fused one.
  (h) one-hot cell kernel vs plain: csrc/block_sgd.cu against the plain
      PyTorch versions on the same CUDA tensors: the row schedule, the diag
      schedule (with a dummy lane) and fused_cell_update's single cell;
      collision normalization, rank mask, 0/1 and float weights, ids
      repeating within every batch, batch offsets and several steps per
      cell, segment sums in a cluster's shared memory (small blocks and
      the JAX default 1024-blocks) and in the global scratch; f32 and bf16
      products; then one-step cases whose bf16 rounding is exact, each
      with a control in the other precision that must FAIL;
  (i) main path of the one-hot engine: train_model(algo="mf",
      mf_method="blocksgd") on (d)'s data, k=64, lr 0.005, 5 epochs: the
      DSGD diag schedule, 384-blocks (261 x 53), 1024-rating steps, one
      kernel launch per epoch (a cluster per lane, a grid barrier per
      round); then fused_cell_update over the cells of one round of its
      staged streams, one call (one launch) per cell;
  (j) the long-tail models on the same engine: algo="tmf" (rank masks)
      and algo="ifwmf" (float weights), 2 epochs each;
  (k) the row schedule at full shape: one epoch of
      BlockSGDSolver(engine="pallas", schedule="row", batch_size=1024) with
      the JAX default blocks of 1024 (98 x 20), one launch: one cluster of
      16 CTAs (8 where the card cannot host 16) walks the 1,960 cells;
  (l) IFWMF on the stripe engine: train_model(algo="ifwmf",
      mf_method="densesgd") on (d)'s data, 2 epochs: its popularity
      weights stage as bf16 W beside bf16 R;
  (m) the toolchain probes (csrc/bisect_probes.cu) at the JAX probes'
      shapes, each once against its plain version (exact), then timed.
(d), (e) and (l) check that every stripe went through the kernel (launch count),
that val RMSE is finite and below its value at the initial state, replay
the main path's first epoch on its staged tiles through the kernel and
through the plain version and hold them together (rtol 1e-3 / atol 1e-5),
check that the kernel's epoch run twice gives bit-identical factors, and
time both on those tensors. (g) checks each step's top-N launches against
the wrapper's plan, that HR@10 is finite every epoch and its best above
the initial state's. (i),
(j) and (k) check the launch count and the kernel's device count of
finished cells, that the objective and val RMSE are finite and fall,
replay a first epoch on the staged streams through kernel and plain with
one schedule and hold them to (h)'s bf16 class, and time both.

The line before the last is a JSON record of the kernels: per kernel its
launches on the main path, max abs error against the plain version, its
time and the plain version's on the main path's inputs, the least time the
card could take for the same work (bound_ms: bytes each read or written
once at 3.35 TB/s, or operations at the peak of their type, whichever is
larger; bound_by says which) and, where PyTorch has one, a library
yardstick (library_ms). The last line is {"ok": true, "device": {...}}.
Without a CUDA device the script exits non-zero and prints no result.
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
from matfac_tpu_torch.models.base import ModelMF, init_state
from matfac_tpu_torch.ops import _build
from matfac_tpu_torch.ops import bisect_probes as bp
from matfac_tpu_torch.ops import block_sgd_kernel as bsk
from matfac_tpu_torch.ops import dense_row_kernel as drk
from matfac_tpu_torch.ops import sgd_kernel as sk
from matfac_tpu_torch.ops import topk_kernel as tk
from matfac_tpu_torch.ops.dense_block_kernel import dense_sweep_rows
from matfac_tpu_torch.serving import Recommender
from matfac_tpu_torch.solvers.block_sgd import (BlockSGDSolver,
                                                stage_batch_collision_counts)
from matfac_tpu_torch.train.loop import TrainLoop, train_model

SOURCE = "matfac_tpu_torch/csrc/dense_rows.cu"
TOPK_SOURCE = "matfac_tpu_torch/csrc/topk.cu"
BLOCK_SOURCE = "matfac_tpu_torch/csrc/block_sgd.cu"
PROBE_SOURCE = "matfac_tpu_torch/csrc/bisect_probes.cu"
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

# The stripe engine's configurations: synthetic data (bench_data), Params,
# and the tiles the ladder should stage ("codes": int8 rating codes; else
# R's type + W's type).
CELLS = {
    # bench.py's full shape, continuous ratings -> bf16 R + int8 W
    "d": (dict(n_users=100_000, n_items=20_000, density=0.005, noise=0.1,
               power_law=0.6, stars=False, val_pc=0.1),
          dict(fac_dim=64, u_reg=0.01, i_reg=0.01, learn_rate=0.05, seed=0,
               max_iter=5, obj_iter=1, disp_iter=1),
          "bf16+W"),
    # scripts/ml20m_flagship.py's shape, half stars -> int8 codes
    "e": (dict(n_users=138_000, n_items=27_000,
               density=20e6 / (138_000 * 27_000), noise=0.35,
               power_law=0.8, stars=True, val_pc=0.05),
          dict(fac_dim=64, u_reg=0.002, i_reg=0.002, learn_rate=0.05,
               seed=0, max_iter=3, obj_iter=1, disp_iter=1),
          "codes"),
}
# IFWMF on (d)'s data, 2 epochs, float W: at 41 x 2560 x 20096 slots f32 W
# misses the 8 GiB dense budget, so bf16 W + bf16 R. At the default weight
# scale rho_rms 1 the weights are 0.99998-0.99999 here and round to exactly
# 1.0 in bf16; rho_rms 1e4 spreads them over 0.868-0.949 (22 bf16 values),
# so the tiles carry real weights (the model's weights on this data, as
# phase (l) logs them).
CELLS["l"] = (CELLS["d"][0], dict(CELLS["d"][1], max_iter=2, rho_rms=1e4),
              "bf16+bfW")
CELL_ALGO = {"d": "mf", "e": "mf", "l": "ifwmf"}
TILE_KINDS = ("f32+W", "bf16+W", "codes", "f32+fW", "bf16+bfW")
# H100 SXM peaks (NVIDIA's data sheet)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}


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
    """Every source at once (one nvcc each), then load each."""
    t0 = time.perf_counter()
    paths = _build.build_all(["dense_rows", "topk", "block_sgd",
                              "bisect_probes"])
    for mod in (drk, tk, bsk, bp):
        mod.library()
    dt = time.perf_counter() - t0
    log(f"(b) build + load of {SOURCE}, {TOPK_SOURCE}, {BLOCK_SOURCE} and "
        f"{PROBE_SOURCE}: {dt:.2f} s "
        f"({', '.join(p.name for p in paths.values())})")
    return dt


def _tiles(kind: str, NU: int, bu: int, ni: int, gen: torch.Generator,
           dev):
    """Random stripe tiles, ~5% valid: (R, W, r_scale). "+W": int8
    validity; "+fW" / "+bfW": weights in [0.2, 1) of R's type (IFWMF)."""
    valid = torch.rand((NU, bu, ni), generator=gen) < 0.05
    if kind == "codes":
        codes = torch.randint(1, 11, (NU, bu, ni), generator=gen)
        R = torch.where(valid, codes, 0).to(torch.int8)
        return R.to(dev), None, 0.5
    ratings = 1.0 + 4.0 * torch.rand((NU, bu, ni), generator=gen)
    rtype = torch.bfloat16 if kind.startswith("bf16") else torch.float32
    R = torch.where(valid, ratings, 0.0).to(rtype)
    if kind.endswith("+W"):
        W = valid.to(torch.int8)
    else:
        W = torch.where(valid, 0.2 + 0.8 * torch.rand((NU, bu, ni),
                                                      generator=gen),
                        0.0).to(rtype)
    return R.to(dev), W.to(dev), None


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
    for kind in TILE_KINDS:
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
                    log(f"(c) {kind:8s} k={k:3d} mm_bf16={mm!s:5s} "
                        f"collision_norm={cn!s:5s} max_abs {a:.3e} "
                        f"max_rel {r:.3e} err/tol {ratio:.3e} "
                        f"{'ok' if ok else 'FAIL'}")
                    if not ok:
                        failures.append((kind, k, mm, cn))
    if failures:
        raise AssertionError(f"kernel disagrees with the plain version "
                             f"(rtol {RTOL}, atol {ATOL}): {failures}")
    return worst


def phase_codes_vs_float(dev="cuda") -> int:
    """Half-star tiles: int8 codes (r_scale 0.5) and float tiles of code *
    0.5 with int8 validity (f32 and bf16 R) must give bit-identical factors
    through the kernel (fixed-point gradient sums on a grid fixed by k), at
    k = 32, 64, 128, in both matmul precisions, with and without collision
    normalization. Returns the number of cases."""
    NU, bu, ni = 8, 376, 1000
    gen = torch.Generator().manual_seed(4)
    codes, _, _ = _tiles("codes", NU, bu, ni, gen, dev)
    W = (codes != 0).to(torch.int8)
    floats = {t: ((codes.float() * 0.5).to(t), W)
              for t in (torch.float32, torch.bfloat16)}
    failures, cases = [], 0
    for k in (32, 64, 128):
        u3 = torch.randn((NU, bu, k), generator=gen).to(dev)
        i_tab = torch.randn((ni, k), generator=gen).to(dev)
        order = torch.randperm(NU, generator=gen)
        for mm in (True, False):
            scale = SCALE_BF16 if mm else SCALE_F32
            for cn in (True, False):
                lr = LR if cn else LR / COUNT_PER_USER
                run = lambda R, W_, r_scale: drk.dense_rows_epoch(
                    scale * u3, scale * i_tab, order, lr, R, W_, r_scale,
                    REG, REG, cn, mm)
                want = run(codes, None, 0.5)
                for rtype, (R, W_) in floats.items():
                    got = run(R, W_, None)
                    same = all(torch.equal(x, y) for x, y in zip(got, want))
                    cases += 1
                    log(f"(c) codes vs {str(rtype)[6:]} R + int8 W k={k:3d} "
                        f"mm_bf16={mm!s:5s} collision_norm={cn!s:5s} "
                        f"bit-identical {same} {'ok' if same else 'FAIL'}")
                    if not same:
                        failures.append((rtype, k, mm, cn))
    if failures:
        raise AssertionError(f"codes and float tiles differ: {failures}")
    return cases


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
    for kind in TILE_KINDS:
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
                    log(f"(c) exact-bf16 {kind:8s} k={k:3d} "
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


def _check_and_time(tag: str, solver, state, lr: float, reps: int = 2,
                    mm_bf16=None):
    """One epoch from ``state`` on the solver's staged tiles, through the
    kernel and through the plain version, held together at RTOL / ATOL; the
    kernel's epoch run twice must give bit-identical factors (fixed-point
    gradient sums); then ms per epoch of each, alternating plain, kernel,
    kernel, plain,
    CUDA-event timed; in the solver's matmul precision unless ``mm_bf16``
    says otherwise. Returns (max abs error, kernel ms, plain ms)."""
    mm = solver.mm_bf16 if mm_bf16 is None else mm_bf16
    u3, i_tab = solver.stage_factors(state)
    order = torch.randperm(solver.NU, generator=torch.Generator()
                           .manual_seed(1))
    args = (solver.R_rows, solver.W_rows)
    p = solver.params

    def kernel():
        return drk.dense_rows_epoch(u3.clone(), i_tab.clone(), order, lr,
                                    *args, solver.r_scale, p.u_reg, p.i_reg,
                                    solver.collision_norm, mm,
                                    counts=solver.counts)

    def plain():
        return dense_sweep_rows(u3.clone(), i_tab.clone(), order, lr, *args,
                                p.u_reg, p.i_reg, solver.collision_norm,
                                mm, r_scale=solver.r_scale)

    a, r, ratio = _errors(kernel(), plain())
    log(f"({tag}) first epoch replayed on the staged tiles, kernel vs "
        f"plain: max_abs {a:.3e} max_rel {r:.3e} err/tol {ratio:.3e} "
        f"{'ok' if ratio <= 1.0 else 'FAIL'}")
    if ratio > 1.0:
        raise AssertionError(f"({tag}) kernel disagrees with the plain "
                             f"version on the main path's tiles (rtol "
                             f"{RTOL}, atol {ATOL})")
    same = all(torch.equal(x, y) for x, y in zip(kernel(), kernel()))
    log(f"({tag}) the same epoch through the kernel twice: bit-identical "
        f"factors {same} {'ok' if same else 'FAIL'}")
    if not same:
        raise AssertionError(f"({tag}) two runs of one epoch differ")
    return (a, *_alternate(kernel, plain, reps))


def _bound(nbytes: float, flops: float, peak: str):
    """(least ms the card could take, "bytes" or "operations"): nbytes
    each read or written once at HBM rate, flops at the peak of ``peak``."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[peak] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def stripe_bound(solver):
    """Bound of one stripe-engine epoch: every tile read once, U and I read
    and written once; three products of 2k FLOP a slot on the bf16 tensor
    cores (the f32 CUDA-core peak without mm_bf16)."""
    k = solver.params.fac_dim
    slots = solver.NU * solver.bu * solver.n_items_pad
    nbytes = (solver.R_rows.nbytes
              + (0 if solver.W_rows is None else solver.W_rows.nbytes)
              + 2 * 4 * k * (solver.NU * solver.bu + solver.n_items_pad))
    return _bound(nbytes, 6.0 * slots * k,
                  "bf16" if solver.mm_bf16 else "f32")


def stripe_library_ms(solver) -> float:
    """The epoch's three stripe products as bf16 torch.matmul calls
    (cuBLAS) on random operands of the stripe's shapes, summed over the
    epoch's stripes: a yardstick only, the port never calls it. Min of 3
    after a warm-up, CUDA events."""
    bu, ni, k = solver.bu, solver.n_items_pad, solver.params.fac_dim
    gen = torch.Generator(device="cuda").manual_seed(0)
    rnd = lambda *shape: torch.randn(shape, device="cuda", generator=gen,
                                     dtype=torch.bfloat16)
    U, I, E = rnd(bu, k), rnd(ni, k), rnd(bu, ni)

    def epoch():
        for _ in range(solver.NU):
            U @ I.T, E.T @ U, E @ I

    epoch()
    torch.cuda.synchronize()
    return min(_cuda_ms(epoch) for _ in range(3))


def phase_main_path(tag: str, data: Data, params: Params, tiles: str,
                    dev="cuda", algo: str = "mf"):
    drk.dense_rows_epoch.launches = 0
    t0 = time.perf_counter()
    rep, model, ev, _ = train_model(data, params, algo=algo,
                                    mf_method="densesgd", device=dev,
                                    log_fn=lambda s: log(f"({tag}) {s}"))
    wall = time.perf_counter() - t0
    launches = drk.dense_rows_epoch.launches
    solver = rep.solver
    log(f"({tag}) {algo}: staged NU={solver.NU} bu={solver.bu} ni_pad="
        f"{solver.n_items_pad} R={solver.R_rows.dtype} W="
        f"{None if solver.W_rows is None else solver.W_rows.dtype} "
        f"r_scale={solver.r_scale} nnz={solver.nnz}; train_model wall "
        f"{wall:.1f} s; stop={rep.stop_reason}")
    if tiles == "codes":
        assert solver.W_rows is None and solver.r_scale == 0.5, \
            "star ratings should stage int8 code tiles"
    else:
        r, w = tiles.split("+")
        rtype = {"f32": torch.float32, "bf16": torch.bfloat16}[r]
        wtype = {"W": torch.int8, "fW": torch.float32,
                 "bfW": torch.bfloat16}[w]
        assert solver.W_rows is not None and \
            (solver.R_rows.dtype, solver.W_rows.dtype) == (rtype, wtype), \
            f"this shape should stage {tiles} tiles"
    if algo == "ifwmf":
        w = solver.W_rows[solver.W_rows > 0]
        log(f"({tag}) ifwmf weights on the tiles: min {float(w.min())!r} "
            f"max {float(w.max())!r}")
        assert float(w.min()) < 1.0
    epochs = len(rep.history)
    assert rep.stop_reason == "max_iter" and epochs == params.max_iter, \
        (rep.stop_reason, epochs)
    want = epochs * drk.epoch_launches(solver.NU, params.fac_dim,
                                       solver.mm_bf16)
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
    bound = stripe_bound(solver)
    lib_ms = stripe_library_ms(solver)
    if tag == "d":
        # the f32-product instantiation (CUDA cores), off the main path
        f32 = _check_and_time("d, f32 products", solver, s0,
                              params.learn_rate, mm_bf16=False)
        log(f"(d) f32-product epoch (CUDA cores; CUDA events): kernel "
            f"{f32[1]:.3f} ms, plain PyTorch {f32[2]:.3f} ms")
    log(f"({tag}) epoch in the loop (host clock, synchronized): "
        f"{loop_ms!r} ms; median after the first {steady:.3f} ms = "
        f"{solver.nnz / steady * 1e3:.4e} ratings/s")
    log(f"({tag}) stripe epoch alone (CUDA events): kernel "
        f"{kernel_ms:.3f} ms = {solver.nnz / kernel_ms * 1e3:.4e} "
        f"ratings/s; plain PyTorch {plain_ms:.3f} ms = "
        f"{solver.nnz / plain_ms * 1e3:.4e} ratings/s; bound {bound[0]:.3f} "
        f"ms ({bound[1]}), kernel at {bound[0] / kernel_ms:.3f} of it; "
        f"the three products as bf16 cuBLAS calls {lib_ms:.3f} ms")
    del rep, solver, ev
    torch.cuda.empty_cache()
    return dict(launches=launches, max_abs_err=err, ms=kernel_ms,
                plain_ms=plain_ms, bound_ms=bound[0], bound_by=bound[1],
                library_ms=lib_ms)


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


def run_cell(tag: str, data=None):
    data_kw, params_kw, tiles = CELLS[tag]
    data = bench_data(**data_kw) if data is None else data
    return phase_main_path(tag, data, Params(**params_kw), tiles,
                           algo=CELL_ALGO[tag])


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
    """Max abs score error over all (f) cases: 637 queried rows of a 3,001
    item catalog (the fused route splits the catalog, then merges) at n
    from 1 to 1000, around the fused route's limit FUSED_MAX_N and past it
    (the radix route); then 20,000 queried rows, whose user tiles fill the
    card (the fused route in one launch)."""
    gen = torch.Generator().manual_seed(3)
    N_F = tk.FUSED_MAX_N
    groups = [(600, (32, 64, 128), (1, 10, 100, N_F - 1, N_F, N_F + 1,
                                     1000)),
              (20_000, (64,), (10, N_F))]
    worst, failures = 0.0, []
    for n_users, ks, ns in groups:
        for exact in (False, True):
            for k in ks:
                case = topk_case(n_users, 3001, k, exact, gen, dev)
                B = case["users"].numel()
                for n in ns:
                    pl = tk.fused_plan(B, 3001, n)
                    before = tk.topk_catalog.launches
                    got = tk.topk_catalog(**case, n=n)
                    launched = tk.topk_catalog.launches - before
                    want = tk.topk_plain(**case, n=n)
                    torch.cuda.synchronize()
                    ok, err, held = topk_agree(got, want, exact)
                    ok = ok and launched == pl["launches"]
                    worst = max(worst, err)
                    pads = int((want[1] == -1).sum())
                    ties = int((want[0][:, 1:] == want[0][:, :-1])
                               .logical_and(want[1][:, 1:] >= 0).sum())
                    log(f"(f) {'exact' if exact else 'random'} B={B} k={k:3d}"
                        f" n={n:4d} {pl['route']} route, {pl['splits']} "
                        f"slices, {launched} launches; max_abs {err:.3e} ids "
                        f"held at {held:.4f} of slots; -1 slots {pads}, tied "
                        f"neighbours {ties} {'ok' if ok else 'FAIL'}")
                    if not ok:
                        failures.append((B, exact, k, n))
    if failures:
        raise AssertionError(f"top-N kernel disagrees with topk_plain "
                             f"(rtol {TOPK_RTOL}, atol {TOPK_ATOL}; exact "
                             f"cases exactly), or launched other than its "
                             f"plan: {failures}")
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


def _kernel_ms(fn, names) -> dict:
    """{name: device ms} of the kernels whose names contain each of
    ``names`` in one call of fn, by torch.profiler (one warm call first)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {name: 0.0 for name in names}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            for name in names:
                if name in e.name:
                    out[name] += e.time_range.elapsed_us() / 1e3
    return out


def _pass_bound(args: dict, n: int) -> tuple:
    """A full-catalog top-n pass: the scores' 2k FLOP a (user, item) pair
    on the f32 CUDA cores; the inputs read once, the [B, n] f32 scores and
    int32 ids written once."""
    B, (n_items, k) = args["users"].numel(), args["i_fac"].shape
    nbytes = (sum(t.nbytes for t in args.values() if torch.is_tensor(t))
              + 8 * B * n)
    return _bound(nbytes, 2.0 * B * n_items * k, "f32")


def phase_ranking(dev="cuda"):
    """(g): the main path (train with val HR@10 after each epoch, test ARHR
    at n=1000, Recommender answering 2,048 users) with the top-N counts
    zeroed just before and read after each step; then each route against
    the plain version on the best view, and timed. Returns {route:
    (launches, max abs error, kernel ms, plain ms, bound)}."""
    data_kw, params_kw = BPR_CELL
    data = bench_data(**data_kw)
    params = Params(**params_kw)
    n_users, n_items = data.n_users, data.n_items
    os.makedirs(RUN_DIR, exist_ok=True)
    prefix = os.path.join(RUN_DIR, "bpr")
    tk.topk_catalog.launches = 0
    t0 = time.perf_counter()
    rep, model, scorer, _ = train_model(data, params, algo="bpr",
                                        mf_method="train", device=dev,
                                        prefix=prefix,
                                        log_fn=lambda s: log(f"(g) {s}"))
    wall = time.perf_counter() - t0
    n_train = tk.topk_catalog.launches
    view = model.eval_view(rep.best_state)
    arhr = scorer.arhr(view, data.test_mat, 1000)
    n_arhr = tk.topk_catalog.launches - n_train
    rec = Recommender.from_checkpoint(prefix, params, data, device=dev)
    users = torch.randperm(n_users, generator=torch.Generator()
                           .manual_seed(5))[:2048]
    items, scores = rec.recommend(users.numpy(), n=10)
    n_rec = tk.topk_catalog.launches - n_train - n_arhr
    epochs = len(rep.history)
    assert rep.stop_reason == "max_iter" and epochs == params.max_iter, \
        (rep.stop_reason, epochs)
    plans = {"HR@10": tk.fused_plan(n_users, n_items, 10),
             "ARHR": tk.fused_plan(n_users, n_items, 1000),
             "recommend": tk.fused_plan(2048, n_items, 10)}
    log(f"(g) top-N plans: {plans}; launches: train_model {n_train} (the "
        f"initial check and one per epoch), test ARHR {n_arhr}, recommend "
        f"{n_rec}")
    # the initial check and one per epoch
    assert n_train == (1 + epochs) * plans["HR@10"]["launches"], n_train
    assert n_arhr == plans["ARHR"]["launches"], n_arhr
    assert n_rec == plans["recommend"]["launches"], n_rec
    assert plans["HR@10"]["route"] == "fused" and \
        plans["HR@10"]["launches"] == 1
    assert plans["recommend"]["splits"] > 1
    solver = rep.solver
    s0 = init_state(params, n_users, n_items, device=dev)
    hr0 = scorer.hit_rate(model.eval_view(s0), data.val_mat, 10)
    hrs = [h.val_rmse for h in rep.history]
    log(f"(g) {solver.n_pos} positives in {solver.n_batches} batches; "
        f"train_model wall {wall:.1f} s; val HR@10 at init {hr0!r}, per "
        f"epoch {hrs!r}, best {rep.best_metric!r} at epoch "
        f"{rep.best_iter}")
    assert all(np.isfinite(hrs)), hrs
    assert rep.best_metric > hr0, (rep.best_metric, hr0)

    args = dict(u_fac=view.u_fac, i_fac=view.i_fac, i_bias=view.i_bias,
                u_bias=view.u_bias, mu=view.mu,
                invalid=scorer.invalid_items_dev, indptr=scorer.indptr,
                indices=scorer.indices, users=scorer._all_users)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    got = tk.topk_catalog(**args, n=10)
    torch.cuda.synchronize()
    grew = torch.cuda.max_memory_allocated() - base
    log(f"(g) the fused top-10 pass allocated {grew} B beyond its inputs "
        f"(a [B, n_items] score scratch would be {4 * n_users * n_items} B)")
    assert grew < 4 * n_users * n_items / 100, grew
    want10 = tk.topk_plain(**args, n=10)
    ok, err, held = topk_agree(got, want10, False)
    log(f"(g) top-10 of all {n_users} users on the best view, kernel "
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
    _held_metric("g", "test ARHR (n=1000)", arhr,
                 scorer.loo_credit(want1k[1], data.test_mat, True),
                 int((got1k[1] != want1k[1]).any(1).sum()), n_test)
    del got1k, want1k

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

    # timings: the loop's epochs (host clock, synced); each pass over every
    # user, CUDA events after the bench's 2 warm-ups, in turns plain,
    # kernel, kernel, plain; the fused pass beside the radix route on the
    # same call (the radix route's top-(FUSED_MAX_N + 1), whose first 10
    # slots are the top-10: its time hardly depends on n)
    epoch_ms = [1e3 * h.seconds for h in rep.history]
    steady = float(np.median(epoch_ms[1:])) if epochs > 1 else epoch_ms[0]

    def turns(kernel, plain, reps=1):
        for _ in range(2):
            kernel(), plain()
        p_ms = [_cuda_ms(plain, reps)]
        k_ms = [_cuda_ms(kernel, reps), _cuda_ms(kernel, reps)]
        p_ms.append(_cuda_ms(plain, reps))
        return k_ms, p_ms

    k10, p10 = turns(lambda: tk.topk_catalog(**args, n=10),
                     lambda: tk.topk_plain(**args, n=10))
    radix = tk.FUSED_MAX_N + 1
    r10 = [_cuda_ms(lambda: tk.topk_catalog(**args, n=radix))
           for _ in range(2)]
    k1k, p1k = turns(lambda: tk.topk_catalog(**args, n=1000),
                     lambda: tk.topk_plain(**args, n=1000))
    hr_ms = _cuda_ms(lambda: scorer.hit_rate(view, data.val_mat, 10), 2)
    rec_users = users.to(dev)
    rec_args = dict(args, users=rec_users)
    rec_f = [_cuda_ms(lambda: tk.topk_catalog(**rec_args, n=10), 3)
             for _ in range(2)]
    rec_r = [_cuda_ms(lambda: tk.topk_catalog(**rec_args, n=radix), 3)
             for _ in range(2)]
    split10 = _kernel_ms(lambda: tk.topk_catalog(**args, n=radix),
                         ("score_kernel", "select_kernel"))
    split1k = _kernel_ms(lambda: tk.topk_catalog(**args, n=1000),
                         ("score_kernel", "select_kernel"))
    fused10 = _kernel_ms(lambda: tk.topk_catalog(**args, n=10),
                         ("topk_fused_kernel",))
    log(f"(g) BPR epoch in the loop (host clock, synchronized): "
        f"{epoch_ms!r} ms; median after the first {steady:.3f} ms = "
        f"{solver.n_pos / steady * 1e3:.4e} pairs/s")
    log(f"(g) top-10 pass over {n_users} users x {n_items} items (CUDA "
        f"events): fused kernel {k10!r} ms, plain {p10!r} ms, the radix "
        f"route on the same call {r10!r} ms; scorer.hit_rate (fused "
        f"kernel, LOO credit included) {hr_ms:.3f} ms")
    log(f"(g) device ms by kernel (torch.profiler, one pass): fused top-10 "
        f"{fused10}; radix top-{radix} {split10}; radix top-1000 {split1k}")
    log(f"(g) top-1000 pass (radix route): kernel {k1k!r} ms, plain "
        f"{p1k!r} ms")
    log(f"(g) recommend's top-10 of 2,048 users (CUDA events, mean of 3): "
        f"fused ({plans['recommend']['splits']} slices + merge) {rec_f!r} "
        f"ms, radix route {rec_r!r} ms")
    bound10, bound1k = _pass_bound(args, 10), _pass_bound(args, 1000)
    log(f"(g) pass bound {bound10[0]:.3f} ms ({bound10[1]}) at n=10, "
        f"{bound1k[0]:.3f} ms ({bound1k[1]}) at n=1000")
    del rep, solver, scorer, rec, got, want10
    torch.cuda.empty_cache()
    err_all = max(err, err1k, err_r)
    return {"fused": (n_train + n_rec, err_all, float(np.mean(k10)),
                      float(np.mean(p10)), bound10),
            "radix": (n_arhr, err_all, float(np.mean(k1k)),
                      float(np.mean(p1k)), bound1k)}


# ----------------------------------------------------------------------
# (h) - (k): the one-hot cell kernel and the paths that run it
# ----------------------------------------------------------------------

# f32 products: the class the JAX package pins between its two engines
# (tests/test_block_sgd.py:235-249), summation order only
BLOCK_RTOL, BLOCK_ATOL = 1e-5, 1e-6
# bf16 products over several steps: a prediction summed in another order
# can differ by one f32 ulp and flip the bf16 rounding of one -lr * g
# term, one bf16 ulp (2^-8 to 2^-7) of it. The random cases therefore take
# factors of 0.03 and lr 0.005, so a flip moves a factor by ~5e-6, below
# atol, while each step still moves the factors by ~10% (a wrong product,
# mask or count shows far above the tolerance); the main-path replays start
# from the init of +-0.01 at lr 0.005.
BF16_RTOL, BF16_ATOL = 1e-3, 1e-5
# fused_cell_update: the tolerance of the JAX package's own test of it
# against plain jnp (tests/test_pallas.py:66-101)
FUSED_ATOL = 1e-5
# (bu, bi, k, bs): a step's segment sums in a cluster's shared memory
# (small blocks; the JAX default 1024-blocks at k = 64), or in the global
# scratch (2048-slot steps on 2048-blocks at k = 256: up to 4,608 sums of
# 1 KiB, above 227 KiB a CTA even at C = 16)
BLOCK_ROUTES = {"cluster": (64, 48, 64, 64),
                "cluster1024": (1024, 1024, 64, 256),
                "scratch": (2048, 2048, 256, 2048)}
BLOCK_WRAPPERS = (bsk.block_sgd_epoch, bsk.block_sgd_diag_epoch,
                  sk.fused_cell_update)
# (i), (j), (k): bench.py's full shape (cell (d)'s data), k=64, and its
# step: batch_size 65,536, which train_model cuts to 1024 per lane and
# step. lr 0.005 as in bench.py: at 20,000 x 4,000, density 0.025 (the same
# per-user and per-item degrees) on the CPU, val RMSE falls from 3.267 to
# 0.593 in 5 epochs (mf), and by ~1e-3 in 2 epochs (tmf, ifwmf).
BLOCK_PARAMS = dict(fac_dim=64, u_reg=0.01, i_reg=0.01, learn_rate=0.005,
                    seed=0, batch_size=65_536, max_iter=5, obj_iter=1,
                    disp_iter=1)


def _zero_block_counts() -> None:
    bsk.reset_counts(*BLOCK_WRAPPERS)


def _block_counts():
    """(launches, finished cells) of the row, diag and cell wrappers."""
    return (tuple(fn.launches for fn in BLOCK_WRAPPERS),
            tuple(bsk.cells_done(fn) for fn in BLOCK_WRAPPERS))


def step_counts(solver):
    """(steps, live steps) of one epoch of the solver's staged streams:
    every cell's S / bs steps, and those whose slice holds a valid slot
    (the kernel skips the others)."""
    n_cells = solver.NU * solver.NI
    n_steps = solver.S // solver.bs
    wts = solver.wts.reshape(-1, solver.bs)[:n_cells * n_steps]
    live = int((wts != 0).any(1).sum())
    return n_cells * n_steps, live


def _log_plan(tag: str, solver, n_par: int) -> dict:
    pl = bsk.plan(n_par, solver.bs, solver.bu, solver.bi,
                  solver.params.fac_dim)
    steps, live = step_counts(solver)
    log(f"({tag}) kernel plan: {pl['route']} route, clusters of "
        f"{pl['cluster']} CTAs, {pl['clusters']} clusters ({pl['resident']} "
        f"co-resident), {pl['smem']} B shared memory per CTA; steps per "
        f"epoch {steps}, live {live}, skipped as padding "
        f"{1 - live / steps:.4f}")
    return dict(pl, steps=steps, live_steps=live)


def _cell_streams(gen: torch.Generator, n_rows: int, S: int, bs: int,
                  bu: int, bi: int, k: int, float_w: bool, dummy: bool,
                  dev):
    """Streams [n_rows (+ an all-invalid dummy row), S] as the solver
    stages them: ~80% valid slots, padding slots w = 0, ids 0, lam 1; ids
    from max(16, bs / 8) rows, so they repeat within every batch (3-6
    times) and some rows of a large batch span several of the kernel's
    ranges; weights 0/1 or float in [0.2, 1); host-staged collision counts
    per static batch slice."""
    valid = torch.rand((n_rows, S), generator=gen) < 0.8
    if dummy:
        valid = torch.cat([valid, torch.zeros((1, S), dtype=torch.bool)])
    shape = valid.shape
    n_ids = max(16, bs // 8)
    ids = lambda n: torch.where(valid, torch.randint(0, min(n_ids, n), shape,
                                                     generator=gen), 0)
    u, i = ids(bu).to(torch.int32), ids(bi).to(torch.int32)
    r = torch.where(valid, 3.0 + torch.randn(shape, generator=gen), 0.0)
    w = valid.float()
    if float_w:
        w = w * (0.2 + 0.8 * torch.rand(shape, generator=gen))
    lam = torch.where(valid, torch.randint(1, k + 1, shape, generator=gen),
                      1).to(torch.int32)
    cnu = torch.from_numpy(stage_batch_collision_counts(w.numpy(),
                                                        u.numpy(), bs, bu))
    cni = torch.from_numpy(stage_batch_collision_counts(w.numpy(),
                                                        i.numpy(), bs, bi))
    return [x.to(dev) for x in (u, i, r, w, cnu, cni, lam)]


def _block_kw(bs, bu, bi, NI, cn, mask, mm) -> dict:
    return dict(bs=bs, bu=bu, bi=bi, NI=NI, u_reg=REG, i_reg=REG,
                collision_norm=cn, use_mask=mask, mm_bf16=mm)


def _block_case(schedule: str, route: str, gen: torch.Generator, dev,
                exact: bool = False):
    """(tables, schedule, streams, NI, bs) of one small case. Row: 3 rows x
    2 cells x 3 steps; diag: 5 x 3 blocks in 6 rounds with a dummy lane, 2
    steps per cell; both from random batch offsets. exact: one step per
    block, factors from _dyadic (one row of one cell, or one round of 4
    lanes)."""
    bu, bi, k, bs = BLOCK_ROUTES[route]
    if exact:
        NU = NI = 1 if schedule == "row" else 4
        bs, n_steps = 128, 1
    else:
        NU, NI = (3, 2) if schedule == "row" else (5, 3)
        n_steps = 3 if schedule == "row" else 2
    S = bs * n_steps
    if exact:
        u_tab = _dyadic((NU * bu, k), gen).to(dev)
        i_tab = _dyadic((NI * bi, k), gen).to(dev)
    else:
        u_tab = torch.randn((NU * bu, k), generator=gen).to(dev)
        i_tab = torch.randn((NI * bi, k), generator=gen).to(dev)
    if schedule == "row":
        sched = (torch.randperm(NU, generator=gen),
                 torch.stack([torch.randperm(NI, generator=gen)
                              for _ in range(NU)]),
                 torch.randint(0, n_steps, (NU, NI), generator=gen))
    elif exact:
        sched = (torch.randperm(NU, generator=gen)[None],
                 torch.arange(NI)[None], torch.zeros((1, NI), dtype=torch.int64))
    else:
        sched = bsk.diag_schedule(gen, NU, NI, n_steps)
        assert bool((sched[0] == NU).any())   # a dummy lane
    return u_tab, i_tab, sched, (NU, NI, S, bs, k)


def _block_pair(schedule, u_tab, i_tab, sched, lr, streams, kw):
    """(kernel result, plain result) from the same inputs; checks that the
    wrapper launched once and the kernel finished every real cell."""
    fn, plain = ((bsk.block_sgd_epoch, bsk.block_sweep_rows)
                 if schedule == "row" else
                 (bsk.block_sgd_diag_epoch, bsk.block_sweep_diag))
    bsk.reset_counts(fn)
    got = fn(u_tab.clone(), i_tab.clone(), *sched, lr, *streams, **kw)
    real = (sched[0].numel() if schedule == "row"
            else int((sched[0] < u_tab.shape[0] // kw["bu"]).sum()))
    if schedule == "row":
        real *= kw["NI"]
    assert (fn.launches, bsk.cells_done(fn)) == (1, real), \
        (fn.launches, bsk.cells_done(fn), real)
    want = plain(u_tab.clone(), i_tab.clone(), *sched, lr, *streams, **kw)
    torch.cuda.synchronize()
    return got, want


def phase_block_vs_plain(dev="cuda") -> dict:
    """(h): max abs error per kernel use ("row", "diag", "cell") over all
    cases."""
    gen = torch.Generator().manual_seed(6)
    worst = {"row": 0.0, "diag": 0.0, "cell": 0.0}
    failures = []
    for route, (bu, bi, k, bs) in BLOCK_ROUTES.items():
        for n_par in (1, 3):
            pl = bsk.plan(n_par, bs, bu, bi, k)
            assert pl["route"] == route.replace("1024", ""), (route, pl)
    for schedule in ("row", "diag"):
        for route in BLOCK_ROUTES:
            for cn in (True, False):
                for mask in (False, True):
                    for float_w in (False, True):
                        for mm in (False, True):
                            u_tab, i_tab, sched, (NU, NI, S, bs, k) = \
                                _block_case(schedule, route, gen, dev)
                            bu, bi, _, _ = BLOCK_ROUTES[route]
                            rows = NU * NI
                            streams = _cell_streams(
                                gen, rows, S, bs, bu, bi, k, float_w,
                                schedule == "diag", dev)
                            if schedule == "row":
                                streams = [x.view(NU, NI * S)
                                           for x in streams]
                            scale, lr = (0.03, 0.005) if mm else (0.3, LR)
                            lr = lr if cn else lr / 4
                            rtol, atol = ((BF16_RTOL, BF16_ATOL) if mm else
                                          (BLOCK_RTOL, BLOCK_ATOL))
                            got, want = _block_pair(
                                schedule, scale * u_tab, scale * i_tab,
                                sched, lr, streams,
                                _block_kw(bs, bu, bi, NI, cn, mask, mm))
                            a, r, ratio = _errors(got, want, rtol, atol)
                            ok = ratio <= 1.0
                            worst[schedule] = max(worst[schedule], a)
                            log(f"(h) {schedule:4s} {route:7s} cn={cn!s:5s} "
                                f"mask={mask!s:5s} float_w={float_w!s:5s} "
                                f"mm_bf16={mm!s:5s} max_abs {a:.3e} max_rel "
                                f"{r:.3e} err/tol {ratio:.3e} "
                                f"{'ok' if ok else 'FAIL'}")
                            if not ok:
                                failures.append((schedule, route, cn, mask,
                                                 float_w, mm))
    # one step per block from factors exact in bf16: no rounding can flip,
    # so both precisions hold at the f32 class, and each misses the plain
    # version of the other precision
    for schedule in ("row", "diag"):
        for cn in (True, False):
            for mask, float_w in ((False, False), (True, True)):
                u_tab, i_tab, sched, (NU, NI, S, bs, k) = _block_case(
                    schedule, "cluster", gen, dev, exact=True)
                bu, bi, _, _ = BLOCK_ROUTES["cluster"]
                streams = _cell_streams(gen, NU * NI, S, bs, bu, bi, k,
                                        float_w, schedule == "diag", dev)
                lr = LR if cn else LR / 4
                res = {mm: _block_pair(schedule, u_tab, i_tab, sched, lr,
                                       streams, _block_kw(bs, bu, bi, NI, cn,
                                                          mask, mm))
                       for mm in (True, False)}
                for mm in (True, False):
                    a, r, ratio = _errors(res[mm][0], res[mm][1],
                                          BLOCK_RTOL, BLOCK_ATOL)
                    ctl = _errors(res[mm][0], res[not mm][1], BLOCK_RTOL,
                                  BLOCK_ATOL)[2]
                    ok = ratio <= 1.0 and ctl > 1.0
                    worst[schedule] = max(worst[schedule], a)
                    log(f"(h) exact-bf16 {schedule:4s} cn={cn!s:5s} "
                        f"mask={mask!s:5s} float_w={float_w!s:5s} "
                        f"mm_bf16={mm!s:5s} max_abs {a:.3e} err/tol "
                        f"{ratio:.3e}; control vs mm_bf16={not mm!s:5s} "
                        f"err/tol {ctl:.3e} (must be > 1) "
                        f"{'ok' if ok else 'FAIL'}")
                    if not ok:
                        failures.append(("exact", schedule, cn, mask, mm))
    # fused_cell_update: the JAX package's interpret-mode case and two more
    for BU, BI, k, S, bs in ((32, 24, 8, 64, 16), (8, 8, 32, 96, 32),
                             (384, 384, 64, 2048, 256)):
        args = (0.1 * torch.randn((BU, k), generator=gen),
                0.1 * torch.randn((BI, k), generator=gen),
                torch.randint(0, BU, (S,), generator=gen).to(torch.int32),
                torch.randint(0, BI, (S,), generator=gen).to(torch.int32),
                torch.randn((S,), generator=gen),
                (torch.rand((S,), generator=gen) > 0.2).float())
        args = [x.to(dev) for x in args]
        bsk.reset_counts(sk.fused_cell_update)
        got = sk.fused_cell_update(*args, LR, bs, REG, 2 * REG)
        assert (sk.fused_cell_update.launches,
                bsk.cells_done(sk.fused_cell_update)) == (1, 1)
        want = sk.fused_cell_plain(*args, LR, bs, REG, 2 * REG)
        torch.cuda.synchronize()
        a, r, ratio = _errors(got, want, 0.0, FUSED_ATOL)
        worst["cell"] = max(worst["cell"], a)
        ok = ratio <= 1.0
        log(f"(h) fused_cell_update BU={BU} BI={BI} k={k} S={S} bs={bs} "
            f"max_abs {a:.3e} err/tol {ratio:.3e} {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(("cell", BU, BI, k, S, bs))
    if failures:
        raise AssertionError(
            f"block kernel disagrees with the plain version (f32 rtol "
            f"{BLOCK_RTOL} / atol {BLOCK_ATOL}, bf16 rtol {BF16_RTOL} / atol "
            f"{BF16_ATOL}, fused atol {FUSED_ATOL}; a control that agrees "
            f"fails too): {failures}")
    return worst


def _alternate(kernel, plain, reps: int = 1):
    """(kernel ms, plain ms), CUDA events over ``reps`` calls, in turns
    plain, kernel, kernel, plain, after one warm call of each."""
    kernel(), plain()
    torch.cuda.synchronize()
    p_ms = [_cuda_ms(plain, reps)]
    k_ms = [_cuda_ms(kernel, reps), _cuda_ms(kernel, reps)]
    p_ms.append(_cuda_ms(plain, reps))
    return float(np.mean(k_ms)), float(np.mean(p_ms))


def _replay(tag: str, solver, state, lr: float, sched):
    """One epoch of the solver's staged streams from ``state`` with one
    schedule, through the kernel and through the plain version, held at
    (h)'s bf16 class (f32 class without mm_bf16); then both timed.
    Returns (max abs error, kernel ms, plain ms)."""
    u_tab, i_tab = solver.stage_factors(state)
    diag = solver.schedule == "diag"
    fn = bsk.block_sgd_diag_epoch if diag else bsk.block_sgd_epoch
    plain_fn = bsk.block_sweep_diag if diag else bsk.block_sweep_rows
    args = (*sched, lr, *solver.streams)
    kw = solver.sweep_kwargs()
    kernel = lambda: fn(u_tab.clone(), i_tab.clone(), *args, **kw,
                        slices=solver.slices)
    plain = lambda: plain_fn(u_tab.clone(), i_tab.clone(), *args, **kw)
    rtol, atol = ((BF16_RTOL, BF16_ATOL) if solver.mm_bf16
                  else (BLOCK_RTOL, BLOCK_ATOL))
    a, r, ratio = _errors(kernel(), plain(), rtol, atol)
    log(f"({tag}) first epoch replayed on the staged streams, kernel vs "
        f"plain: max_abs {a:.3e} max_rel {r:.3e} err/tol {ratio:.3e} "
        f"{'ok' if ratio <= 1.0 else 'FAIL'}")
    if ratio > 1.0:
        raise AssertionError(f"({tag}) kernel disagrees with the plain "
                             f"version on the path's streams (rtol {rtol}, "
                             f"atol {atol})")
    k_ms, p_ms = _alternate(kernel, plain)
    return a, k_ms, p_ms


def block_bound(solver):
    """Bound of one one-hot epoch: each rating's stream values read once
    (ids, r, w, and the collision counts and rank where the epoch reads
    them; a padding slot holds nothing the epoch needs), both factor tables
    read and written once; 8k FLOP a rating (prediction, two gradients, two
    updates) at the f32 CUDA-core peak."""
    k = solver.params.fac_dim
    per_rating = sum(t.element_size() for t in solver.streams
                     if t is not None)
    nbytes = (solver.nnz * per_rating
              + 2 * 4 * k * (solver.model.n_users + solver.model.n_items))
    return _bound(nbytes, 8.0 * k * solver.nnz, "f32")


def _train_block(tag: str, data: Data, params: Params, algo: str,
                 dev="cuda"):
    """train_model(algo, mf_method="blocksgd") with the counts zeroed just
    before; checks the launches, the staging and that the objective and
    val RMSE are finite and fall. Returns (report, model, evaluator,
    invalid masks, launches, initial state)."""
    _zero_block_counts()
    t0 = time.perf_counter()
    rep, model, ev, inval = train_model(data, params, algo=algo,
                                        mf_method="blocksgd", device=dev,
                                        log_fn=lambda s: log(f"({tag}) {s}"))
    wall = time.perf_counter() - t0
    (n_row, n_diag, n_cell), cells = _block_counts()
    launches = (n_diag, n_row, n_cell)
    solver = rep.solver
    epochs = len(rep.history)
    R = -(-solver.NU // solver.NI) * solver.NI
    log(f"({tag}) {algo}: staged NU={solver.NU} NI={solver.NI} bu={solver.bu} "
        f"bs={solver.bs} S={solver.S} use_mask={solver.use_mask} nnz="
        f"{solver.nnz} pad_frac {solver.pad_frac:.3f}; {R} rounds per epoch; "
        f"train_model wall {wall:.1f} s; stop={rep.stop_reason}; launches "
        f"(diag, row, cell) {launches}; finished cells (row, diag, cell) "
        f"{cells}")
    # at the full shape: 261 x 53 blocks, 265 rounds
    assert (solver.engine, solver.schedule, solver.bu, solver.bi, solver.bs,
            solver.NU, solver.NI) == ("xla", "diag", 384, 384, 1024,
                                      -(-data.n_users // 384),
                                      -(-data.n_items // 384))
    assert solver.use_mask == (algo == "tmf")
    assert rep.stop_reason == "max_iter" and epochs == params.max_iter, \
        (rep.stop_reason, epochs)
    # one launch an epoch; every real cell of every round, each epoch
    assert launches == (epochs, 0, 0), launches
    assert cells == (0, epochs * solver.NU * solver.NI, 0), cells
    s0 = init_state(params, data.n_users, data.n_items, device=dev)
    loop = TrainLoop(model, solver, ev, params, log_fn=lambda s: None)
    obj0 = loop._objective(s0)
    val0 = ev.rmse(model.eval_view(s0), "val")
    vals = [h.val_rmse for h in rep.history]
    objs = [h.objective for h in rep.history]
    log(f"({tag}) {algo}: val RMSE at init {val0!r}, per epoch {vals!r}; "
        f"objective at init {obj0!r}, per epoch {objs!r}")
    assert all(np.isfinite(vals + objs)), (vals, objs)
    assert rep.best_metric < val0 and objs[-1] < obj0, (vals, objs)
    for t in rep.state[:2]:
        assert bool(torch.isfinite(t).all())
    assert tuple(rep.state.u_fac.shape) == (data.n_users, params.fac_dim)
    return rep, model, ev, inval, launches[0], s0


def phase_blocksgd(data: Data, dev="cuda"):
    """(i): returns (diag launches, replay error, kernel ms, plain ms),
    then the single-cell path's (launches, error, kernel ms, plain ms), the
    evaluator, the invalid masks and the initial state."""
    params = Params(**BLOCK_PARAMS)
    rep, model, ev, inval, launches, s0 = _train_block("i", data, params,
                                                       "mf", dev)
    solver = rep.solver
    loop_ms = [1e3 * h.seconds for h in rep.history]
    sched = bsk.diag_schedule(torch.Generator().manual_seed(1), solver.NU,
                              solver.NI, solver.S // solver.bs)
    err, k_ms, p_ms = _replay("i", solver, s0, params.learn_rate, sched)
    pl = _log_plan("i", solver, solver.NI)
    R = sched[0].shape[0]
    log(f"(i) solver epoch in the loop with its views (host clock, "
        f"synchronized): {loop_ms!r} ms")
    log(f"(i) diag epoch alone (CUDA events): kernel {k_ms:.3f} ms = "
        f"{solver.nnz / k_ms * 1e3:.4e} ratings/s, {k_ms / R * 1e3:.2f} us "
        f"a round over {R} rounds ({pl['live_steps']} live steps); plain "
        f"PyTorch {p_ms:.3f} ms = {solver.nnz / p_ms * 1e3:.4e} ratings/s")
    bound = block_bound(solver)
    cell = phase_cells(solver, s0, params, sched)
    del rep, solver
    torch.cuda.empty_cache()
    return (launches, err, k_ms, p_ms, bound), cell, ev, inval, s0


def phase_cells(solver, s0, params: Params, sched):
    """fused_cell_update over the cells of round 0 of (i)'s diag schedule,
    one call per cell on its staged stream, in 256-rating minibatches, each
    cell's stream staged for the kernel once (``stage_cell``) as a caller
    of many calls would (counts zeroed just before the calls); each cell
    held to its plain version at FUSED_ATOL, then the round timed both
    ways. Returns (launches, max abs error, kernel ms, plain ms)."""
    u_tab, i_tab = solver.stage_factors(s0)
    bu, bi, NI, NU = solver.bu, solver.bi, solver.NI, solver.NU
    k = params.fac_dim
    lanes = [(int(u), int(i)) for u, i in zip(sched[0][0], sched[1][0])
             if int(u) < NU]
    p = params
    stream = lambda c: (solver.u_loc[c], solver.i_loc[c], solver.vals[c],
                        solver.wts[c])
    staged = {ub * NI + ib: sk.stage_cell(*stream(ub * NI + ib), 256, bu,
                                          bi, k) for ub, ib in lanes}

    def cells(fn, staged=None):
        out = []
        for ub, ib in lanes:
            c = ub * NI + ib
            kw = {} if staged is None else {"slices": staged[c]}
            out.append(fn(u_tab[ub * bu:(ub + 1) * bu],
                          i_tab[ib * bi:(ib + 1) * bi], *stream(c),
                          p.learn_rate, 256, p.u_reg, p.i_reg, **kw))
        return out

    kernel = lambda: cells(sk.fused_cell_update, staged)
    _zero_block_counts()
    got = kernel()
    launches = sk.fused_cell_update.launches
    done = bsk.cells_done(sk.fused_cell_update)
    assert (launches, done) == (len(lanes), len(lanes)), (launches, done)
    want = cells(sk.fused_cell_plain)
    torch.cuda.synchronize()
    err = max(_errors(g, w, 0.0, FUSED_ATOL)[0] for g, w in zip(got, want))
    ratio = max(_errors(g, w, 0.0, FUSED_ATOL)[2] for g, w in zip(got, want))
    log(f"(i) fused_cell_update over the {len(lanes)} cells of one round, "
        f"kernel vs plain: max_abs {err:.3e} err/tol {ratio:.3e} "
        f"{'ok' if ratio <= 1.0 else 'FAIL'}")
    if ratio > 1.0:
        raise AssertionError("(i) fused_cell_update disagrees with its "
                             f"plain version (atol {FUSED_ATOL})")
    k_ms, p_ms = _alternate(kernel, lambda: cells(sk.fused_cell_plain))
    # each valid slot's u, i, r, w read once; both blocks read and the new
    # blocks written once a call
    n = sum(int((solver.wts[ub * NI + ib] > 0).sum()) for ub, ib in lanes)
    nbytes = 16 * n + len(lanes) * 2 * 4 * k * (bu + bi)
    bound = _bound(nbytes, 8.0 * k * n, "f32")
    pl = bsk.plan(1, 256, bu, bi, k)
    # a caller that hands each call a fresh stream: checked and sorted each
    # call (outside the main path's counts)
    free_ms = _cuda_ms(lambda: cells(sk.fused_cell_update))
    log(f"(i) one round of cells through fused_cell_update (CUDA events): "
        f"kernel {k_ms:.3f} ms ({k_ms / len(lanes) * 1e3:.1f} us a call, "
        f"one cluster of {pl['cluster']} CTAs), plain {p_ms:.3f} ms; bound "
        f"{bound[0]:.4f} ms ({bound[1]}); without staged slices {free_ms:.3f}"
        f" ms ({free_ms / len(lanes) * 1e3:.1f} us a call)")
    return launches, err, k_ms, p_ms, bound


def phase_longtail(data: Data, dev="cuda") -> float:
    """(j): TMF and IFWMF, 2 epochs each; returns the max replay error."""
    worst = 0.0
    for algo in ("tmf", "ifwmf"):
        params = Params(**dict(BLOCK_PARAMS, max_iter=2))
        rep, model, ev, _, _, s0 = _train_block("j", data, params, algo,
                                                dev)
        solver = rep.solver
        if algo == "ifwmf":
            w = solver.wts[solver.wts > 0]
            log(f"(j) ifwmf weights on the stream: min {float(w.min())!r} "
                f"max {float(w.max())!r}")
            assert float(w.min()) < 1.0
        sched = bsk.diag_schedule(torch.Generator().manual_seed(2),
                                  solver.NU, solver.NI,
                                  solver.S // solver.bs)
        err, k_ms, p_ms = _replay("j", solver, s0, params.learn_rate, sched)
        log(f"(j) {algo} diag epoch alone (CUDA events): kernel {k_ms:.3f} "
            f"ms, plain {p_ms:.3f} ms")
        worst = max(worst, err)
        del rep, solver
        torch.cuda.empty_cache()
    return worst


def phase_rows(data: Data, ev, inval, s0, dev="cuda"):
    """(k): one row-schedule epoch at the JAX default blocks (counts zeroed
    just before); returns (launches, replay error, kernel ms, plain ms)."""
    params = Params(**BLOCK_PARAMS)
    model = ModelMF(params, data.n_users, data.n_items)
    solver = BlockSGDSolver(model, params, data.train_mat, *inval,
                            batch_size=1024, engine="pallas", schedule="row",
                            device=dev)
    log(f"(k) staged NU={solver.NU} NI={solver.NI} bu={solver.bu} "
        f"bs={solver.bs} S={solver.S} ({solver.S // solver.bs} steps per "
        f"cell)")
    pl = _log_plan("k", solver, 1)
    # at the full shape: 98 x 20 blocks; the chain spread over a cluster,
    # its deltas in the cluster's shared memory
    assert (solver.NU, solver.NI, solver.bu, solver.bi) == (
        -(-data.n_users // 1024), -(-data.n_items // 1024), 1024, 1024)
    assert pl["route"] == "cluster" and pl["cluster"] >= 2, pl
    _zero_block_counts()
    t0 = time.perf_counter()
    state = solver.epoch(s0, params.learn_rate)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _block_counts()
    launches = counts[0][0]
    assert counts == ((1, 0, 0), (solver.NU * solver.NI, 0, 0)), counts
    val0 = ev.rmse(model.eval_view(s0), "val")
    val1 = ev.rmse(model.eval_view(state), "val")
    log(f"(k) one epoch through BlockSGDSolver.epoch: {wall * 1e3:.1f} ms "
        f"(host clock); launches and finished cells {counts}; val RMSE "
        f"{val0!r} -> {val1!r}")
    assert np.isfinite(val1) and val1 < val0, (val0, val1)
    rng = np.random.default_rng(3)
    sched = (rng.permutation(solver.NU),
             np.stack([rng.permutation(solver.NI) for _ in range(solver.NU)]),
             rng.integers(0, solver.S // solver.bs, (solver.NU, solver.NI)))
    err, k_ms, p_ms = _replay("k", solver, s0, params.learn_rate, sched)
    bound = block_bound(solver)
    log(f"(k) row epoch alone (CUDA events): kernel {k_ms:.3f} ms "
        f"({k_ms / pl['live_steps'] * 1e3:.2f} us a live step), plain "
        f"{p_ms:.3f} ms; bound {bound[0]:.4f} ms ({bound[1]})")
    del solver, state
    torch.cuda.empty_cache()
    return launches, err, k_ms, p_ms, bound


# ----------------------------------------------------------------------
# (m): the toolchain probes
# ----------------------------------------------------------------------

# the pl.pallas_call line of each probe in scripts/tpu_pallas_bisect.py
PROBE_LINES = {"1 elementwise": 49, "2 grid matmul": 59, "3 batch update": 80,
               "4 scalar prefetch": 96, "5 slice loop": 115}


def phase_probes(dev="cuda") -> dict:
    """(m): the five probes of csrc/bisect_probes.cu at the JAX probes'
    shapes, their counts zeroed just before the probe run and read after
    it; each held to its plain version exactly (its inputs make every
    result exact in f32), then timed beside it (CUDA events, mean of 200
    calls). Returns {stage: (launches, max abs error, ms, plain ms,
    bound)}."""
    stages = bp.stage_inputs(torch.Generator().manual_seed(0), dev)
    for fn in bp.PROBES:
        fn.launches = 0
    got = {name: fn(*args) for name, (fn, _, args) in stages.items()}
    out, failures = {}, []
    for name, (fn, plain, args) in stages.items():
        launches = fn.launches
        want = plain(*args)
        torch.cuda.synchronize()
        err = float((got[name] - want).abs().max())
        ok = launches == 1 and err == 0.0
        k_ms, p_ms = _alternate(lambda: fn(*args), lambda: plain(*args), 200)
        x = [a for a in args if torch.is_tensor(a)]
        nbytes = sum(a.nbytes for a in x) + got[name].nbytes
        ops = (2.0 * x[0].shape[0] * x[0].shape[1] * x[1].shape[1]
               if name.startswith("2") else float(got[name].numel()))
        bound = _bound(nbytes, ops, "f32")
        log(f"(m) probe {name}: {launches} launch, max_abs {err:.3e} "
            f"(exact); kernel {k_ms * 1e3:.2f} us, plain {p_ms * 1e3:.2f} us, "
            f"bound {bound[0] * 1e3:.3f} us ({bound[1]}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(name)
        out[name] = (launches, err, k_ms, p_ms, bound)
    if failures:
        raise AssertionError(f"probes failed: {failures}")
    return out


NO_LIBRARY = "none: no one PyTorch call computes this function"


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; nothing to run",
              file=sys.stderr)
        return 2
    smi = phase_env()
    phase_build()
    worst = phase_kernel_vs_plain()
    exact = phase_bf16_rounding()
    phase_codes_vs_float()
    data_d = bench_data(**CELLS["d"][0])
    d = run_cell("d", data_d)
    e = run_cell("e")
    err_f = phase_topk_vs_plain()
    g = phase_ranking()
    block = phase_block_vs_plain()
    (n_i, err_i, k_i, p_i, bound_i), cell, ev, inval, s0 = \
        phase_blocksgd(data_d)
    err_j = phase_longtail(data_d)
    n_k, err_k, k_k, p_k, bound_k = phase_rows(data_d, ev, inval, s0)
    del ev
    l_ = run_cell("l", data_d)
    probes = phase_probes()

    float_err = max(max(worst[t], exact[t]) for t in TILE_KINDS
                    if t != "codes")
    stripe_lib = ("the stripe's three products as bf16 torch.matmul "
                  "(cuBLAS) calls, summed over the epoch")

    def entry(name, source, replaces, launches, err, ms, plain_ms, bound,
              library_ms=None, library=NO_LIBRARY):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound[0], "bound_by": bound[1],
                "library_ms": library_ms, "library": library}

    kernels = [
        entry("dense_rows<f32|bf16 R; int8|bf16|f32 W>", SOURCE,
              "matfac_tpu/ops/dense_row_kernel.py:108", d["launches"],
              max(float_err, d["max_abs_err"], l_["max_abs_err"]), d["ms"],
              d["plain_ms"], (d["bound_ms"], d["bound_by"]),
              d["library_ms"], stripe_lib),
        entry("dense_rows<int8 codes>", SOURCE,
              "matfac_tpu/ops/dense_row_kernel.py:231", e["launches"],
              max(worst["codes"], exact["codes"], e["max_abs_err"]), e["ms"],
              e["plain_ms"], (e["bound_ms"], e["bound_by"]),
              e["library_ms"], stripe_lib),
        entry("topk_catalog<fused>", TOPK_SOURCE,
              "matfac_tpu/ops/topk_kernel.py:118", g["fused"][0],
              max(err_f, g["fused"][1]), *g["fused"][2:]),
        entry("topk_catalog<radix>", TOPK_SOURCE,
              "matfac_tpu/ops/topk_kernel.py:118", g["radix"][0],
              max(err_f, g["radix"][1]), *g["radix"][2:]),
        entry("block_sgd<diag>", BLOCK_SOURCE,
              "matfac_tpu/ops/block_sgd_kernel.py:148", n_i,
              max(block["diag"], err_i, err_j), k_i, p_i, bound_i),
        entry("block_sgd<row>", BLOCK_SOURCE,
              "matfac_tpu/ops/block_sgd_kernel.py:148", n_k,
              max(block["row"], err_k), k_k, p_k, bound_k),
        entry("fused_cell_update", BLOCK_SOURCE,
              "matfac_tpu/ops/sgd_kernel.py:73", cell[0],
              max(block["cell"], cell[1]), cell[2], cell[3], cell[4]),
    ] + [entry(f"probe<{name}>", PROBE_SOURCE,
               f"scripts/tpu_pallas_bisect.py:{PROBE_LINES[name]}", *res)
         for name, res in probes.items()]
    log(smi)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
