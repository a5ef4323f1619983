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
      give bit-identical factors; then the same three kinds of case for the
      rank-mask instantiation (TMF's static ranks and TMF+Dropout's Poisson
      rank rows per visit, on the 0/1 tile kinds, k up to 160), and
      full-rank masks against the unmasked kernel, bit for bit; then the
      same source's cell-grid entry (the dense engine's diag cell grid)
      against dense_sweep_diag: every tile kind x mm_bf16 x
      collision_norm at k = 10, 64, 128, 160 on cells of 376 x 200 / 384
      (ragged), two epochs of rounds with dummy lanes and every user block
      back on every lane (a stale bf16 copy of U would show), one-round
      exact-bf16 cases with must-fail controls, and codes against float
      tiles bit for bit;
  (d) main path, float tiles: train_model(algo="mf", mf_method="densesgd")
      at 100,000 x 20,000, density 0.005 (~9.9M continuous ratings), k=64;
  (w) the dense engine's diag cell grid at full width: BlockSGDSolver(
      engine="dense", bu=2560, bi=512) on (d)'s data (40 x 40 cells, bf16
      R + int8 W), 3 epochs through TrainLoop, every epoch one call of the
      cell-grid entry; an epoch replayed through kernel and plain (rtol
      1e-3 / atol 1e-5), twice bit-identical, half-star codes of its tiles
      against the same ratings as bf16 tiles bit for bit; val RMSE falls;
      epoch ms, launches, idle share, bound, plain and cuBLAS times, peak
      memory;
  (e) main path, code tiles: the ML-20M shape (138,000 x 27,000, ~20M
      half-star ratings), k=64;
  (z) the flagship at a cut depth, after (e) on (e)'s data (which is
      scripts/torch_ml20m_flagship.py's make_data): its run_k at k 64 for
      Z_MAX_ITER epochs with text checkpoints every Z_SAVE_ITER: the loop
      stops with a reason and keeps the best-on-val state, the stripe
      kernel's launches against the plan, the text checkpoint read back
      (val RMSE within 1e-5 of the best), the full-catalog HR@10 of the
      JAX script over every user through the fused top-N kernel (launches
      against the plan), that kernel held against topk_plain on
      Z_HELD_USERS users, and each phase's wall;
      ``python3 chip_smoke.py --stripes`` runs (a), the stripe source's
      build, (c), (d), (w), (n), (e) and (z): every path of the stripe
      kernel's ``StripeTiles``;
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
  (r) the BPR x TMF+Poisson hybrid at (g)'s data: train_model(
      algo="bpr_poisson") for 3 epochs of "train" (Poisson-sampled triple
      ranks) and 2 of "sigmoid", lr 0.1 (the JAX package's end-to-end BPR
      run), val HR@10 after each epoch through the fused top-N kernel on
      the CDF-truncated view (launches counted around each run), that
      kernel held against topk_plain on the truncated best view, 4 steps
      held against the CPU copy of the solver on the same draws and masks,
      two runs of one epoch on the same draws and masks bit-identical;
  (s) the dense-stripe BPR engine at (g)'s data: train_model(algo="bpr",
      bpr_engine="dense") for 3 epochs at one negative a positive, then 2
      epochs of the panel epoch at panel_q=128 (TrainLoopHR), val HR@10
      each epoch through the fused kernel; 1 stripe held against the CPU
      copy on the same draws; two runs of an epoch (both engines' epochs)
      bit-identical;
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
  (n) the long-tail models on the stripe engine: train_model(algo="tmf"
      and "tmfdropout", mf_method="densesgd") on (d)'s data, 2 epochs
      each, through the masked kernel; then "tmfdropout" at k 128 on
      half-star codes, 2,560 users a stripe and 26,744 items (the
      benchmark cell's instantiation); ranks not trivial, launches
      counted, one epoch replayed with the drawn order and round uniforms;
  (o) the scatter engine, train_model's default method, for algo "mf"
      and "tmfdropout" on (d)'s data, 2 epochs each: val RMSE falls; one
      fused step (csrc/sgd_step.cu) launched a batch in those epochs
      (counted from 0 at the front door's call); the
      epoch's time, batches and CUDA kernels; two runs of an epoch
      bit-identical (every scatter sums in a fixed order); the epoch timed
      in turns with the eager step (ops/sgd_step.sgd_step_plain, the
      route before the fused step) in its place;
  (ss) the fused step at the sgd cell's shape (batches of 16,384 over
      138,493 users, uniform, and 26,744 items by a 0.8 power law, k 64,
      1,038 batches): its gradient kernel's device ms a batch beside its
      bytes bound, the step's and the eager step's ms a batch in turns,
      the host us a batch, two runs of an epoch bit-identical, one launch
      a batch, and the largest gap of the tables after 3 epochs against
      the eager route. ``python3 chip_smoke.py --sgd-step`` runs (a), the
      build of the two sources, (ss) and (o) alone;
  (os) the ordered scatter kernel (csrc/ordered_scatter.cu) at the sgd
      cell's two sides (16,384 ids over 138,493 users, uniform, and over
      26,744 items by a 0.8 power law, k 64) and BPR's item side (131,072
      ids over 10,677 items): bit for bit index_put_(accumulate=True) and
      the plain version, f32 and bf16, staged and per-call plans; device
      ms a call (torch.profiler) in turns against index_put_, the plain
      version's ms, host us a call of each route, the bytes bound.
      ``python3 chip_smoke.py --ordered-scatter`` runs (a), its build, (o)
      and (os) alone;
  (p) the coordinate family's ALS on (d)'s data with bench.py's Params
      (k 64, reg 0.01), 2 epochs each: train_model(mf_method="auto")
      (exact bucketed ALS), ALSSolver(cg_iters=6), SubspaceALSSolver,
      DenseALSSolver (bf16 values, exact, ridge retry) and with
      cg_iters=6, gram_int8=True; no hand kernel (JAX uses XLA);
  (q) CCD on the same data: train_model for ccd++ (2 epochs), ccd++ with
      ccd_group_dims=4 and ccd++freqadap (1 each), ccd (2); two runs of
      one CCD++ and one CCD epoch must be bit-identical;
  (t) SVD-initialised SGD on (d)'s data: svd_init at k 64 timed twice,
      the two bit-identical, its
      leading singular pair checked on the card and a 20,000-user slice
      held against the CPU with one test matrix; train_model(mf_method=
      "sgdparsvd") for 2 epochs: val RMSE falls from the SVD start, 4
      batches held against the CPU copy of the solver; no hand kernel
      (JAX uses XLA);
  (y) the multi-device engines on a mesh of 4 shards of the one card, at
      (d)'s data: train_model(mf_method="densesgd", mesh=...) for 3
      epochs (DenseBlockDSGDSolver: 10 stripes of 2560 x 5120 a shard,
      bf16 R + int8 W; each shard-round one call of the stripe entry,
      launches asserted), one shard-round against dense_sweep_rows, a
      whole epoch in f32 and in bf16 products against the plain version,
      the epoch twice bit-identical, epoch ms, idle share and bound; the
      first epoch again as 2 processes x 2 shards on the card (gloo; this
      script with --mesh-worker), bit for bit; in the same two processes
      ALS, iALS++ and dense ALS under train_model(mesh=...), 2 epochs
      each, every process solving its share of each half-sweep, bit for
      bit the 1-process runs; half-star ratings as int8
      code tiles against bf16 + int8 tiles, bit for bit; the sharded
      top-10 (HR@10, ARHR@10, ids) and RMSE against one device, launches
      against the plan; save_sharded / restore_sharded bit for bit; mesh
      ALS, one epoch, bit for bit ALS on one device; train_model(
      mf_method="blocksgd", mesh=...) for 2 epochs (BlockDSGDSolver, one
      diag launch a shard-round, every cell finished, a shard-round
      against block_sweep_diag); TMF+Dropout on the scatter DSGD, 1
      epoch, two runs of an epoch bit-identical, and the same epoch in
      the two --mesh-worker processes bit for bit the 1-process run;
      val RMSE falls in each run; scripts/torch_scaling_curve.py's
      phase split (full, nopermute and permuteonly epochs of the three
      DSGD solvers at 1, 2 and 4 shards), printed, with one dense and one
      one-hot shard-round at its shapes against their plain versions;
  (u) the port's front door at (d)'s width: (d)'s splits written once
      through the port's write_csr (the val split also the probe matrix)
      and read back by read_csr through the native host parser (which
      must be taken) and by the line parser, bit for bit, both timed,
      then ``matfac_tpu_torch.cli.main`` in process for mf_headwt with
      --mf_method auto (the one-hot kernel, float weights; 2 epochs) and
      densesgd (the stripe kernel, bf16 W; 4 epochs at lr 0.1, val RMSE
      down by 1% at least), tmf_bias, mf_loc and dropoutmf_ordered (2
      epochs each, the scatter engine), mf_freq (5 stages of 1 epoch),
      increment (6 epochs, a growth check at epoch 5) and bpr (2 epochs at
      lr 0.1; the top-N kernel, fused for val and test HR@10 and radix for
      test ARHR), tmf_bias alone writing its text checkpoints: each run's
      report lines, epoch ms, idle share, peak memory, checkpoint seconds
      and val metric before and after (it must improve); one stripe
      epoch, one one-hot epoch and the top-10 / top-1000 passes of these
      runs held against their plain versions, one tmf_bias and one
      increment epoch run twice bit-identical, and the ranking run's
      quartile_ranking_report; the read half: tmf_bias's text checkpoint
      read back with load_full onto the card (biases and mu equal the
      files', val RMSE within 1e-5 of the best) and (d)'s best factors
      through save_bin_facs / load_bin_facs, bit for bit;
  (v) analyze mode at (d)'s width: ``cli.main([..., "--mode", "analyze"])``
      in process on (u)'s splits, tmf_bias's text checkpoint as the trained
      factors and the generator's k = 8 factors, zero-padded to k = 64, as
      the ground truth; no --graphmat, so the 20,000-item cosine graph is
      built on the card. The report's lines present and finite; each
      step's host seconds, the wall, peak memory, the idle share of the
      graph build and of PPR; card against CPU (the port with
      device="cpu"): 1,024 rows of the cosine graph (the same edges, values
      at rtol 1e-6), user_ppr of 16 sampled users (rtol 1e-4, atol 1e-6),
      one catalog_sq_err block (rtol 1e-5), top_n_rec's test-item ranks
      and per_user_bucket_rmses on 256 users; the card's user_ppr of the
      200 sampled users twice, bit-identical. No hand kernel (JAX uses XLA
      and numpy);
  (x) the quality harness at a cut depth: scripts/torch_quality_report.py's
      nine solvers at --maxiter 30 on the card, each best val RMSE within
      0.01 of the JAX package's at that depth (QUALITY_JAX);
  (mb) scripts/torch_microbench.py --quick, printed: the primitive rates,
      the scatter chain through the ordered sums and through index_add_;
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
one schedule and hold them to (h)'s bf16 class, and time both. (p) and
(q) check that val RMSE falls and the factors stay finite, hold chunks,
row blocks or a partial epoch on the card against the CPU (COORD_TOL,
BF16_TOL; CG solves by the quadratic they minimize, CG_OBJ_RTOL), and log
each solver's epoch ms, idle share, peak memory, top three device ops and
bound; (r), (s) and (t) do the same for their solvers (SCATTER_TOL,
DENSE_BPR_TOL) and fail the run if val HR@10 does not rise, or val RMSE
does not fall.

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

import contextlib
import copy
import glob
import importlib.util
import io
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

from matfac_tpu_torch import (Data, Params, RatingMatrix, low_rank_ratings,
                              split_train_test_val)
from matfac_tpu_torch import cli
from matfac_tpu_torch.data import io as mfio
from matfac_tpu_torch.eval.quartile import quartile_ranking_report
from matfac_tpu_torch.models import increment as inc_mod
from matfac_tpu_torch.models.base import ModelMF, init_state
from matfac_tpu_torch.models.longtail import poisson_cdf_table
from matfac_tpu_torch.ops import _build
from matfac_tpu_torch.ops import bisect_probes as bp
from matfac_tpu_torch.ops import block_sgd_kernel as bsk
from matfac_tpu_torch.ops import dense_row_kernel as drk
from matfac_tpu_torch.ops import scatter as osc_mod
from matfac_tpu_torch.ops import sgd_kernel as sk
from matfac_tpu_torch.ops import sgd_step as step_mod
from matfac_tpu_torch.ops import topk_kernel as tk
from matfac_tpu_torch.eval.metrics import Evaluator
from matfac_tpu_torch.eval.ranking import CatalogScorer
from matfac_tpu_torch.parallel import block_dsgd as bdsgd
from matfac_tpu_torch.parallel.mesh import make_mesh, shard_state
from matfac_tpu_torch.ops.dense_block_kernel import (dense_sweep_diag,
                                                    dense_sweep_rows,
                                                    identity_quantiles,
                                                    visit_quantiles)
from matfac_tpu_torch.ops.svd_init import svd_init
from matfac_tpu_torch.serving import Recommender
from matfac_tpu_torch.solvers.block_sgd import (BlockSGDSolver,
                                                stage_batch_collision_counts)
from matfac_tpu_torch.solvers import als
from matfac_tpu_torch.solvers.bpr import BPRSolver
from matfac_tpu_torch.solvers.bpr_dense import DenseBPRSolver
from matfac_tpu_torch.solvers.sgd import SGDSolver
from matfac_tpu_torch.train import checkpoint as ckpt_mod
from matfac_tpu_torch.train import loop as loop_mod
from matfac_tpu_torch.train.loop import TrainLoop, TrainLoopHR, train_model
from matfac_tpu_torch.utils import freq
from matfac_tpu_torch.utils import native

SOURCE = "matfac_tpu_torch/csrc/dense_rows.cu"
TOPK_SOURCE = "matfac_tpu_torch/csrc/topk.cu"
BLOCK_SOURCE = "matfac_tpu_torch/csrc/block_sgd.cu"
PROBE_SOURCE = "matfac_tpu_torch/csrc/bisect_probes.cu"
SCATTER_SOURCE = "matfac_tpu_torch/csrc/ordered_scatter.cu"
STEP_SOURCE = "matfac_tpu_torch/csrc/sgd_step.cu"
HOST_SOURCE = "matfac_tpu_torch/csrc/native_host.cpp"
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
# (n)'s k 128 run: the benchmark cell ml20m-tmfdropout-densesgd's kernel
# instantiation (masked int8 codes at KP 128, 2,560 users a stripe, the
# cell's 26,744 items padded to 26,752) on 22 stripes of half-star ratings
# (1.51e9 one-byte slots: at 1.5e9 and over, the ladder stages codes), the
# cell's mean of 144 a user, and its model's settings
N_K128 = (dict(n_users=56_320, n_items=26_744, density=144 / 26_744,
               noise=0.35, power_law=0.8, stars=True, val_pc=0.05),
          dict(fac_dim=128, u_reg=0.005, i_reg=0.005, learn_rate=0.05,
               seed=0, max_iter=2, obj_iter=1, disp_iter=1, rho_rms=1.0,
               alpha=0.0))
TILE_KINDS = ("f32+W", "bf16+W", "codes", "f32+fW", "bf16+bfW")
# H100 SXM peaks (NVIDIA's data sheet)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12, "int8": 1979e12,
              "f64": 67e12}


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
    """Every source at once (one nvcc each, g++ for the host library),
    then load each."""
    t0 = time.perf_counter()
    paths = _build.build_all(["dense_rows", "topk", "block_sgd",
                              "bisect_probes", "ordered_scatter",
                              "sgd_step", "native_host"])
    for mod in (drk, tk, bsk, bp, osc_mod, step_mod):
        mod.library()
    assert native.available()
    dt = time.perf_counter() - t0
    log(f"(b) build + load of {SOURCE}, {TOPK_SOURCE}, {BLOCK_SOURCE}, "
        f"{PROBE_SOURCE}, {SCATTER_SOURCE}, {STEP_SOURCE} and {HOST_SOURCE} "
        f"({_build.host_compiler()}): "
        f"{dt:.2f} s "
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


def _stripe_epoch(u3, i_tab, order, lr, R, W, r_scale, cn, mm, ranks=None):
    """One stripe epoch of freshly staged StripeTiles at REG on copies of
    the tables; ``ranks`` (Lu, Li, C, u) as _ranks gives them, or None."""
    tiles = drk.StripeTiles(R, W, r_scale, u3.shape[2], REG, REG, cn, mm,
                            ranks=None if ranks is None else ranks[:2],
                            pois_cdf=None if ranks is None else ranks[2])
    return tiles.rows_epoch(u3.clone(), i_tab.clone(), order, lr,
                            None if ranks is None else ranks[3])


def _restaged(tiles, mm_bf16: bool):
    """``tiles`` staged again with the products in the other precision."""
    return drk.StripeTiles(tiles.R, tiles.W, tiles.r_scale, tiles.k,
                           tiles.u_reg, tiles.i_reg, tiles.collision_norm,
                           mm_bf16, NI=tiles.NI, ranks=tiles.ranks,
                           pois_cdf=tiles.pois_cdf)


def _epoch_pair(u3, i_tab, order, lr, R, W, r_scale, cn, mm):
    """(kernel result, plain result) from the same inputs."""
    uk, ik = _stripe_epoch(u3, i_tab, order, lr, R, W, r_scale, cn, mm)
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
                run = lambda R, W_, r_scale: _stripe_epoch(
                    scale * u3, scale * i_tab, order, lr, R, W_, r_scale,
                    cn, mm)
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


# the tile kinds the rank masks are instantiated for (0/1 weights)
MASK_KINDS = ("f32+W", "bf16+W", "codes")


def _ranks(NU: int, bu: int, ni: int, k: int, kind: str,
           gen: torch.Generator, dev, full: bool = False):
    """(Lu [NU, bu], Li [ni], C, u): random int32 lambdas in [1, k] on
    ``dev`` (all k when ``full``) with TMF's static ranks ("static": C and
    u None) or TMF+Dropout's Poisson CDF table C [k, k] on ``dev`` and one
    host uniform u a visit ("poisson")."""
    lo = k if full else 1
    Lu = torch.randint(lo, k + 1, (NU, bu), generator=gen, dtype=torch.int32)
    Li = torch.randint(lo, k + 1, (ni,), generator=gen, dtype=torch.int32)
    if kind == "static":
        return Lu.to(dev), Li.to(dev), None, None
    return (Lu.to(dev), Li.to(dev),
            torch.from_numpy(poisson_cdf_table(k)).to(dev),
            torch.rand(NU, generator=gen))


def _visit_q(ranks, NU: int, k: int):
    """The plain version's Q of _ranks' ``ranks``: a row a visit."""
    C, u = ranks[2:]
    return (identity_quantiles(NU, k, ranks[0].device) if C is None
            else visit_quantiles(C, u))


def _masked_pair(u3, i_tab, order, lr, R, W, r_scale, cn, mm, ranks):
    """(kernel result, plain result) of one masked epoch."""
    got = _stripe_epoch(u3, i_tab, order, lr, R, W, r_scale, cn, mm, ranks)
    want = dense_sweep_rows(u3.clone(), i_tab.clone(), order, lr, R, W, REG,
                            REG, cn, mm, r_scale=r_scale, Lu3=ranks[0],
                            Li=ranks[1], Q=_visit_q(ranks, *u3.shape[::2]))
    return got, want


def phase_masked_vs_plain(dev="cuda") -> dict:
    """(c), masked: the rank-mask instantiation of the stripe kernel
    against the plain version on the same CUDA tensors. (1) 8-stripe cases
    (376 x 1000, ragged) for each 0/1 tile kind x k 32 / 64 / 128 (and 160,
    the CUDA-core kernel) x matmul precision x collision norm x static
    (TMF) or Poisson (TMF+Dropout) rank rows, at RTOL / ATOL; (2) one
    stripe whose bf16 rounding is exact, at EXACT_RTOL / EXACT_ATOL, with
    its control in the other precision, which must FAIL; (3) masked
    half-star codes against masked f32 / bf16 tiles with int8 validity,
    bit for bit; (4) full-rank masks (every lambda at k with identity
    rows, or random lambdas with rows of k) against the unmasked kernel,
    bit for bit. Returns {"max_abs": worst error of (1)-(2), "cases": n}."""
    NU, bu, ni = 8, 376, 1000
    gen = torch.Generator().manual_seed(5)
    worst, cases, failures = 0.0, 0, []
    for kind in MASK_KINDS:
        R, W, r_scale = _tiles(kind, NU, bu, ni, gen, dev)
        for k in (32, 64, 128, 160):
            u3 = torch.randn((NU, bu, k), generator=gen).to(dev)
            i_tab = torch.randn((ni, k), generator=gen).to(dev)
            order = torch.randperm(NU, generator=gen)
            for rk in ("static", "poisson"):
                ranks = _ranks(NU, bu, ni, k, rk, gen, dev)
                for mm in ((True,) if k > 128 else (True, False)):
                    scale = SCALE_BF16 if mm else SCALE_F32
                    for cn in (True, False):
                        lr = LR if cn else LR / COUNT_PER_USER
                        got, want = _masked_pair(scale * u3, scale * i_tab,
                                                 order, lr, R, W, r_scale,
                                                 cn, mm, ranks)
                        a, r, ratio = _errors(got, want)
                        worst, cases = max(worst, a), cases + 1
                        ok = ratio <= 1.0
                        log(f"(c) masked {rk:7s} {kind:6s} k={k:3d} "
                            f"mm_bf16={mm!s:5s} collision_norm={cn!s:5s} "
                            f"max_abs {a:.3e} max_rel {r:.3e} err/tol "
                            f"{ratio:.3e} {'ok' if ok else 'FAIL'}")
                        if not ok:
                            failures.append(("multi", kind, k, rk, mm, cn))
    order1 = torch.zeros(1, dtype=torch.int64)
    for kind in MASK_KINDS:
        R, W, r_scale = _tiles(kind, 1, bu, ni, gen, dev)
        for k in (32, 64, 128):
            u3 = _dyadic((1, bu, k), gen).to(dev)
            i_tab = _dyadic((ni, k), gen).to(dev)
            ranks = _ranks(1, bu, ni, k, "poisson", gen, dev)
            for cn in (True, False):
                lr = LR if cn else LR / COUNT_PER_USER
                pairs = {mm: _masked_pair(u3, i_tab, order1, lr, R, W,
                                          r_scale, cn, mm, ranks)
                         for mm in (True, False)}
                for mm in (True, False):
                    a, r, ratio = _errors(*pairs[mm], EXACT_RTOL, EXACT_ATOL)
                    ctl = _errors(pairs[mm][0], pairs[not mm][1],
                                  EXACT_RTOL, EXACT_ATOL)[2]
                    worst, cases = max(worst, a), cases + 1
                    ok = ratio <= 1.0 and ctl > 1.0
                    log(f"(c) masked exact-bf16 {kind:6s} k={k:3d} "
                        f"mm_bf16={mm!s:5s} collision_norm={cn!s:5s} "
                        f"max_abs {a:.3e} err/tol {ratio:.3e}; control "
                        f"err/tol {ctl:.3e} (must be > 1) "
                        f"{'ok' if ok else 'FAIL'}")
                    if not ok:
                        failures.append(("exact", kind, k, mm, cn))
    codes, _, _ = _tiles("codes", NU, bu, ni, gen, dev)
    W8 = (codes != 0).to(torch.int8)
    for k in (32, 64, 128):
        u3 = torch.randn((NU, bu, k), generator=gen).to(dev)
        i_tab = torch.randn((ni, k), generator=gen).to(dev)
        order = torch.randperm(NU, generator=gen)
        ranks = _ranks(NU, bu, ni, k, "poisson", gen, dev)
        for mm in (True, False):
            scale = SCALE_BF16 if mm else SCALE_F32
            for cn in (True, False):
                lr = LR if cn else LR / COUNT_PER_USER
                run = lambda R, W_, r_scale: _stripe_epoch(
                    scale * u3, scale * i_tab, order, lr, R, W_, r_scale,
                    cn, mm, ranks)
                want = run(codes, None, 0.5)
                for rtype in (torch.float32, torch.bfloat16):
                    got = run((codes.float() * 0.5).to(rtype), W8, None)
                    same = all(torch.equal(x, y) for x, y in zip(got, want))
                    cases += 1
                    log(f"(c) masked codes vs {str(rtype)[6:]} R + int8 W "
                        f"k={k:3d} mm_bf16={mm!s:5s} collision_norm="
                        f"{cn!s:5s} bit-identical {same} "
                        f"{'ok' if same else 'FAIL'}")
                    if not same:
                        failures.append(("codes", rtype, k, mm, cn))
    for kind in MASK_KINDS:
        R, W, r_scale = _tiles(kind, NU, bu, ni, gen, dev)
        for k in (32, 64, 128, 160):
            u3 = SCALE_BF16 * torch.randn((NU, bu, k), generator=gen).to(dev)
            i_tab = SCALE_BF16 * torch.randn((ni, k), generator=gen).to(dev)
            order = torch.randperm(NU, generator=gen)
            for full in (True, False):
                ranks = _ranks(NU, bu, ni, k, "static", gen, dev, full=full)
                if not full:    # rows of k: a CDF table of zeros at U = 1
                    ranks = (*ranks[:2], torch.zeros((k, k), device=dev),
                             torch.ones(NU))
                for mm in (True, False):
                    run = lambda rk: _stripe_epoch(
                        u3, i_tab, order, LR, R, W, r_scale, True, mm, rk)
                    same = all(torch.equal(x, y)
                               for x, y in zip(run(ranks), run(None)))
                    cases += 1
                    log(f"(c) full-rank masks vs unmasked {kind:6s} "
                        f"k={k:3d} mm_bf16={mm!s:5s} "
                        f"{'every lambda k' if full else 'rows of k':14s} "
                        f"bit-identical {same} {'ok' if same else 'FAIL'}")
                    if not same:
                        failures.append(("full", kind, k, full, mm))
    if failures:
        raise AssertionError(f"masked stripe kernel cases failed: "
                             f"{failures}")
    return {"max_abs": worst, "cases": cases}


def _cell_rounds(NU: int, NI: int, epochs: int, gen: torch.Generator):
    """``epochs`` epochs of the diag schedule's rounds, [R, NI]: NU user
    blocks on NI lanes (item blocks); NU marks a dummy lane."""
    return torch.cat([bsk.diag_schedule(gen, NU, NI, 1)[0]
                      for _ in range(epochs)])


def _cells_epoch(u3, i3, ub_idx, lr, R, W, r_scale, cn, mm):
    """One cell-grid epoch of freshly staged StripeTiles at REG on copies
    of the tables."""
    tiles = drk.StripeTiles(R, W, r_scale, u3.shape[2], REG, REG, cn, mm,
                            NI=i3.shape[0])
    return tiles.cells_epoch(u3.clone(), i3.clone(), ub_idx, lr)


def _cell_pair(u3, i3, ub_idx, lr, R, W, r_scale, cn, mm):
    """(kernel result, plain result) of the cell grid on the same inputs;
    the kernel's launches checked against its plan (a panel and a step
    launch a round with a live cell, + the bf16 copy of U)."""
    before = drk.StripeTiles.launches
    kern = _cells_epoch(u3, i3, ub_idx, lr, R, W, r_scale, cn, mm)
    assert drk.StripeTiles.launches - before == \
        drk.cells_plan(ub_idx, u3.shape[0], u3.shape[2], mm)["launches"]
    plain = dense_sweep_diag(u3.clone(), i3.clone(), ub_idx, lr, R, W, REG,
                             REG, cn, mm, r_scale=r_scale)
    return kern, plain


def _cell_tiles(kind, n_cells, bu, bi, gen, dev):
    """_tiles for n_cells cells plus the all-invalid dummy cell last."""
    R, W, r_scale = _tiles(kind, n_cells + 1, bu, bi, gen, dev)
    R[-1] = 0
    if W is not None:
        W[-1] = 0
    return R, W, r_scale


def phase_cells_vs_plain(dev="cuda") -> dict:
    """(c), cell grid: the cell-grid entry of the stripe source
    (StripeTiles.cells_epoch) against dense_sweep_diag on the same CUDA
    tensors.
    (1) 4 user blocks of 376 on 3 lanes, one epoch's rounds (dummy lanes;
    each user block back on every lane, so a stale bf16 copy of U would
    show; each further epoch would compound the bf16 rounding flips the
    tolerance leaves out, SCALE_BF16), bi 200 (a ragged 128-item panel,
    int8 rows not whole 16-byte pieces) or 384, every tile kind x k 10 / 64 / 128 / 160 (the CUDA-core
    kernel) x matmul precision x collision norm, at RTOL / ATOL; (2) one
    round of disjoint cells (a dummy lane) from _dyadic factors at
    EXACT_RTOL / EXACT_ATOL, with the control in the other precision that
    must FAIL; (3) half-star codes against f32 / bf16 tiles with int8
    validity, bit for bit. Returns ({tile kind: max abs error of (1)-(2)},
    cases)."""
    NU, NI, bu = 4, 3, 376
    gen = torch.Generator().manual_seed(6)
    worst, cases, failures = {}, 0, []
    for kind in TILE_KINDS:
        for k in (10, 64, 128, 160):
            bi = 200 if k in (10, 128) else 384
            R, W, r_scale = _cell_tiles(kind, NU * NI, bu, bi, gen, dev)
            ub_idx = _cell_rounds(NU, NI, 1, gen)
            u3 = torch.randn((NU, bu, k), generator=gen).to(dev)
            i3 = torch.randn((NI, bi, k), generator=gen).to(dev)
            for mm in (True, False):
                scale = SCALE_BF16 if mm else SCALE_F32
                for cn in (True, False):
                    # without the norm a gradient sums ~5% of bi items
                    lr = LR if cn else LR / (0.05 * bi)
                    got, want = _cell_pair(scale * u3, scale * i3, ub_idx,
                                           lr, R, W, r_scale, cn, mm)
                    a, r, ratio = _errors(got, want)
                    worst[kind] = max(worst.get(kind, 0.0), a)
                    cases += 1
                    ok = ratio <= 1.0
                    log(f"(c) cells {kind:8s} k={k:3d} bi={bi} "
                        f"mm_bf16={mm!s:5s} collision_norm={cn!s:5s} "
                        f"max_abs {a:.3e} max_rel {r:.3e} err/tol "
                        f"{ratio:.3e} {'ok' if ok else 'FAIL'}")
                    if not ok:
                        failures.append(("multi", kind, k, mm, cn))
    one_round = torch.tensor([[1, 2, 0]])   # lane 1: the dummy block 2
    for kind in TILE_KINDS:
        R, W, r_scale = _cell_tiles(kind, 2 * NI, bu, 200, gen, dev)
        for k in (32, 128, 160):
            u3 = _dyadic((2, bu, k), gen).to(dev)
            i3 = _dyadic((NI, 200, k), gen).to(dev)
            for cn in (True, False):
                lr = LR if cn else LR / 10
                pairs = {mm: _cell_pair(u3, i3, one_round, lr, R, W,
                                        r_scale, cn, mm)
                         for mm in (True, False)}
                for mm in (True, False):
                    a, r, ratio = _errors(*pairs[mm], EXACT_RTOL, EXACT_ATOL)
                    ctl = _errors(pairs[mm][0], pairs[not mm][1],
                                  EXACT_RTOL, EXACT_ATOL)[2]
                    worst[kind] = max(worst.get(kind, 0.0), a)
                    cases += 1
                    ok = ratio <= 1.0 and ctl > 1.0
                    log(f"(c) cells exact-bf16 {kind:8s} k={k:3d} "
                        f"mm_bf16={mm!s:5s} collision_norm={cn!s:5s} "
                        f"max_abs {a:.3e} err/tol {ratio:.3e}; control "
                        f"err/tol {ctl:.3e} (must be > 1) "
                        f"{'ok' if ok else 'FAIL'}")
                    if not ok:
                        failures.append(("exact", kind, k, mm, cn))
    codes, _, _ = _cell_tiles("codes", NU * NI, bu, 384, gen, dev)
    W8 = (codes != 0).to(torch.int8)
    for k in (32, 64, 128):
        ub_idx = _cell_rounds(NU, NI, 2, gen)
        u3 = torch.randn((NU, bu, k), generator=gen).to(dev)
        i3 = torch.randn((NI, 384, k), generator=gen).to(dev)
        for mm in (True, False):
            scale = SCALE_BF16 if mm else SCALE_F32
            for cn in (True, False):
                lr = LR if cn else LR / (0.05 * 384)
                run = lambda R, W_, r_scale: _cells_epoch(
                    scale * u3, scale * i3, ub_idx, lr, R, W_, r_scale, cn,
                    mm)
                want = run(codes, None, 0.5)
                for rtype in (torch.float32, torch.bfloat16):
                    got = run((codes.float() * 0.5).to(rtype), W8, None)
                    same = all(torch.equal(x, y) for x, y in zip(got, want))
                    cases += 1
                    log(f"(c) cells codes vs {str(rtype)[6:]} R + int8 W "
                        f"k={k:3d} mm_bf16={mm!s:5s} collision_norm="
                        f"{cn!s:5s} bit-identical {same} "
                        f"{'ok' if same else 'FAIL'}")
                    if not same:
                        failures.append(("codes", rtype, k, mm, cn))
    if failures:
        raise AssertionError(f"cell-grid kernel cases failed: {failures}")
    return worst, cases


def _check_and_time(tag: str, solver, state, lr: float, reps: int = 2,
                    mm_bf16=None, order=None, round_u=None):
    """One epoch from ``state`` on the solver's staged tiles, through the
    kernel and through the plain version, held together at RTOL / ATOL; the
    kernel's epoch run twice must give bit-identical factors (fixed-point
    gradient sums); then ms per epoch of each, alternating plain, kernel,
    kernel, plain,
    CUDA-event timed; in the solver's matmul precision unless ``mm_bf16``
    says otherwise (the tiles staged again); in ``order`` (default: a fixed
    random one) and with TMF+Dropout's visit uniforms ``round_u`` where
    its ranks are drawn. Returns (max abs error, kernel ms, plain ms)."""
    tiles = solver.tiles
    if mm_bf16 is not None and mm_bf16 != tiles.mm_bf16:
        tiles = _restaged(tiles, mm_bf16)
    u3, i_tab = solver.stage_factors(state)
    if order is None:
        order = torch.randperm(solver.NU, generator=torch.Generator()
                               .manual_seed(1))
    Lu, Li, Q = tiles.visit_ranks(round_u) or (None, None, None)

    def kernel():
        return tiles.rows_epoch(u3.clone(), i_tab.clone(), order, lr,
                                round_u)

    def plain():
        return dense_sweep_rows(u3.clone(), i_tab.clone(), order, lr,
                                tiles.R, tiles.W, tiles.u_reg, tiles.i_reg,
                                tiles.collision_norm, tiles.mm_bf16,
                                r_scale=tiles.r_scale, Lu3=Lu, Li=Li, Q=Q)

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
    return _bound_ops(nbytes, {peak: flops})


def _bound_ops(nbytes: float, flops: dict):
    """_bound for work of several types ({peak: flops}): the operations'
    times at their peaks, summed, against the bytes' time."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = sum(f / PEAK_FLOPS[kind] * 1e3 for kind, f in flops.items())
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def stripe_bound(solver, ranks=None):
    """Bound of one stripe-engine epoch: every tile read once, U and I read
    and written once (and the rank tables Lu, Li, Q read once where
    given); three products of 2k FLOP a slot on the bf16 tensor cores (the
    f32 CUDA-core peak without mm_bf16)."""
    k = solver.params.fac_dim
    slots = solver.NU * solver.bu * solver.n_items_pad
    nbytes = (solver.tiles.R.nbytes
              + (0 if solver.tiles.W is None else solver.tiles.W.nbytes)
              + 2 * 4 * k * (solver.NU * solver.bu + solver.n_items_pad)
              + (0 if ranks is None else sum(t.nbytes for t in ranks)))
    return _bound(nbytes, 6.0 * slots * k,
                  "bf16" if solver.mm_bf16 else "f32")


def _three_products_ms(bu: int, ni: int, k: int, n: int) -> float:
    """n steps of the three products of a [bu, ni] tile as bf16
    torch.matmul calls (cuBLAS) on random operands, P = U I^T, E^T U and
    E I: a yardstick only, the port never calls it. Min of 3 after a
    warm-up, CUDA events."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    rnd = lambda *shape: torch.randn(shape, device="cuda", generator=gen,
                                     dtype=torch.bfloat16)
    U, I, E = rnd(bu, k), rnd(ni, k), rnd(bu, ni)

    def epoch():
        for _ in range(n):
            U @ I.T, E.T @ U, E @ I

    epoch()
    torch.cuda.synchronize()
    return min(_cuda_ms(epoch) for _ in range(3))


def stripe_library_ms(solver) -> float:
    """The epoch's three stripe products as bf16 cuBLAS calls, summed over
    the epoch's stripes (_three_products_ms)."""
    return _three_products_ms(solver.bu, solver.n_items_pad,
                              solver.params.fac_dim, solver.NU)


def phase_main_path(tag: str, data: Data, params: Params, tiles: str,
                    dev="cuda", algo: str = "mf"):
    drk.StripeTiles.launches = 0
    t0 = time.perf_counter()
    rep, model, ev, _ = train_model(data, params, algo=algo,
                                    mf_method="densesgd", device=dev,
                                    log_fn=lambda s: log(f"({tag}) {s}"))
    wall = time.perf_counter() - t0
    launches = drk.StripeTiles.launches
    solver = rep.solver
    R, W = solver.tiles.R, solver.tiles.W
    log(f"({tag}) {algo}: staged NU={solver.NU} bu={solver.bu} ni_pad="
        f"{solver.n_items_pad} R={R.dtype} W="
        f"{None if W is None else W.dtype} "
        f"r_scale={solver.r_scale} nnz={solver.nnz}; train_model wall "
        f"{wall:.1f} s; stop={rep.stop_reason}")
    if tiles == "codes":
        assert W is None and solver.r_scale == 0.5, \
            "star ratings should stage int8 code tiles"
    else:
        r, w = tiles.split("+")
        rtype = {"f32": torch.float32, "bf16": torch.bfloat16}[r]
        wtype = {"W": torch.int8, "fW": torch.float32,
                 "bfW": torch.bfloat16}[w]
        assert W is not None and (R.dtype, W.dtype) == (rtype, wtype), \
            f"this shape should stage {tiles} tiles"
    if algo == "ifwmf":
        w = W[W > 0]
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
    best = rep.best_state
    del rep, solver, ev
    torch.cuda.empty_cache()
    return dict(launches=launches, max_abs_err=err, ms=kernel_ms,
                plain_ms=plain_ms, bound_ms=bound[0], bound_by=bound[1],
                library_ms=lib_ms, best=best, params=params)


def bench_data(n_users, n_items, density, noise, power_law, stars, val_pc):
    """The cell's splits, with the generator's factors as ground truth."""
    t0 = time.perf_counter()
    mat, uf, vf = low_rank_ratings(n_users, n_items, k=8, density=density,
                                   seed=0, noise=noise, power_law=power_law,
                                   nonneg=True)
    if stars:
        mat.values[:] = (np.clip(np.round(mat.values / 0.5), 1, 10)
                         * 0.5).astype(np.float32)
    tr, te, va = split_train_test_val(mat, 0.1, val_pc, seed=1)
    data = Data(train_mat=tr, test_mat=te, val_mat=va, orig_u_fac=uf,
                orig_i_fac=vf)
    log(f"data {data} made in {time.perf_counter() - t0:.1f} s")
    return data


def run_cell(tag: str, data=None):
    data_kw, params_kw, tiles = CELLS[tag]
    data = bench_data(**data_kw) if data is None else data
    return phase_main_path(tag, data, Params(**params_kw), tiles,
                           algo=CELL_ALGO[tag])


# ----------------------------------------------------------------------
# (w): the dense engine's diag cell grid at full width
# ----------------------------------------------------------------------

# (d)'s data and Params on the cell grid the JAX package measured at this
# shape (scripts/tpu_dense_probe.py:3-6: R [1601, 2560, 512]): 40 x 40
# cells of 2560 users x 512 items, bf16 R + int8 W under the 8 GiB budget
W_BLOCKS = (2560, 512)
W_EPOCHS = 3
# A whole cell-grid epoch in bf16 products is held at the JAX package's
# class for bf16 over several steps (tests/test_pallas_dense_rows.py:120),
# not at RTOL / ATOL: each block takes 40 steps an epoch, each from rows
# the previous step rounded to bf16, and a rounding flip of E between two
# correct summation orders carries on through them. Measured by
# scripts/torch_cells_drift.py on an NVIDIA H100 80GB HBM3 at 700 W from
# (w)'s initial state: the kernel against the plain version 3.7e-9 after
# one round, 2.3e-5 after two, 1.8e-3 after 40; the plain version on the
# card against the plain version on the CPU 6.8e-4 (err/tol 1.78 at RTOL
# / ATOL). One round (every block once, as a stripe epoch) is held at
# RTOL / ATOL, and the whole epoch in f32 products (3.6e-7) too.
W_BF16_RTOL, W_BF16_ATOL = 5e-3, 5e-4
# (w) with a panel and a step launch a cell, the entry's design before
# one launch pair a round (NVIDIA H100 80GB HBM3 at 700 W): the numbers
# (w) logs its own beside
W_PER_CELL = dict(ms=62.591, launches=3201, idle=0.068, us_round=1564.8)


def cells_bound(solver):
    """Bound of one cell-grid epoch: every visited cell's tiles read once,
    U and I read and written once; three products of 2k FLOP a slot on the
    bf16 tensor cores (the f32 CUDA-core peak without mm_bf16)."""
    k = solver.params.fac_dim
    slots = solver.NU * solver.NI * solver.bu * solver.bi
    per_slot = solver.tiles.R.element_size() + (
        0 if solver.tiles.W is None else solver.tiles.W.element_size())
    nbytes = (slots * per_slot
              + 2 * 4 * k * (solver.n_users_pad + solver.n_items_pad))
    return _bound(nbytes, 6.0 * slots * k,
                  "bf16" if solver.mm_bf16 else "f32")


def _code_tiles(R, W, chunk: int = 100):
    """Half-star int8 codes of the float tiles, round(2 r) in [1, 10] on
    valid slots, and the same ratings as bf16 tiles (code * 0.5, exact),
    made a chunk of cells at a time (the f32 temporaries of the whole grid
    would take 8 GB each)."""
    codes = torch.empty(R.shape, dtype=torch.int8, device=R.device)
    halves = torch.empty(R.shape, dtype=torch.bfloat16, device=R.device)
    for c0 in range(0, R.shape[0], chunk):
        sl = slice(c0, c0 + chunk)
        q = (R[sl].float() * 2).round().clamp(1, 10)
        codes[sl] = torch.where(W[sl] > 0, q, 0.0).to(torch.int8)
        halves[sl] = codes[sl].to(torch.bfloat16) * 0.5
    return codes, halves


def phase_cell_grid(data: Data, dev="cuda") -> dict:
    """(w): BlockSGDSolver(engine="dense", bu=2560, bi=512) on (d)'s data
    through TrainLoop for W_EPOCHS epochs, counts zeroed just before: every
    epoch one cell-grid call, a panel and a step launch for each of its 40
    rounds and the bf16 copy of U (81), val RMSE
    finite and falling; then, from the initial state on the staged cells
    and with rounds from a fixed generator, kernel against plain: the
    epoch's first round at RTOL / ATOL, the whole epoch at W_BF16_RTOL /
    W_BF16_ATOL and in f32 products at RTOL / ATOL; the kernel's epoch
    twice (bit-identical), half-star codes of the tiles against the same
    ratings as bf16 tiles (bit-identical); epoch ms of both, the idle
    share, the bound, the three products as cuBLAS calls and peak
    memory."""
    params = Params(**dict(CELLS["d"][1], max_iter=W_EPOCHS))
    n, m, k = data.n_users, data.n_items, params.fac_dim
    iu, ii = freq.invalid_users_items(data.train_mat, n, m)
    model = ModelMF(params, n, m)
    ev = Evaluator(data, iu, ii, params, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    solver = BlockSGDSolver(model, params, data.train_mat, iu, ii,
                            bu=W_BLOCKS[0], bi=W_BLOCKS[1], engine="dense",
                            device=dev)
    torch.cuda.synchronize()
    stage_s = time.perf_counter() - t0
    R, W = solver.tiles.R, solver.tiles.W
    tiles_gb = (R.nbytes + W.nbytes) / 1e9
    log(f"(w) staged the diag cell grid: NU={solver.NU} NI={solver.NI} "
        f"bu={solver.bu} bi={solver.bi} tiles {tuple(R.shape)} R={R.dtype} "
        f"W={W.dtype} ({tiles_gb:.2f} GB) nnz={solver.nnz} in "
        f"{stage_s:.1f} s")
    assert (solver.schedule, solver.NU, solver.NI, R.dtype, W.dtype) == (
        "diag", -(-n // W_BLOCKS[0]), -(-m // W_BLOCKS[1]), torch.bfloat16,
        torch.int8)
    assert int(W.sum(dtype=torch.int64)) == solver.nnz
    s0 = init_state(params, n, m, device=dev)
    drk.StripeTiles.launches = 0
    t0 = time.perf_counter()
    rep = TrainLoop(model, solver, ev, params,
                    log_fn=lambda s: log(f"(w) {s}")).run(s0)
    wall = time.perf_counter() - t0
    launches = drk.StripeTiles.launches
    visits = solver.NU * solver.NI
    rounds = -(-solver.NU // solver.NI) * solver.NI
    want = W_EPOCHS * drk.epoch_launches(rounds, k, solver.mm_bf16)
    assert want == W_EPOCHS * 81, want
    assert launches == want, (launches, want)
    assert rep.stop_reason == "max_iter" and len(rep.history) == W_EPOCHS
    val0 = ev.rmse(model.eval_view(s0), "val")
    vals = [h.val_rmse for h in rep.history]
    loop_ms = [1e3 * h.seconds for h in rep.history]
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"(w) {W_EPOCHS} epochs in {wall:.1f} s; launches {launches} "
        f"(= {want}: {want // W_EPOCHS} an epoch, {W_PER_CELL['launches']} "
        f"with a launch pair a cell); val RMSE at init {val0!r}, per epoch "
        f"{vals!r}; epoch "
        f"in the loop (host clock, synchronized) {loop_ms!r} ms; peak "
        f"memory {peak:.2f} GB")
    assert all(np.isfinite(vals)) and rep.best_metric < val0, (vals, val0)
    for t in rep.state[:2]:
        assert bool(torch.isfinite(t).all())
    ub_idx = bsk.diag_schedule(torch.Generator().manual_seed(1), solver.NU,
                               solver.NI, 1)[0]
    u3, i3 = solver.stage_factors(s0)
    p, lr = params, params.learn_rate
    def run(R_, W_, r_scale, rounds=ub_idx, mm=solver.mm_bf16):
        """An epoch of the tiles R_ / W_: the solver's staged object, or
        the tiles staged afresh."""
        tiles = solver.tiles if R_ is R and mm == solver.mm_bf16 else \
            drk.StripeTiles(R_, W_, r_scale, k, p.u_reg, p.i_reg,
                            solver.collision_norm, mm, NI=solver.NI)
        return tiles.cells_epoch(u3.clone(), i3.clone(), rounds, lr)
    sweep = lambda rounds=ub_idx, mm=solver.mm_bf16: dense_sweep_diag(
        u3.clone(), i3.clone(), rounds, lr, R, W, p.u_reg, p.i_reg,
        solver.collision_norm, mm)
    kernel = lambda: run(R, W, None)
    plain = lambda: sweep()
    err = 0.0
    for what, kern, pl, rtol, atol in (
            ("the first round", run(R, W, None, ub_idx[:1]),
             sweep(ub_idx[:1]), RTOL, ATOL),
            ("the epoch", kernel(), plain(), W_BF16_RTOL, W_BF16_ATOL),
            ("the epoch in f32 products", run(R, W, None, mm=False),
             sweep(mm=False), RTOL, ATOL)):
        a, rel, ratio = _errors(kern, pl, rtol, atol)
        err = max(err, a)
        log(f"(w) {what} replayed on the staged cells, kernel vs plain: "
            f"max_abs {a:.3e} max_rel {rel:.3e} err/tol {ratio:.3e} (rtol "
            f"{rtol}, atol {atol}) {'ok' if ratio <= 1.0 else 'FAIL'}")
        if ratio > 1.0:
            raise AssertionError(f"(w) kernel disagrees with the plain "
                                 f"version on {what} (rtol {rtol}, atol "
                                 f"{atol})")
    same = all(torch.equal(x, y) for x, y in zip(kernel(), kernel()))
    codes, halves = _code_tiles(R, W)
    coded = all(torch.equal(x, y) for x, y in zip(run(codes, None, 0.5),
                                                   run(halves, W, None)))
    del codes, halves
    log(f"(w) the kernel's epoch twice: bit-identical {same}; half-star "
        f"codes of the tiles vs the same ratings as bf16 tiles: "
        f"bit-identical {coded} {'ok' if same and coded else 'FAIL'}")
    if not (same and coded):
        raise AssertionError("(w) the cell-grid epoch is not reproducible "
                             "bit for bit")
    k_ms, p_ms = _alternate(kernel, plain)
    ms, busy, idle, _ = _busy_idle(kernel)
    by_kernel = _kernel_ms(kernel, ("panel_kernel", "step_kernel",
                                    "u_bf16_kernel"))
    bound = cells_bound(solver)
    lib_ms = _three_products_ms(solver.bu, solver.bi, k, visits)
    log(f"(w) cell-grid epoch alone (CUDA events): kernel {k_ms:.3f} ms "
        f"(a launch pair a cell: {W_PER_CELL['ms']}) = "
        f"{solver.nnz / k_ms * 1e3:.4e} "
        f"ratings/s, {launches // W_EPOCHS} launches, "
        f"{k_ms / rounds * 1e3:.1f} us a round of {solver.NI} cells (a "
        f"launch pair a cell: {W_PER_CELL['us_round']}); device busy "
        f"{busy:.3f} of {ms:.3f} ms, idle share {idle:.3f} (a launch pair a "
        f"cell: {W_PER_CELL['idle']}); device ms by "
        f"kernel (torch.profiler) {by_kernel}; plain PyTorch "
        f"{p_ms:.3f} ms; bound {bound[0]:.3f} ms ({bound[1]}), kernel at "
        f"{bound[0] / k_ms:.3f} of it; the three products a cell as bf16 "
        f"cuBLAS calls {lib_ms:.3f} ms")
    del rep, solver, ev, R, W, u3, i3
    torch.cuda.empty_cache()
    return dict(launches=launches, max_abs_err=err, ms=k_ms, plain_ms=p_ms,
                bound_ms=bound[0], bound_by=bound[1], library_ms=lib_ms)


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
    (the radix route), the radix route's first m slots against the fused
    route's top-m bit for bit (m = 1, 10, FUSED_MAX_N); then 20,000 queried
    rows, whose user tiles fill the card (the fused route in one
    launch)."""
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
                outs = {}
                for n in ns:
                    pl = tk.fused_plan(B, 3001, n)
                    before = tk.topk_catalog.launches
                    got = outs[n] = tk.topk_catalog(**case, n=n)
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
                if 1000 not in outs:
                    continue
                same = [m for m in (1, 10, N_F) if all(
                    torch.equal(r[:, :m], f) for r, f in zip(outs[1000],
                                                             outs[m]))]
                ok = len(same) == 3
                log(f"(f) {'exact' if exact else 'random'} B={B} k={k:3d} "
                    f"radix top-1000's first m slots = fused top-m bit for "
                    f"bit at m in {same} {'ok' if ok else 'FAIL'}")
                if not ok:
                    failures.append((B, exact, k, "radix vs fused"))
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


def phase_ranking(data: Data, dev="cuda"):
    """(g): the main path (train with val HR@10 after each epoch, test ARHR
    at n=1000, Recommender answering 2,048 users) with the top-N counts
    zeroed just before and read after each step; then each route against
    the plain version on the best view, the radix route's first m slots
    against the fused route's top-m bit for bit, and both timed, the radix
    route by stage beside torch.topk on its score scratch. Returns {route:
    (launches, max abs error, kernel ms, plain ms, bound)}."""
    params = Params(**BPR_CELL[1])
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
    same = [m for m, fused in ((1, tk.topk_catalog(**args, n=1)), (10, got),
                               (tk.FUSED_MAX_N, tk.topk_catalog(
                                   **args, n=tk.FUSED_MAX_N)))
            if all(torch.equal(r[:, :m], f) for r, f in zip(got1k, fused))]
    log(f"(g) the radix top-1000's first m slots = the fused top-m bit for "
        f"bit, all {n_users} users, at m in {same} "
        f"{'ok' if len(same) == 3 else 'FAIL'}")
    if len(same) != 3:
        raise AssertionError("(g) the radix route's prefix differs from the "
                             "fused route's top-m")
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
    stages = ("radix_score_kernel", "radix_select_kernel")
    split10 = _kernel_ms(lambda: tk.topk_catalog(**args, n=radix), stages)
    split1k = _kernel_ms(lambda: tk.topk_catalog(**args, n=1000), stages)
    # the select stage's yardstick (the port never calls it): torch.topk on
    # the score stage's scratch of one chunk, scaled to the pass's users
    chunk = tk.chunk_users(n_items)
    S = tk.radix_scores(**dict(args, users=args["users"][:chunk]))
    torch.topk(S, 1000, dim=1)
    topk_ms = _cuda_ms(lambda: torch.topk(S, 1000, dim=1), 2) \
        * n_users / S.shape[0]
    del S
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
    log(f"(g) radix top-1000 by stage: score {split1k[stages[0]]:.3f} ms "
        f"(a 4x4-tile score kernel: ~15), select {split1k[stages[1]]:.3f} ms "
        f"(a select kernel reading the row six times: 25.7); "
        f"torch.topk on the same excluded score scratch (a chunk of "
        f"{chunk} users, scaled to {n_users}) {topk_ms:.3f} ms, a yardstick "
        f"for the select stage only")
    log(f"(g) top-1000 pass (radix route): kernel {k1k!r} ms (those two "
        f"kernels: 40.690), plain {p1k!r} ms")
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
# (r), (s): the rest of BPR at (g)'s shape, plain PyTorch around the
# top-N kernel
# ----------------------------------------------------------------------

# The JAX package's own end-to-end BPR run at this shape steps at lr 0.1
# (scripts/tpu_bpr_end2end.py:65). At (g)'s 0.005 the loss stays at
# n ln 2 for the first epochs and val HR@10 does not move in 2-3 of them
# (a rehearsal at 20k x 4k on the CPU: 0.0024 -> 0.0027 in three hybrid
# epochs, below its start after two sigmoid ones); at 0.1 it rose to 0.25
# (hybrid) and 0.45 (dense engine) in two.
BPR_E2E_LR = 0.1
# card vs CPU, the scatter engines (stream BPR, sgd) on the same draws and
# masks: f32 sums in another order (index_add_'s atomics on the card), a
# few steps from a trained state
SCATTER_TOL = (1e-4, 1e-5)
# the dense engine: the JAX package's own replica tolerance for it
# (tests/test_bpr_dense.py: bf16 score operands, f32 sums in another order)
DENSE_BPR_TOL = (2e-4, 2e-5)


def _tensor_bytes(obj) -> int:
    return sum(v.nbytes for v in vars(obj).values() if torch.is_tensor(v))


def bpr_bound(solver, draws_bytes: int):
    """A stream BPR epoch: the staged positives, CSR rows and sampler tables
    and the epoch's draws read once, both tables read and written once;
    per pair three k-dots and three k-wide gradient rows (~16k f32
    FLOP)."""
    k = solver.params.fac_dim
    tables = 4 * k * (solver.model.n_users + solver.model.n_items)
    return _bound_ops(_tensor_bytes(solver) + draws_bytes + 2 * tables,
                      {"f32": 16.0 * k * solver.n_pos})


def dense_bpr_bound(solver):
    """A dense BPR epoch: the int8 mask, the staged positives and counts,
    both tables read and written once; per stripe the bf16 score product
    and the two f32 routing products, 2 bu ni_pad k FLOP each."""
    k = solver.params.fac_dim
    prod = 2.0 * solver.NU * solver.bu * solver.ni_pad * k
    tables = 4 * k * (solver.n_users_pad + solver.ni_pad)
    return _bound_ops(_tensor_bytes(solver) + 2 * tables,
                      {"bf16": prod, "f32": 2 * prod})


def _clone_state(state, device=None):
    """A copy of every table (on ``device``, default its own): the stream
    BPR epoch updates the tables it is given in place."""
    return type(state)(*(t.to(device or t.device, copy=True)
                         for t in state))


def _hr_run(tag: str, data: Data, params: Params, algo: str, method: str,
            dev: str):
    """train_model with the top-N counts zeroed just before and read just
    after; the launches must be one fused pass per HR@10 check (the
    initial one and one an epoch), val HR@10 finite and its best above
    the initial state's."""
    tk.topk_catalog.launches = 0
    t0 = time.perf_counter()
    rep, model, scorer, _ = train_model(data, params, algo=algo,
                                        mf_method=method, device=dev,
                                        log_fn=lambda s: log(f"({tag}) {s}"))
    wall = time.perf_counter() - t0
    launches = tk.topk_catalog.launches
    epochs = len(rep.history)
    plan = tk.fused_plan(data.n_users, data.n_items, 10)
    assert rep.stop_reason == "max_iter" and epochs == params.max_iter, \
        (rep.stop_reason, epochs)
    assert plan["route"] == "fused" and \
        launches == (1 + epochs) * plan["launches"], (launches, plan)
    s0 = init_state(params, data.n_users, data.n_items, device=dev)
    hr0 = scorer.hit_rate(model.eval_view(s0), data.val_mat, 10)
    hrs = [h.val_rmse for h in rep.history]
    ok = all(np.isfinite(hrs)) and rep.best_metric > hr0
    log(f"({tag}) {algo} {method}: {type(rep.solver).__name__}, top-N "
        f"launches {launches} (the initial check and one an epoch, fused); "
        f"train_model wall {wall:.1f} s; val HR@10 at init {hr0!r}, per "
        f"epoch {hrs!r}, best {rep.best_metric!r} at epoch {rep.best_iter}; "
        f"loss per epoch {[h.objective for h in rep.history]!r}; epoch in "
        f"the loop {[round(1e3 * h.seconds, 3) for h in rep.history]} ms "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"({tag}) {algo} {method}: val HR@10 did not "
                             "rise or is not finite")
    return rep, model, scorer, launches


def _bpr_partial_masks(solver, border, bits, steps: int):
    """The sampled triple masks of the first ``steps`` steps, drawn on the
    solver's device from its mask generator, for both devices to use."""
    B = solver.batch_size
    masks = []
    for t in range(steps):
        sl = slice(int(border[t]) * B, (int(border[t]) + 1) * B)
        neg, _ = solver.sample_rankgap(solver.pos_start[sl],
                                       solver.pos_deg[sl], bits[t, 0],
                                       bits[t, 1])
        masks.append(solver.model.triple_rank_mask(
            solver.pos_u[sl], solver.pos_i[sl], neg,
            generator=solver.mask_gen))
    return masks


def _twice(tag: str, what: str, run):
    """Two runs of one epoch from one state with one set of draws: every
    table bit-identical (the engines sum in a fixed order), or the run
    fails. Returns the largest difference (0.0)."""
    return _same_bits(tag, what, run(), run())


def _same_bits(tag: str, what: str, a, b):
    """``_twice`` on two runs' states ``a`` and ``b``."""
    torch.cuda.synchronize()
    same = all(torch.equal(x, y) for x, y in zip(a, b))
    diff = max(float((x.float() - y.float()).abs().max())
               for x, y in zip(a, b) if x.numel())
    log(f"({tag}) {what}: two runs of one epoch on the card bit-identical "
        f"{same} (largest difference {diff:.3e}) {'ok' if same else 'FAIL'}")
    if not same:
        raise AssertionError(f"({tag}) {what}: two runs of one epoch differ")
    return diff


def phase_hybrid(data: Data, dev="cuda") -> dict:
    """(r): train_model(algo="bpr_poisson") at (g)'s shape, 3 epochs of
    "train" (Poisson-sampled triple ranks) and 2 of "sigmoid" (lambda
    itself), val HR@10 after each epoch through the fused top-N kernel on
    the CDF-truncated view; that kernel held against topk_plain on the
    truncated best view; 4 steps on the card held against the CPU copy of
    the solver on the same draws and masks; epoch ms, idle share, peak
    memory and bound. Returns {method: timing}, the top-N launches and the
    kernel's error."""
    out, launches, err = {}, 0, 0.0
    for method, n in (("train", 3), ("sigmoid", 2)):
        params = Params(**dict(BPR_CELL[1], learn_rate=BPR_E2E_LR,
                               max_iter=n))
        rep, model, scorer, n_launch = _hr_run("r", data, params,
                                               "bpr_poisson", method, dev)
        launches += n_launch
        solver = rep.solver
        assert isinstance(solver, BPRSolver), type(solver)
        assert model.sample_poisson == (method == "train")
        view = model.eval_view(rep.best_state)
        r_u, r_i = model.rank_u, model.rank_i
        cut = float((view.i_fac == 0).float().mean())
        log(f"(r) {method}: inference ranks: users {int(r_u.min())}-"
            f"{int(r_u.max())} (mean {float(r_u.float().mean()):.2f}), items "
            f"{int(r_i.min())}-{int(r_i.max())} (mean "
            f"{float(r_i.float().mean()):.2f}); lambda items "
            f"{int(model.lambda_i.min())}-{int(model.lambda_i.max())}; "
            f"{cut:.4f} of the item view's entries cut to 0")
        assert int(r_i.min()) < params.fac_dim and cut > 0, \
            "the eval view should be rank-truncated"
        args = dict(u_fac=view.u_fac, i_fac=view.i_fac, i_bias=view.i_bias,
                    u_bias=view.u_bias, mu=view.mu,
                    invalid=scorer.invalid_items_dev, indptr=scorer.indptr,
                    indices=scorer.indices, users=scorer._all_users)
        ok, e, held = topk_agree(tk.topk_catalog(**args, n=10),
                                 tk.topk_plain(**args, n=10), False)
        err = max(err, e)
        log(f"(r) {method}: top-10 of every user on the truncated best view, "
            f"kernel vs plain: max_abs {e:.3e}, ids held at {held:.4f} of "
            f"slots {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("(r) top-10 kernel vs plain on the "
                                 "truncated view")
        # a partial epoch on both devices: the same draws and masks
        lr = params.learn_rate
        border, bits = solver.draw()
        steps = 4
        masks = (_bpr_partial_masks(solver, border, bits, steps)
                 if model.sample_poisson else None)
        cpu = _cpu_copy(solver)
        st_c = cpu.epoch_with(_clone_state(rep.state, "cpu"), lr,
                              border[:steps],
                              bits.cpu(), masks)
        st_g = solver.epoch_with(_clone_state(rep.state), lr, border[:steps],
                                 bits, masks)
        for what, a, b in (("u", st_g.u_fac, st_c.u_fac),
                           ("i", st_g.i_fac, st_c.i_fac)):
            _held("r", f"{method}, {steps} steps of "
                  f"{solver.batch_size}, {what}", a, b, SCATTER_TOL)
        gen0 = solver.mask_gen.get_state()

        def epoch_again():
            solver.mask_gen.set_state(gen0)
            return solver.epoch_with(_clone_state(rep.state), lr, border,
                                     bits)

        _twice("r", method, epoch_again)
        state = _clone_state(rep.state)
        draws_bytes = bits.nbytes + border.nbytes
        out[method] = _time_epoch("r", f"bpr_poisson {method}",
                                  lambda: solver.epoch(state, lr),
                                  bpr_bound(solver, draws_bytes))
        out[method]["pairs_per_s"] = solver.n_pos / np.mean(
            out[method]["ms"]) * 1e3
        log(f"(r) {method}: {solver.n_pos} positives in {solver.n_batches} "
            f"batches, {out[method]['pairs_per_s']:.4e} pairs/s")
        del rep, solver, scorer, cpu, st_c, st_g, state, view, args
        torch.cuda.empty_cache()
    return {"timings": out, "launches": launches, "max_abs_err": err}


def phase_dense_bpr(data: Data, dev="cuda") -> dict:
    """(s): train_model(algo="bpr", bpr_engine="dense") at (g)'s shape, 3
    epochs at one negative a positive, then 2 epochs of the panel epoch at
    panel_q=128 (DenseBPRSolver built directly, TrainLoopHR), val HR@10 after
    each epoch through the fused top-N kernel; 1 stripe on the card held
    against the CPU copy of the solver on the same draws; whether two runs
    of an epoch repeat bit for bit; epoch ms, pairs/s, idle share, peak
    memory and bound. Returns {mode: timing} and the top-N launches."""
    out, launches = {}, 0
    base = dict(BPR_CELL[1], learn_rate=BPR_E2E_LR)
    params = Params(**dict(base, max_iter=3, bpr_engine="dense"))
    rep, model, scorer, n_launch = _hr_run("s", data, params, "bpr",
                                           "train", dev)
    launches += n_launch
    runs = [("T=1", rep.solver, rep.state)]
    del rep
    # the panel epoch: JAX's front door builds no panel solver, so it is
    # built here and trained by the same loop, from the initial state
    inval_u, inval_i = freq.invalid_users_items(data.train_mat, data.n_users,
                                                data.n_items)
    pp = Params(**dict(base, max_iter=2))
    panel = DenseBPRSolver(model, pp, data.train_mat, inval_u, inval_i,
                           panel_q=128, device=dev)
    tk.topk_catalog.launches = 0
    t0 = time.perf_counter()
    prep = TrainLoopHR(model, panel, scorer, data.val_mat, pp,
                       log_fn=lambda s: log(f"(s) {s}")).run(
        init_state(pp, data.n_users, data.n_items, device=dev))
    wall = time.perf_counter() - t0
    n_launch = tk.topk_catalog.launches
    launches += n_launch
    s0 = init_state(pp, data.n_users, data.n_items, device=dev)
    hr0 = scorer.hit_rate(model.eval_view(s0), data.val_mat, 10)
    hrs = [h.val_rmse for h in prep.history]
    ok = (all(np.isfinite(hrs)) and prep.best_metric > hr0
          and n_launch == 3 * tk.fused_plan(data.n_users, data.n_items,
                                            10)["launches"])
    log(f"(s) panel_q=128 ({panel.nb} sub-batches a stripe): top-N launches "
        f"{n_launch}; wall {wall:.1f} s; val HR@10 at init {hr0!r}, per "
        f"epoch {hrs!r}; loss {[h.objective for h in prep.history]!r}; "
        f"epoch in the loop {[round(1e3 * h.seconds, 3) for h in prep.history]}"
        f" ms {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("(s) panel epoch: val HR@10 did not rise")
    runs.append(("panel_q=128", panel, prep.state))
    del prep
    for name, solver, state in runs:
        log(f"(s) {name}: NU={solver.NU} bu={solver.bu} ni_pad="
            f"{solver.ni_pad} S={solver.S} nb={solver.nb} (pad share "
            f"{solver.pad_frac:.3f}); W_rows {solver.W_rows.nbytes / 1e9:.3f}"
            f" GB int8; {solver.n_pos} positives")
        lr = solver.params.learn_rate
        row_of, d = solver.draw()
        cpu = _cpu_copy(solver)
        # one stripe: a second reads the items the first updated, and there
        # a one-ulp f32 difference can flip a bf16 operand rounding of the
        # score product (1e-7 relative noise on a trained state moved two
        # stripes by 2e-4 in a rehearsal on the CPU, 20k x 4k)
        st_c = cpu.epoch_with(_clone_state(state, "cpu"), lr, row_of[:1],
                              d.cpu())
        st_g = solver.epoch_with(_clone_state(state), lr, row_of[:1], d)
        for what, a, b in (("u", st_g.u_fac, st_c.u_fac),
                           ("i", st_g.i_fac, st_c.i_fac)):
            _held("s", f"{name}, 1 stripe, {what}", a, b, DENSE_BPR_TOL)
        for what, a, b in (("loss", solver.last_loss, cpu.last_loss),
                           ("inversions", solver.last_inversions,
                            cpu.last_inversions)):
            log(f"(s) {name}, 1 stripe, {what}: card {float(a)!r} CPU "
                f"{float(b)!r}")
        del cpu, st_c, st_g
        out[name] = dict(twice=_twice("s", name, lambda: solver.epoch_with(
            _clone_state(state), lr, row_of, d)))
        held = [_clone_state(state)]

        def epoch():   # epochs in a row, as the loop runs them
            held[0] = solver.epoch(held[0], lr)

        out[name].update(_time_epoch("s", f"dense BPR {name}", epoch,
                                     dense_bpr_bound(solver)))
        ms = float(np.mean(out[name]["ms"]))
        t = solver.panel_q or solver.n_negs
        out[name]["pairs_per_s"] = solver.n_pos / ms * 1e3
        log(f"(s) {name}: {out[name]['pairs_per_s']:.4e} pairs/s (positives "
            f"an epoch second, bench.py's bpr_dense_pairs_per_sec), "
            f"{solver.n_pos * t / ms * 1e3:.4e} (positive, negative) pairs/s "
            f"at {t} negatives a positive")
        del solver, state, held
        torch.cuda.empty_cache()
    del runs, panel
    torch.cuda.empty_cache()
    return {"timings": out, "launches": launches}


def svd_bound(mat, rr: int, n_iter: int):
    """The randomized SVD: 2 n_iter + 2 COO products, each reading the COO
    triplets and its dense operand once and writing its output once, 2 nnz
    rr FLOP each; 2 n_iter + 1 QRs of [n, rr] (~2 n rr^2 FLOP each, f32)."""
    n_prod = 2 * n_iter + 2
    coo = mat.nnz * (8 + 8 + 4)
    dense = 4 * rr * (mat.nrows + mat.ncols)
    qr = (n_iter + 1) * 2.0 * mat.nrows * rr * rr + n_iter * 2.0 * \
        mat.ncols * rr * rr
    return _bound_ops(n_prod * (coo + dense),
                      {"f32": n_prod * 2.0 * mat.nnz * rr + qr})


def sgd_bound(solver):
    """A scatter SGD epoch: the staged stream read once, both tables read
    and written once; ~8k f32 FLOP a rating."""
    k = solver.params.fac_dim
    tables = 4 * k * (solver.model.n_users + solver.model.n_items)
    return _bound_ops(_tensor_bytes(solver) + 2 * tables,
                      {"f32": 8.0 * k * solver.nnz})


def _svd_vs_cpu(mat, k: int, dev: str, n_rows: int = 20_000) -> float:
    """svd_init of the first ``n_rows`` users' rows on the card and on the
    CPU with one test matrix: singular values at rtol 1e-4, vectors by
    |u_card . u_cpu| = 1 at atol 1e-3 (either may flip a sign), as the CPU
    parity tests hold the port to JAX. Returns the largest value error."""
    r, c, v = mat.to_coo()
    keep = r < n_rows
    sub = RatingMatrix.from_coo(r[keep], c[keep], v[keep], n_rows,
                                mat.ncols)
    rr = min(k + 8, sub.nrows, sub.ncols)
    omega = torch.randn(sub.ncols, rr,
                        generator=torch.Generator().manual_seed(3)).numpy()
    gu, gv, gs = svd_init(sub, k, omega=omega, device=dev)
    cu, cv, cs_ = svd_init(sub, k, omega=omega, device="cpu")
    err = float(np.abs(gs - cs_).max())
    dots = [np.abs((a * b).sum(0)) for a, b in ((gu, cu), (gv, cv))]
    ok = (np.allclose(gs, cs_, rtol=1e-4, atol=0)
          and all(np.allclose(d, 1.0, atol=1e-3) for d in dots))
    log(f"(t) svd_init of {sub.nrows} x {sub.ncols} (nnz {sub.nnz}), card vs "
        f"CPU with one omega: singular values max_abs {err:.3e} (rtol "
        f"1e-4), |u . u| min {float(dots[0].min()):.6f}, |v . v| min "
        f"{float(dots[1].min()):.6f} (atol 1e-3) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("(t) svd_init: the card disagrees with the CPU")
    return err


def phase_sgdparsvd(data: Data, dev="cuda") -> dict:
    """(t): the SVD init at (d)'s shape and k 64 timed on its own (CUDA
    synchronized) and checked on the card (orthonormal columns, descending
    singular values, |A v_1 - s_1 u_1| / s_1 of the leading, well-separated
    pair; the other dims' residuals logged) and against the CPU on a
    20,000-user slice; then train_model(mf_method="sgdparsvd") for 2 epochs
    with (d)'s Params: val RMSE falls from the SVD start; 4 batches on the
    card held against the CPU copy of the solver on the same batch order;
    epoch ms, idle share, peak memory and bound."""
    params = Params(**dict(CELLS["d"][1], max_iter=2))
    k = params.fac_dim
    mat = data.train_mat
    ms, runs = [], []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs.append(svd_init(mat, k, device=dev))
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
    u0, v0, sv = runs[0]
    same = all(np.array_equal(a, b) for a, b in zip(*runs))
    log(f"(t) svd_init twice on the card bit-identical {same} "
        f"{'ok' if same else 'FAIL'}")
    if not same:
        raise AssertionError("(t) two runs of svd_init differ")
    del runs
    rr = min(k + 8, mat.nrows, mat.ncols)
    bound = svd_bound(mat, rr, 6)
    # on the card: A v_j against s_j u_j
    ip, cols, vals = (torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                      for a in (mat.indptr, mat.indices, mat.values))
    rows = torch.repeat_interleave(torch.arange(mat.nrows, device=dev),
                                   ip[1:] - ip[:-1])
    U, V = torch.from_numpy(u0).to(dev), torch.from_numpy(v0).to(dev)
    av = torch.zeros(mat.nrows, k, device=dev).index_add_(
        0, rows, vals.float()[:, None] * V[cols.long()])
    s_t = torch.from_numpy(sv).to(dev)
    resid = ((av - U * s_t[None, :]).norm(dim=0) / s_t).cpu().numpy()
    ortho = float((U.t() @ U - torch.eye(k, device=dev)).abs().max())
    ok = (bool(np.all(np.diff(sv) <= 0)) and sv[-1] > 0 and ortho < 1e-4
          and float(resid[0]) < 1e-4)
    log(f"(t) svd_init at {mat.nrows} x {mat.ncols}, nnz {mat.nnz}, rank "
        f"{k} (+8 oversampled, 6 power iterations): {ms[0]:.1f} / "
        f"{ms[1]:.1f} ms (host clock, synchronized), bound {bound[0]:.3f} ms "
        f"({bound[1]}); singular values {sv[0]:.4f}, {sv[1]:.4f} .. "
        f"{sv[-1]:.4f}; |U^T U - I| max {ortho:.3e}; |A v_j - s_j u_j| / "
        f"s_j: dim 0 {float(resid[0]):.3e}, dims 1-7 max "
        f"{float(resid[1:8].max()):.3e}, all max {float(resid.max()):.3e} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("(t) the SVD init is wrong on the card")
    del ip, cols, vals, rows, U, V, av
    svd_err = _svd_vs_cpu(mat, k, dev)
    t0 = time.perf_counter()
    rep, model, ev, _ = train_model(data, params, mf_method="sgdparsvd",
                                    device=dev,
                                    log_fn=lambda s: log(f"(t) {s}"))
    wall = time.perf_counter() - t0
    solver = rep.solver
    assert isinstance(solver, SGDSolver) and solver.reg_vec is not None
    s0 = init_state(params, data.n_users, data.n_items, device=dev)
    s0 = s0._replace(u_fac=torch.from_numpy(u0).to(dev)[: data.n_users],
                     i_fac=torch.from_numpy(v0).to(dev)[: data.n_items])
    val0 = ev.rmse(model.eval_view(s0), "val")
    log(f"(t) sgdparsvd: train_model wall {wall:.1f} s (its own SVD init "
        f"included); per-dim reg {float(solver.reg_vec.min()):.5f} .. "
        f"{float(solver.reg_vec.max()):.5f}; objective_sing per epoch "
        f"{[h.objective for h in rep.history]!r}; epoch in the loop "
        f"{[round(1e3 * h.seconds, 3) for h in rep.history]} ms")
    _val_falls("t", "sgdparsvd", [h.val_rmse for h in rep.history], val0,
               rep.state)
    border = solver.batch_order()
    cpu = _cpu_copy(solver)
    st_c = cpu.epoch_with(_clone_state(rep.state, "cpu"),
                          params.learn_rate, border[:4])
    st_g = solver.epoch_with(rep.state, params.learn_rate, border[:4])
    for what, a, b in (("u", st_g.u_fac, st_c.u_fac),
                       ("i", st_g.i_fac, st_c.i_fac)):
        _held("t", f"sgdparsvd, 4 batches of {solver.batch_size}, {what}",
              a, b, SCATTER_TOL)
    del cpu, st_c, st_g
    _twice("t", "sgdparsvd", lambda: solver.epoch_with(
        rep.state, params.learn_rate, border))
    out = _time_epoch("t", "sgdparsvd (scatter SGD, per-dim reg)",
                      lambda: solver.epoch_with(rep.state, params.learn_rate,
                                                border), sgd_bound(solver))
    out.update(svd_ms=ms, svd_bound=bound, svd_err=svd_err, ratings_per_s=solver.nnz / float(
        np.mean(out["ms"])) * 1e3)
    del rep, solver, ev
    torch.cuda.empty_cache()
    return out


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


def _alternate(kernel, plain, reps: int = 1, warm: bool = True):
    """(kernel ms, plain ms), CUDA events over ``reps`` calls, in turns
    plain, kernel, kernel, plain, after one warm call of each (``warm``;
    a caller that has just run both passes False)."""
    if warm:
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
    k_ms, p_ms = _alternate(kernel, plain, warm=False)
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
# (n), (o): the long-tail models on densesgd; the scatter engine
# ----------------------------------------------------------------------

def phase_longtail_dense(data: Data, dev="cuda") -> dict:
    """(n): train_model(algo="tmf" and "tmfdropout", mf_method="densesgd")
    on (d)'s data, 2 epochs each, the masked stripe kernel on bf16 R + int8
    W; then "tmfdropout" on N_K128's half-star data, the masked codes
    instantiation at KP 128 with 2,560 users a stripe. Counts zeroed just
    before each run. Checks the launches, that the ranks are not trivial
    and val RMSE falls; replays one epoch with the solver's drawn order
    (and TMF+Dropout's round uniforms) through kernel and plain, times
    both. Returns the kernels-line numbers (launches of the three runs,
    the worst replay error; times and bound of the k 64 TMF+Dropout
    replay)."""
    out = {"launches": 0, "max_abs_err": 0.0}
    data_k128 = bench_data(**N_K128[0])
    runs = (("tmf", data, CELLS["d"][1], "bf16+W"),
            ("tmfdropout", data, CELLS["d"][1], "bf16+W"),
            ("tmfdropout", data_k128, N_K128[1], "codes"))
    for algo, data, params_kw, tiles in runs:
        params = Params(**dict(params_kw, max_iter=2))
        k = params.fac_dim
        tag = f"{algo} k {k}"
        drk.StripeTiles.launches = 0
        t0 = time.perf_counter()
        rep, model, ev, _ = train_model(data, params, algo=algo,
                                        mf_method="densesgd", device=dev,
                                        log_fn=lambda s: log(f"(n) {s}"))
        wall = time.perf_counter() - t0
        launches = drk.StripeTiles.launches
        solver = rep.solver
        assert isinstance(solver, BlockSGDSolver) and \
            solver.engine == "dense", "densesgd should not fall back here"
        st = solver.tiles
        if tiles == "codes":
            assert st.R.dtype == torch.int8 and st.W is None and \
                (solver.bu, solver.n_items_pad) == (2560, 26_752), \
                "N_K128 stages the cell's code tiles"
        else:
            assert (st.R.dtype, st.W.dtype) == (
                torch.bfloat16, torch.int8), "(d)'s data stages bf16 R + W"
        Lu, Li = st.ranks
        order, round_u = solver.draw_schedule()
        ranks = solver.epoch_ranks(round_u)
        q = ranks[2]
        log(f"(n) {tag}: staged NU={solver.NU} bu={solver.bu} ni_pad="
            f"{solver.n_items_pad}; {'lambdas' if round_u is not None else 'ranks'}"
            f" of users min {int(Lu.min())} median "
            f"{float(Lu.float().median())}, of items min {int(Li.min())} "
            f"median {float(Li.float().median())} (k={k}); rank of lambda "
            f"1 / {k // 2} / {k} over the replay's visits: "
            f"{q[:, 0].min().item()}-{q[:, 0].max().item()} / "
            f"{q[:, k // 2 - 1].min().item()}-{q[:, k // 2 - 1].max().item()}"
            f" / {q[:, -1].min().item()}-{q[:, -1].max().item()}; "
            f"hists {sum(h.nbytes for h in st.hists or ()) / 1e6:.1f} MB; "
            f"train_model wall {wall:.1f} s")
        assert min(int(Lu.min()), int(Li.min())) < k, "trivial ranks"
        epochs = len(rep.history)
        assert rep.stop_reason == "max_iter" and epochs == params.max_iter
        want = epochs * drk.epoch_launches(solver.NU, k, solver.mm_bf16)
        assert launches == want, f"kernel launches {launches} != {want}"
        s0 = init_state(params, data.n_users, data.n_items, device=dev)
        val0 = ev.rmse(model.eval_view(s0), "val")
        vals = [h.val_rmse for h in rep.history]
        log(f"(n) {tag}: val RMSE at init {val0!r}, per epoch {vals!r}; "
            f"epoch in the loop {[1e3 * h.seconds for h in rep.history]!r} "
            f"ms")
        assert all(np.isfinite(vals)) and rep.best_metric < val0, \
            (vals, val0)
        err, k_ms, p_ms = _check_and_time(f"n, {tag}", solver, s0,
                                          params.learn_rate, order=order,
                                          round_u=round_u)
        u3, i_tab = solver.stage_factors(s0)
        plain_tiles = drk.StripeTiles(
            st.R, st.W, st.r_scale, k, st.u_reg, st.i_reg,
            st.collision_norm, st.mm_bf16)
        run = lambda masked: (st if masked else plain_tiles).rows_epoch(
            u3.clone(), i_tab.clone(), order, params.learn_rate,
            round_u if masked else None)
        unmasked = _alternate(lambda: run(False), lambda: None)[0]
        names = ("u_bf16_kernel", "panel_kernel", "stripe_step_kernel")
        split = {tag: _kernel_ms(lambda: run(masked), names)
                 for tag, masked in (("masked", True), ("unmasked", False))}
        log(f"(n) {tag} device ms an epoch by kernel (torch.profiler): "
            + "; ".join(f"{tag} " + ", ".join(f"{nm} {ms:.3f}"
                                               for nm, ms in d.items())
                        for tag, d in split.items()))
        bound = stripe_bound(solver, ranks)
        lib_ms = stripe_library_ms(solver)
        log(f"(n) {tag} masked stripe epoch alone (CUDA events): kernel "
            f"{k_ms:.3f} ms = {solver.nnz / k_ms * 1e3:.4e} ratings/s "
            f"(the unmasked kernel on the same tiles {unmasked:.3f} ms); "
            f"plain PyTorch {p_ms:.3f} ms; bound {bound[0]:.3f} ms "
            f"({bound[1]}); the three products as bf16 cuBLAS calls "
            f"{lib_ms:.3f} ms")
        out["launches"] += launches
        out["max_abs_err"] = max(out["max_abs_err"], err)
        if algo == "tmfdropout" and k == CELLS["d"][1]["fac_dim"]:
            out.update(ms=k_ms, plain_ms=p_ms, bound_ms=bound[0],
                       bound_by=bound[1], library_ms=lib_ms)
        del rep, solver, ev, st, plain_tiles
        torch.cuda.empty_cache()
    del data_k128
    return out


def _device_kernels(fn):
    """(CUDA kernels launched, their summed device ms) in one call of fn,
    by torch.profiler, after one warm call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    return len(ev), sum(e.time_range.elapsed_us() for e in ev) / 1e3


@contextlib.contextmanager
def _eager_step(solver):
    """``solver``'s epochs through the eager step (``sgd_step_plain`` on
    the card, its scatters by the staged plans: the route before the fused
    step), as a yardstick."""
    solver.step.epoch = solver.step.epoch_plain
    try:
        yield
    finally:
        del solver.step.epoch


def phase_scatter(data: Data, dev="cuda") -> dict:
    """(o): train_model(data, params) -- the default mf_method, the scatter
    engine -- for algo "mf" and "tmfdropout" on (d)'s data, 2 epochs each:
    val RMSE falls; then one epoch alone from the initial state (CUDA
    events), its batches and the CUDA kernels it launches (torch.profiler;
    idle share = 1 - their device time / the epoch's); two runs of one
    epoch with the same batch order and masks must be bit-identical; and
    the epoch through the fused and the eager step (``_eager_step``)
    from one start, order and masks, the tables within 1e-5 of the
    largest entry, and timed in turns (fused, eager, eager, fused). The
    fused step's launches and the ordered scatter launches it reports are
    counted from 0 at each ``train_model`` call and must be one a batch an
    epoch and one a batch side (2, 4 with biases). Returns {"costs":
    {algo: (fused ms, eager ms)}, "launches": the fused steps of the two
    ``train_model`` calls, "scatters": the ordered scatter launches they
    made, "max_abs_err": the largest fused-eager gap}."""
    costs, launches, scatters, gaps = {}, 0, 0, []
    for algo in ("mf", "tmfdropout"):
        params = Params(**dict(CELLS["d"][1], max_iter=2))
        t0 = time.perf_counter()
        step_mod.SGDStep.launches = step_mod.SGDStep.scatter_launches = 0
        rep, model, ev, _ = train_model(data, params, algo=algo, device=dev,
                                        log_fn=lambda s: log(f"(o) {s}"))
        wall = time.perf_counter() - t0
        solver = rep.solver
        assert isinstance(solver, SGDSolver)
        n_step = step_mod.SGDStep.launches
        n_sc = step_mod.SGDStep.scatter_launches
        want = params.max_iter * solver.n_batches
        sides = 4 if model.use_bias else 2
        log(f"(o) {algo}: fused step launches in train_model {n_step} "
            f"(want {want}: one a batch an epoch), the ordered scatter "
            f"launches they reported {n_sc} (want {sides * want})")
        assert n_step == want, (n_step, want)
        assert n_sc == sides * want, (n_sc, sides * want)
        launches += n_step
        scatters += n_sc
        s0 = init_state(params, data.n_users, data.n_items, device=dev)
        val0 = ev.rmse(model.eval_view(s0), "val")
        vals = [h.val_rmse for h in rep.history]
        log(f"(o) {algo}: {solver.n_batches} batches of "
            f"{solver.batch_size} an epoch ({solver.nnz} ratings); val RMSE "
            f"at init {val0!r}, per epoch {vals!r}; epoch in the loop "
            f"{[1e3 * h.seconds for h in rep.history]!r} ms; train_model "
            f"wall {wall:.1f} s")
        assert all(np.isfinite(vals)) and rep.best_metric < val0, \
            (vals, val0)
        border = solver.batch_order()
        gen0 = solver._mask_gen.get_state()

        def epoch():
            solver._mask_gen.set_state(gen0)
            return solver.epoch_with(s0, params.learn_rate, border)

        epoch()
        torch.cuda.synchronize()
        ms = [_cuda_ms(epoch) for _ in range(2)]
        n_kern, dev_ms = _device_kernels(epoch)
        log(f"(o) {algo} scatter epoch alone (CUDA events): {ms!r} ms = "
            f"{solver.nnz / np.mean(ms) * 1e3:.4e} ratings/s; "
            f"{n_kern} CUDA kernels an epoch "
            f"({n_kern / solver.n_batches:.1f} a batch), device busy "
            f"{dev_ms:.3f} ms, idle share {1 - dev_ms / np.mean(ms):.3f}")
        _twice("o", f"{algo} (same order and masks)", epoch)
        got = epoch()
        with _eager_step(solver):
            want_st = epoch()
        torch.cuda.synchronize()
        gap = max(float((a.float() - b.float()).abs().max())
                  for a, b in zip(got, want_st) if a.numel())
        top = max(float(b.float().abs().max()) for b in want_st if b.numel())
        log(f"(o) {algo} one epoch, fused against eager from one start, "
            f"order and masks: largest table gap {gap:.3e} (largest entry "
            f"{top:.3e})")
        assert gap <= 1e-5 * max(top, 1.0), (gap, top)
        gaps.append(gap)
        del got, want_st
        fused, eager = [_cuda_ms(epoch)], []
        with _eager_step(solver):
            epoch()
            eager += [_cuda_ms(epoch) for _ in range(2)]
            n_e, dev_e = _device_kernels(epoch)
        fused.append(_cuda_ms(epoch))
        costs[algo] = (float(np.mean(fused)), float(np.mean(eager)))
        log(f"(o) {algo} fused and eager steps, in turns (CUDA events): "
            f"fused {fused!r} ms, eager {eager!r} ms (device busy "
            f"{dev_e:.3f} ms, {n_e} kernels), eager / fused "
            f"{costs[algo][1] / costs[algo][0]:.3f}")
        del rep, solver, ev
        torch.cuda.empty_cache()
    return {"costs": costs, "launches": launches, "scatters": scatters,
            "max_abs_err": max(gaps)}


# ----------------------------------------------------------------------
# (ss): the fused sgd step, csrc/sgd_step.cu, at the sgd cell's shape
# ----------------------------------------------------------------------

# the benchmark cell ml20m-mf-sgd: ML-20M's rated users and items, its
# 17.0M train ratings (1,038 batches of 16,384), k 64, lr 0.005, reg 0.002
SS_SHAPE = dict(n_users=138_493, n_items=26_744, n_ratings=17_000_000,
                law=0.8)
SS_PARAMS = dict(fac_dim=64, u_reg=0.002, i_reg=0.002, learn_rate=0.005,
                 seed=0, batch_size=16_384)
SS_EPOCHS = 3


def _ss_matrix(n_users, n_items, n_ratings, law, seed=0) -> RatingMatrix:
    """Half-star ratings, users uniform, items by a ``law`` power law (ids
    may repeat within a user: the step does not care)."""
    rng = np.random.default_rng(seed)
    w = 1.0 / np.arange(1, n_items + 1, dtype=np.float64) ** law
    users = np.sort(rng.integers(0, n_users, n_ratings))
    items = rng.choice(n_items, n_ratings, p=w / w.sum()).astype(np.int32)
    vals = (rng.integers(1, 11, n_ratings) * 0.5).astype(np.float32)
    indptr = np.concatenate([[0], np.cumsum(np.bincount(users,
                                                        minlength=n_users))])
    return RatingMatrix(indptr, items, vals, n_items)


def sgd_step_bound(solver, k: int, esize: int = 4) -> tuple:
    """A batch of the gradient kernel: each example's two table rows read
    and two scratch rows written once, its two int64 ids and its rating,
    valid flag and f32 weight read once."""
    return _bound(solver.batch_size * (4 * k * esize + 2 * 8 + 3 * 4),
                  0.0, "f32")


def phase_sgd_step(dev="cuda") -> dict:
    """(ss): the fused step at the sgd cell's shape (``SS_SHAPE``,
    ``SS_PARAMS``): one epoch's launches; its gradient kernel's and
    scatters' device ms (torch.profiler) a batch beside the bytes bound;
    the epoch's ms through the fused and the eager step in turns (CUDA
    events) and each one's host us a batch (enqueue without a sync); two
    runs of an epoch bit-identical; then ``SS_EPOCHS`` epochs from one
    start through each route, same orders: the largest gap of the tables.
    Returns the kernels-table numbers."""
    t0 = time.perf_counter()
    mat = _ss_matrix(**SS_SHAPE)
    params = Params(**SS_PARAMS)
    nu, ni = SS_SHAPE["n_users"], SS_SHAPE["n_items"]
    none = np.zeros(nu, bool), np.zeros(ni, bool)
    solver = SGDSolver(ModelMF(params, nu, ni), params, mat, *none,
                       device=dev)
    k, lr, nb = params.fac_dim, params.learn_rate, solver.n_batches
    s0 = init_state(params, nu, ni, device=dev)
    border = solver.batch_order()
    epoch = lambda: solver.epoch_with(s0, lr, border)
    log(f"(ss) {nb} batches of {solver.batch_size} over {nu:,} x {ni:,}, "
        f"k {k}, staged in {time.perf_counter() - t0:.1f} s")
    n0, s0_sc = step_mod.SGDStep.launches, step_mod.SGDStep.scatter_launches
    epoch()
    torch.cuda.synchronize()
    n_step = step_mod.SGDStep.launches - n0
    n_sc = step_mod.SGDStep.scatter_launches - s0_sc
    log(f"(ss) one epoch: {n_step} fused steps, {n_sc} ordered scatters")
    assert (n_step, n_sc) == (nb, 2 * nb), (n_step, n_sc, nb)
    _twice("ss", "fused step", epoch)
    dev_ms = {n: v / nb for n, v in _kernel_ms(
        epoch, ["sgd_grad_kernel", "ordered_scatter_kernel"]).items()}
    bound = sgd_step_bound(solver, k)

    def host_us(run):
        torch.cuda.synchronize()
        t = time.perf_counter()
        run()
        dt = time.perf_counter() - t
        torch.cuda.synchronize()
        return dt / nb * 1e6

    fused, eager = [_cuda_ms(epoch)], []
    host = {"fused": [host_us(epoch)], "eager": []}
    with _eager_step(solver):
        epoch()
        eager += [_cuda_ms(epoch) for _ in range(2)]
        host["eager"].append(host_us(epoch))
        eager_dev = _kernel_ms(epoch, ["elementwise", "gather", "reduce",
                                       "ordered_scatter_kernel"])
    fused.append(_cuda_ms(epoch))
    host["fused"].append(host_us(epoch))
    log(f"(ss) device ms a batch: gradient kernel "
        f"{dev_ms['sgd_grad_kernel']:.5f} (bound {bound[0]:.5f}, "
        f"{bound[1]}: {bound[0] / dev_ms['sgd_grad_kernel']:.1%}), "
        f"scatters {dev_ms['ordered_scatter_kernel']:.5f}; the eager "
        f"step's by kernel family an epoch {eager_dev!r} ms")
    log(f"(ss) an epoch in turns (CUDA events): fused {fused!r} ms, eager "
        f"{eager!r} ms; host us a batch {host!r}; "
        f"{solver.nnz / np.mean(fused) * 1e3:.4e} ratings/s fused")
    orders = [solver.batch_order() for _ in range(SS_EPOCHS)]

    def run():
        st = s0
        for o in orders:
            st = solver.epoch_with(st, lr, o)
        return st

    got = run()
    with _eager_step(solver):
        want = run()
    torch.cuda.synchronize()
    gap = max(float((a.float() - b.float()).abs().max())
              for a, b in zip(got, want) if a.numel())
    top = max(float(b.float().abs().max()) for b in want if b.numel())
    log(f"(ss) after {SS_EPOCHS} epochs, fused against eager from one start "
        f"and one order: largest table gap {gap:.3e} (largest entry "
        f"{top:.3e})")
    assert gap <= 1e-5 * max(top, 1.0), gap
    del solver, got, want
    torch.cuda.empty_cache()
    return dict(max_abs_err=gap,
                ms=dev_ms["sgd_grad_kernel"],
                step_ms=float(np.mean(fused)) / nb,
                plain_ms=float(np.mean(eager)) / nb, bound_ms=bound[0],
                bound_by=bound[1])


# ----------------------------------------------------------------------
# (os): the ordered scatter kernel, csrc/ordered_scatter.cu
# ----------------------------------------------------------------------

# (tag, table rows, ids a call, k, item power law or None for uniform):
# the sgd cell's two sides (ML-20M, batches of 16,384 at k 64; items by
# the benchmark's 0.8 power law) and BPR's item side (ML-10M's 10,677
# items, [positives; negatives] of a 65,536 batch, the same law)
OS_CASES = (("sgd users", 138_493, 16_384, 64, None),
            ("sgd items", 26_744, 16_384, 64, 0.8),
            ("bpr items", 10_677, 131_072, 64, 0.8))
OS_CALLS = 200   # calls a timing


def _os_index(n_rows: int, n: int, law, gen: torch.Generator, dev):
    if law is None:
        return torch.randint(0, n_rows, (n,), generator=gen, device=dev)
    w = 1.0 / torch.arange(1, n_rows + 1, device=dev,
                           dtype=torch.float64) ** law
    return torch.multinomial(w, n, replacement=True, generator=gen)


def _host_us(fn, calls: int) -> float:
    """Host microseconds a call of ``fn`` (no sync inside the loop)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / calls * 1e6


def phase_ordered_scatter(dev="cuda") -> dict:
    """(os): the kernel of ``ops/scatter.index_add_ordered_`` at the
    benchmark's shapes, f32 tables: bit for bit against
    ``index_put_(accumulate=True)`` and the plain version with a staged
    plan and one made per call (bf16 too); then, in turns on one table,
    the device ms a call (torch.profiler: its kernels' time, the sort's
    included) of the kernel (staged plan; plan made per call) and of
    ``index_put_``, the plain version's ms, and the host us a call of
    each of the three (each enqueued alone, no sync);
    the bytes bound (each source row read once, each touched table row
    read and written once, the int32 plan read once). Returns {case:
    its numbers}."""
    gen = torch.Generator(device=dev).manual_seed(20)
    out = {}
    for tag, n_rows, n, k, law in OS_CASES:
        index = _os_index(n_rows, n, law, gen, dev)
        hot = int(torch.bincount(index).max())
        staged = osc_mod.stage_plans(index.view(1, -1), n_rows)[0]
        err = 0.0
        for dtype in (torch.float32, torch.bfloat16):
            table = (torch.randn(n_rows, k, generator=gen, device=dev)
                     * 0.1).to(dtype)
            src = (torch.randn(n, k, generator=gen, device=dev)
                   * 1e-3).to(dtype)
            want = table.clone()
            want.index_put_((index,), src, accumulate=True)
            got = [osc_mod.index_add_ordered_(table.clone(), 0, index,
                                              src, p)
                   for p in (staged, None)]
            plain = osc_mod.ordered_scatter_plain(
                table.clone(), 0, src, osc_mod.plan_ordered(index))
            torch.cuda.synchronize()
            for g in got + [plain]:
                assert torch.equal(g, want), (tag, dtype)
            err = max(err, float((got[0].float() - plain.float()).abs()
                                 .max()))
        table = torch.randn(n_rows, k, generator=gen, device=dev) * 0.1
        src = torch.randn(n, k, generator=gen, device=dev) * 1e-3
        runs = {
            "kernel, staged plan": lambda: osc_mod.index_add_ordered_(
                table, 0, index, src, staged),
            "kernel, plan per call": lambda: osc_mod.index_add_ordered_(
                table, 0, index, src),
            "index_put_": lambda: table.index_put_((index,), src,
                                                   accumulate=True),
        }
        ms = {name: [] for name in runs}
        for name in list(runs) + list(runs)[::-1]:
            # device time: back to back, the kernel outruns the host
            ms[name].append(_device_kernels(
                lambda: [runs[name]() for _ in range(OS_CALLS)])[1]
                / OS_CALLS)
        plain_ms = _cuda_ms(lambda: osc_mod.ordered_scatter_plain(
            table, 0, src, staged), 3)
        host = {name: _host_us(runs[name], OS_CALLS) for name in runs}
        touched = int(torch.unique(index).numel())
        nbytes = 4 * (n * k + 2 * touched * k) + 8 * n
        bound = _bound(nbytes, 0.0, "f32")
        card = {name: float(np.mean(v)) for name, v in ms.items()}
        log(f"(os) {tag}: {n:,} ids over {n_rows:,} rows ({touched:,} "
            f"touched, hottest {hot}), k {k}: bit for bit index_put_ and "
            f"plain (f32, bf16; staged and per-call plans); device ms a "
            f"call { {a: [round(x, 5) for x in v] for a, v in ms.items()} }; "
            f"plain {plain_ms:.3f} ms; bound {bound[0]:.5f} ms "
            f"({bound[1]}); host us a call {host!r}")
        out[tag] = dict(ms=card["kernel, staged plan"],
                        per_call_ms=card["kernel, plan per call"],
                        library_ms=card["index_put_"], plain_ms=plain_ms,
                        bound_ms=bound[0], bound_by=bound[1],
                        host_us=host, max_abs_err=err)
    return out


# ----------------------------------------------------------------------
# (u): the port's front door, python -m matfac_tpu_torch.cli, at (d)'s width
# ----------------------------------------------------------------------

# (d)'s Params as flags (bench.py's k 64, reg 0.01, seed 0); the val split
# is the probe matrix (--graphmat) of ModelIncrement
CLI_FLAGS = ["--facdim", "64", "--ureg", "0.01", "--ireg", "0.01", "--seed",
             "0"]
# (tag, flags) of each run, in order. Learn rates: the one-hot engine at
# (i)'s 0.005; the scatter engines at (o)'s 0.05; the stripe engine at 0.1
# for 4 epochs: it takes one collision-normalized step a user an epoch, so
# from the uniform(-0.01, 0.01) start (d)'s lr 0.05 moves val RMSE by
# ~1e-5 in 2 epochs and by 3% only at epoch 5, and the run is held to a
# relative drop of at least CLI_MIN_DROP;
# ModelIncrement's scatter sums colliding gradients with no collision
# normalization, and its hottest item takes ~89 of a 16,384 batch here
# (the same shares at a tenth of the users on the CPU), where lr 0.005
# diverged and rolled every entity back at the growth check and 0.002
# trained (val RMSE 3.264 -> 3.216 in 6 epochs, every entity grown); BPR
# at (r)'s lr 0.1, reg 0.001 and 65,536-pair batches.
CLI_RUNS = (
    ("mf_headwt auto", ["--algo", "mf_headwt", "--mf_method", "auto",
                        "--maxiter", "2", "--learnrate", "0.005"]),
    ("mf_headwt densesgd", ["--algo", "mf_headwt", "--mf_method",
                            "densesgd", "--maxiter", "4", "--learnrate",
                            "0.1"]),
    ("tmf_bias", ["--algo", "tmf_bias", "--maxiter", "2", "--learnrate",
                  "0.05"]),
    ("mf_loc", ["--algo", "mf_loc", "--maxiter", "2", "--learnrate",
                "0.05"]),
    ("dropoutmf_ordered", ["--algo", "dropoutmf_ordered", "--maxiter", "2",
                           "--learnrate", "0.05"]),
    ("mf_freq", ["--algo", "mf_freq", "--maxiter", "1", "--learnrate",
                 "0.05"]),
    ("increment", ["--algo", "increment", "--maxiter", "6", "--learnrate",
                   "0.002"]),
    ("bpr", ["--algo", "bpr", "--mf_method", "train", "--maxiter", "2",
             "--learnrate", "0.1", "--ureg", "0.001", "--ireg", "0.001",
             "--batchsize", "65536"]),
)
# the least relative drop of val RMSE, init to best, a run is held to
# beyond "improves"
CLI_MIN_DROP = {"mf_headwt densesgd": 0.01}
# the one run that writes its text checkpoints (a bias model's factors,
# biases and mu) and times them; the others pass an empty --prefix, which
# writes nothing (tests/test_torch_cli.py holds the files to JAX's)
CLI_CKPT_RUN = "tmf_bias"


class _Recorded:
    """Wraps the front door's train_model and each engine's epoch for one
    CLI run: what train_model was given and returned, each epoch's CUDA
    events, and the last epoch call (to replay it under the profiler)."""

    EPOCHS = ((SGDSolver, "epoch"), (BlockSGDSolver, "epoch"),
              (BPRSolver, "epoch"), (inc_mod, "increment_epoch"))
    SAVES = ("save_facs", "save_full", "save_state", "save_invalid")

    def __enter__(self):
        self.calls, self.events, self.last = [], [], None
        self.saves, self.save_s, self.depth = 0, 0.0, 0
        real = loop_mod.train_model

        def train(data, params, **kw):
            out = real(data, params, **kw)
            self.calls.append((data, params, kw, out))
            return out

        self.saved = [(loop_mod, "train_model", real)]
        loop_mod.train_model = train
        for owner, name in self.EPOCHS:
            fn = getattr(owner, name)
            self.saved.append((owner, name, fn))
            setattr(owner, name, self._timed(fn))
        for name in self.SAVES:
            fn = getattr(ckpt_mod, name)
            self.saved.append((ckpt_mod, name, fn))
            setattr(ckpt_mod, name, self._host_timed(fn))
        return self

    def _host_timed(self, fn):
        # outermost calls only: save_full calls save_facs
        def call(*args, **kw):
            t0 = time.perf_counter()
            self.depth += 1
            out = fn(*args, **kw)
            self.depth -= 1
            if not self.depth:
                self.saves += 1
                self.save_s += time.perf_counter() - t0
            return out
        return call

    def _timed(self, fn):
        def call(*args, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kw)
            end.record()
            self.events.append((start, end))
            self.last = lambda: fn(*args, **kw)
            return out
        return call

    def __exit__(self, *exc):
        for owner, name, fn in self.saved:
            setattr(owner, name, fn)

    def epoch_ms(self):
        torch.cuda.synchronize()
        return [s.elapsed_time(e) for s, e in self.events]


def _cli_run(tag: str, argv: list) -> dict:
    """One in-process ``cli.main(argv)`` with the kernel counts zeroed just
    before and read just after; its printed lines logged. Returns what the
    run recorded, its counts, output, wall seconds, peak memory and its
    checkpoint writes (count, seconds)."""
    drk.StripeTiles.launches = 0
    tk.topk_catalog.launches = 0
    _zero_block_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with _Recorded() as rec, contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(stripe=drk.StripeTiles.launches,
                  topk=tk.topk_catalog.launches,
                  diag=bsk.block_sgd_diag_epoch.launches,
                  row=bsk.block_sgd_epoch.launches,
                  cell=sk.fused_cell_update.launches)
    out = buf.getvalue().splitlines()
    dump = set(cli.params_from_args(
        cli.build_parser().parse_args(argv)).display().splitlines())
    for line in out:
        if line.strip() and line not in dump:   # all but the Params dump
            log(f"(u) {tag} | {line}")
    assert rc == 0 and len(rec.calls) == 1, (rc, len(rec.calls))
    data, params, kw, (rep, model, ev, inval) = rec.calls[0]
    resolved = [s.split("'")[1] for s in out if "resolved to" in s]
    return dict(data=data, params=params, rep=rep, model=model, ev=ev,
                inval=inval, counts=counts, out=out, wall=wall,
                peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                epoch_ms=rec.epoch_ms(), replay=rec.last,
                resolved=resolved[0] if resolved else None,
                saves=(rec.saves, rec.save_s))


def _read_back(prefix: str, params: Params, model, ev, rep, dev) -> None:
    """(u), the read half: CLI_CKPT_RUN's text checkpoint (factors,
    biases and mu) read back with load_full onto the card: the biases and
    mu equal the values in the files, those are the best state's to the
    text's 7 digits, and the reloaded model's val RMSE is within 1e-5 of
    the run's best."""
    n, m = model.n_users, model.n_items
    sig = ckpt_mod.model_signature(params, n, m)
    t0 = time.perf_counter()
    st = ckpt_mod.load_full(init_state(params, n, m, device=dev), prefix,
                            sig)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    assert st is not None and all(t.device.type == torch.device(dev).type
                                  for t in st)
    files = [mfio.read_vector(f).astype(np.float32)
             for f in ckpt_mod.bias_paths(prefix, sig)]
    got = [t.detach().cpu().numpy().reshape(-1)
           for t in (st.u_bias, st.i_bias, st.mu)]
    same = all(np.array_equal(g, f) for g, f in zip(got, files))
    best = [t.detach().cpu().numpy().reshape(-1)
            for t in (rep.best_state.u_bias, rep.best_state.i_bias,
                      rep.best_state.mu)]
    digits = all(np.allclose(f, b, rtol=1e-6, atol=1e-30)
                 for f, b in zip(files, best))
    val = ev.rmse(model.eval_view(st), "val")
    ok = same and digits and abs(val - rep.best_metric) <= 1e-5
    log(f"(u) {CLI_CKPT_RUN}: load_full of its text checkpoint onto the "
        f"card in {load_s:.2f} s: biases and mu equal the files' values "
        f"{same}, the best state's to 7 digits {digits}; val RMSE reloaded "
        f"{val!r} vs best {rep.best_metric!r} (|diff| "
        f"{abs(val - rep.best_metric):.2e} <= 1e-5) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"(u) {CLI_CKPT_RUN}'s checkpoint did not read "
                             "back")


def _bin_round_trip(best, params: Params, dev) -> None:
    """(u), the read half: (d)'s best factors through save_bin_facs /
    load_bin_facs (the reference's float64 binaries), bit for bit."""
    n, m = best.u_fac.shape[0], best.i_fac.shape[0]
    d = os.path.join(RUN_DIR, "bin")
    os.makedirs(d, exist_ok=True)
    prefix = os.path.join(d, "d_best")
    sig = ckpt_mod.model_signature(params, n, m)
    t0 = time.perf_counter()
    paths = ckpt_mod.save_bin_facs(best, prefix, sig)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = ckpt_mod.load_bin_facs(init_state(params, n, m, device=dev),
                                  prefix, sig)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    sizes = [os.path.getsize(f) for f in paths]
    ok = (back is not None
          and back.u_fac.device.type == torch.device(dev).type
          and torch.equal(back.u_fac, best.u_fac.float())
          and torch.equal(back.i_fac, best.i_fac.float())
          and sizes == [8 * n * params.fac_dim, 8 * m * params.fac_dim])
    log(f"(u) (d)'s best factors through save_bin_facs ({sizes} B in "
        f"{save_s:.2f} s) and load_bin_facs ({load_s:.2f} s) onto the card: "
        f"bit-identical {ok} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("(u) the binary factor round trip differs")
    for f in paths:
        os.remove(f)


def _parse_both(paths: dict) -> RatingMatrix:
    """(u)'s text read: each split through ``read_csr``, which must take
    the native parser (``utils/native.py``, csrc/native_host.cpp built with
    g++), then through the line parser, its fallback: the same arrays bit
    for bit; both times printed. Returns the train split."""
    taken, real = [], native.parse_csr_text

    def spy(path, with_values):
        out = real(path, with_values)
        taken.append(out is not None)
        return out
    back = None
    for name, path in paths.items():
        native.parse_csr_text = spy
        try:
            t0 = time.perf_counter()
            mat = mfio.read_csr(path)
            native_s = time.perf_counter() - t0
        finally:
            native.parse_csr_text = real
        if taken != [True]:
            raise AssertionError(f"(u) read_csr {name}: the native parser "
                                 f"was not taken ({taken})")
        taken.clear()
        t0 = time.perf_counter()
        indptr, cols, vals = mfio._parse_lines(path, True)
        line_s = time.perf_counter() - t0
        same = (np.array_equal(indptr, mat.indptr)
                and np.array_equal(cols.astype(np.int32), mat.indices)
                and np.array_equal(vals.astype(np.float32), mat.values))
        log(f"(u) read_csr {name} ({os.path.getsize(path) / 1e6:.1f} MB, "
            f"{mat.nnz} ratings): native parser {native_s:.3f} s, line "
            f"parser {line_s:.3f} s; arrays bit for bit equal {same}")
        if not same:
            raise AssertionError(f"(u) {name}: the native parser's arrays "
                                 "differ from the line parser's")
        back = mat if name == "train" else back
    return back


def phase_cli(data: Data, dev="cuda", best_d=None) -> dict:
    """(u): (d)'s splits written once through the port's write_csr (the val
    split also as --graphmat), then ``cli.main`` in process for each of
    CLI_RUNS: the stripe kernel (mf_headwt densesgd, bf16 W of 0.8 ->
    0.80078125), the one-hot kernel (mf_headwt auto -> blocksgd), the
    scatter engine's othersrc models, the mf_freq curriculum (5 stages of
    1 epoch), ModelIncrement (6 epochs, a growth check at epoch 5) and BPR
    (the top-N kernel, fused for val and test HR@10, radix for test ARHR).
    Per run: the report's lines, epoch ms (CUDA events), the idle share of
    a replayed epoch (torch.profiler), peak memory, the resolved method,
    the val metric at init and at its best (must improve and be finite),
    the kernel launches against the plan; CLI_CKPT_RUN alone writes (and
    times) its checkpoints; then one stripe epoch, one
    one-hot epoch and one top-N pass of these runs held against their
    plain versions; the read half: CLI_CKPT_RUN's checkpoint through
    load_full, and ``best_d`` = ((d)'s best state, its Params) through the
    binary factor files. Returns {kernel: (launches, max abs error)}."""
    t_phase = time.perf_counter()
    if best_d is not None:
        _bin_round_trip(*best_d, dev)
    d = os.path.join(RUN_DIR, "cli")
    os.makedirs(d, exist_ok=True)
    paths = {}
    for name, mat in (("train", data.train_mat), ("test", data.test_mat),
                      ("val", data.val_mat)):
        paths[name] = os.path.join(d, f"{name}.csr")
        t0 = time.perf_counter()
        mfio.write_csr(mat, paths[name])
        log(f"(u) write_csr {name}: {mat.nnz} ratings, "
            f"{os.path.getsize(paths[name]) / 1e6:.1f} MB in "
            f"{time.perf_counter() - t0:.2f} s")
    back = _parse_both(paths)
    # "%g" keeps 6 significant digits: a relative error up to 5e-6
    same = (np.array_equal(back.indptr, data.train_mat.indptr)
            and np.array_equal(back.indices, data.train_mat.indices)
            and np.allclose(back.values, data.train_mat.values, rtol=1e-5,
                            atol=0))
    log(f"(u) read_csr train: the same matrix as written (values to the "
        f"text's 6 digits) {same}")
    assert same, "read_csr did not read back what write_csr wrote"
    files = ["--trainmat", paths["train"], "--testmat", paths["test"],
             "--valmat", paths["val"], "--graphmat", paths["val"]]
    out = {"stripe": [0, 0.0], "diag": [0, 0.0], "fused": [0, 0.0],
           "radix": [0, 0.0]}
    for tag, flags in CLI_RUNS:
        prefix = (os.path.join(d, tag.replace(" ", "_"))
                  if tag == CLI_CKPT_RUN else "")
        argv = files + CLI_FLAGS + flags + ["--prefix", prefix]
        r = _cli_run(tag, argv)
        rep, model, ev, params, c = (r["rep"], r["model"], r["ev"],
                                     r["params"], r["counts"])
        cd = r["data"]
        solver = rep.solver
        n, m = cd.n_users, cd.n_items
        s0 = init_state(params, n, m, device=dev)
        ranking = getattr(model, "is_ranking", False)
        if ranking:
            before = ev.hit_rate(model.eval_view(s0), cd.val_mat, 10)
            improved = rep.best_metric > before
        else:
            m0 = (inc_mod.ModelIncrement(params, n, m) if tag == "increment"
                  else model)
            before = ev.rmse(m0.eval_view(m0.transform_init_state(s0)),
                             "val")
            improved = rep.best_metric < before * (
                1 - CLI_MIN_DROP.get(tag, 0.0))
        ok = improved and np.isfinite(rep.best_metric)
        ms = r["epoch_ms"]
        rep_ms = _cuda_ms(r["replay"])
        busy, top = _device_profile(r["replay"])
        idle = (f"{1 - busy / rep_ms:.3f}" if busy else
                "not measured (no device event in the trace)")
        log(f"(u) {tag}: {type(solver).__name__ if solver else 'no solver'}"
            f"{' (auto -> ' + r['resolved'] + ')' if r['resolved'] else ''}"
            f"; {len(ms)} epochs, epoch ms (CUDA events) "
            f"{[round(x, 3) for x in ms]}; a replayed epoch {rep_ms:.3f} ms, "
            f"device busy {busy:.3f} ms, idle share {idle}"
            f"; peak memory {r['peak_gb']:.2f} GB; cli.main wall "
            f"{r['wall']:.1f} s, {r['saves'][0]} checkpoint writes in "
            f"{r['saves'][1]:.2f} s; launches {c}; val "
            f"{'HR@10' if ranking else 'RMSE'} at init {before!r}, best "
            f"{rep.best_metric!r} (epoch {rep.best_iter}) "
            f"{'ok' if ok else 'FAIL'}; top device ops {top}")
        if not ok:
            raise AssertionError(f"(u) {tag}: the val metric did not "
                                 "improve (by CLI_MIN_DROP) or is not "
                                 "finite")
        assert (r["saves"][0] > 0) == (tag == CLI_CKPT_RUN), r["saves"]
        if tag == CLI_CKPT_RUN:
            _read_back(prefix, params, model, ev, rep, dev)
        assert any(s.startswith("stop: ") for s in r["out"]), r["out"]
        for t in (rep.best_state.u_fac, rep.best_state.i_fac):
            assert bool(torch.isfinite(t).all())
        if tag == "mf_headwt auto":
            assert r["resolved"] == "blocksgd" and isinstance(
                solver, BlockSGDSolver) and solver.schedule == "diag"
            assert (c["diag"], c["row"], c["cell"], c["stripe"]) == \
                (params.max_iter, 0, 0, 0), c
            sched = bsk.diag_schedule(torch.Generator().manual_seed(1),
                                      solver.NU, solver.NI,
                                      solver.S // solver.bs)
            err, k_ms, p_ms = _replay("u", solver, s0, params.learn_rate,
                                      sched)
            log(f"(u) {tag}: one-hot diag epoch (float weights) kernel "
                f"{k_ms:.3f} ms, plain {p_ms:.3f} ms")
            out["diag"] = [c["diag"], err]
        elif tag == "mf_headwt densesgd":
            W = solver.tiles.W
            assert solver.engine == "dense" and W.dtype == torch.bfloat16, \
                W.dtype
            w = torch.unique(W[0]).float().tolist()
            log(f"(u) {tag}: bf16 R {solver.tiles.R.dtype}, weights of "
                f"stripe 0 {w}")
            assert 0.80078125 in w and 1.0 in w, w
            want = params.max_iter * drk.epoch_launches(
                solver.NU, params.fac_dim, solver.mm_bf16)
            assert c["stripe"] == want and c["diag"] == 0, (c, want)
            err, k_ms, p_ms = _check_and_time("u", solver, s0,
                                              params.learn_rate)
            log(f"(u) {tag}: stripe epoch (bf16 W) kernel {k_ms:.3f} ms, "
                f"plain {p_ms:.3f} ms")
            out["stripe"] = [c["stripe"], err]
        elif ranking:
            p10 = tk.pass_launches(n, m, 10)
            p1k = tk.pass_launches(n, m, 1000)
            # val HR@10 at init and after each epoch, test HR@10: fused;
            # test ARHR: radix
            assert tk.fused_plan(n, m, 10)["route"] == "fused" and \
                tk.fused_plan(n, m, 1000)["route"] == "radix"
            want = (params.max_iter + 2) * p10 + p1k
            assert c["topk"] == want, (c, want)
            view = model.eval_view(rep.best_state)
            args = dict(u_fac=view.u_fac, i_fac=view.i_fac,
                        i_bias=view.i_bias, u_bias=view.u_bias, mu=view.mu,
                        invalid=ev.invalid_items_dev, indptr=ev.indptr,
                        indices=ev.indices, users=ev._all_users)
            errs = []
            for nn in (10, 1000):
                ok_n, e_n, held = topk_agree(tk.topk_catalog(**args, n=nn),
                                             tk.topk_plain(**args, n=nn),
                                             False)
                log(f"(u) {tag}: top-{nn} of all {n} users on the best "
                    f"view, kernel vs plain: max_abs {e_n:.3e}, ids held "
                    f"at {held:.4f} of slots {'ok' if ok_n else 'FAIL'}")
                if not ok_n:
                    raise AssertionError(f"(u) top-{nn} kernel vs plain")
                errs.append(e_n)
            tk.topk_catalog.launches = 0
            report = quartile_ranking_report(view, cd, ev, *r["inval"])
            for line in report.splitlines():
                log(f"(u) {tag} quartile_ranking_report | {line}")
            assert tk.topk_catalog.launches == p10 + p1k
            out["fused"] = [(params.max_iter + 2) * p10, errs[0]]
            out["radix"] = [p1k, errs[1]]
        else:
            assert c["stripe"] == c["diag"] == c["topk"] == 0, c
        if tag == "mf_freq":
            stages = [s for s in r["out"] if "mf_freq stage" in s]
            assert len(stages) == 5 and len(rep.history) == 5, stages
        if tag == "increment":
            inc = rep.increment
            assert [h[0] for h in inc.history] == [5], inc.history
            log(f"(u) increment: growth {inc.history}, ranks users "
                f"{np.bincount(inc.rank_u).nonzero()[0].tolist()} items "
                f"{np.bincount(inc.rank_i).nonzero()[0].tolist()}")
        if tag == "dropoutmf_ordered":
            assert tuple(model.eval_view(s0).u_fac.shape) == (n, 128)
        if tag == "increment":
            _twice("u", tag, r["replay"])
        if tag == "tmf_bias":
            assert isinstance(solver, SGDSolver)
            border = solver.batch_order()
            gen0 = solver._mask_gen.get_state()

            def again():
                solver._mask_gen.set_state(gen0)
                return solver.epoch_with(rep.state, params.learn_rate,
                                         border)

            _twice("u", tag, again)
        del r, rep, model, ev, solver
        torch.cuda.empty_cache()
    log(f"(u) phase {time.perf_counter() - t_phase:.1f} s")
    return out


# ----------------------------------------------------------------------
# (v): analyze mode, python -m matfac_tpu_torch.cli --mode analyze, at (d)
# ----------------------------------------------------------------------

# the analysis's card-against-CPU checks: float64 cosines rounded to
# float32; PPR's float32 power iteration (sums in another order); float32
# catalog products (card and CPU sum k = 64 terms in other orders: an
# error ~1e-6 in a score, 2 |d| 1e-6 in d^2, so d^2 is held to 1e-5 of the
# block's largest value besides rtol 1e-5); bucket RMSEs of one ordering
COS_RTOL = 1e-6
PPR_TOL = (1e-4, 1e-6)
SQ_ERR_RTOL = 1e-5
ANALYZE_ROWS, ANALYZE_PPR_USERS, ANALYZE_TOPN_USERS = 1024, 16, 256


class _Steps:
    """Host seconds of named calls inside one ``cli.main`` run, the device
    synchronized before and after each, with each call's arguments and
    result kept (the last call of a name)."""

    def __init__(self, targets):
        self.targets = targets           # [(name, owner, attribute)]

    def __enter__(self):
        self.seconds, self.last, self.saved = {}, {}, []
        for name, owner, attr in self.targets:
            fn = getattr(owner, attr)
            self.saved.append((owner, attr, fn))
            setattr(owner, attr, self._timed(name, fn))
        return self

    def _timed(self, name, fn):
        def call(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            self.seconds.setdefault(name, []).append(
                time.perf_counter() - t0)
            self.last[name] = (args, kw, out)
            return out
        return call

    def __exit__(self, *exc):
        for owner, attr, fn in reversed(self.saved):
            setattr(owner, attr, fn)


def _busy_idle(fn):
    """(CUDA-event ms of one call of fn, device busy ms of another by
    torch.profiler, idle share, the second call's result); fn is warm."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    ms = _cuda_ms(fn)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    busy = sum(e.time_range.elapsed_us() / 1e3 for e in prof.events()
               if e.device_type == DeviceType.CUDA)
    return ms, busy, 1.0 - busy / ms, out


def analysis_bounds(train, graph, n_users_ppr: int, iters: int, k: int):
    """Bounds of (v)'s device steps: the cosine graph (the two-hop walk's
    float64 products, sum over users of degree^2, at the FP64 tensor-core
    peak; both views of the train matrix read, the graph written once),
    one PPR call (iters steps of a multiply-add an edge a column, float32;
    the graph and restart read once, the iterate written once) and one
    catalog_sq_err block of n_users_ppr users (two [B, k] x [k, n_items]
    float32 products; the factors read once, d^2 written once)."""
    deg_u = train.row_degrees().astype(np.float64)
    n_items, nnz = train.ncols, train.nnz
    cos = _bound(2 * (12 * nnz + 8 * (train.nrows + n_items))
                 + 8 * graph.nnz, 2.0 * float((deg_u ** 2).sum()), "f64")
    ppr = _bound(12 * graph.nnz + 8 * n_items * n_users_ppr,
                 2.0 * iters * graph.nnz * n_users_ppr, "f32")
    sq = _bound(4 * k * 2 * (n_items + n_users_ppr)
                + 4 * n_users_ppr * n_items,
                4.0 * n_users_ppr * n_items * k, "f32")
    return dict(cosine=cos, ppr=ppr, sq_err=sq)


def _pad_cols(a: np.ndarray, k: int) -> np.ndarray:
    return np.pad(a, ((0, 0), (0, k - a.shape[1])))


def _finite_numbers(line: str):
    return [float(x) for x in re.findall(r"-?\d+\.\d+|nan|inf", line)]


def phase_analyze(data: Data, dev="cuda") -> dict:
    """(v): ``cli.main(["--mode", "analyze", ...])`` in process at (d)'s
    width on (u)'s text splits, the factors of (u)'s tmf_bias checkpoint
    (--initufac / --initifac) and the generator's k = 8 factors written
    zero-padded to k = 64 (the product unchanged) as --origufac /
    --origifac; no --graphmat, so the 50-neighbour cosine graph of the
    20,000 items is built on the card. Each step's host seconds (the
    device synchronized around it), the wall, peak memory, the idle share
    of the graph build and of PPR (replays, torch.profiler); the report's
    lines present and finite; then card against CPU through the port
    (device="cpu"): the graph's rows of ANALYZE_ROWS items, user_ppr of
    ANALYZE_PPR_USERS sampled users, one catalog_sq_err block, top_n_rec's
    ranks and per_user_bucket_rmses on ANALYZE_TOPN_USERS users; the card's
    user_ppr of the sample twice, bit-identical. Returns the bounds and
    times of the XLA-path rows."""
    from matfac_tpu_torch.analysis import confidence as conf_mod
    from matfac_tpu_torch.analysis import drivers as drv
    from matfac_tpu_torch.analysis import topn as topn_mod
    from matfac_tpu_torch.analysis.batch import catalog_sq_err
    from matfac_tpu_torch.analysis.top_bucket import sample_users
    from matfac_tpu_torch.ops import svd_init as svd_mod
    from matfac_tpu_torch.ops.ppr import PPREngine
    t_phase = time.perf_counter()
    d = os.path.join(RUN_DIR, "cli")
    (ufac,), (ifac,) = (glob.glob(os.path.join(d, f"{CLI_CKPT_RUN}_{s}_*"))
                        for s in ("uFac", "iFac"))
    k = 64
    t0 = time.perf_counter()
    truth = []
    for name, f in (("u", data.orig_u_fac), ("i", data.orig_i_fac)):
        truth.append(os.path.join(d, f"truth_{name}.mat"))
        mfio.write_factor_mat(_pad_cols(f, k), truth[-1])
    log(f"(v) ground truth (k {data.orig_u_fac.shape[1]} padded to {k}) "
        f"written in {time.perf_counter() - t0:.2f} s")
    argv = ["--trainmat", os.path.join(d, "train.csr"), "--testmat",
            os.path.join(d, "test.csr"), "--valmat",
            os.path.join(d, "val.csr"), "--mode", "analyze", "--facdim",
            str(k), "--svdfacdim", str(k), "--seed", "0", "--initufac", ufac,
            "--initifac", ifac, "--origufac", truth[0], "--origifac",
            truth[1], "--prefix", ""] + (["--cpu"] if dev == "cpu" else [])
    targets = [("read_csr", mfio, "read_csr"),
               ("read_factor_mat", mfio, "read_factor_mat"),
               ("Evaluator", Evaluator, "__init__"),
               ("fullLowRankErr", Evaluator, "full_low_rank_err"),
               ("svd_init", svd_mod, "svd_init"),
               ("graph", mfio, "item_cosine_sim"),
               ("ppr", PPREngine, "ppr"),
               ("freq_rmse_sweep", drv, "freq_rmse_sweep"),
               ("bucket curves", drv, "pred_samp_users_rmse"),
               ("analysis", drv, "sample_top_n_analysis"),
               ("ppr_vs_gpr", drv, "compare_ppr_gpr")]
    iters = []
    real_ppr = PPREngine.ppr

    def counted(self, *a, **kw):
        out = real_ppr(self, *a, **kw)
        iters.append(self.iterations)
        return out
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    buf = io.StringIO()
    PPREngine.ppr = counted
    try:
        with _Steps(targets) as steps, contextlib.redirect_stdout(buf):
            t0 = time.perf_counter()
            rc = cli.main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        PPREngine.ppr = real_ppr
    peak = torch.cuda.max_memory_allocated() / 1e9
    out = buf.getvalue().splitlines()
    report = out[next(i for i, line in enumerate(out)
                      if line.startswith("Loaded model")):]
    for line in report:
        log(f"(v) analyze | {line}")
    assert rc == 0
    heads = ("Loaded model: Train RMSE", "fullLowRankErr vs ground truth:",
             "Freq-RMSE sweep", "  top 10%", "  top 25%", "  top 50%",
             "  top 75%", "  top 100%", "Per-user bucket RMSE curves",
             "  freq:", "  svd:", "  ppr:", "PPR-vs-GPR top-100 mean")
    ok = (len(report) == len(heads)
          and all(a.startswith(h) for a, h in zip(report, heads))
          and all(np.isfinite(_finite_numbers(a)).all() for a in report)
          and all(len(_finite_numbers(a)) == 10 for a in report[9:12]))
    log(f"(v) the report's {len(report)} lines present and finite "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("(v) analyze mode's report")
    sec = {name: (len(v), sum(v)) for name, v in steps.seconds.items()}
    (n_ppr, ppr_s) = sec["ppr"]
    log(f"(v) cli.main wall {wall:.2f} s, peak memory {peak:.2f} GB; host "
        f"seconds by step (count, s; the device synchronized around each): "
        + ", ".join(f"{n} ({c}, {t:.3f})" for n, (c, t) in sec.items())
        + f"; PPR iterations by call {iters}")

    # the card's objects of the run
    args, _, _ = steps.last["analysis"]
    full, orig, ev, cd, inval_u, inval_i = args[:6]
    eng = steps.last["analysis"][1]["ppr_engine"]
    train = cd.train_mat
    (gargs, gkw, graph) = steps.last["graph"]
    assert gkw.get("device") == dev and eng.device.type == dev
    users = sample_users(inval_u, train.nrows, min(200, cd.n_users), 0)

    # idle shares of the graph build and of PPR; PPR twice, bit-identical
    g_ms, g_busy, g_idle, _ = _busy_idle(
        lambda: mfio.item_cosine_sim(train, top_k=50, device=dev))
    p_ms, p_busy, p_idle, pr1 = _busy_idle(
        lambda: eng.user_ppr(train, users))
    pr2 = eng.user_ppr(train, users)
    same = np.array_equal(pr1, pr2)
    log(f"(v) graph build: {graph.nnz} edges, {g_ms:.3f} ms (CUDA events), "
        f"device busy {g_busy:.3f} ms, idle share {g_idle:.3f}; user_ppr "
        f"of {len(users)} users: {eng.iterations} iterations, {p_ms:.3f} "
        f"ms, busy {p_busy:.3f} ms, idle share {p_idle:.3f}; two runs "
        f"bit-identical {same} {'ok' if same else 'FAIL'}")
    if not same:
        raise AssertionError("(v) two runs of user_ppr differ")

    # card against CPU, through the port with device="cpu"
    rows = np.unique(np.linspace(0, train.ncols - 1, ANALYZE_ROWS).astype(
        np.int64))
    t0 = time.perf_counter()
    r, c, v = mfio.cosine_topk_rows(train, rows, top_k=50, device="cpu")
    cpu_s = time.perf_counter() - t0
    bad = 0
    err = 0.0
    for i in rows:
        gc, gv = graph.row(int(i))
        order = np.argsort(c[r == i], kind="stable")
        wc, wv = c[r == i][order], v[r == i][order]
        if not np.array_equal(gc, wc):
            bad += 1
            continue
        err = max(err, float(np.max(np.abs(gv - wv) / wv, initial=0.0)))
    ok = bad == 0 and err <= COS_RTOL
    log(f"(v) item_cosine_sim, {len(rows)} rows, card vs CPU ({cpu_s:.1f}"
        f" s): rows with other edges {bad}, max rel err {err:.3e} (rtol "
        f"{COS_RTOL}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("(v) the card's cosine graph vs the CPU's")
    cpu_eng = PPREngine(graph, device="cpu")
    few = users[:ANALYZE_PPR_USERS]
    _held("v", f"user_ppr of {len(few)} sampled users",
          torch.from_numpy(eng.user_ppr(train, few)),
          torch.from_numpy(cpu_eng.user_ppr(train, few)), PPR_TOL)
    cpu_view = lambda vw: type(vw)(*(t.cpu() for t in vw))
    full_c, orig_c = cpu_view(full), cpu_view(orig)
    (_, d2), = catalog_sq_err(orig, full, users, block=len(users))
    (_, d2c), = catalog_sq_err(orig_c, full_c, users, block=len(users))
    _held("v", f"catalog_sq_err block [{len(users)}, {train.ncols}]",
          torch.from_numpy(d2), torch.from_numpy(d2c),
          (SQ_ERR_RTOL, SQ_ERR_RTOL * float(np.abs(d2c).max())))
    rank_args = lambda vw: (vw, train, cd.test_mat, inval_u, inval_i, 0.5,
                            ANALYZE_TOPN_USERS, 1000, 0, None, None)
    (ranks, head), (ranks_c, head_c) = (topn_mod._topn_ranks(*rank_args(vw))
                                        for vw in (full, full_c))
    moved = ranks["model"] != ranks_c["model"]
    steps_moved = np.abs(ranks["model"] - ranks_c["model"])[moved]
    rep = topn_mod._report(ranks, head, 10)
    rep_c = topn_mod._report(ranks_c, head_c, 10)
    diff = abs(rep.recall["model"] - rep_c.recall["model"]) * len(head)
    ok = (np.array_equal(head, head_c) and moved.mean() <= 1e-3
          and (steps_moved <= 1).all() and diff <= moved.sum())
    log(f"(v) top_n_rec of {ANALYZE_TOPN_USERS} users ({len(head)} test "
        f"items, 1000 negatives each), card vs CPU: recall@10 {rep.recall} "
        f"vs {rep_c.recall}; test-item ranks moved by a near-tie "
        f"{int(moved.sum())} (at most 1 position each, at most 0.1%) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("(v) top_n_rec card vs CPU")
    some = users[:ANALYZE_TOPN_USERS]
    scores = eng.user_ppr(train, some)[:, :cd.n_items]
    mask = ~inval_i[:cd.n_items]
    got = conf_mod.per_user_bucket_rmses(orig, full, scores, some, mask)
    want = conf_mod.per_user_bucket_rmses(orig_c, full_c, scores, some,
                                          mask)
    _held("v", "per_user_bucket_rmses (PPR ordering)",
          torch.from_numpy(got[0]), torch.from_numpy(want[0]),
          (SQ_ERR_RTOL, 0.0))
    assert np.array_equal(got[1], want[1])

    b = analysis_bounds(train, graph, len(users), eng.iterations, k)
    # the host loop's card yardstick: the d^2 block and three score rows
    # per user read once (sorting is comparisons, not counted)
    host_bound = _bound(4 * 4 * len(users) * train.ncols, 0.0, "f32")
    lap_ms = lambda name: 1e3 * sec[name][1] / sec[name][0]
    out = dict(
        graph=(lap_ms("graph"), b["cosine"], 1),
        ppr=(1e3 * steps.seconds["ppr"][0], b["ppr"], n_ppr),
        sq_err=(_cuda_ms(lambda: next(catalog_sq_err(
            orig, full, users, block=len(users)))), b["sq_err"], 1),
        curves=(lap_ms("bucket curves"), host_bound, 1))
    log(f"(v) XLA-path rows (ms, bound ms and what bounds it, main-path "
        f"calls): {out}")
    log(f"(v) phase {time.perf_counter() - t_phase:.1f} s")
    return out


# ----------------------------------------------------------------------
# (p), (q): the coordinate family, plain PyTorch (no hand kernel)
# ----------------------------------------------------------------------

# bench.py:53-54's Params (fac_dim 64, reg 0.01) on (d)'s data
COORD_PARAMS = dict(fac_dim=64, u_reg=0.01, i_reg=0.01, learn_rate=0.005,
                    seed=0, obj_iter=1, disp_iter=1)
# card vs CPU: the CPU parity tests' multi-epoch class, JAX's
# engine-to-engine 2e-3 (tests/test_torch_ccd.py, test_torch_train.py).
# At k = 64 and reg 0.01 a row with fewer than 64 ratings has a Gram of
# rank < k plus 0.01 I, so f32 summation-order noise (cuBLAS / cuSOLVER
# against MKL / LAPACK) grows by its condition number: 2.3e-4 in one chunk
# of exact ALS (H100 80GB HBM3, 700 W); the int8 Grams' quantization
# flips on such noise. bf16 dense Grams at their 5e-3 class.
COORD_TOL = (2e-3, 2e-3)
BF16_TOL = (5e-3, 5e-3)


def _device_profile(fn, top: int = 3):
    """(device busy ms, [(op, ms)] of the ``top`` device ops by summed time)
    in one call of fn, by torch.profiler, after one warm call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by[e.name] = by.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    ranked = sorted(by.items(), key=lambda kv: -kv[1])
    return sum(by.values()), [(n[:60], round(ms, 3)) for n, ms in
                              ranked[:top]]


def _held(tag: str, what: str, got, want, tol) -> float:
    """Max abs error of card vs CPU tensors; raises past rtol / atol."""
    got, want = got.float().cpu(), want.float().cpu()
    err = float((got - want).abs().max())
    ok = bool(torch.isfinite(got).all()) and torch.allclose(
        got, want, rtol=tol[0], atol=tol[1])
    log(f"({tag}) {what}: card vs CPU max_abs {err:.3e} (rtol {tol[0]}, "
        f"atol {tol[1]}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"({tag}) {what}: the card disagrees with the "
                             "CPU")
    return err


def _time_epoch(tag: str, name: str, epoch, bound) -> dict:
    """Epoch ms (CUDA events, two timings after the runs before), peak
    device memory of an epoch, device busy ms, idle share and top three
    device ops (torch.profiler), beside the bound."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = [_cuda_ms(epoch) for _ in range(2)]
    peak = torch.cuda.max_memory_allocated()
    busy, top = _device_profile(epoch)
    out = dict(ms=ms, busy=busy, idle=1.0 - busy / float(np.mean(ms)),
               peak_gb=peak / 1e9, top=top, bound=bound)
    log(f"({tag}) {name} epoch (CUDA events): {ms[0]:.3f} / {ms[1]:.3f} ms, "
        f"device busy {busy:.3f} ms, idle share {out['idle']:.3f}, peak "
        f"memory {out['peak_gb']:.2f} GB, bound {bound[0]:.3f} ms "
        f"({bound[1]}); top device ops {top}")
    return out


def _val_falls(tag: str, name: str, vals, val0: float, state) -> None:
    finite = all(bool(torch.isfinite(t).all()) for t in (state.u_fac,
                                                         state.i_fac))
    ok = finite and all(np.isfinite(vals)) and vals[-1] < val0
    log(f"({tag}) {name}: val RMSE at init {val0!r}, per epoch {vals!r}; "
        f"factors finite {finite} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"({tag}) {name}: val RMSE did not fall or the "
                             "factors are not finite")


def _epochs(solver, ev, model, state, n: int):
    """n epochs of a solver built outside train_model; val RMSE after each."""
    vals = []
    for _ in range(n):
        state = solver.epoch(state, 0.0)
        vals.append(ev.rmse(model.eval_view(state), "val"))
    return state, vals


def _staged_bytes(solver) -> int:
    return sum(t.nbytes for side in solver._stage for c in side for t in c)


def als_bound(solver):
    """Bucketed ALS epoch: the staged rows read once, the tables read and
    written once; each padded slot's Gram (2k^2), b (2k), and a row's
    Cholesky (k^3 / 3) and two triangular solves (2k^2) -- or cg_iters
    matvecs (2k^2 each) -- in f32 (batched products, not tensor cores)."""
    k = solver.model.k
    flops = 0.0
    for side in solver._stage:
        for ids, cols, *_ in side:
            nb, cap = cols.shape
            flops += 2.0 * nb * cap * k * (k + 1)
            flops += nb * (solver.cg_iters * 2.0 * k * k if solver.cg_iters
                           else k ** 3 / 3.0 + 2.0 * k * k)
    tables = 4 * k * (solver.model.n_users + solver.model.n_items)
    return _bound(_staged_bytes(solver) + 3 * tables, flops, "f32")


def subspace_bound(solver):
    """iALS++ epoch: the staged rows and tables as ALS; a padded slot's
    prediction (2k), then per block its Gram (2d^2), gradient (2d) and
    prediction update (2d), a row's d x d Cholesky and solves, in f32."""
    k, d = solver.model.k, solver.d
    nbl = solver._block_idx.shape[0]
    flops = 0.0
    for side in solver._stage:
        for ids, cols, *_ in side:
            nb, cap = cols.shape
            flops += 2.0 * nb * cap * k + nbl * (
                2.0 * nb * cap * d * (d + 2) + nb * (d ** 3 / 3.0 + 2 * d * d))
    tables = 4 * k * (solver.model.n_users + solver.model.n_items)
    return _bound(_staged_bytes(solver) + 3 * tables, flops, "f32")


def dense_als_bound(solver):
    """Dense ALS epoch: the dense values (and the int8 masks) read once, the
    tables read and written once; per sweep the Gram product 2 n_rows n_src
    P on the tensor cores (bf16, or int8 with gram_int8) -- the larger
    part -- and b's 2 n_rows n_src k."""
    k = solver.model.k
    P = k * (k + 1) // 2 if solver.packed else k * k
    mn = solver.nu_pad * solver.ni_pad
    nbytes = solver.dense.nbytes + (2 * solver.mask_rows.nbytes
                                    if solver.gram_int8 else 0) \
        + 12 * k * (solver.nu_pad + solver.ni_pad)
    gram = 2 * 2.0 * mn * P
    peak = "int8" if solver.gram_int8 else (
        "bf16" if solver.dense.dtype == torch.bfloat16 else "f32")
    return _bound(nbytes, gram + 2 * 2.0 * mn * k, peak)


def ccd_bound(solver):
    """CCD / CCD++ epoch: the staged stream (rows, cols, the item-sorted
    view's permutation, rows and cols, int64; the ratings) and the residual
    read once, the residual and the tables written once; per dim (group of
    g) per side per alternation each entry's integrand, W = 2 (P + g at
    g > 1) values of ~2 flops each, and its sum, in f32."""
    nnz, k = solver.vals.numel(), solver.model.k
    g = solver.g
    W = 2 if g == 1 else g * (g + 1) // 2 + g
    passes = (k // g) * solver.n_inner * 2
    flops = passes * nnz * 3.0 * W + (k // g) * 4.0 * nnz * g
    nbytes = nnz * (5 * 8 + 3 * 4) + 12 * k * (solver.n_users
                                                + solver.n_items)
    return _bound(nbytes, flops, "f32")


# CG's sixth iterate at k = 64 is far from converged, and where a Gram is
# near-singular it moves along the flat directions by up to 0.22 when the
# Gram is perturbed by 1e-7 relative (a CPU run at fac_dim 8,
# tests/test_torch_cuda_coordinate.py's data), so card and CPU are held
# by the quadratic CG minimizes, summed over the rows, not by the iterate
CG_OBJ_RTOL = 1e-3


def _quadratic(pred, w, r, x, lam) -> float:
    """sum over rows of 0.5 x^T (G + lam I) x - b^T x, the normal equations'
    quadratic, in float64 from the predictions pred = <q_i, x> [n, m], the
    0/1 weights w and ratings r [n, m]."""
    pred, w, r, x = (t.double() for t in (pred, w, r, x))
    return float((0.5 * (w * pred * pred).sum(dim=1)
                  + 0.5 * lam * (x * x).sum(dim=1)
                  - (w * r * pred).sum(dim=1)).sum())


def _held_quadratic(tag, what, q_card, q_cpu) -> float:
    rel = abs(q_card - q_cpu) / abs(q_cpu)
    ok = np.isfinite(q_card) and rel <= CG_OBJ_RTOL
    log(f"({tag}) {what}: CG's quadratic card {q_card!r} CPU {q_cpu!r}, "
        f"relative difference {rel:.3e} (rtol {CG_OBJ_RTOL}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"({tag}) {what}: the card's CG solves are "
                             "worse than the CPU's")
    return rel


def _cpu_copy(solver):
    """The solver with its staged tensors on the CPU (no restaging)."""
    c = copy.copy(solver)
    for key, v in vars(solver).items():
        if torch.is_tensor(v):
            setattr(c, key, v.cpu())
    if hasattr(solver, "_stage"):
        c._stage = [[tuple(t.cpu() for t in ch) for ch in side]
                    for side in solver._stage]
    if isinstance(solver, SGDSolver):
        # the batch views and the step hold the stream too (CPU tables
        # take the step's plain route)
        c.batches = [tuple(t.cpu() for t in bt) for bt in solver.batches]
        c.step = copy.copy(solver.step)
        for key, v in vars(solver.step).items():
            if torch.is_tensor(v):
                setattr(c.step, key, v.cpu())
        c.step.u_plans = c.step.i_plans = None    # the CPU reads none
    c.device = torch.device("cpu")
    return c


def _cpu_state(state):
    return type(state)(*(t.cpu() for t in state))


def _bucket_chunks_vs_cpu(tag, name, solver, state, blocks=None):
    """The user sweep's first and last chunk (degrees lowest and highest)
    and the item sweep's last, each solved on the card and on the CPU from
    the same tables."""
    p = solver.params
    cpu = _cpu_copy(solver)
    worst = 0.0
    for side, j in ((0, 0), (0, -1), (1, -1)):
        tgt, src = (state.u_fac, state.i_fac) if side == 0 else \
            (state.i_fac, state.u_fac)
        reg = float(p.u_reg if side == 0 else p.i_reg)
        outs = []
        for s, t_, s_ in ((solver, tgt, src), (cpu, tgt.cpu(), src.cpu())):
            t_ = t_.clone()
            chunk = s._stage[side][j]
            if blocks is None:
                als._solve_bucket(t_, s_, *chunk, reg, cg_iters=s.cg_iters,
                                  reg_exp=s.reg_exp)
            else:
                als._subspace_solve_bucket(t_, s_, *chunk,
                                           blocks.to(s_.device), reg, s.d)
            outs.append(t_[chunk[-1]])
        what = (f"{name}, {'user' if side == 0 else 'item'} chunk {j} "
                f"({tuple(chunk[1].shape)})")
        if not solver.cg_iters:
            worst = max(worst, _held(tag, what, *outs, COORD_TOL))
            continue
        ids, cols, vals, mask, sel, _ = chunk
        q = src.cpu()[cols[sel]].double()                  # [n, cap, k]
        w = (mask * (vals > 0))[sel]
        lam = reg * (torch.clamp_min(w.sum(dim=1), 1.0) ** solver.reg_exp
                     if solver.reg_exp else 1.0)
        quad = [_quadratic(torch.bmm(q, x.cpu().double()[:, :, None])[
            :, :, 0], w, vals[sel], x.cpu(), lam) for x in outs]
        worst = max(worst, _held_quadratic(tag, what, *quad))
    return worst


def _dense_blocks_vs_cpu(tag, name, solver, state):
    """The first row block of each sweep on the card and on the CPU, from
    the same tables (the whole sweep on the CPU would take minutes)."""
    blk, k = solver.row_block, solver.model.k
    pad = lambda t, n: torch.nn.functional.pad(t, (0, 0, 0, n - len(t)))
    u = pad(state.u_fac, solver.nu_pad)
    i = pad(state.i_fac, solver.ni_pad)
    tol = BF16_TOL if solver.dense.dtype == torch.bfloat16 else COORD_TOL
    kw = dict(cg_iters=solver.cg_iters, packed=solver.packed,
              gram_int8=solver.gram_int8)
    p = solver.params
    for side, tgt, src, vals, m8 in (
            ("user", u, i, solver.dense[:blk], solver.mask_rows),
            ("item", i, u, solver.dense[:, :blk], solver.mask_cols)):
        reg = float(p.u_reg if side == "user" else p.i_reg)
        tr = side == "item"
        m8 = None if m8 is None else m8[:blk]
        outs = [als.dense_als_sweep(t[:blk], s_, v, reg, blk, transposed=tr,
                                    mask8=m, **kw)
                for t, s_, v, m in ((tgt, src, vals, m8),
                                    (tgt.cpu(), src.cpu(), vals.cpu(),
                                     None if m8 is None else m8.cpu()))]
        what = f"{name}, first {side} block"
        if not solver.cg_iters:
            _held(tag, what, *outs, tol)
            continue
        r = (vals.t() if tr else vals).cpu().double()      # [blk, n_src]
        q = src.cpu().double()
        _held_quadratic(tag, what, *(_quadratic(
            x.cpu().double() @ q.t(), (r > 0).double(), r, x.cpu(), reg)
            for x in outs))


def phase_als(data: Data, dev="cuda") -> dict:
    """(p): ALS at (d)'s data and bench.py's Params, 2 epochs each:
    train_model(mf_method="auto") (exact bucketed ALS), ALSSolver(cg_iters=6)
    (bench.py's perf path), DenseALSSolver by default (bf16 values, exact
    Cholesky with the ridge retry) and with cg_iters=6, gram_int8=True, and
    SubspaceALSSolver; val RMSE falls, the factors stay finite; chunks or
    row blocks of an epoch held against the CPU; epoch ms, idle share,
    peak memory, top device ops, bound."""
    params = Params(**dict(COORD_PARAMS, max_iter=2))
    logs = []
    t0 = time.perf_counter()
    rep, model, ev, (iu, ii) = train_model(
        data, params, mf_method="auto", device=dev,
        log_fn=lambda s: (logs.append(s), log(f"(p) {s}")))
    wall = time.perf_counter() - t0
    assert "resolved to 'als'" in logs[0], logs[0]
    s0 = init_state(params, data.n_users, data.n_items, device=dev)
    val0 = ev.rmse(model.eval_view(s0), "val")
    out = {}
    solver = rep.solver
    assert isinstance(solver, als.ALSSolver) and solver.cg_iters == 0
    _val_falls("p", "auto -> als (exact)", [h.val_rmse for h in
                                            rep.history], val0, rep.state)
    log(f"(p) train_model wall {wall:.1f} s; epochs in the loop "
        f"{[round(1e3 * h.seconds, 3) for h in rep.history]} ms")
    _bucket_chunks_vs_cpu("p", "als exact", solver, rep.state)
    out["als"] = _time_epoch("p", "als exact", lambda: solver.epoch(
        rep.state, 0.0), als_bound(solver))
    del rep, solver
    torch.cuda.empty_cache()
    makers = {
        "als cg6": lambda: als.ALSSolver(model, params, data.train_mat, iu,
                                         ii, cg_iters=6, device=dev),
        "ialspp": lambda: als.SubspaceALSSolver(model, params,
                                                data.train_mat, iu, ii,
                                                device=dev),
        "alsdense": lambda: als.DenseALSSolver(model, params, data.train_mat,
                                               iu, ii, device=dev),
        "alsdense cg6 int8": lambda: als.DenseALSSolver(
            model, params, data.train_mat, iu, ii, cg_iters=6,
            gram_int8=True, device=dev),
    }
    bounds = {"als cg6": als_bound, "ialspp": subspace_bound,
              "alsdense": dense_als_bound,
              "alsdense cg6 int8": dense_als_bound}
    for name, make in makers.items():
        t0 = time.perf_counter()
        solver = make()
        torch.cuda.synchronize()
        stage_s = time.perf_counter() - t0
        st, vals = _epochs(solver, ev, model, s0, 2)
        log(f"(p) {name}: staged in {stage_s:.1f} s")
        _val_falls("p", name, vals, val0, st)
        if name.startswith("alsdense"):
            _dense_blocks_vs_cpu("p", name, solver, st)
        else:
            blocks = None
            if name == "ialspp":
                blocks = torch.from_numpy(solver._block_idx[
                    solver.draw().numpy()])
            _bucket_chunks_vs_cpu("p", name, solver, st, blocks)
        out[name] = _time_epoch("p", name, lambda: solver.epoch(st, 0.0),
                                bounds[name](solver))
        if name == "alsdense cg6 int8":
            _int8_layouts(solver, st)
        del solver, st
        torch.cuda.empty_cache()
    return out


def _int8_layouts(solver, state):
    """One user block's int8 Gram product with QQ row-major (as the sweep
    passes it) and column-major, beside the bf16 product of the same
    block (CUDA events, mean of 20)."""
    k, blk = solver.model.k, solver.row_block
    iu_, il_ = np.triu_indices(k)
    qf = torch.nn.functional.pad(state.i_fac, (0, 0, 0, solver.ni_pad
                                               - state.i_fac.shape[0]))
    qq = qf[:, torch.from_numpy(iu_).to(qf.device)] * \
        qf[:, torch.from_numpy(il_).to(qf.device)]
    _, q8 = als.quantize_columns(qq)
    q8 = torch.nn.functional.pad(q8, (0, (-q8.shape[1]) % 8))
    m8 = solver.mask_rows[:blk]
    col_major = q8.t().contiguous().t()
    bf = qq.to(torch.bfloat16)
    mb = m8.to(torch.bfloat16)
    same = torch.equal(torch._int_mm(m8, q8), torch._int_mm(m8, col_major))
    t = {name: _cuda_ms(fn, 20) for name, fn in (
        ("row-major", lambda: torch._int_mm(m8, q8)),
        ("column-major", lambda: torch._int_mm(m8, col_major)),
        ("bf16", lambda: torch.mm(mb, bf, out_dtype=torch.float32)))}
    log(f"(p) int8 Gram of one user block [{blk} x {m8.shape[1]}] @ "
        f"[{q8.shape[0]} x {q8.shape[1]}]: QQ row-major {t['row-major']:.4f} "
        f"ms, column-major {t['column-major']:.4f} ms (equal {same}); the "
        f"bf16 product {t['bf16']:.4f} ms")


def phase_ccd(data: Data, dev="cuda") -> dict:
    """(q): train_model(mf_method="ccd++") 2 epochs, ccd++ with
    ccd_group_dims=4 1 epoch, ccd++freqadap 1 epoch, ccd 2 epochs, at (d)'s
    data and bench.py's Params: val RMSE falls, factors finite; a partial
    epoch (one dim, one group of 4, two dims a side for CCD) on the card
    and on the CPU from the same tables and residual; two runs of one
    CCD++ and one CCD epoch bit-identical; epoch ms, idle share, peak
    memory, top device ops, bound."""
    out = {}
    runs = (("ccd++", {}, 2), ("ccd++ g4", dict(ccd_group_dims=4), 1),
            ("ccd++freqadap", {}, 1), ("ccd", {}, 2))
    for name, extra, n in runs:
        params = Params(**dict(COORD_PARAMS, max_iter=n, **extra))
        method = name.split()[0]
        t0 = time.perf_counter()
        rep, model, ev, _ = train_model(data, params, mf_method=method,
                                        device=dev,
                                        log_fn=lambda s: log(f"(q) {s}"))
        wall = time.perf_counter() - t0
        solver = rep.solver
        s0 = init_state(params, data.n_users, data.n_items, device=dev)
        val0 = ev.rmse(model.eval_view(s0), "val")
        _val_falls("q", name, [h.val_rmse for h in rep.history], val0,
                   rep.state)
        log(f"(q) {name}: train_model wall {wall:.1f} s, epochs in the loop "
            f"{[round(1e3 * h.seconds, 3) for h in rep.history]} ms; "
            f"{solver.vals.numel()} staged ratings, g = {solver.g}"
            + (f", {int(solver.item_dim_ok.sum())} of {solver.n_items} "
               "items above the frequency threshold"
               if solver.item_dim_ok is not None else ""))
        # a partial epoch on both devices from the same tables and residual
        cpu = _cpu_copy(solver)
        k = solver.model.k
        dims = (([0, k - 1], [k - 1, 1]) if name == "ccd"
                else list(range(solver.g)))
        st_c = cpu.epoch_with(_cpu_state(rep.state), 0.0, dims)
        st_g = solver.epoch_with(rep.state, 0.0, dims)
        for what, a, b in (("u", st_g.u_fac, st_c.u_fac),
                           ("i", st_g.i_fac, st_c.i_fac),
                           ("res", solver.res, cpu.res)):
            _held("q", f"{name} partial epoch {dims}, {what}", a, b,
                  COORD_TOL)
        if name in ("ccd++", "ccd"):
            res0 = solver.res.clone()
            draws = solver.draw()
            outs = []
            for _ in range(2):
                solver.res = res0.clone()
                st = solver.epoch_with(rep.state, 0.0, draws)
                outs.append((st.u_fac, st.i_fac, solver.res))
            same = all(torch.equal(a, b) for a, b in zip(*outs))
            log(f"(q) {name}: two runs of one epoch bit-identical {same} "
                f"{'ok' if same else 'FAIL'}")
            if not same:
                raise AssertionError(f"(q) {name}: two runs of one epoch "
                                     "differ")
        out[name] = _time_epoch("q", name, lambda: solver.epoch(
            rep.state, 0.0), ccd_bound(solver))
        del rep, solver, ev, cpu
        torch.cuda.empty_cache()
    return out


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


# ----------------------------------------------------------------------
# (x): the quality harness at a cut depth
# ----------------------------------------------------------------------

# scripts/torch_quality_report.py's nine solvers at --maxiter 30, the
# depth of the JAX package's own chip rerun (BASELINE.md:255-257). Each
# solver's best val RMSE is held within QUALITY_TOL of the JAX package's
# at the same depth: scripts/quality_seed_band.py --cpu --maxiter 30 (JAX's
# scripts/quality_report.py grid on the CPU, Params seeds 1-4, seed 1 the
# script's own), best_val to 4 digits; the card's value must lie within
# QUALITY_TOL of [min, max] over the four. One JAX seed is no yardstick:
# its four runs span 0.0324 for sgd and 0.0159 for ccd at this depth
QUALITY_MAXITER = 30
QUALITY_TOL = 0.01
QUALITY_JAX = {
    "sgd": (0.1707, 0.1685, 0.1383, 0.1698),
    "sgdparsvd": (0.1505, 0.1502, 0.1499, 0.1503),
    "als": (0.1363, 0.1365, 0.1341, 0.1346),
    "ialspp": (0.1363, 0.1365, 0.1341, 0.1346),
    "alsdense": (0.1363, 0.1365, 0.1341, 0.1346),
    "ccd++": (0.1334, 0.1367, 0.1316, 0.1358),
    "ccd++g5": (0.1349, 0.1375, 0.1362, 0.1368),
    "ccd": (0.1438, 0.1279, 0.1340, 0.1349),
    "densesgd": (0.1417, 0.1458, 0.1486, 0.1496)}


def phase_quality(dev="cuda") -> list:
    """(x): scripts/torch_quality_report.py's run() for its nine solvers at
    QUALITY_MAXITER through the port's train_model on the card; each best
    val RMSE within QUALITY_TOL of QUALITY_JAX's band. Prints the table
    beside JAX's; returns the rows."""
    qr = _load_script("torch_quality_report")
    t0 = time.perf_counter()
    data = qr.quality_data()
    rows = qr.run(data, QUALITY_MAXITER, dev, log=lambda s: log(f"(x) {s}"))
    failures = []
    log(f"(x) {'solver':10s} {'card val':>9s} {'test':>7s} "
        f"{'JAX val (seeds 1-4)':>28s}  within {QUALITY_TOL}")
    for method, val, test, best_iter, stop, secs in rows:
        band = QUALITY_JAX[method]
        ok = (np.isfinite(val) and min(band) - QUALITY_TOL <= val
              <= max(band) + QUALITY_TOL)
        log(f"(x) {method:10s} {val:9.4f} {test:7.4f} "
            f"{', '.join(f'{v:.4f}' for v in band):>28s}  "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append((method, val, band))
    log(f"(x) phase {time.perf_counter() - t0:.1f} s")
    if failures:
        raise AssertionError(f"(x) best val RMSE off the JAX package's by "
                             f"more than {QUALITY_TOL}: {failures}")
    return rows


# ----------------------------------------------------------------------
# (y): the multi-device engines on a 4-shard mesh of the one card
# ----------------------------------------------------------------------

# (d)'s data and Params on a mesh of 4 shards of the one card: the dense
# block-DSGD engine stages bu 25,600 (10 stripes of 2,560) x bi 5,120 a
# shard, 102,400 x 20,480 slots in all, bf16 R + int8 W (6.3 GB, under
# the JAX package's 8 GiB budget)
Y_SHARDS = 4
Y_PARAMS = dict(CELLS["d"][1], max_iter=3)
Y_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                     "chip_smoke", "mesh")
# a whole bf16-product epoch against the plain version: the JAX package's
# class for bf16 over several steps (tests/test_pallas_dense_rows.py:120),
# as (w) holds its epoch; one shard-round and the f32-product epoch at
# RTOL / ATOL
Y_BF16_RTOL, Y_BF16_ATOL = 5e-3, 5e-4
# (y) 2: the coordinate solvers under train_model(mesh=...), 2 epochs each
# at (d)'s Params (k 64, reg 0.01), 1 process against 2
Y_COORD = ("als", "ialspp", "alsdense")
Y_COORD_PARAMS = dict(CELLS["d"][1], max_iter=2)
Y_COORD_SOLVERS = {"als": als.ALSSolver, "ialspp": als.SubspaceALSSolver,
                   "alsdense": als.DenseALSSolver}
# (y) 6: scripts/torch_scaling_curve.py's phase split
Y_CURVE_SHARDS = (1, 2, 4)
Y_CURVE_EPOCHS = 2
# (y) 5: TMF+Dropout on the scatter DSGD, 1 epoch (~13 s on the ordered
# sums). Steps of 2,048 ratings at lr 0.01: the DSGD engine sums a batch's
# gradients without collision normalization (as JAX's), so a hot item of a
# 16,384-rating step at (d)'s lr 0.05 takes many steps at once.
Y_DSGD_PARAMS = dict(CELLS["d"][1], max_iter=1, batch_size=2048,
                     learn_rate=0.01)


def _y_dsgd_run(data, mesh):
    """train_model(algo="tmfdropout", mf_method="sgd", mesh): the scatter
    DSGD with Poisson ranks drawn per (round, shard), keyed by the
    global shard, so 2 processes draw what 1 process draws."""
    return train_model(data, Params(**Y_DSGD_PARAMS), algo="tmfdropout",
                       mf_method="sgd", mesh=mesh,
                       log_fn=lambda s: log(f"(y) {s}"))


def _y_mesh(dev, n=Y_SHARDS):
    return make_mesh((n,), ("u",), devices=[torch.device(dev)] * n)


class _PlainStripes:
    """A shard-round's StripeTiles stand-in: its rows_epoch runs the plain
    dense_sweep_rows on the same tiles, in the matmul precision ``mm``."""

    def __init__(self, tiles, mm: bool):
        self.t, self.mm = tiles, mm

    def rows_epoch(self, u3, i_tab, order, lr, round_u=None):
        t = self.t
        return dense_sweep_rows(u3, i_tab, order, lr, t.R, t.W, t.u_reg,
                                t.i_reg, t.collision_norm, self.mm,
                                r_scale=t.r_scale)


def _mesh_epoch(solver, state, lr, sched, plain=False, mm_bf16=None):
    """One epoch of a DenseBlockDSGDSolver from ``state`` on ``sched``,
    each shard-round through the kernel or its plain version, in the
    solver's matmul precision or ``mm_bf16`` (the kernel's tiles staged
    again); returns (u, i) copies. The solver's resident tables are
    dropped first and after."""
    stripes = solver.stripes
    mm = solver.mm_bf16 if mm_bf16 is None else mm_bf16
    if plain:
        solver.stripes = [[_PlainStripes(t, mm) for t in row]
                          for row in stripes]
    elif mm != solver.mm_bf16:
        solver.stripes = [[_restaged(t, mm) for t in row] for row in stripes]
    solver._resident = None
    try:
        out = solver.epoch_with(state, lr, sched)
        return out.u_fac.clone(), out.i_fac.clone()
    finally:
        solver.stripes = stripes
        solver._resident = None


def mesh_dense_bound(solver):
    """Bound of one dense block-DSGD epoch: every tile read once, each
    shard-round's user block and held item block read and written once;
    three products of 2k FLOP a slot on the bf16 tensor cores."""
    k = solver.model.k
    N = solver.n_shards
    tiles = sum(t.nbytes for t in solver.R_tiles) + (
        0 if solver.W_tiles is None else sum(t.nbytes
                                             for t in solver.W_tiles))
    slots = sum(t.numel() for t in solver.R_tiles)
    nbytes = tiles + N * N * 2 * 4 * k * (solver.bu + solver.bi)
    return _bound(nbytes, 6.0 * slots * k, "bf16" if solver.mm_bf16
                  else "f32")


def _dense_round_vs_plain(tag, solver, s0, params) -> float:
    """One shard-round (shard 0, round 0) of a DenseBlockDSGDSolver from
    ``s0``, kernel vs dense_sweep_rows at RTOL / ATOL, both timed; returns
    the max abs error."""
    k, p = params.fac_dim, params
    u_blk, i_blk = solver.stage_factors(s0)
    order = torch.randperm(solver.SU, generator=torch.Generator()
                           .manual_seed(1))
    tiles = solver.stripes[0][0]
    R, W = tiles.R, tiles.W
    U0 = u_blk[0].view(solver.SU, solver.sub_bu, k)
    kern = lambda: tiles.rows_epoch(U0.clone(), i_blk[0].clone(), order,
                                    p.learn_rate)
    plain = lambda: dense_sweep_rows(
        U0.clone(), i_blk[0].clone(), order, p.learn_rate, R, W, p.u_reg,
        p.i_reg, solver.collision_norm, solver.mm_bf16,
        r_scale=solver.r_scale)
    a, r, ratio = _errors(kern(), plain())
    ms, plain_ms = _alternate(kern, plain)
    log(f"{tag} one dense shard-round (shard 0, round 0; {solver.SU} "
        f"stripes of [{solver.sub_bu}, {solver.bi}]) kernel vs plain: "
        f"max_abs {a:.3e} max_rel {r:.3e} err/tol {ratio:.3e}; kernel "
        f"{ms:.3f} ms, plain {plain_ms:.3f} ms (CUDA events)")
    if ratio > 1.0:
        raise AssertionError(f"{tag} shard-round: kernel disagrees with "
                             f"dense_sweep_rows (rtol {RTOL}, atol {ATOL})")
    return a


def _block_round_vs_plain(tag, solver, s0, lr):
    """One shard-round (shard 0, round 0) of a BlockDSGDSolver from ``s0``,
    kernel vs block_sweep_diag at BF16_RTOL / BF16_ATOL, both timed;
    returns (max abs error, kernel ms, plain ms)."""
    u_blk, i_blk = solver.stage_factors(s0)
    sched = bsk.diag_schedule(torch.Generator().manual_seed(1), solver.SU,
                              solver.SI, solver.S // solver.bs)
    args = (*sched, lr, *solver.streams(0, 0))
    kw = solver.sweep_kwargs()
    kern = lambda: bsk.block_sgd_diag_epoch(
        u_blk[0].clone(), i_blk[0].clone(), *args, **kw,
        slices=None if solver.slices is None else solver.slices[0][0])
    plain = lambda: bsk.block_sweep_diag(u_blk[0].clone(),
                                         i_blk[0].clone(), *args, **kw)
    a, r, ratio = _errors(kern(), plain(), BF16_RTOL, BF16_ATOL)
    k_ms, p_ms = _alternate(kern, plain)
    log(f"{tag} one shard-round of the one-hot engine (shard 0, round 0, "
        f"{sched[0].shape[0]} diag rounds of {solver.SI} lanes) kernel vs "
        f"plain: max_abs {a:.3e} max_rel {r:.3e} err/tol {ratio:.3e}; "
        f"kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms (CUDA events)")
    if ratio > 1.0:
        raise AssertionError(f"{tag} block shard-round: kernel vs plain")
    return a, k_ms, p_ms


def _y_dense(data, dev):
    """(y) 1: train_model(mf_method="densesgd", mesh=4 shards), 3 epochs:
    launches, staging, val RMSE; one shard-round against dense_sweep_rows,
    a whole epoch in f32 and in bf16 products against the plain version,
    the kernel's epoch twice bit-identical; epoch ms, idle share, bound."""
    params = Params(**Y_PARAMS)
    mesh = _y_mesh(dev)
    drk.StripeTiles.launches = 0
    t0 = time.perf_counter()
    rep, model, ev, inval = train_model(
        data, params, algo="mf", mf_method="densesgd", mesh=mesh,
        log_fn=lambda s: log(f"(y) {s}"))
    wall = time.perf_counter() - t0
    launches = drk.StripeTiles.launches
    solver = rep.solver
    N, k = solver.n_shards, params.fac_dim
    log(f"(y) densesgd on {N} shards of {mesh.home()}: SU={solver.SU} "
        f"sub_bu={solver.sub_bu} bu={solver.bu} bi={solver.bi} R="
        f"{solver.R_tiles[0].dtype} W={solver.W_tiles[0].dtype} tiles "
        f"{sum(t.numel() for t in solver.R_tiles)} slots; nnz {solver.nnz}; "
        f"train_model wall {wall:.1f} s; stop={rep.stop_reason}")
    assert isinstance(solver, bdsgd.DenseBlockDSGDSolver)
    if (data.n_users, data.n_items) == (100_000, 20_000):
        assert (solver.SU, solver.sub_bu, solver.bi) == (10, 2560, 5120)
    assert (solver.R_tiles[0].dtype, solver.W_tiles[0].dtype) == (
        torch.bfloat16, torch.int8)
    epochs = len(rep.history)
    assert epochs == params.max_iter, (rep.stop_reason, epochs)
    want = epochs * N * N * drk.epoch_launches(solver.SU, k, solver.mm_bf16)
    assert launches == want, f"(y) stripe launches {launches} != {want}"
    s0 = shard_state(init_state(params, data.n_users, data.n_items,
                                device=dev), mesh)
    val0 = ev.rmse(model.eval_view(s0), "val")
    vals = [h.val_rmse for h in rep.history]
    log(f"(y) val RMSE at init {val0!r}, per epoch {vals!r}; epoch in the "
        f"loop {[1e3 * h.seconds for h in rep.history]!r} ms")
    assert all(np.isfinite(vals)) and rep.best_metric < val0 and \
        vals[-1] < val0, (vals, val0)
    lr = params.learn_rate
    a_sr = _dense_round_vs_plain("(y)", solver, s0, params)
    # whole epochs, f32 then bf16 products
    sched = solver.draw_schedule()
    errs = [a_sr]
    for mm, rtol, atol in ((False, RTOL, ATOL),
                           (True, Y_BF16_RTOL, Y_BF16_ATOL)):
        got = _mesh_epoch(solver, s0, lr, sched, mm_bf16=mm)
        want_ = _mesh_epoch(solver, s0, lr, sched, plain=True, mm_bf16=mm)
        a, r, ratio = _errors(got, want_, rtol, atol)
        errs.append(a)
        log(f"(y) a whole epoch ({'bf16' if mm else 'f32'} products) "
            f"kernel vs plain: max_abs {a:.3e} max_rel {r:.3e} err/tol "
            f"{ratio:.3e} (rtol {rtol}, atol {atol})")
        if ratio > 1.0:
            raise AssertionError(f"(y) epoch in {'bf16' if mm else 'f32'} "
                                 "products: kernel vs plain")
    twice = [_mesh_epoch(solver, s0, lr, sched) for _ in range(2)]
    same = all(torch.equal(x, y) for x, y in zip(*twice))
    log(f"(y) the same epoch through the kernel twice: bit-identical {same}")
    if not same:
        raise AssertionError("(y) two runs of one mesh epoch differ")

    def epoch():
        solver._resident = None
        return solver.epoch_with(s0, lr, sched)

    epoch()
    torch.cuda.synchronize()
    ms, busy, idle, _ = _busy_idle(epoch)
    plain_ms = _cuda_ms(lambda: _mesh_epoch(solver, s0, lr, sched,
                                            plain=True))
    bound = mesh_dense_bound(solver)
    lib_ms = _three_products_ms(solver.sub_bu, solver.bi, k,
                                N * N * solver.SU)
    log(f"(y) dense block-DSGD epoch alone (CUDA events, tables staged "
        f"and gathered): {ms:.3f} ms = {solver.nnz / ms * 1e3:.4e} "
        f"ratings/s, device busy {busy:.3f} ms, idle share {idle:.3f}; "
        f"plain PyTorch {plain_ms:.3f} ms; bound {bound[0]:.3f} ms "
        f"({bound[1]}), kernel epoch at {bound[0] / ms:.3f} of it; the "
        f"products as bf16 cuBLAS calls {lib_ms:.3f} ms")
    # the 1-process first epoch of train_model, for (y) 2
    solver._sched_rng = np.random.default_rng(params.seed + 41)
    solver._resident = None
    first = solver.epoch(s0, lr)
    first = (first.u_fac.clone(), first.i_fac.clone())
    return dict(launches=launches, max_abs_err=max(errs), ms=ms,
                plain_ms=plain_ms, idle=idle, bound=bound, first=first,
                rep=rep, model=model, ev=ev, inval=inval, s0=s0)


def _y_coord(data, dev) -> dict:
    """(y) 2, one process: train_model(mf_method=m, mesh=4 shards) for m in
    Y_COORD, 2 epochs each: the split layout (``split``: each process's
    share of every half-sweep, here all of it), val RMSE falls, the wall
    and the epochs; returns {m: (u, i)}, the final factors on the host,
    for the 2-process run."""
    params = Params(**Y_COORD_PARAMS)
    mesh = _y_mesh(dev)
    s0 = shard_state(init_state(params, data.n_users, data.n_items,
                                device=dev), mesh)
    out, val0 = {}, None
    for m in Y_COORD:
        t0 = time.perf_counter()
        rep, model, ev, _ = train_model(data, params, algo="mf",
                                        mf_method=m, mesh=mesh,
                                        log_fn=lambda s: None)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        solver = rep.solver
        assert type(solver) is Y_COORD_SOLVERS[m] and solver.split, solver
        if val0 is None:
            val0 = ev.rmse(model.eval_view(s0), "val")
        vals = [h.val_rmse for h in rep.history]
        log(f"(y) mesh {m}, 1 process x {mesh.size} shards: train_model "
            f"wall {wall:.1f} s; epoch in the loop "
            f"{[round(1e3 * h.seconds, 3) for h in rep.history]} ms; val "
            f"RMSE at init {val0!r}, per epoch {vals!r}")
        if not (len(vals) == params.max_iter and all(np.isfinite(vals))
                and vals[-1] < val0):
            raise AssertionError(f"(y) mesh {m}: val RMSE did not fall")
        out[m] = (rep.state.u_fac.cpu().numpy(),
                  rep.state.i_fac.cpu().numpy())
        del rep, model, ev, solver
        torch.cuda.empty_cache()
    return out


def mesh_worker(port: int, rank: int, out_dir: str, dev: str) -> int:
    """One of the two processes of (y) 2: (d)'s data, this rank's
    host-local rows, DenseBlockDSGDSolver on 2 of the 4 shards (gloo, the
    item blocks staged through host memory), train_model's first epoch
    from its initial state; then the whole train matrix gathered once
    from the host-local rows and train_model(mf_method=m, mesh) for m in
    Y_COORD, 2 epochs each, this process solving its share of every
    half-sweep; then (y) 5's scatter DSGD from the host-local rows. Rank 0
    writes the factors."""
    from matfac_tpu_torch.parallel import distributed
    distributed.initialize(f"tcp://127.0.0.1:{port}", world_size=2,
                           rank=rank, backend="gloo")
    data = bench_data(**CELLS["d"][0])
    params = Params(**Y_PARAMS)
    iu, ii = freq.invalid_users_items(data.train_mat, data.n_users,
                                      data.n_items)
    r, c, v = distributed.host_local_ratings(data.train_mat, data.n_users,
                                             2, rank)
    local = RatingMatrix.from_coo(r, c, v, data.n_users, data.n_items)
    mesh = make_mesh((Y_SHARDS,), ("u",),
                     devices=[torch.device(dev)] * (Y_SHARDS // 2))
    solver = bdsgd.DenseBlockDSGDSolver(
        ModelMF(params, data.n_users, data.n_items), params, local, iu, ii,
        mesh)
    assert solver.local_blocks == [2 * rank, 2 * rank + 1]
    s0 = init_state(params, data.n_users, data.n_items, device=dev)
    drk.StripeTiles.launches = 0
    st = solver.epoch(s0, params.learn_rate)
    if dev != "cpu":
        torch.cuda.synchronize()
        assert drk.StripeTiles.launches == Y_SHARDS * 2 * \
            drk.epoch_launches(solver.SU, params.fac_dim, solver.mm_bf16)
    if rank == 0:
        np.savez(os.path.join(out_dir, "two_process.npz"),
                 u_fac=st.u_fac.cpu().numpy(), i_fac=st.i_fac.cpu().numpy())
    del solver, st
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    whole = distributed.whole_matrix(local)
    assert whole is not local and all(np.array_equal(a, b) for a, b in (
        (whole.indptr, data.train_mat.indptr),
        (whole.indices, data.train_mat.indices),
        (whole.values, data.train_mat.values)))
    log(f"mesh worker {rank}: {local.nnz} host-local ratings, the whole "
        f"train matrix ({whole.nnz}) gathered in "
        f"{time.perf_counter() - t0:.2f} s")
    cdata = copy.copy(data)
    cdata.train_mat = whole
    for m in Y_COORD:
        t0 = time.perf_counter()
        rep, *_ = train_model(cdata, Params(**Y_COORD_PARAMS), algo="mf",
                              mf_method=m, mesh=mesh, log_fn=lambda s: None)
        if dev != "cpu":
            torch.cuda.synchronize()
        solved = (rep.solver._runs[0] if m == "alsdense"
                  else rep.solver._solved[0])
        log(f"mesh worker {rank}: {m} 2 epochs in "
            f"{time.perf_counter() - t0:.1f} s; user rows (blocks) solved "
            f"by each process {[len(x) for x in solved]}")
        if rank == 0:
            np.savez(os.path.join(out_dir, f"two_process_{m}.npz"),
                     u_fac=rep.state.u_fac.cpu().numpy(),
                     i_fac=rep.state.i_fac.cpu().numpy())
        del rep
        torch.cuda.empty_cache()
    # host-local rows: train_model sums the frequencies behind the
    # Poisson ranks over the processes
    ldata = copy.copy(data)
    ldata.train_mat = local
    t0 = time.perf_counter()
    rep, *_ = _y_dsgd_run(ldata, mesh)
    log(f"mesh worker {rank}: tmfdropout scatter DSGD "
        f"{Y_DSGD_PARAMS['max_iter']} epoch(s) in "
        f"{time.perf_counter() - t0:.1f} s")
    if rank == 0:
        np.savez(os.path.join(out_dir, "two_process_dsgd.npz"),
                 u_fac=rep.state.u_fac.cpu().numpy(),
                 i_fac=rep.state.i_fac.cpu().numpy())
    del rep
    distributed.barrier()
    torch.distributed.destroy_process_group()
    log(f"mesh worker {rank}: ok")
    return 0


def _y_two_process(first, coord, dev):
    """(y) 2: the first epoch as 2 processes x 2 shards on the one card
    (gloo; this script's --mesh-worker), bit for bit (y) 1's; then in the
    same two processes ALS, iALS++ and dense ALS under train_model(mesh),
    bit for bit ``coord``, the 1-process runs of ``_y_coord``."""
    import socket
    os.makedirs(Y_DIR, exist_ok=True)
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")}
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--mesh-worker",
         str(port), str(r), Y_DIR, dev], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        tail = "\n".join(out.splitlines()[-15:])
        if p.returncode != 0:
            raise AssertionError(f"(y) mesh worker {r} failed "
                                 f"({p.returncode}):\n{tail}")
    multi = np.load(os.path.join(Y_DIR, "two_process.npz"))
    same = (np.array_equal(multi["u_fac"], first[0].cpu().numpy())
            and np.array_equal(multi["i_fac"], first[1].cpu().numpy()))
    log(f"(y) first epoch as 2 processes x 2 shards (gloo, exchange "
        f"through host memory), {time.perf_counter() - t0:.1f} s with "
        f"start-up and staging: bit for bit the 1-process epoch {same}")
    if not same:
        raise AssertionError("(y) 2-process epoch differs from 1-process")
    for line in outs[0].splitlines() + outs[1].splitlines():
        if "mesh worker" in line and ("gathered" in line or "epochs in"
                                      in line or "epoch(s) in" in line):
            log(f"(y) {line}")
    for m in Y_COORD:
        multi = np.load(os.path.join(Y_DIR, f"two_process_{m}.npz"))
        same = (np.array_equal(multi["u_fac"], coord[m][0])
                and np.array_equal(multi["i_fac"], coord[m][1]))
        log(f"(y) mesh {m}, 2 processes x 2 shards (each its share of "
            f"every half-sweep, the solved rows all-gathered over gloo), 2 "
            f"epochs: bit for bit the 1-process run {same}")
        if not same:
            raise AssertionError(f"(y) mesh {m}: 2 processes differ from 1")


def _y_codes(data, dev):
    """(y) 3: (d)'s ratings rounded to half stars on the same mesh:
    dense_codes "codes" (int8 code tiles, no W) against "off" (bf16 R +
    int8 W), one epoch each on one schedule, bit for bit; the codes
    epoch's launches."""
    mat = data.train_mat.copy()
    mat.values[:] = (np.clip(np.round(mat.values / 0.5), 1, 10)
                     * 0.5).astype(np.float32)
    params = Params(**Y_PARAMS)
    iu, ii = freq.invalid_users_items(mat, data.n_users, data.n_items)
    model = ModelMF(params, data.n_users, data.n_items)
    mesh = _y_mesh(dev)
    s0 = init_state(params, data.n_users, data.n_items, device=dev)
    out = {}
    for codes in ("codes", "off"):
        solver = bdsgd.DenseBlockDSGDSolver(model, params, mat, iu, ii,
                                            mesh, dense_codes=codes)
        assert (solver.W_tiles is None) == (codes == "codes")
        sched = solver.draw_schedule()
        drk.StripeTiles.launches = 0
        st = solver.epoch_with(s0, params.learn_rate, sched)
        out[codes] = (st.u_fac.clone(), st.i_fac.clone(),
                      drk.StripeTiles.launches)
        del solver, st
        torch.cuda.empty_cache()
    same = all(torch.equal(x, y) for x, y in zip(out["codes"][:2],
                                                 out["off"][:2]))
    log(f"(y) half-star ratings: int8 code tiles against bf16 R + int8 W "
        f"tiles, one epoch: bit for bit {same}; code launches "
        f"{out['codes'][2]}")
    if not same:
        raise AssertionError("(y) code tiles and float tiles differ")
    return out["codes"][2]


def _y_block(data, dev):
    """(y) 4: train_model(mf_method="blocksgd", mesh), 2 epochs: one diag
    launch a shard-round, every cell finished; one shard-round against
    block_sweep_diag; val RMSE falls."""
    params = Params(**dict(CELLS["d"][1], max_iter=2))
    mesh = _y_mesh(dev)
    _zero_block_counts()
    rep, model, ev, _ = train_model(data, params, algo="mf",
                                    mf_method="blocksgd", mesh=mesh,
                                    log_fn=lambda s: log(f"(y) {s}"))
    (n_row, n_diag, n_cell), cells = _block_counts()
    solver = rep.solver
    N = solver.n_shards
    log(f"(y) blocksgd on {N} shards: SU={solver.SU} SI={solver.SI} sub "
        f"{solver.sub_bu} x {solver.sub_bi} S={solver.S} bs={solver.bs} "
        f"pad_frac {solver.pad_frac:.3f}; launches (row, diag, cell) "
        f"{(n_row, n_diag, n_cell)}; finished cells {cells}")
    assert isinstance(solver, bdsgd.BlockDSGDSolver)
    epochs = len(rep.history)
    assert epochs == params.max_iter
    assert (n_row, n_diag, n_cell) == (0, epochs * N * N, 0)
    assert cells == (0, epochs * N * N * solver.SU * solver.SI, 0), cells
    s0 = shard_state(init_state(params, data.n_users, data.n_items,
                                device=dev), mesh)
    val0 = ev.rmse(model.eval_view(s0), "val")
    vals = [h.val_rmse for h in rep.history]
    log(f"(y) blocksgd val RMSE at init {val0!r}, per epoch {vals!r}; "
        f"epoch in the loop {[1e3 * h.seconds for h in rep.history]!r} ms")
    assert len(vals) == params.max_iter and all(np.isfinite(vals)) and \
        rep.best_metric < val0, vals
    a, k_ms, p_ms = _block_round_vs_plain("(y)", solver, s0,
                                          params.learn_rate)
    return dict(launches=n_diag, max_abs_err=a, ms=k_ms, plain_ms=p_ms)


def _y_dsgd(data, dev):
    """(y) 5: TMF+Dropout on the scatter DSGD (``_y_dsgd_run``), 2 epochs:
    Poisson ranks drawn per (round, shard); val RMSE falls; the trained
    tables bit for bit the 2 processes x 2 shards run of ``mesh_worker``;
    two runs of an epoch bit-identical; epoch ms and idle share (one
    timed epoch, one profiled: the epoch is host-bound, seconds long)."""
    params = Params(**Y_DSGD_PARAMS)
    mesh = _y_mesh(dev)
    rep, model, ev, _ = _y_dsgd_run(data, mesh)
    solver = rep.solver
    assert type(solver).__name__ == "DSGDShardedSolver"
    assert solver.sample_poisson
    s0 = shard_state(init_state(params, data.n_users, data.n_items,
                                device=dev), mesh)
    val0 = ev.rmse(model.eval_view(s0), "val")
    vals = [h.val_rmse for h in rep.history]
    sched = solver.draw_schedule()

    def epoch():
        solver._resident = None
        return solver.epoch_with(s0, params.learn_rate, sched)

    multi = np.load(os.path.join(Y_DIR, "two_process_dsgd.npz"))
    same = (np.array_equal(multi["u_fac"], rep.state.u_fac.cpu().numpy())
            and np.array_equal(multi["i_fac"],
                               rep.state.i_fac.cpu().numpy()))
    log(f"(y) tmfdropout scatter DSGD, {params.max_iter} epoch(s) as 2 "
        f"processes x 2 shards (the --mesh-worker processes): bit for bit "
        f"the 1-process run "
        f"{same} {'ok' if same else 'FAIL'}")
    if not same:
        raise AssertionError("(y) scatter DSGD: 2 processes differ from 1")
    runs = []      # the timed and the profiled epoch, compared
    ms, busy, idle, _ = _busy_idle(lambda: runs.append(epoch()) or runs[-1])
    _same_bits("y", "tmfdropout scatter DSGD", *runs)
    log(f"(y) tmfdropout scatter DSGD: S={solver.S} bs={solver.bs} "
        f"({solver.S // solver.bs} steps a shard-round); val RMSE at init "
        f"{val0!r}, per epoch {vals!r}; epoch alone (CUDA events) "
        f"{ms:.3f} ms, device busy {busy:.3f} ms, idle share {idle:.3f}")
    assert len(vals) == params.max_iter and all(np.isfinite(vals)) and \
        rep.best_metric < val0, vals


def _y_eval(data, dense, dev):
    """(y) 6-8: the sharded top-N (HR@10, ARHR@10) and RMSE against one
    device, the sharded checkpoint round trip, mesh ALS against ALS."""
    mesh = _y_mesh(dev)
    rep, model = dense["rep"], dense["model"]
    view = model.eval_view(rep.best_state)
    iu, ii = dense["inval"]
    kw = dict(user_block=1024)
    sc1 = CatalogScorer(data.train_mat, iu, ii, data.n_users, data.n_items,
                        mesh=mesh, **kw)
    sc0 = CatalogScorer(data.train_mat, iu, ii, data.n_users, data.n_items,
                        device=dev, **kw)
    tk.topk_catalog.launches = 0
    hr1 = sc1.hit_rate(view, data.val_mat, 10)
    ar1 = sc1.arhr(view, data.test_mat, 10)
    launches = tk.topk_catalog.launches
    per = -(-(-(-data.n_users // 1024)) // Y_SHARDS) * Y_SHARDS \
        // Y_SHARDS * 1024
    want = 2 * sum(tk.pass_launches(min(per, data.n_users - s * per),
                                    data.n_items, 10)
                   for s in range(Y_SHARDS))
    hr0 = sc0.hit_rate(view, data.val_mat, 10)
    ar0 = sc0.arhr(view, data.test_mat, 10)
    s1, i1 = sc1._topk_dev(view, 10)
    s0_, i0 = sc0._topk_dev(view, 10)
    err = float((s1 - s0_).abs().max())
    pass_ms = [_cuda_ms(lambda: sc._topk_dev(view, 10), 3)
               for sc in (sc1, sc0, sc0, sc1)]
    log(f"(y) sharded top-10 over {Y_SHARDS} shards: HR@10 {hr1!r} (one "
        f"device {hr0!r}), ARHR@10 {ar1!r} (one device {ar0!r}); ids equal "
        f"{bool(torch.equal(i1, i0))}, scores max_abs {err:.3e}; top-N "
        f"launches {launches} (plan {want}); a top-10 pass (CUDA events, "
        f"sharded, one device, one device, sharded) {pass_ms!r} ms")
    assert launches == want, (launches, want)
    if not (hr1 == hr0 and ar1 == ar0 and torch.equal(i1, i0)):
        raise AssertionError("(y) sharded top-N differs from one device")
    ev1 = Evaluator(data, iu, ii, rep.solver.params, mesh=mesh)
    for which in ("val", "test"):
        r1, r0 = ev1.rmse(view, which), dense["ev"].rmse(view, which)
        log(f"(y) sharded RMSE ({which}) {r1!r}, one device {r0!r}")
        assert abs(r1 - r0) <= 1e-6 * max(1.0, r0), (which, r1, r0)
    path = os.path.join(Y_DIR, "ckpt")
    t0 = time.perf_counter()
    ckpt_mod.save_sharded(path, rep.best_state, epoch=np.int64(3))
    back, extra = ckpt_mod.restore_sharded(path, rep.best_state)
    same = all(torch.equal(a, b) for a, b in zip(back, rep.best_state))
    log(f"(y) save_sharded -> restore_sharded of the trained state: bit "
        f"for bit {same}, {time.perf_counter() - t0:.2f} s")
    assert same and int(extra["epoch"]) == 3
    params = Params(**dict(COORD_PARAMS, max_iter=1))
    runs = {}
    for tag, kw_ in (("mesh", dict(mesh=mesh)), ("one device",
                                                 dict(device=dev))):
        t0 = time.perf_counter()
        r_, *_ = train_model(data, params, algo="mf", mf_method="als",
                             log_fn=lambda s: None, **kw_)
        runs[tag] = (r_.state, time.perf_counter() - t0)
    same = all(torch.equal(a, b) for a, b in zip(runs["mesh"][0],
                                                 runs["one device"][0]))
    log(f"(y) mesh ALS, 1 epoch ({runs['mesh'][1]:.1f} s) against ALS on "
        f"one device ({runs['one device'][1]:.1f} s): bit for bit {same}")
    if not same:
        raise AssertionError("(y) mesh ALS differs from ALS")
    return launches, err


def _y_scaling(dev) -> dict:
    """(y) 6: scripts/torch_scaling_curve.py's run() with its phase split
    at Y_CURVE_SHARDS shards of the card (scatter, one-hot and dense
    block DSGD; full, nopermute and permuteonly epochs), printed; counts
    zeroed around it; then one dense and one one-hot shard-round at 4
    shards of the curve's data held against their plain versions. Returns
    {kernel: (launches, max abs error)}."""
    sc = _load_script("torch_scaling_curve")
    t0 = time.perf_counter()
    drk.StripeTiles.launches = 0
    _zero_block_counts()
    rows = sc.run(phase_split=True, shards=Y_CURVE_SHARDS, dev=dev,
                  epochs=Y_CURVE_EPOCHS, log=lambda s: log(f"(y) {s}"))
    torch.cuda.synchronize()
    stripe = drk.StripeTiles.launches
    (n_row, n_diag, n_cell), _ = _block_counts()
    for line in sc.table(rows, True).splitlines():
        log(f"(y) {line}")
    log(f"(y) scaling curve launches: stripe {stripe}, diag {n_diag} (row "
        f"{n_row}, cell {n_cell}); {time.perf_counter() - t0:.1f} s")
    if stripe == 0 or n_diag == 0 or n_row or n_cell:
        raise AssertionError("(y) the scaling curve did not run through the "
                             "stripe and diag kernels alone")
    data, params, iu, ii, model = sc.curve_problem()
    mesh = _y_mesh(dev)
    s0 = shard_state(init_state(params, data.n_users, data.n_items,
                                device=dev), mesh)
    dense = sc.make_solver("densedsgd", model, params, data, iu, ii, mesh)
    a_dense = _dense_round_vs_plain("(y) curve", dense, s0, params)
    del dense
    block = sc.make_solver("blockdsgd", model, params, data, iu, ii, mesh)
    a_block, _, _ = _block_round_vs_plain("(y) curve", block, s0,
                                          params.learn_rate)
    return {"stripe": (stripe, a_dense), "diag": (n_diag, a_block)}


def phase_mesh(data: Data, dev="cuda") -> dict:
    """(y): the multi-device engines on a 4-shard mesh of the one card.
    Returns the launches and worst errors of each kernel on this path."""
    dense = _y_dense(data, dev)
    coord = _y_coord(data, dev)
    _y_two_process(dense["first"], coord, dev)
    del coord
    n_codes = _y_codes(data, dev)
    topk_n, topk_err = _y_eval(data, dense, dev)
    del dense["rep"], dense["ev"]
    torch.cuda.empty_cache()
    block = _y_block(data, dev)
    torch.cuda.empty_cache()
    _y_dsgd(data, dev)
    torch.cuda.empty_cache()
    curve = _y_scaling(dev)
    torch.cuda.empty_cache()
    return dict(dense=dense, codes=n_codes, block=block,
                topk=(topk_n, topk_err), curve=curve)


# ----------------------------------------------------------------------
# (z): the flagship at a cut depth; (mb): the microbenchmarks
# ----------------------------------------------------------------------

SCRIPTS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "scripts")
# scripts/torch_ml20m_flagship.py's run at k 64, cut from 60 epochs: a
# text checkpoint at epoch 5 and at the end, the loop's evals every 5
Z_MAX_ITER, Z_SAVE_ITER = 6, 5
Z_HELD_USERS = 2048


def _load_script(name: str):
    """A script of scripts/ as a module (its main not run)."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(SCRIPTS_DIR, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_flagship(flag, data: Data, dev="cuda") -> dict:
    """(z): ``flag.run_k`` (scripts/torch_ml20m_flagship.py) on its own
    data at k 64, Z_MAX_ITER epochs, text checkpoints every Z_SAVE_ITER,
    the counts zeroed just before and read just after: the loop stops
    with a reason and keeps the best-on-val state; the stripe kernel's
    launches (int8 codes) and the fused top-N kernel's (the HR@10 pass
    and its warm-up over every user) against the plan; the text
    checkpoint read back onto the card (factors only, as the reference's
    plain MF writes: ``load_full`` finds no biases and ``load_facs``
    reads it), val RMSE within 1e-5 of the best; the top-10 of
    Z_HELD_USERS users on the best view, kernel against topk_plain; each
    phase's wall. Returns the launches and worst errors."""
    params = flag.flagship_params(64, Z_MAX_ITER, Z_SAVE_ITER)
    prefix = os.path.join(RUN_DIR, "flagship", "ml20m_k64")
    n, m = data.n_users, data.n_items
    drk.StripeTiles.launches = 0
    tk.topk_catalog.launches = 0
    torch.cuda.synchronize()
    out = flag.run_k(data, params, prefix, dev, hr=True,
                     log=lambda s: log(f"(z) {s}"))
    torch.cuda.synchronize()
    stripe, topk = drk.StripeTiles.launches, tk.topk_catalog.launches
    rep, model, ev, walls = out["rep"], out["model"], out["ev"], \
        out["walls"]
    solver = rep.solver
    vals = [h.val_rmse for h in rep.history]
    epochs = walls["n_epochs"]
    want_stripe = epochs * drk.epoch_launches(solver.NU, 64, solver.mm_bf16)
    want_topk = 2 * tk.pass_launches(n, m, 10)
    ok = (solver.tiles.R.dtype == torch.int8 and rep.stop_reason
          and rep.best_iter >= 0 and rep.best_metric == min(vals)
          and np.isfinite(vals).all()
          and epochs == Z_MAX_ITER and stripe == want_stripe
          and tk.fused_plan(n, m, 10)["route"] == "fused"
          and topk == want_topk)
    log(f"(z) flagship at k 64, {epochs} epochs: stop={rep.stop_reason}, "
        f"best epoch {rep.best_iter}, val per logged epoch {vals!r}, best "
        f"{rep.best_metric!r}, test {out['test']!r}; {out['n_ckpt']} "
        f"checkpoint files; stripe launches {stripe} (plan {want_stripe}, "
        f"R {solver.tiles.R.dtype}), top-N launches {topk} (plan "
        f"{want_topk}); HR@10 {out['hr10']!r}; walls {walls} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("(z) the flagship run is not as planned")
    sig = ckpt_mod.model_signature(params, n, m)
    s0 = init_state(params, n, m, device=dev)
    t0 = time.perf_counter()
    back = ckpt_mod.load_facs(s0, prefix, sig)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    val = ev.rmse(model.eval_view(back), "val")
    ok = (ckpt_mod.load_full(s0, prefix, sig) is None
          and back.u_fac.device.type == torch.device(dev).type
          and abs(val - rep.best_metric) <= 1e-5)
    log(f"(z) the text checkpoint read back onto the card in {load_s:.2f} "
        f"s (factors only: load_full None, load_facs): val RMSE {val!r} "
        f"against the best {rep.best_metric!r} (|diff| "
        f"{abs(val - rep.best_metric):.2e} <= 1e-5) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("(z) the flagship checkpoint did not read back")
    scorer = out["scorer"]
    view = model.eval_view(rep.best_state)
    args = dict(u_fac=view.u_fac, i_fac=view.i_fac, i_bias=view.i_bias,
                u_bias=view.u_bias, mu=view.mu,
                invalid=scorer.invalid_items_dev, indptr=scorer.indptr,
                indices=scorer.indices,
                users=scorer._all_users[:Z_HELD_USERS])
    ok, err, held = topk_agree(tk.topk_catalog(**args, n=10),
                               tk.topk_plain(**args, n=10), False)
    log(f"(z) top-10 of {Z_HELD_USERS} users on the best view, kernel vs "
        f"plain: max_abs {err:.3e}, ids held at {held:.4f} of slots "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("(z) top-10 kernel vs plain")
    return {"stripe": (stripe, 0.0), "fused": (topk, err)}


def phase_microbench(dev="cuda") -> dict:
    """(mb): scripts/torch_microbench.py --quick on the card, printed."""
    return _load_script("torch_microbench").run(
        dev, quick=True, log=lambda s: log(f"(mb) {s}"))


NO_LIBRARY = "none: no one PyTorch call computes this function"


def _os_entry(res: dict, launches: int) -> dict:
    """The kernels-table entry of the ordered scatter: ``launches``, those
    the fused steps of (o)'s front-door runs reported enqueuing (counted
    from 0 at each), and the sgd cell's items case's times."""
    r = res["sgd items"]
    return {"name": "ordered_scatter<f32|bf16|f16|f64>", "route": "cuda",
            "source": SCATTER_SOURCE,
            "replaces": "none (XLA's scatter-add, .at[].add)",
            "launches": launches,
            "max_abs_err": max(v["max_abs_err"] for v in res.values()),
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            "library": "index_put_(accumulate=True), PyTorch's sort-based "
                       "fixed-order sum"}


def _ss_entry(ss: dict, o: dict) -> dict:
    """The kernels-table entry of the fused sgd step: launches, those of
    (o)'s front-door runs (counted from 0 at each); the largest gap to the
    eager step, (o)'s and (ss)'s; (ss)'s times a batch (card ms: the
    gradient kernel; plain ms: the eager step)."""
    return {"name": "sgd_step<f32|bf16>", "route": "cuda",
            "source": STEP_SOURCE,
            "replaces": "none (XLA's gathers, products and scatter-add)",
            "launches": o["launches"],
            "max_abs_err": max(ss["max_abs_err"], o["max_abs_err"]),
            "ms": ss["ms"],
            "step_ms": ss["step_ms"], "plain_ms": ss["plain_ms"],
            "bound_ms": ss["bound_ms"], "bound_by": ss["bound_by"],
            "library_ms": None, "library": NO_LIBRARY}


def sgd_step_main() -> int:
    """``--sgd-step``: phases (a), the build of the two sources, (ss) and
    (o) on (d)'s data; prints the kernels-table entry and the device."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; nothing to run",
              file=sys.stderr)
        return 2
    phase_env()
    t0 = time.perf_counter()
    _build.build_all(["ordered_scatter", "sgd_step"])
    osc_mod.library(), step_mod.library()
    log(f"(b) build + load of {SCATTER_SOURCE} and {STEP_SOURCE}: "
        f"{time.perf_counter() - t0:.2f} s")
    ss = phase_sgd_step()
    o = phase_scatter(bench_data(**CELLS["d"][0]))
    print(json.dumps({"kernels": [_ss_entry(ss, o)],
                      "ordered_scatter_launches": o["scatters"]}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def stripes_main() -> int:
    """``--stripes``: phases (a), the build of the stripe source, (c), (d),
    (w), (e), (z) and (n): every path of ``StripeTiles``; prints the
    phases' kernel numbers and the device."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; nothing to run",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    phase_env()
    drk.library()
    log(f"(b) build + load of {SOURCE}: "
        f"{time.perf_counter() - t_start:.2f} s")
    out = dict(kernel=phase_kernel_vs_plain(), exact=phase_bf16_rounding(),
               masked=phase_masked_vs_plain(),
               cells=phase_cells_vs_plain()[0])
    phase_codes_vs_float()
    data_d = bench_data(**CELLS["d"][0])
    out["d"] = run_cell("d", data_d)
    out["w"] = phase_cell_grid(data_d)
    out["n"] = phase_longtail_dense(data_d)
    del data_d
    flag = _load_script("torch_ml20m_flagship")
    data_e = flag.make_data()
    out["e"] = run_cell("e", data_e)
    out["z"] = phase_flagship(flag, data_e)
    for tag in ("d", "e"):
        out[tag] = {key: v for key, v in out[tag].items()
                    if key in ("launches", "max_abs_err", "ms", "plain_ms")}
    log(f"chip_smoke --stripes: every phase in "
        f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps(out, default=str), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def ordered_scatter_main() -> int:
    """``--ordered-scatter``: phases (a), the build of the one source, (o)
    on (d)'s data and (os) alone; prints the kernels-table entry and the
    device."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; nothing to run",
              file=sys.stderr)
        return 2
    phase_env()
    t0 = time.perf_counter()
    osc_mod.library()
    log(f"(b) build + load of {SCATTER_SOURCE}: "
        f"{time.perf_counter() - t0:.2f} s")
    o = phase_scatter(bench_data(**CELLS["d"][0]))
    res = phase_ordered_scatter()
    print(json.dumps({"kernels": [_os_entry(res, o["scatters"])],
                      "cases": res}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; nothing to run",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    laps = []

    def lap(tag: str) -> None:
        """Seconds since the previous lap, for the budget of the script."""
        laps.append((tag, round(time.perf_counter() - t_start
                                - sum(t for _, t in laps), 1)))

    smi = phase_env()
    phase_build()
    lap("a, b")
    worst = phase_kernel_vs_plain()
    exact = phase_bf16_rounding()
    phase_codes_vs_float()
    masked = phase_masked_vs_plain()
    cells, _ = phase_cells_vs_plain()
    lap("c")
    data_d = bench_data(**CELLS["d"][0])
    d = run_cell("d", data_d)
    lap("d")
    w = phase_cell_grid(data_d)
    lap("w")
    flag = _load_script("torch_ml20m_flagship")
    t0 = time.perf_counter()
    data_e = flag.make_data()
    log(f"data {data_e} made by scripts/torch_ml20m_flagship.py in "
        f"{time.perf_counter() - t0:.1f} s")
    e = run_cell("e", data_e)
    lap("e")
    z = phase_flagship(flag, data_e)
    del data_e
    torch.cuda.empty_cache()
    lap("z")
    err_f = phase_topk_vs_plain()
    lap("f")
    data_g = bench_data(**BPR_CELL[0])
    g = phase_ranking(data_g)
    lap("g")
    hyb = phase_hybrid(data_g)
    lap("r")
    dbpr = phase_dense_bpr(data_g)
    lap("s")
    del data_g
    block = phase_block_vs_plain()
    lap("h")
    (n_i, err_i, k_i, p_i, bound_i), cell, ev, inval, s0 = \
        phase_blocksgd(data_d)
    lap("i")
    err_j = phase_longtail(data_d)
    lap("j")
    n_k, err_k, k_k, p_k, bound_k = phase_rows(data_d, ev, inval, s0)
    lap("k")
    del ev
    l_ = run_cell("l", data_d)
    lap("l")
    n = phase_longtail_dense(data_d)
    lap("n")
    o = phase_scatter(data_d)
    lap("o")
    ss = phase_sgd_step()
    lap("ss")
    osc = phase_ordered_scatter()
    lap("os")
    phase_als(data_d)
    lap("p")
    phase_ccd(data_d)
    lap("q")
    phase_sgdparsvd(data_d)
    lap("t")
    y = phase_mesh(data_d)
    lap("y")
    cli_k = phase_cli(data_d, best_d=(d.pop("best"), d.pop("params")))
    lap("u")
    phase_analyze(data_d)
    lap("v")
    phase_quality()
    lap("x")
    phase_microbench()
    lap("mb")
    probes = phase_probes()
    lap("m")

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
              "matfac_tpu/ops/dense_row_kernel.py:108",
              d["launches"] + cli_k["stripe"][0] + y["dense"]["launches"]
              + y["curve"]["stripe"][0],
              max(float_err, d["max_abs_err"], l_["max_abs_err"],
                  cli_k["stripe"][1], y["dense"]["max_abs_err"],
                  y["curve"]["stripe"][1]), d["ms"],
              d["plain_ms"], (d["bound_ms"], d["bound_by"]),
              d["library_ms"], stripe_lib),
        entry("dense_rows<int8 codes>", SOURCE,
              "matfac_tpu/ops/dense_row_kernel.py:231",
              e["launches"] + y["codes"] + z["stripe"][0],
              max(worst["codes"], exact["codes"], e["max_abs_err"]), e["ms"],
              e["plain_ms"], (e["bound_ms"], e["bound_by"]),
              e["library_ms"], stripe_lib),
        entry("dense_rows<masked>", SOURCE,
              "matfac_tpu/ops/dense_block_kernel.py:52 (XLA, masked)",
              n["launches"], max(masked["max_abs"], n["max_abs_err"]),
              n["ms"], n["plain_ms"], (n["bound_ms"], n["bound_by"]),
              n["library_ms"], stripe_lib),
        entry("dense_cells<f32|bf16 R; int8|bf16|f32 W; int8 codes>",
              SOURCE, "matfac_tpu/ops/dense_block_kernel.py:110 (XLA "
              "dense_sweep_diag; the step of matfac_tpu/ops/"
              "dense_row_kernel.py:108 on each cell)", w["launches"],
              max(max(cells.values()), w["max_abs_err"]), w["ms"],
              w["plain_ms"], (w["bound_ms"], w["bound_by"]),
              w["library_ms"], "the cell's three products as bf16 "
              "torch.matmul (cuBLAS) calls, summed over the epoch's cells"),
        entry("topk_catalog<fused>", TOPK_SOURCE,
              "matfac_tpu/ops/topk_kernel.py:118",
              g["fused"][0] + hyb["launches"] + dbpr["launches"]
              + cli_k["fused"][0] + y["topk"][0] + z["fused"][0],
              max(err_f, g["fused"][1], hyb["max_abs_err"],
                  cli_k["fused"][1], y["topk"][1], z["fused"][1]),
              *g["fused"][2:]),
        entry("topk_catalog<radix>", TOPK_SOURCE,
              "matfac_tpu/ops/topk_kernel.py:118",
              g["radix"][0] + cli_k["radix"][0],
              max(err_f, g["radix"][1], cli_k["radix"][1]),
              *g["radix"][2:]),
        entry("block_sgd<diag>", BLOCK_SOURCE,
              "matfac_tpu/ops/block_sgd_kernel.py:148",
              n_i + cli_k["diag"][0] + y["block"]["launches"]
              + y["curve"]["diag"][0],
              max(block["diag"], err_i, err_j, cli_k["diag"][1],
                  y["block"]["max_abs_err"], y["curve"]["diag"][1]), k_i,
              p_i, bound_i),
        entry("block_sgd<row>", BLOCK_SOURCE,
              "matfac_tpu/ops/block_sgd_kernel.py:148", n_k,
              max(block["row"], err_k), k_k, p_k, bound_k),
        entry("fused_cell_update", BLOCK_SOURCE,
              "matfac_tpu/ops/sgd_kernel.py:73", cell[0],
              max(block["cell"], cell[1]), cell[2], cell[3], cell[4]),
        _os_entry(osc, o["scatters"]),
        _ss_entry(ss, o),
    ] + [entry(f"probe<{name}>", PROBE_SOURCE,
               f"scripts/tpu_pallas_bisect.py:{PROBE_LINES[name]}", *res)
         for name, res in probes.items()]
    log(f"chip_smoke: every phase in {time.perf_counter() - t_start:.1f} s; "
        f"seconds by phase {laps}")
    log(smi)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-worker"]:
        # one process of phase (y)'s 2-process run (started by the script)
        port, rank, out_dir, dev = sys.argv[2:6]
        sys.exit(mesh_worker(int(port), int(rank), out_dir, dev))
    if sys.argv[1:2] == ["--ordered-scatter"]:
        sys.exit(ordered_scatter_main())
    if sys.argv[1:2] == ["--sgd-step"]:
        sys.exit(sgd_step_main())
    if sys.argv[1:2] == ["--stripes"]:
        sys.exit(stripes_main())
    sys.exit(main())
