"""Block DSGD on one shard of the card: the one-hot cell engine inside the
DSGD rotation (``parallel.block_dsgd.BlockDSGDSolver``, the diag entry of
csrc/block_sgd.cu) at the bench shape, its ratings a second by
configuration (the counterpart of scripts/tpu_block_dsgd.py; JAX's pad_k
fills the TPU's matrix lanes and has no counterpart here).

``--shape medium`` takes the JAX script's 20,000 x 5,000 at density 0.05;
``--cpu`` runs the plain PyTorch version on the CPU at 4,000 x 1,000
unless sizes are given.

Usage: python scripts/torch_block_dsgd.py [--cpu] [--shape full|medium]
       [--n-users N --n-items N --density D]
"""

import argparse
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from matfac_tpu_torch.config import Params  # noqa: E402
from matfac_tpu_torch.data.synthetic import low_rank_ratings  # noqa: E402
from matfac_tpu_torch.models.base import ModelMF, init_state  # noqa: E402
from matfac_tpu_torch.parallel.block_dsgd import (  # noqa: E402
    BlockDSGDSolver)
from matfac_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from matfac_tpu_torch.utils import freq  # noqa: E402

SHAPES = {"full": (100_000, 20_000, 0.005), "medium": (20_000, 5_000, 0.05),
          "cpu": (4_000, 1_000, 0.05)}
# (label, sub-block, batch size: None sizes it from the cells)
CONFIGS = {"full": (("sub384 bs1024", 384, 1024), ("sub384 bs512", 384, 512)),
           "medium": (("sub384 AUTO", 384, None),
                      ("sub384 bs1024", 384, 1024))}


def sync(dev):
    if dev != "cpu":
        torch.cuda.synchronize()


def time_epochs(solver, params, n_users, n_items, dev, n=3):
    """(first epoch s, min of ``n`` epochs s): the first builds the kernel
    and stages the tables."""
    st = init_state(params, n_users, n_items, device=dev)
    t0 = time.perf_counter()
    st = solver.epoch(st, params.learn_rate)
    sync(dev)
    first = time.perf_counter() - t0
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        st = solver.epoch(st, params.learn_rate)
        sync(dev)
        times.append(time.perf_counter() - t0)
    return first, min(times)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--shape", choices=("full", "medium"), default="full")
    ap.add_argument("--n-users", type=int)
    ap.add_argument("--n-items", type=int)
    ap.add_argument("--density", type=float)
    a = ap.parse_args()
    if not a.cpu and not torch.cuda.is_available():
        print("no CUDA device visible (pass --cpu for the CPU)",
              file=sys.stderr)
        return 2
    dev = "cpu" if a.cpu else "cuda"
    n_users, n_items, density = SHAPES["cpu" if a.cpu else a.shape]
    n_users, n_items = a.n_users or n_users, a.n_items or n_items
    density = a.density or density
    k = 64
    print(f"device: {'cpu' if a.cpu else torch.cuda.get_device_name(0)}",
          flush=True)
    mat, _, _ = low_rank_ratings(n_users, n_items, k=8, density=density,
                                 seed=0, noise=0.1, power_law=0.6,
                                 nonneg=True)
    iu, ii = freq.invalid_users_items(mat, n_users, n_items)
    print(f"{n_users} x {n_items}: nnz={mat.nnz}", flush=True)
    mesh = make_mesh((1,), ("u",), devices=[torch.device(dev)])
    for label, sub, bs in CONFIGS[a.shape]:
        params = Params(fac_dim=k, u_reg=0.001, i_reg=0.001,
                        learn_rate=0.005, seed=0)
        model = ModelMF(params, n_users, n_items)
        t0 = time.perf_counter()
        s = BlockDSGDSolver(model, params, mat, iu, ii, mesh, sub_bu=sub,
                            sub_bi=sub, batch_size=bs)
        print(f"{label}: staged {time.perf_counter() - t0:.1f} s "
              f"pad_frac={s.pad_frac:.2f} S={s.S} bs={s.bs}", flush=True)
        first, dt = time_epochs(s, params, n_users, n_items, dev)
        print(f"blockDSGD N=1 {label}: first epoch (build) {first:.1f} s, "
              f"epoch={dt * 1e3:.1f} ms rate={s.nnz / dt / 1e6:.1f}M "
              "ratings/s", flush=True)
        del s
    return 0


if __name__ == "__main__":
    sys.exit(main())
