"""The long-tail models on the one-hot cell engine, then the scatter DSGD
on one shard, at the bench shape on the card (the counterpart of
scripts/tpu_longtail_dsgd.py). Stage 1: MF, IFWMF (per-example weights)
and TMF (sigmoid rank masks) through ``BlockSGDSolver`` (diag schedule,
384-blocks, batch 1024, collision-normalised; the diag entry of
csrc/block_sgd.cu), the hooks riding the staged streams. Stage 2: the
scatter DSGD (``DSGDShardedSolver``, item-balanced) on a 1-shard mesh,
its factor tables resident across epochs. Each prints its first epoch
(the build and the staging), its epoch ms and its ratings a second.

``--cpu`` runs the plain PyTorch versions on the CPU at 4,000 x 1,000
unless sizes are given.

Usage: python scripts/torch_longtail_dsgd.py [--cpu]
       [--n-users N --n-items N --density D]
"""

import argparse
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from matfac_tpu_torch.config import Params  # noqa: E402
from matfac_tpu_torch.data.synthetic import low_rank_ratings  # noqa: E402
from matfac_tpu_torch.models.base import ModelMF, init_state  # noqa: E402
from matfac_tpu_torch.models.longtail import (  # noqa: E402
    ModelDropoutSigmoid, ModelInvPopMF)
from matfac_tpu_torch.parallel.dsgd import DSGDShardedSolver  # noqa: E402
from matfac_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from matfac_tpu_torch.solvers.block_sgd import BlockSGDSolver  # noqa: E402
from matfac_tpu_torch.utils import freq  # noqa: E402


def time_epochs(solver, params, n_users, n_items, dev, n=3):
    """(first epoch s, min of ``n`` epochs s)."""
    sync = (lambda: None) if dev == "cpu" else torch.cuda.synchronize
    state = init_state(params, n_users, n_items, device=dev)
    t0 = time.perf_counter()
    state = solver.epoch(state, params.learn_rate)
    sync()
    first = time.perf_counter() - t0
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        state = solver.epoch(state, params.learn_rate)
        sync()
        times.append(time.perf_counter() - t0)
    return first, min(times)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--n-users", type=int)
    ap.add_argument("--n-items", type=int)
    ap.add_argument("--density", type=float)
    a = ap.parse_args()
    if not a.cpu and not torch.cuda.is_available():
        print("no CUDA device visible (pass --cpu for the CPU)",
              file=sys.stderr)
        return 2
    dev = "cpu" if a.cpu else "cuda"
    n_users, n_items, density = ((4_000, 1_000, 0.05) if a.cpu
                                 else (100_000, 20_000, 0.005))
    n_users, n_items = a.n_users or n_users, a.n_items or n_items
    density = a.density or density
    k = 64
    print(f"device: {'cpu' if a.cpu else torch.cuda.get_device_name(0)}",
          flush=True)
    mat, _, _ = low_rank_ratings(n_users, n_items, k=8, density=density,
                                 seed=0, noise=0.1, power_law=0.6,
                                 nonneg=True)
    iu, ii = freq.invalid_users_items(mat, n_users, n_items)
    uf, itf = freq.row_col_freq(mat)
    uf = np.pad(uf, (0, n_users - len(uf)))
    itf = np.pad(itf, (0, n_items - len(itf)))
    print(f"{n_users} x {n_items}: nnz={mat.nnz}", flush=True)
    params = Params(fac_dim=k, u_reg=0.001, i_reg=0.001, learn_rate=0.005,
                    seed=0, rho_rms=1.0, alpha=0.0)
    for name, model in (
            ("MF", ModelMF(params, n_users, n_items)),
            ("IFWMF", ModelInvPopMF(params, n_users, n_items, uf, itf, iu,
                                    ii)),
            ("TMF", ModelDropoutSigmoid(params, n_users, n_items, uf,
                                        itf))):
        s = BlockSGDSolver(model, params, mat, iu, ii, batch_size=1024,
                           bu=384, bi=384, collision_norm=True,
                           schedule="diag", device=dev)
        first, dt = time_epochs(s, params, n_users, n_items, dev)
        print(f"blocksgd {name}: first epoch {first:.1f} s, "
              f"epoch={dt * 1e3:.1f} ms rate={s.nnz / dt / 1e6:.1f}M "
              "ratings/s", flush=True)
        del s
    mesh = make_mesh((1,), ("u",), devices=[torch.device(dev)])
    s = DSGDShardedSolver(ModelMF(params, n_users, n_items), params, mat,
                          iu, ii, mesh, balance_items=True)
    first, dt = time_epochs(s, params, n_users, n_items, dev)
    print(f"DSGD N=1: first epoch {first:.1f} s, epoch={dt * 1e3:.1f} ms "
          f"rate={s.nnz / dt / 1e6:.1f}M ratings/s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
