"""Dense block DSGD on one shard of the card against the single-device
row-dense engine, at the bench shape (the counterpart of
scripts/tpu_dense_bdsgd.py): the multi-device path should keep the
single-device stripe rate up to the rotation's cost. Both run the stripe
entry of csrc/dense_rows.cu; each prints its first epoch (the build and
the staging), its epoch ms and its ratings a second.

``--cpu`` runs the plain PyTorch versions on the CPU at 4,000 x 1,000
unless sizes are given.

Usage: python scripts/torch_dense_bdsgd.py [--cpu]
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
    DenseBlockDSGDSolver)
from matfac_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from matfac_tpu_torch.solvers.block_sgd import BlockSGDSolver  # noqa: E402
from matfac_tpu_torch.utils import freq  # noqa: E402


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
    print(f"{n_users} x {n_items}: nnz={mat.nnz}", flush=True)
    params = Params(fac_dim=k, u_reg=0.001, i_reg=0.001, learn_rate=0.005,
                    seed=0)
    model = ModelMF(params, n_users, n_items)

    def sync():
        if dev != "cpu":
            torch.cuda.synchronize()

    def run(label, s):
        st = init_state(params, n_users, n_items, device=dev)
        t0 = time.perf_counter()
        st = s.epoch(st, 0.005)
        sync()
        first = time.perf_counter() - t0
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            st = s.epoch(st, 0.005)
            sync()
            times.append(time.perf_counter() - t0)
        dt = min(times)
        print(f"{label}: first epoch (build, staging) {first:.1f} s, "
              f"epoch={dt * 1e3:.1f} ms rate={s.nnz / dt / 1e6:.1f}M "
              "ratings/s", flush=True)

    ref = BlockSGDSolver(model, params, mat, iu, ii, engine="dense",
                         bu=None, bi=None, device=dev)
    run("single-device row-dense", ref)
    del ref
    mesh = make_mesh((1,), ("u",), devices=[torch.device(dev)])
    t0 = time.perf_counter()
    s = DenseBlockDSGDSolver(model, params, mat, iu, ii, mesh)
    print(f"dense block-DSGD staged {time.perf_counter() - t0:.1f} s "
          f"SU={s.SU} sub_bu={s.sub_bu} bi={s.bi}", flush=True)
    run("dense block-DSGD N=1", s)
    return 0


if __name__ == "__main__":
    sys.exit(main())
