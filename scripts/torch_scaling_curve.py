"""DSGD / block-DSGD / dense block-DSGD scaling curve on the port (the
counterpart of scripts/scaling_curve.py): epoch wall-clock at N = 1, 2, 4
and 8 shards for the scatter DSGD, the one-hot block DSGD and the dense
block DSGD, with the speedup against N = 1 and the staged streams' balance
(max / median real entries a shard).

Where JAX places the N shards on N devices, this script places them on
one card (or on the CPU with ``--cpu``), and the shards of a round run one
after another: the epoch time is the work of all N shards on one device,
not a throughput on N. The curve's shape is what it shows: what the
schedule costs as N grows (rounds, the item-block rotation, padding and
stream imbalance) on the same hardware.

``--phase-split`` also times each epoch in the solvers' phase-attribution
modes: "nopermute" (the rounds without the rotation: compute) and
"permuteonly" (the rotations alone), and prints the rotation's share of
the epoch, (full - nopermute) / full.

Usage: python scripts/torch_scaling_curve.py [--cpu] [--phase-split]
       [--shards 1 2 4 8] [--n-users N] [--n-items N] [--nnz N] [--k K]
       [--epochs E]
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
from matfac_tpu_torch.data.synthetic import synthetic_data  # noqa: E402
from matfac_tpu_torch.models.base import ModelMF, init_state  # noqa: E402
from matfac_tpu_torch.parallel.block_dsgd import (  # noqa: E402
    BlockDSGDSolver, DenseBlockDSGDSolver)
from matfac_tpu_torch.parallel.dsgd import DSGDShardedSolver  # noqa: E402
from matfac_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from matfac_tpu_torch.utils import freq as ufreq  # noqa: E402

ENGINES = ("dsgd", "blockdsgd", "densedsgd")
LR = 0.005


def stream_balance(solver) -> float:
    """max / median real (non-padding) staged entries a shard."""
    if isinstance(solver, DenseBlockDSGDSolver):
        tiles = solver.W_tiles if solver.W_tiles is not None \
            else solver.R_tiles
        per = [int((t != 0).sum()) for t in tiles]
    else:
        per = [int((w > 0).sum()) for w in solver.wts]
    return float(max(per) / max(np.median(per), 1))


def _sync(dev: str) -> None:
    if dev != "cpu":
        torch.cuda.synchronize()


def time_epochs(solver, state, epochs: int, dev: str, mode: str = "full"):
    """(state, min wall seconds of ``epochs`` epochs in ``mode``), after
    one epoch that builds the kernels and stages the tables."""
    state = solver.epoch(state, LR, mode=mode)
    _sync(dev)
    times = []
    for _ in range(epochs):
        t0 = time.perf_counter()
        state = solver.epoch(state, LR, mode=mode)
        _sync(dev)
        times.append(time.perf_counter() - t0)
    return state, min(times)


def make_solver(engine, model, params, data, iu, ii, mesh):
    if engine == "dsgd":
        return DSGDShardedSolver(model, params, data.train_mat, iu, ii,
                                 mesh, balance_items=True)
    if engine == "blockdsgd":
        return BlockDSGDSolver(model, params, data.train_mat, iu, ii, mesh,
                               sub_bu=512, sub_bi=512, batch_size=1024)
    return DenseBlockDSGDSolver(model, params, data.train_mat, iu, ii, mesh,
                                sub_bu=512)


def curve_problem(n_users=16384, n_items=4096, nnz=1_000_000, k=32):
    """(data, params, invalid users, invalid items, model) of the curve:
    the JAX script's power-law synthetic ratings."""
    data, _, _ = synthetic_data(n_users=n_users, n_items=n_items, k=8,
                                density=nnz / (n_users * n_items), seed=3,
                                noise=0.1, power_law=1.1, nonneg=True)
    params = Params(fac_dim=k, u_reg=0.01, i_reg=0.01, learn_rate=LR,
                    seed=1, batch_size=4096)
    iu, ii = ufreq.invalid_users_items(data.train_mat, data.n_users,
                                       data.n_items)
    return data, params, iu, ii, ModelMF(params, data.n_users, data.n_items)


def run(n_users=16384, n_items=4096, nnz=1_000_000, k=32, epochs=4,
        phase_split=False, shards=(1, 2, 4, 8), dev="cuda",
        engines=ENGINES, log=print):
    """Rows (engine, N, epoch s, speedup vs N=1, balance, nopermute s,
    permuteonly s); the two last None without ``phase_split``."""
    data, params, iu, ii, model = curve_problem(n_users, n_items, nnz, k)
    gen = lambda: torch.Generator().manual_seed(0)
    rows = []
    for engine in engines:
        base = None
        for n in shards:
            mesh = make_mesh((n,), ("u",), devices=[torch.device(dev)] * n)
            solver = make_solver(engine, model, params, data, iu, ii, mesh)
            state = init_state(params, data.n_users, data.n_items,
                               generator=gen(), device=dev)
            _, dt = time_epochs(solver, state, epochs, dev)
            base = dt if base is None else base
            comp = perm = None
            if phase_split:
                fresh = lambda: init_state(params, data.n_users,
                                           data.n_items, generator=gen(),
                                           device=dev)
                _, comp = time_epochs(solver, fresh(), epochs, dev,
                                      "nopermute")
                _, perm = time_epochs(solver, fresh(), epochs, dev,
                                      "permuteonly")
            bal = stream_balance(solver)
            rows.append((engine, n, dt, base / dt, bal, comp, perm))
            extra = ("" if not phase_split else
                     f" compute={comp * 1e3:9.3f} ms permute_only="
                     f"{perm * 1e3:8.3f} ms comm_frac={(dt - comp) / dt:6.1%}")
            log(f"{engine:10s} N={n} epoch={dt * 1e3:9.3f} ms "
                f"speedup_vs_N1={base / dt:5.2f} balance={bal:4.2f}"
                + extra)
    return rows


def table(rows, phase_split: bool) -> str:
    head = "| engine | N | epoch ms | speedup vs N=1 | max/median stream |"
    if phase_split:
        head += " compute ms | permute-only ms | comm frac |"
    lines = [head, "|---|---|---|---|---|" + ("---|" * 3 if phase_split
                                              else "")]
    for e, n, dt, sp, bal, comp, perm in rows:
        line = f"| {e} | {n} | {dt * 1e3:.3f} | {sp:.2f} | {bal:.2f} |"
        if phase_split:
            line += (f" {comp * 1e3:.3f} | {perm * 1e3:.3f} |"
                     f" {(dt - comp) / dt:.1%} |")
        lines.append(line)
    return "\n".join(lines)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--phase-split", action="store_true")
    ap.add_argument("--shards", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--n-users", type=int, default=16384)
    ap.add_argument("--n-items", type=int, default=4096)
    ap.add_argument("--nnz", type=int, default=1_000_000)
    ap.add_argument("--k", type=int, default=32)
    ap.add_argument("--epochs", type=int, default=4)
    a = ap.parse_args()
    if not a.cpu and not torch.cuda.is_available():
        print("no CUDA device visible (pass --cpu for the CPU)",
              file=sys.stderr)
        return 2
    dev = "cpu" if a.cpu else "cuda"
    print(f"device: {'cpu' if a.cpu else torch.cuda.get_device_name(0)}; "
          f"N shards of it", flush=True)
    rows = run(a.n_users, a.n_items, a.nnz, a.k, a.epochs, a.phase_split,
               tuple(a.shards), dev,
               log=lambda s: print(s, flush=True))
    print()
    print(table(rows, a.phase_split))
    return 0


if __name__ == "__main__":
    sys.exit(main())
